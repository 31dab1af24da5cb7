"""Model code of the port: the dense decoder family on a paged KV cache."""

from repro_torch.models import layers, paged, transformer
from repro_torch.models.paged import (copy_blocks, decode_step_paged,
                                      forward_paged, init_pages,
                                      supports_paged)
from repro_torch.models.transformer import init_params

__all__ = ["layers", "paged", "transformer", "copy_blocks",
           "decode_step_paged", "forward_paged", "init_pages", "init_params",
           "supports_paged"]
