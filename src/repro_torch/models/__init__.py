"""Model code of the port: the dense decoder family (train, prefill,
decode, and serving on a paged KV cache) and the Mamba SSM stack (train,
prefill, decode)."""

from repro_torch.models import layers, paged, scan_utils, ssm, transformer
from repro_torch.models.paged import (copy_blocks, decode_step_paged,
                                      forward_paged, init_pages,
                                      supports_paged)
from repro_torch.models.transformer import (decode_step, forward_train,
                                            init_cache, init_params,
                                            prefill)

__all__ = ["layers", "paged", "scan_utils", "ssm", "transformer",
           "copy_blocks", "decode_step", "decode_step_paged",
           "forward_paged", "forward_train", "init_cache", "init_pages",
           "init_params", "prefill", "supports_paged"]
