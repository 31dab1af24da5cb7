"""Model code of the port: the dense and MoE decoder families (train,
prefill, decode, and serving on a paged KV cache, vision soft tokens
included; the MoE FFN on one device, over the model axis and
expert-parallel through the engine's all-to-all), the Mamba SSM stack,
the RG-LRU hybrid and the encoder-decoder (train, prefill, decode), and
the modality frontend stubs."""

from repro_torch.models import (frontend, layers, moe, moe_ep, paged, rglru,
                                scan_utils, ssm, transformer)
from repro_torch.models.paged import (copy_blocks, decode_step_paged,
                                      forward_paged, init_pages,
                                      supports_paged)
from repro_torch.models.transformer import (decode_step, forward_train,
                                            init_cache, init_params,
                                            param_specs, prefill)

__all__ = ["frontend", "layers", "moe", "moe_ep", "paged", "rglru",
           "scan_utils", "ssm", "transformer",
           "copy_blocks", "decode_step", "decode_step_paged",
           "forward_paged", "forward_train", "init_cache", "init_pages",
           "init_params", "param_specs", "prefill", "supports_paged"]
