"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The layout mirrors ``src/repro``: each module here is the counterpart of
the module with the same path there.  The port imports ``torch`` and
numpy only; the JAX package is the reference its tests compare against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``repro_torch.device.resolve_device``).  On the CPU every kernel
wrapper takes its plain PyTorch version; on a CUDA tensor it launches
its hand-written kernel (``repro_torch/kernels/csrc``) or raises.
"""
