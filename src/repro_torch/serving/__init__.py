"""Serving subsystem of the port: paged KV cache + continuous batching
(counterpart of ``repro/serving``).

* ``blocks``, ``prefix_cache``, ``scheduler``, ``telemetry`` -- the
  reference's host-side bookkeeping, copied (numpy only);
* ``sampling`` -- greedy / temperature / top-k in torch;
* ``server`` -- paged-model execution on one device.
"""

from repro_torch.serving.blocks import BlockAllocator, BlockTable
from repro_torch.serving.prefix_cache import PrefixCache, chain_keys
from repro_torch.serving.sampling import SamplingParams, sample_tokens
from repro_torch.serving.scheduler import PrefillChunk, Request, Scheduler
from repro_torch.serving.server import ContinuousBatchingServer
from repro_torch.serving.telemetry import Telemetry, TelemetrySnapshot

__all__ = [
    "BlockAllocator", "BlockTable", "ContinuousBatchingServer",
    "PrefillChunk", "PrefixCache", "Request", "SamplingParams",
    "Scheduler", "Telemetry", "TelemetrySnapshot", "chain_keys",
    "sample_tokens",
]
