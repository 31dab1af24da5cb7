"""WSE fabric simulators, the port's copy of ``repro/simulator``.

Framework-free numpy over ``repro_torch.core``, kept so that the port
needs nothing of the JAX package (the prices the simulators check are
the port's own, bit-identical to the reference's).  Two levels of
fidelity:

* ``flow``   -- stream-level event simulation over the Schedule IR;
               exact for the serialized-receive / pipelined-last-child
               execution semantics; scales to the full 512x512 grid.
* ``fabric`` -- wavelet-level cycle simulation of routers, ramps, colors,
               multicast and backpressure on small grids; used to validate
               the flow simulator's assumptions (and the sums themselves).

``runner`` holds the model's closed forms against the flow simulator,
as the paper holds them against the CS-2 (Sec. 8).
"""

from repro_torch.simulator.flow import (simulate_allreduce,
                                        simulate_broadcast,
                                        simulate_reduce_tree,
                                        simulate_ring_allreduce)
from repro_torch.simulator import fabric, runner

__all__ = [
    "simulate_reduce_tree", "simulate_broadcast", "simulate_allreduce",
    "simulate_ring_allreduce", "fabric", "runner",
]
