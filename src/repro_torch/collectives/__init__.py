"""The paper's collectives over one axis: communicators (``comm``), the
per-rank algorithms (``shardmap_impl``), the model-driven engine
(``engine``) and its functional surface (``api``)."""

from repro_torch.collectives.api import (allgather, allgather_inside,
                                         allgather_multi_inside, allreduce,
                                         allreduce_inside,
                                         allreduce_multi_inside,
                                         all_to_all, all_to_all_inside,
                                         all_to_all_multi_inside,
                                         broadcast, broadcast_inside,
                                         get_engine, plan_collective,
                                         reduce_scatter,
                                         reduce_scatter_inside,
                                         reduce_scatter_multi_inside,
                                         reduce_to_root, select_algorithm,
                                         set_engine)
from repro_torch.collectives.comm import (Comm, LocalComm,
                                          ProcessGroupComm, run_local)
from repro_torch.collectives.engine import (CollectiveEngine, Decision,
                                            fit_fabric, measure_ppermute)
from repro_torch.collectives import shardmap_impl

__all__ = ["allreduce", "allreduce_inside", "allreduce_multi_inside",
           "reduce_scatter", "reduce_scatter_inside",
           "reduce_scatter_multi_inside",
           "allgather", "allgather_inside", "allgather_multi_inside",
           "all_to_all", "all_to_all_inside", "all_to_all_multi_inside",
           "broadcast", "broadcast_inside", "reduce_to_root",
           "select_algorithm", "get_engine", "set_engine",
           "plan_collective", "CollectiveEngine", "Decision", "fit_fabric",
           "measure_ppermute", "Comm", "LocalComm", "ProcessGroupComm",
           "run_local", "shardmap_impl"]
