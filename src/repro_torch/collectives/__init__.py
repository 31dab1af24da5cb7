"""The paper's collectives: communicators and grids of ranks
(``comm``), the per-rank algorithms over one axis and the 2D ones over a
grid (``shardmap_impl``), the topology planner (``planner``), the
model-driven engine (``engine``) and its functional surface (``api``)."""

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
from repro_torch.collectives.comm import (Comm, GridComm, LocalComm,
                                          ProcessGroupComm,
                                          ProcessGroupGrid, run_local,
                                          run_local_grid, single_rank_grid)
from repro_torch.collectives.engine import (CollectiveEngine, Decision,
                                            fit_fabric, measure_ppermute)
from repro_torch.collectives.planner import CollectivePlan, PlanStep
from repro_torch.collectives import planner, shardmap_impl

__all__ = ["allreduce", "allreduce_inside", "allreduce_multi_inside",
           "reduce_scatter", "reduce_scatter_inside",
           "reduce_scatter_multi_inside",
           "allgather", "allgather_inside", "allgather_multi_inside",
           "all_to_all", "all_to_all_inside", "all_to_all_multi_inside",
           "broadcast", "broadcast_inside", "reduce_to_root",
           "select_algorithm", "get_engine", "set_engine",
           "plan_collective", "CollectiveEngine", "Decision", "fit_fabric",
           "measure_ppermute", "CollectivePlan", "PlanStep", "Comm",
           "GridComm", "LocalComm", "ProcessGroupComm", "ProcessGroupGrid",
           "run_local", "run_local_grid", "single_rank_grid", "planner",
           "shardmap_impl"]
