from repro_torch.runtime.fault_tolerance import (ElasticPlan,
                                                 HeartbeatMonitor,
                                                 PreemptionGuard,
                                                 StragglerDetector,
                                                 plan_elastic_remesh)

__all__ = ["ElasticPlan", "HeartbeatMonitor", "PreemptionGuard",
           "StragglerDetector", "plan_elastic_remesh"]
