"""``repro_torch.runtime`` — checkpoint / restart fault tolerance for
training, dispatch-granularity fault injection, and elastic re-meshing."""

from repro_torch.runtime.fault_tolerance import (FaultPlan, HeartbeatMonitor,
                                                 InjectedFault,
                                                 ResilientTrainer,
                                                 StragglerPolicy, fault_scope,
                                                 simulate_failure)
from repro_torch.runtime.elastic import elastic_remesh, reshard_tree

__all__ = ["ResilientTrainer", "HeartbeatMonitor", "StragglerPolicy",
           "simulate_failure", "elastic_remesh", "reshard_tree",
           "FaultPlan", "InjectedFault", "fault_scope"]
