"""``repro_torch.runtime`` — checkpoint / restart fault tolerance for
training, and dispatch-granularity fault injection."""

from repro_torch.runtime.fault_tolerance import (FaultPlan, HeartbeatMonitor,
                                                 InjectedFault,
                                                 ResilientTrainer,
                                                 StragglerPolicy, fault_scope,
                                                 simulate_failure)

__all__ = ["ResilientTrainer", "HeartbeatMonitor", "StragglerPolicy",
           "simulate_failure", "FaultPlan", "InjectedFault", "fault_scope"]
