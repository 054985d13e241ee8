"""``repro_torch.runtime`` — dispatch-granularity fault injection."""

from repro_torch.runtime.fault_tolerance import (FaultPlan, InjectedFault,
                                                 fault_scope)

__all__ = ["FaultPlan", "InjectedFault", "fault_scope"]
