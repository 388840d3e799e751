"""Training runtime of the port: failure handling, elastic re-mesh planning,
stragglers — copies of ``repro.runtime`` (host-only Python and numpy)."""
from repro_torch.runtime.elastic import plan_mesh, replan_after_failure
from repro_torch.runtime.fault import FaultTolerantLoop, StepFailure
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = [
    "FaultTolerantLoop",
    "StepFailure",
    "plan_mesh",
    "replan_after_failure",
    "StragglerMonitor",
]
