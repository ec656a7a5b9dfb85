"""repro_torch.faults — what the engine and scheduler did about faults.

Port of ``repro/faults``: ``FaultCounters``, the per-run ledger on
``EngineState.fault_events`` that the async scheduler counts its timeouts,
retries, aborts, evictions and lost slots into. Still to port (ROADMAP
A6): ``FaultPlan`` (seeded fault injection), ``UpdateGuard`` /
``guard_mask`` (the merge's quarantine) and the fault-aware masked merge.
"""
from repro_torch.faults.plan import FaultCounters

__all__ = ["FaultCounters"]
