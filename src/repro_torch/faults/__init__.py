"""repro_torch.faults — deterministic fault injection and graceful degradation.

Port of ``repro/faults``: ``FaultPlan`` describes seeded faults (dropout,
stragglers, corrupt uploads, torn checkpoint writes); ``UpdateGuard`` and
``guard_mask`` are the merge-side admission rule; ``FaultCounters`` is the
per-run ledger on ``EngineState.fault_events``; ``build_faulty_merge`` is
the fused executor's fault-aware merge (the reference's
``build_faulty_chunk``).
"""
from repro_torch.faults.fused import build_faulty_merge
from repro_torch.faults.plan import (
    CORRUPT_MODES,
    FaultCounters,
    FaultPlan,
    UpdateGuard,
    corrupt_params_stack,
    guard_mask,
    tear_file,
)

__all__ = [
    "FaultPlan", "FaultCounters", "UpdateGuard", "guard_mask",
    "corrupt_params_stack", "tear_file", "build_faulty_merge", "CORRUPT_MODES",
]
