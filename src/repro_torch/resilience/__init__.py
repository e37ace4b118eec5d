"""Resilience tier of the port — deterministic fault injection and
preemption recovery for the streaming farm (twin of
:mod:`repro.resilience`).

A seeded :class:`~repro_torch.resilience.faults.FaultPlan` poisons chosen
lanes at chosen sweeps (NaN), stalls lanes, corrupts stream items at the
prep boundary and kills a run at a seeded segment boundary;
:mod:`~repro_torch.resilience.recovery` holds the snapshot and
write-ahead-journal layer (atomic directory publish, structure-preserving
snapshots, CRC-framed fsync'd journal, kill-and-respawn harness), in the
reference's on-disk format.
"""
from .faults import FaultPlan
from .recovery import (PREEMPTED_EXIT, Journal, PreemptionError,
                       RecoveryConfig, latest_snapshot_step, load_snapshot,
                       run_to_completion, save_snapshot)

__all__ = ["FaultPlan", "RecoveryConfig", "Journal", "PreemptionError",
           "PREEMPTED_EXIT", "save_snapshot", "load_snapshot",
           "latest_snapshot_step", "run_to_completion"]
