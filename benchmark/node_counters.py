"""Shared arithmetic of the readers of the node's own counters: phases
that a node's Core gains when its consensus worker counts its sleeps
(`consensus_sleep`), its core lock its waits (`core_lock_wait`) and its
collects the passes that ordered nothing (`consensus_empty`). Each
reader returns None for a record of a program without those counters;
a counter that never fired in such a program reads 0."""

from __future__ import annotations


def node_phases(rec):
    """The record's phase sums ([ns, calls] by phase) when the program
    counts its worker's sleeps, else None."""
    ph = rec.get("phase_ns") or {}
    return ph if "consensus_sleep" in ph else None


def lock_wait_ms_per_s(rec):
    """Waits for the core lock, over every acquisition, per second of
    the window (ms/s)."""
    ph = node_phases(rec)
    if ph is None or not rec.get("window_s"):
        return None
    return ph.get("core_lock_wait", [0, 0])[0] / 1e6 / rec["window_s"]


def cadence_sleep_mean_ms(rec):
    """Mean sleep of the consensus worker between two passes (ms),
    stalled runs' long sleeps included."""
    ph = node_phases(rec)
    if ph is None or not ph["consensus_sleep"][1]:
        return None
    ns, wakes = ph["consensus_sleep"]
    return ns / wakes / 1e6


def empty_pass_pct(rec):
    """Passes collected that ordered no new event, of all passes
    collected (%)."""
    ph = node_phases(rec)
    collected = (ph or {}).get("consensus_collect", [0, 0])[1]
    if ph is None or not collected:
        return None
    return 100.0 * ph.get("consensus_empty", [0, 0])[1] / collected
