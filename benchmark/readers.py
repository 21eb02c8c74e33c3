"""Shared arithmetic of the metric readers (benchmark/metrics/*.py).
Each reader takes the run's record and returns a number, or None when
the record holds nothing to read (the metric is then left out)."""

from __future__ import annotations

import statistics


def phase_total_ns(rec, name):
    ent = rec.get("phase_ns", {}).get(name)
    return ent[0] if ent else None


def ingest_us_per_event(rec):
    """Host wall of a sync less its signature verify, per event synced."""
    sync, verify = phase_total_ns(rec, "sync"), phase_total_ns(rec, "verify")
    events = rec.get("events_synced", 0)
    if sync is None or not events:
        return None
    return (sync - (verify or 0)) / events / 1e3


def verify_us_per_event(rec):
    ns = phase_total_ns(rec, "verify_device-p256")
    events = rec.get("events_verified", 0)
    return ns / events / 1e3 if ns and events else None


def verify_ms_per_sync(rec):
    ent = rec.get("phase_ns", {}).get("verify_device-p256")
    return ent[0] / ent[1] / 1e6 if ent and ent[1] else None


def pass_ms_median(rec):
    walls = rec.get("pass_walls_s")
    return statistics.median(walls) * 1e3 if walls else None


def idle_pct(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(rec, kernel):
    tr = rec.get("trace")
    k = tr.get(kernel) if tr else None
    if not k or not k["launches"] or k["device_s"] <= 0 or k["bound_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]


def percentile_ms(rec, q):
    waits = rec.get("commit_waits_s")
    if not waits:
        return None
    return statistics.quantiles(waits, n=100, method="inclusive")[q - 1] * 1e3
