"""Shared arithmetic of the readers of the engine's work items: the
counters a Core gains from its engine at each collected pass
(`engine_passes`, `engine_fame_steps`, `engine_undecided_rounds`,
`engine_frontier_rounds`, `engine_redos`; babble_tpu_torch/TRACING.md),
items in the calls column. Each reader returns None for a record of a
program without them."""

from __future__ import annotations


def items_per_pass(rec, phase):
    """A counter's items over the passes collected (per pass)."""
    ph = rec.get("phase_ns") or {}
    passes, items = ph.get("engine_passes"), ph.get(phase)
    if not passes or not passes[1] or items is None:
        return None
    return items[1] / passes[1]
