"""Fame's depth steps a pass (one host read each, redo dispatches
included): the Core's engine_fame_steps items over its engine_passes.
Deeper where a witness needs more rounds of votes to reach 2n/3 + 1."""

from engine_counters import items_per_pass


def read(rec):
    return items_per_pass(rec, "engine_fame_steps")
