"""Rounds still undecided after a pass (the engine's undecided_rounds),
averaged over passes: the Core's engine_undecided_rounds items over its
engine_passes. They stay on the fame and round-received windows."""

from engine_counters import items_per_pass


def read(rec):
    return items_per_pass(rec, "engine_undecided_rounds")
