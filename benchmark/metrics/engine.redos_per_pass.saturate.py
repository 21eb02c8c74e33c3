"""Re-dispatches of the fused epilogue a pass on a frontier, window or
timestamp-bucket overflow: the Core's engine_redos items over its
engine_passes."""

from engine_counters import items_per_pass


def read(rec):
    return items_per_pass(rec, "engine_redos")
