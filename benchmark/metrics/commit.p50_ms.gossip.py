"""Median wait of the transactions due in the window, from their event's
due time to the CommitBlock that holds them at the app proxy; one
still uncommitted at the window's end counts its wait up to the end.
A per-layer reading: the node's adaptive cadence falls into stall runs
(a pass of ~1 s, a third of the passes) in about one run in three, so
runs of one build spread by more than any bound allows."""


from readers import percentile_ms


def read(rec):
    return percentile_ms(rec, 50)
