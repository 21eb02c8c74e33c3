"""95th percentile of the wait of commit_p50_ms (ms). A per-layer
reading, not bounded: a stall of a few seconds in one run in four
(engine growth, the adaptive cadence) moves the tail by 3-5x."""

from readers import percentile_ms


def read(rec):
    return percentile_ms(rec, 95)
