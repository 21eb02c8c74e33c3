"""The window over the number of consensus passes collected in it (ms)."""


def read(rec):
    passes = rec.get("window_passes")
    return rec["window_s"] * 1e3 / passes if passes else None
