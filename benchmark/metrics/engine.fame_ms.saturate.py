"""Median `engine.fame` span (ms): fame's virtual voting
(kernels.decide_fame) inside the fused epilogue, over the passes whose
fame closed inside the traced window. It lies inside `engine.fame_rr`,
which adds round received and the packed result."""


def read(rec):
    fame = (rec.get("program_spans") or {}).get("engine.fame")
    return fame["median_ns"] / 1e6 if fame else None
