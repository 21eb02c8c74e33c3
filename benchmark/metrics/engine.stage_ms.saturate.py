"""Median `engine.stage` span (ms): the staging half of a consensus pass
on the engine's worker thread (ingest, closure, fd fold, frontier,
rounds, fame and round received), over the passes whose stage closed
inside the traced window."""


def read(rec):
    stage = (rec.get("program_spans") or {}).get("engine.stage")
    return stage["median_ns"] / 1e6 if stage else None
