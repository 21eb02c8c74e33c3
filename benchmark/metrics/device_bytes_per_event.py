"""Peak device bytes allocated (torch.cuda.max_memory_allocated) over
the events the engine held: in the closed loop, for the window's join
that took the most events, when its peak was reached (the engine's
growth; a join's end would swing with the events the window let it
take); in the open loop, at the window's end. How many events a node
can hold on one card."""


def read(rec):
    rows = [r for r in rec.get("job_bytes") or [] if r[0] and r[1]]
    if not rows:
        return None
    peak, held, _ = max(rows, key=lambda r: r[2])
    return peak / held
