"""Events given a round received and a place in the consensus order by
the window's passes, over the whole window (events/s)."""


def read(rec):
    if "ordered_in_window" not in rec:
        return None
    return rec["ordered_in_window"] / rec["window_s"]
