"""Events taken from the wire, verified, inserted and passed through a
consensus pass by the syncs that completed inside the window, over the
whole window (events/s). In the closed loop every event ingested is
ordered a fixed number of rounds later, so over a long run this is the
rate to consensus order; over one window the order itself moves in
steps of a decided round (about 10,000 events at n = 1,024), which
engine.ordered_events_per_s.saturate reports."""


def read(rec):
    if "ingested_in_window" not in rec:
        return None
    return rec["ingested_in_window"] / rec["window_s"]
