"""Mean sleep of the consensus worker between two passes (ms): the
Core's consensus_sleep phase over its wakes. A mean, so the long sleeps
of a stalled run (twice the pass wall's EMA) weigh in; the median sleep
is the `consensus.sleep` span's, which the record does not hold."""


from node_counters import cadence_sleep_mean_ms as read  # noqa: F401
