"""Core-lock wait per second of the window (ms/s): the Core's
core_lock_wait phase, every acquisition of the node's core lock that
waited, the retake after an unlocked verify or collect included."""


from node_counters import lock_wait_ms_per_s as read  # noqa: F401
