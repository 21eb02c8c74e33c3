"""Consensus passes that ordered no new event, of the passes collected
in the window (%): the Core's consensus_empty and consensus_collect
phases."""


from node_counters import empty_pass_pct as read  # noqa: F401
