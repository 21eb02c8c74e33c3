"""Median wall of a consensus pass, from its dispatch to the end of its
collect (ms)."""


from readers import pass_ms_median as read  # noqa: F401
