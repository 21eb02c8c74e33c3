"""Share of the traced window in which no device activity ran (%), from
torch.profiler."""


from readers import idle_pct as read  # noqa: F401
