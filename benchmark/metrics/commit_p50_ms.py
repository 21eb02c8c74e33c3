"""Median wait of the transactions due in the window, from their event's
due time to the CommitBlock that holds them at the app proxy; one
still uncommitted at the window's end counts its wait up to the end."""


from readers import percentile_ms


def read(rec):
    return percentile_ms(rec, 50)
