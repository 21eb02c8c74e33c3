"""Core.phase_ns sync less verify, per event synced (us): from_wire and
insert into TorchHashgraph."""


from readers import ingest_us_per_event as read  # noqa: F401
