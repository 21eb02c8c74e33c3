"""Core.phase_ns verify_device-p256 per sync that verified (ms)."""


from readers import verify_ms_per_sync as read  # noqa: F401
