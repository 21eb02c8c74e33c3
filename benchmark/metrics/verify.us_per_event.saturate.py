"""Core.phase_ns verify_device-p256 per event verified (us): ops/p256.py
verify_batch on the card."""


from readers import verify_us_per_event as read  # noqa: F401
