"""Telemetry of the port. Only the capacity sizers are ported
(telemetry/capacity.py, a stdlib-only copy of the reference's), which
InmemStore's retained-byte estimate reads; the rest of the reference's
telemetry package waits for the node slice."""
