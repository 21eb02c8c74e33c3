"""P-256 window tables built per device-verify call (one a sync that
verified): the Core's verify_window_tables calls (tables built) over its
verify_prelude calls. 0 where every participant's table is kept."""


def read(rec):
    ph = rec.get("phase_ns") or {}
    prelude = ph.get("verify_prelude")
    if not prelude or not prelude[1]:
        return None
    return ph.get("verify_window_tables", [0, 0])[1] / prelude[1]
