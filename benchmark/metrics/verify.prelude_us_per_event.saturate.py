"""Verify's host prelude (the window tables and the big-int work before
the B9 launch) per signature verified (us): the Core's verify_prelude
phase over the signatures its verify_signatures phase counts."""


def read(rec):
    ph = rec.get("phase_ns") or {}
    prelude, sigs = ph.get("verify_prelude"), ph.get("verify_signatures")
    if not prelude or not sigs or not sigs[1]:
        return None
    return prelude[0] / sigs[1] / 1e3
