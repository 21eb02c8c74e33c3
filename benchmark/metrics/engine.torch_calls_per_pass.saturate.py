"""Torch calls a pass (dispatch, the staging worker, collect), counted by
a TorchFunctionMode in the traced run's warm job."""


def read(rec):
    passes = rec.get("torch_call_passes")
    return rec["torch_calls"] / passes if passes else None
