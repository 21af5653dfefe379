"""The host time of the ``phase:rounds`` scopes of the profiled pass, per window."""


def read(rec):
    s = rec["profile"]["phase_s"].get("phase:rounds")
    return None if s is None else s / rec["windows"] * 1e3
