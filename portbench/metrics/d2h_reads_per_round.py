"""Host dispatch: synchronising device-to-host reads of the counted pass
per round."""


def read(rec):
    if not rec["rounds"]:
        return None
    return rec["census"]["reads"] / rec["rounds"]
