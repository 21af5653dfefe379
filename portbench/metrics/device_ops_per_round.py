"""Host dispatch: operations of the counted pass (aten operations but views
and the scalar read, plus one per hand-kernel launch) per round."""


def read(rec):
    if not rec["rounds"]:
        return None
    return rec["census"]["ops"] / rec["rounds"]
