"""Host dispatch: the time the host waited in the program's synchronising
device reads (its ``read:<site>`` spans) in the span pass, per round
(``spans.py``)."""

from portbench import spans


def read(rec):
    s = spans.of(rec)
    return None if s is None else s["read_wait_ms"]
