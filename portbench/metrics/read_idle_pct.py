"""Host dispatch: the share of the device's idle time in the span pass that
falls in gaps opening inside one of the program's ``read:<site>`` spans
(``spans.py``)."""

from portbench import spans


def read(rec):
    s = spans.of(rec)
    if s is None or s["read_idle_share"] is None:
        return None
    return 100.0 * s["read_idle_share"]
