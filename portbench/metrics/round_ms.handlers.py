"""Rounds: the host time of the program's ``round:h:<kind>`` spans (every
handler pass) in the span pass, per round (``spans.py``)."""

from portbench import spans


def read(rec):
    s = spans.of(rec)
    return None if s is None else s["handler_ms"]
