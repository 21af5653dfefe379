"""Rounds: the host time of the program's ``round:pop`` spans (pop's host
path and launch) in the span pass, per round (``spans.py``)."""

from portbench import spans


def read(rec):
    s = spans.of(rec)
    return None if s is None else s["pop_ms"]
