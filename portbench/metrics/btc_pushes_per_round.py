"""Bitcoin app: the program's ``round:btc:push`` spans (one per masked
push the app makes, one push launch on a card) in the span pass, per
round (``spans.py``). 0.0 where the pass holds no such span; nothing
where there is no span pass."""

from portbench import spans


def read(rec):
    s = spans.of(rec)
    if s is None:
        return None
    return s["totals"].get("round:btc:push", (0, 0))[0] / rec["rounds"]
