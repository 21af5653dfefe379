"""Bitcoin app: the host time of the program's ``round:btc:wakeup`` and
``round:btc:notify`` spans (``on_wakeup``'s and ``on_notify``'s bodies)
in the span pass, per round (``spans.py``). 0.0 where the pass holds no
such span; nothing where there is no span pass."""

from portbench import spans

NAMES = ("round:btc:wakeup", "round:btc:notify")


def read(rec):
    s = spans.of(rec)
    if s is None:
        return None
    ns = sum(s["totals"].get(n, (0, 0))[1] for n in NAMES)
    return ns / rec["rounds"] / 1e6
