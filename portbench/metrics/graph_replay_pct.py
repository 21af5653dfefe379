"""Rounds: the share of handler passes that ran as a replay of a CUDA
graph in the span pass, 100 × the program's ``round:graph:replay`` spans
over its ``round:h:<kind>`` spans (``spans.py``). Nothing where the
program has no such span."""

from portbench import spans


def read(rec):
    s = spans.of(rec)
    try:
        from shadow1_tpu_torch.telemetry.profiler import (
            ROUND_HANDLER,
            RS_GRAPH_REPLAY,
        )
    except ImportError:
        return None
    if s is None:
        return None
    passes = sum(c for n, (c, _) in s["totals"].items()
                 if n.startswith(ROUND_HANDLER))
    if not passes:
        return None
    return 100.0 * s["totals"].get(RS_GRAPH_REPLAY, (0, 0))[0] / passes
