"""The numpy oracle: a sequential discrete-event simulator of the same
semantics (``docs/SEMANTICS.md``), one global heap of (time, tie-break)
events, the NIC, TCP and the apps as per-host objects. A frozen copy, with
its own configuration compiler, counters, draws and digest words, so that
no later change to the program moves what a pass is held to.

``expected`` runs one experiment per seed from window 0 and returns what
the benchmark compares: the final counters the oracle keeps, one row per
window (the work gauges and the five digest words, computed whether or not
the document asks for them) and the model summary.
"""

from __future__ import annotations

import copy
import dataclasses
import heapq

from portbench.reference.oracle.engine import CpuEngine


class _FifoTie(int):
    """A tie-break that orders by push order: the control's broken rule."""

    def __new__(cls, value: int, seq: int):
        obj = int.__new__(cls, value)
        obj.seq = seq
        return obj

    def __lt__(self, other):
        return self.seq < other.seq

    def __gt__(self, other):
        return self.seq > other.seq

    def __eq__(self, other):
        return self.seq == other.seq

    __hash__ = int.__hash__


class FifoTieEngine(CpuEngine):
    """The control: events of one host at one time run in the order they
    were scheduled, not in tie-break order."""

    def _push(self, time, tb, host, kind, p):
        self.pending[host] += 1
        if self.digest_on:
            from portbench.reference.oracle.digest import event_word

            w = event_word(host, time, tb, kind, p)
            self._ev_word[self._gseq] = w
            self._ev_dg += w
        heapq.heappush(self.heap, (time, _FifoTie(tb, self._gseq), self._gseq,
                                   host, kind, p))
        self._gseq += 1


CONTROLS = {"fifo_ties": FifoTieEngine}


def expected(doc: dict, seeds: list[int], n_windows: int, device=None,
             control: str | None = None) -> list[dict]:
    """Per seed: the oracle's counters after ``n_windows`` windows, its
    rows of windows 0..n_windows-1 and its model summary."""
    from portbench.reference.oracle.experiment import build_experiment

    engine = CONTROLS[control] if control else CpuEngine
    out = []
    for seed in seeds:
        d = copy.deepcopy(doc)
        d.setdefault("general", {})["seed"] = int(seed)
        exp, params, _ = build_experiment(d)
        # The digest words are the reference's own, whatever the document
        # sets: the run is judged on the final state's words.
        params = dataclasses.replace(
            params, on_overflow="drop", selfcheck=0, state_digest=1,
            metrics_ring=max(1, params.metrics_ring))
        eng = engine(exp, params)
        metrics = eng.run(n_windows)
        rows: dict[int, dict] = {}
        for r in eng.digest_rows + eng.work_rows:
            rows.setdefault(r["window"], {"window": r["window"]}).update(
                {k: v for k, v in r.items() if k != "type"})
        out.append({"metrics": dict(metrics),
                    "ring": [rows[w] for w in sorted(rows)],
                    "summary": eng.summary()})
    return out
