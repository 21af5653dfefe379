"""The fifth traced pass of a ``--trace 1`` run: the program's own tracer
(``shadow1_tpu_torch.telemetry.profiler``) inside the round loop.

One more pass of the cell's span, from the cell's start state rebuilt
(the harness has freed its copy by the time the per-layer readers run),
with the program's tracer installed and under ``torch.profiler`` with
CUDA activity alone, as the device pass (``tracing.py``). The tracer
times every window phase, every step of a round (``round:pop``,
``round:dispatch``, ``round:h:<kind>``, ``round:continue``) and every
synchronising device read (``read:<site>``), on the clock of the
profiler's records. From it:

* host time per span name, per round of the pass;
* read counts and the host's wait per site;
* the device's idle gaps (between the merged kernel, copy and set
  intervals of the pass, annotations left out), each put down to the
  innermost program span open where the gap starts;
* the shared clock's check: the share of the pop kernel's launch records
  that fall inside ``round:pop`` and of the device-to-host copies' runtime
  records that fall inside a ``read:*`` span (matched to their device
  records by correlation id).

The harness hands a per-layer reader only the run's records, so the first
reader that asks (``of``) finds the cell's engine in ``run_cell``'s frame,
runs the pass once and keeps its reduction in the records. A program
without the tracer (``profiler.active``) gives no pass: the readers
return nothing. On the CPU (the tests) the capture's operator records
stand for the device's intervals.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

from portbench import tracing
from portbench.harness import synchronize

PASS_SPAN = "portbench:spans"
RS_POP, READ_PREFIX = "round:pop", "read:"
# The tracer's scopes, which the capture records beside the device's work.
OURS = ("round:", "read:", "phase:", "portbench:")


def _cell(rec):
    """The harness's ``Cell`` of the run whose records are ``rec``: a local
    of the ``run_cell`` frame that holds this very dict."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_locals.get("records") is rec:
            cell = f.f_locals.get("cell")
            if hasattr(cell, "eng") and hasattr(cell, "span"):
                return cell
        f = f.f_back
    return None


def of(rec) -> dict | None:
    """The fifth pass's reduction for the run of ``rec``, run on the first
    call and kept in ``rec["spans"]``; None where there is none."""
    if "spans" not in rec:
        rec["spans"] = None
        cell = _cell(rec)
        try:
            from shadow1_tpu_torch.telemetry.profiler import (  # noqa: F401
                active,
            )
        except ImportError:
            cell = None
        if cell is not None and rec.get("rounds"):
            rec["spans"] = traced_pass(cell, rec)
    return rec["spans"]


def _busy(events, cuda: bool) -> list:
    """(start, end) ns of the work the device did: kernels, copies and sets
    on a card; on the CPU, the capture's operator records."""
    out = []
    for e in events:
        if e.name().startswith(OURS):
            continue
        if cuda:
            if tracing.is_device_op(e):
                out.append((e.start_ns(), e.end_ns()))
        elif not getattr(e, "is_user_annotation", bool)():
            out.append((e.start_ns(), e.end_ns()))
    return out


class Spans:
    """The tracer's spans of the pass, for the innermost one open at given
    times."""

    def __init__(self, tracer):
        evs = [e for e in tracer.chrome_trace()["traceEvents"]
               if e.get("ph") == "X"]
        base = tracer.base_ns
        self.items = sorted(
            ((round(e["ts"] * 1e3) + base,
              round((e["ts"] + e["dur"]) * 1e3) + base, e["name"])
             for e in evs), key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.items]

    def sweep(self, points):
        """``innermost`` of each of the sorted ``points``, in one pass."""
        out, stack, i = [], [], 0
        for t in points:
            while i < len(self.items) and self.items[i][0] <= t:
                while stack and stack[-1][1] <= self.items[i][0]:
                    stack.pop()
                stack.append(self.items[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out.append(stack[-1][2] if stack else None)
        return out


def idle_by_span(spans: Spans, busy, s0: int, s1: int) -> dict:
    """Idle ns of the device in [s0, s1), by the innermost span open at
    each gap's start: name -> [ns, gaps]."""
    merged = tracing.merge([(max(s, s0), min(e, s1)) for s, e in busy
                            if e > s0 and s < s1])
    edges = [s0] + [x for iv in merged for x in iv] + [s1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    out = defaultdict(lambda: [0, 0])
    for (a, b), name in zip(gaps, spans.sweep([a for a, _ in gaps])):
        g = out[name or "(no span)"]
        g[0] += b - a
        g[1] += 1
    return dict(out)


def issued_inside(events, spans: Spans) -> dict:
    """The shared clock's check: of the pop kernel's launches and of the
    device-to-host copies, how many runtime records (matched by
    correlation id) lie inside ``round:pop`` and inside a ``read:*``
    span."""
    runtime = {}
    for e in events:
        if str(e.device_type()).endswith("CUDA") or not e.correlation_id():
            continue
        # Profiler records of older releases lack ``activity_type``.
        kind = str(getattr(e, "activity_type", str)())
        if "runtime" in kind or "driver" in kind or e.name().startswith("cu"):
            runtime.setdefault(e.correlation_id(), e.start_ns())
    out = {"pop": [0, 0, 0], "d2h": [0, 0, 0]}   # device records, matched, in
    issued = []
    for e in events:
        if not tracing.is_device_op(e):
            continue
        name = e.name()
        key = ("pop" if "pop_kernel" in name else "d2h"
               if "DtoH" in name or "Device -> Pageable" in name else None)
        if key is None:
            continue
        out[key][0] += 1
        t = runtime.get(e.correlation_id())
        if t is not None:
            out[key][1] += 1
            issued.append((t, key))
    issued.sort()
    for (_, key), n in zip(issued, spans.sweep([t for t, _ in issued])):
        out[key][2] += int(n == RS_POP if key == "pop"
                           else bool(n) and n.startswith(READ_PREFIX))
    return {k: {"records": n, "matched": m, "inside": i}
            for k, (n, m, i) in out.items()}


def traced_pass(cell, rec) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from shadow1_tpu_torch.telemetry.profiler import (
        ROUND_HANDLER,
        PhaseProfiler,
        active,
    )

    t_start = time.perf_counter()
    cuda = cell.device.type == "cuda"
    held = [cell.eng.run(cell.eng.init_state(), cell.start)]
    synchronize(cell.device)
    t_state = time.perf_counter()
    tracer = PhaseProfiler(round_events=True)
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        synchronize(cell.device)
        t0 = time.perf_counter()
        with active(tracer), tracer.span(PASS_SPAN):
            st = cell.eng.run(held.pop(), cell.span)
            synchronize(cell.device)
        wall = time.perf_counter() - t0
    del st
    if cuda:
        torch.cuda.empty_cache()
    events = prof.profiler.kineto_results.events()
    spans = Spans(tracer)
    (s0, s1, _), = [s for s in spans.items if s[2] == PASS_SPAN]
    idle = idle_by_span(spans, _busy(events, cuda), s0, s1)
    totals = {n: tuple(v) for n, v in tracer.totals.items()}
    reads = tracer.reads()
    rounds = rec["rounds"]

    def ms_round(names):
        return sum(totals[n][1] for n in names) / rounds / 1e6

    out = {
        "wall_s": wall,
        "totals": totals,
        "reads": reads,
        "idle": idle,
        "pop_ms": ms_round([RS_POP]) if RS_POP in totals else None,
        "handler_ms": ms_round([n for n in totals
                                if n.startswith(ROUND_HANDLER)]),
        "read_wait_ms": ms_round([n for n in totals
                                  if n.startswith(READ_PREFIX)]),
        "read_idle_share": None,
        "issued": issued_inside(events, spans) if cuda else None,
    }
    idle_ns = sum(ns for ns, _ in idle.values())
    if idle_ns:
        out["read_idle_share"] = sum(
            ns for n, (ns, _) in idle.items()
            if n.startswith(READ_PREFIX)) / idle_ns
    report(out, rec, t_state - t_start)
    return out


def report(out: dict, rec: dict, rebuild_s: float) -> None:
    """The fifth pass on stderr: costs, counts against the census, host
    ms per round by span, reads by site, the top idle spans."""
    rounds = rec["rounds"]
    walls = rec.get("walls") or []
    untraced = sum(walls) / len(walls) if walls else None
    pops = out["totals"].get(RS_POP, (0, 0))[0]
    n_reads = sum(c for c, _ in out["reads"].values())
    census = (rec.get("census") or {}).get("reads")
    lines = [
        f"span pass: wall {out['wall_s']:.6f} s (start state rebuilt in "
        f"{rebuild_s:.3f} s); untraced pass mean {untraced} s, device "
        f"pass {rec.get('window_s')} s; round:pop spans {pops}, rounds "
        f"{rounds}; reads {n_reads}, census reads {census}; issued inside "
        f"their span {out['issued']}",
        "span pass, host ms per round (count): " + ", ".join(
            f"{n} {ns / rounds / 1e6:.6f} ({c})" for n, (c, ns) in sorted(
                out["totals"].items(), key=lambda kv: -kv[1][1])),
        "span pass, reads by site (count, wait ms per round): " + ", ".join(
            f"{s} {c} {ns / rounds / 1e6:.6f}" for s, (c, ns) in sorted(
                out["reads"].items(), key=lambda kv: -kv[1][1])),
        "span pass, device idle by innermost span (ms, gaps), top 10: "
        + ", ".join(f"{n} {ns / 1e6:.3f} {g}" for n, (ns, g) in sorted(
            out["idle"].items(), key=lambda kv: -kv[1][0])[:10]),
    ]
    print("\n".join(lines), file=sys.stderr, flush=True)
