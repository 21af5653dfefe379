"""Host-side phase profiler — Chrome trace-event export (port of
``telemetry/profiler.py``).

``with profiler.span("run-chunk"):`` records one complete ("ph": "X")
trace event; ``write(path)`` emits Chrome trace-event JSON that
chrome://tracing and Perfetto load directly. One event per phase (compile
— here the CUDA kernel build —, init, run-chunk, drain, checkpoint), cheap
enough to leave on.

Below it, ``device_trace`` is the op-level zoom: a ``torch.profiler``
capture of the CPU ops and the CUDA kernels, exported as a Chrome trace.
The engine's window phases run inside ``record_function`` scopes named
``WINDOW_PHASES`` (``core/engine.window_step``), and every PhaseProfiler
span opens one under its own name, so the kernels of a trace line up with
the window phase and the chunk that launched them.

Inside the window phases the tracer is off unless one is installed
(``with active(prof): ...``). The window phases are then its spans
(``phase_span``), the engine's round loop opens a span at each step of a
round (``round_span``: ``round:pop``, ``round:dispatch``,
``round:h:<kind>`` per handler pass, within it ``round:graph:replay`` and
``round:graph:capture`` where the pass is a graph, ``round:continue``;
the Bitcoin app adds ``round:btc:*`` inside its passes),
and every synchronising device read of the window path goes through
``read``, a ``read:<site>`` span. Each adds to the tracer's per-name
totals (count, ns) and opens a ``torch.profiler`` scope under its name.
With no tracer installed a round span costs a global read and a shared
null context, ``read`` the read itself: no scope, no allocation.

One clock: spans are stamped in Unix-epoch ns (``perf_counter_ns`` plus
an offset to ``time_ns`` taken as the best of several samples), the clock
of ``torch.profiler``'s records, and the Chrome trace gives them in µs
from the same base as ``torch.profiler``'s ``export_chrome_trace``
(``baseTimeNanoseconds``), so the two files of a ``--profile`` directory
overlay.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

# Canonical host-side phase names (the reference's).
PH_COMPILE = "compile"
PH_INIT = "init"
PH_RUN_CHUNK = "run-chunk"
PH_DRAIN = "drain"
PH_CHECKPOINT = "checkpoint"
PH_DEVICE_TRACE = "device-trace"
# The four window phases, as the reference names its ``jax.named_scope``
# spans (``core/engine.window_phases``).
PH_PREPARE = "phase:prepare"
PH_ROUNDS = "phase:rounds"
PH_DELIVER = "phase:deliver"
PH_TELEM = "phase:telem"
WINDOW_PHASES = {"prepare": PH_PREPARE, "rounds": PH_ROUNDS,
                 "deliver": PH_DELIVER, "telem": PH_TELEM}
# The round loop's spans (``core/engine.run_rounds`` / ``run_round``); a
# handler pass is ``ROUND_HANDLER`` + the kind's name (``KIND_NAMES``).
RS_POP = "round:pop"
RS_DISPATCH = "round:dispatch"
RS_CONTINUE = "round:continue"
ROUND_HANDLER = "round:h:"
# A handler pass replayed as a CUDA graph (``core/graph.py``): each replay
# with its staging copies, inside the pass's ``round:h:<kind>`` span, and
# each capture.
RS_GRAPH_REPLAY = "round:graph:replay"
RS_GRAPH_CAPTURE = "round:graph:capture"
# The Bitcoin app's spans (``apps/bitcoin.py``), inside its handler passes:
# ``on_wakeup``'s and ``on_notify``'s bodies, and each masked push the app
# makes (one push launch on a card).
RS_BTC_WAKEUP = "round:btc:wakeup"
RS_BTC_NOTIFY = "round:btc:notify"
RS_BTC_PUSH = "round:btc:push"
ROUND_PREFIX = "round:"
# A synchronising device read: READ_PREFIX + its site.
READ_PREFIX = "read:"
# The spans a run-chunk's end writes out as counters.
_COUNTED = ("phase:", ROUND_PREFIX, READ_PREFIX)
# The process name of the trace's metadata event.
PROCESS_NAME = "shadow1_tpu_torch"
# torch.profiler's Chrome trace base: the epoch floored to 7,889,238 s
# (libkineto's ChromeTraceBaseTime).
_TRACE_BASE_S = 7889238


def epoch_offset_ns() -> int:
    """``time_ns() - perf_counter_ns()``, from the best of nine samples: the
    one whose two ``perf_counter_ns`` reads lie closest together."""
    best = None
    for _ in range(9):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1]


class PhaseProfiler:
    """Collects complete-span trace events and per-name totals;
    thread-safe, append-only.

    ``round_events``: keep one trace event per window phase, round and
    read span of the active tracer (the CLI's ``--profile``); without it
    those spans only add to the totals,
    which each ``run-chunk`` span's end writes out as counter events, so a
    trace grows by a bounded number of events a chunk."""

    def __init__(self, round_events: bool = False):
        self.offset_ns = epoch_offset_ns()
        self.base_ns = (time.time_ns() // 10**9 // _TRACE_BASE_S
                        * _TRACE_BASE_S * 10**9)
        self.round_events = round_events
        # Trace events; a complete span is kept as the tuple (name, start
        # and end perf_counter ns, thread, args) until a trace is asked for.
        self.events: list = []
        # name -> [count, total ns] of every span
        self.totals: dict[str, list[int]] = {}
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._scope = None

    def now_ns(self) -> int:
        """The shared clock: Unix-epoch ns."""
        return time.perf_counter_ns() + self.offset_ns

    def _ts(self, ns: int) -> float:
        return round((ns - self.base_ns) / 1e3, 3)

    def _event(self, name: str, ph: str, t0: int, **kw) -> dict:
        return {"name": name, "ph": ph, "ts": self._ts(t0), **kw,
                "pid": self.pid, "tid": threading.get_ident() & 0xFFFFFFFF}

    def _close(self, name: str, t0: int, t1: int, keep: bool = True,
               args: dict | None = None) -> None:
        """Add one span (perf_counter ns) to the totals, and to the events
        when ``keep``."""
        with self._lock:
            tot = self.totals.get(name)
            if tot is None:
                self.totals[name] = [1, t1 - t0]
            else:
                tot[0] += 1
                tot[1] += t1 - t0
            if keep:
                self.events.append((name, t0, t1, threading.get_ident(),
                                    args))

    def _complete(self, span: tuple) -> dict:
        """A kept span as its ``"ph": "X"`` trace event."""
        name, t0, t1, tid, args = span
        ev = {"name": name, "ph": "X", "ts": self._ts(t0 + self.offset_ns),
              "dur": round((t1 - t0) / 1e3, 3), "pid": self.pid,
              "tid": tid & 0xFFFFFFFF}
        if args:
            ev["args"] = args
        return ev

    def scope(self, name: str):
        """A ``torch.profiler`` scope for a round or read span: the
        profiler's C++ record function, which costs 1.4-2.3 µs of the card
        host's time where a ``record_function`` costs several times that
        and, under a CUDA capture, slowed a phold pass by half."""
        if self._scope is None:
            import torch

            self._scope = torch._C._profiler._RecordFunctionFast
        return self._scope(name)

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a phase: ``with prof.span("run-chunk", windows=128): ...``"""
        import torch

        t0 = time.perf_counter_ns()
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            t1 = time.perf_counter_ns()
            self._close(name, t0, t1, args=args)
            if name == PH_RUN_CHUNK:
                self._counters(t1 + self.offset_ns)

    def _counters(self, t_ns: int) -> None:
        """One counter event per window phase, round and read span name:
        its count and total ms so far."""
        with self._lock:
            self.events.extend(
                self._event(n, "C", t_ns, args={"n": c, "ms": ns / 1e6})
                for n, (c, ns) in self.totals.items()
                if n.startswith(_COUNTED))

    def instant(self, name: str, **args) -> None:
        """Mark a point in time (``"ph": "i"`` instant event)."""
        ev = self._event(name, "i", self.now_ns(), s="p")
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def total(self, name: str) -> tuple[int, int]:
        """(count, ns) of the spans named ``name`` so far."""
        with self._lock:
            return tuple(self.totals.get(name, (0, 0)))

    def reads(self) -> dict[str, tuple[int, int]]:
        """Per read site: (count, ns waited)."""
        with self._lock:
            return {n[len(READ_PREFIX):]: (c, ns)
                    for n, (c, ns) in self.totals.items()
                    if n.startswith(READ_PREFIX)}

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (dict form)."""
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": self.pid,
            "tid": 0,
            "args": {"name": PROCESS_NAME},
        }]
        with self._lock:
            events = meta + [self._complete(e) if isinstance(e, tuple) else e
                             for e in self.events]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": self.base_ns}

    def write(self, path: str) -> None:
        """Write the trace JSON (atomic: tmp + rename, like ckpt saves)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)

    def span_names(self) -> list[str]:
        with self._lock:
            return [e[0] for e in self.events if isinstance(e, tuple)]


class _Span:
    """A round or read span of the active tracer (``round_span``)."""

    __slots__ = ("prof", "name", "rf", "t0")

    def __init__(self, prof: PhaseProfiler, name: str):
        self.prof, self.name = prof, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.rf = self.prof.scope(self.name)
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.prof._close(self.name, self.t0, time.perf_counter_ns(),
                         keep=self.prof.round_events)


# The installed tracer (``active``), None when tracing is off.
_ACTIVE: PhaseProfiler | None = None
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def active(prof: PhaseProfiler | None):
    """Install ``prof`` as the tracer of the round loop for the with-body
    (None: tracing off); the previous one comes back on exit."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, prof
    try:
        yield prof
    finally:
        _ACTIVE = prev


def phase_span(name: str):
    """A window phase's scope: a span of the active tracer, or, with none
    installed, a plain ``record_function`` under its name."""
    prof = _ACTIVE
    if prof is None:
        import torch

        return torch.profiler.record_function(name)
    return _Span(prof, name)


def round_span(name: str):
    """A span of the active tracer, or a shared null context when none is
    installed."""
    prof = _ACTIVE
    if prof is None:
        return _NULL
    return _Span(prof, name)


def read(site: str, how, x):
    """``how(x)``: a synchronising device read (``bool``, ``int`` or
    ``torch.Tensor.tolist`` of a device tensor), a ``read:<site>`` span of
    the active tracer, which counts it and the time the host waited."""
    prof = _ACTIVE
    if prof is None:
        return how(x)
    with _Span(prof, READ_PREFIX + site):
        return how(x)


def maybe_span(profiler: PhaseProfiler | None, name: str, **args):
    """``profiler.span(...)`` or a nullcontext — call sites stay branchless."""
    if profiler is None:
        return contextlib.nullcontext()
    return profiler.span(name, **args)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str, profiler: PhaseProfiler | None = None):
    """A ``torch.profiler`` trace of the with-body (CPU ops, and the CUDA
    kernels when a card is present), exported on exit as a Chrome trace
    to ``log_dir/trace.json`` (``TRACE_FILE``). A ``device-trace`` span
    marks the capture window in the PhaseProfiler's own trace, so the two
    zoom levels line up. A profiler that cannot start fails the run: an
    asked-for trace is never silently missing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        with maybe_span(profiler, PH_DEVICE_TRACE, log_dir=log_dir):
            yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
