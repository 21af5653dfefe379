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
# The process name of the trace's metadata event.
PROCESS_NAME = "shadow1_tpu_torch"


class PhaseProfiler:
    """Collects complete-span trace events; thread-safe, append-only."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.events: list[dict] = []
        self._lock = threading.Lock()

    def _now_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a phase: ``with prof.span("run-chunk", windows=128): ...``"""
        import torch

        t_start = self._now_us()
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            t_end = self._now_us()
            ev = {
                "name": name,
                "ph": "X",
                "ts": round(t_start, 1),
                "dur": round(t_end - t_start, 1),
                "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFFFFFF,
            }
            if args:
                ev["args"] = args
            with self._lock:
                self.events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Mark a point in time (``"ph": "i"`` instant event)."""
        ev = {
            "name": name,
            "ph": "i",
            "s": "p",
            "ts": round(self._now_us(), 1),
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (dict form)."""
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": os.getpid(),
            "tid": 0,
            "args": {"name": PROCESS_NAME},
        }]
        with self._lock:
            events = meta + list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        """Write the trace JSON (atomic: tmp + rename, like ckpt saves)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)

    def span_names(self) -> list[str]:
        with self._lock:
            return [e["name"] for e in self.events if e.get("ph") == "X"]


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
