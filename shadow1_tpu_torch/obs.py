"""Observability — the heartbeat metrics stream (port of ``obs.py``, the
same record schema key for key, so the reference's
``tools/heartbeat_report.py`` reads a port log unchanged).

The window loop runs in chunks and one structured heartbeat per chunk
carries the metric deltas — events/s, packets, drops, faults, work and
fill — without any device→host read inside a window. When the state
carries the telemetry ring, the flow-probe ring or the link accumulator,
the heartbeat drains them at each chunk boundary into ``ring``, ``flow``
and ``link`` records, and a ``telemetry.PhaseProfiler`` times the
compile (here: the CUDA kernel build), run-chunk, drain and checkpoint
phases.
"""

from __future__ import annotations

import json
import os
import sys
import time

from shadow1_tpu_torch.ckpt import run_chunked
from shadow1_tpu_torch.consts import SEC
from shadow1_tpu_torch.telemetry import (
    PH_CHECKPOINT,
    PH_COMPILE,
    PH_DRAIN,
    PH_INIT,
    maybe_span,
    normalize,
)
from shadow1_tpu_torch.telemetry.registry import (
    DROP_FIELDS,
    HOST_FIELDS,
    REC_HEARTBEAT,
)


def _metrics_mapping(metrics) -> dict:
    """Engine metrics → plain int dict (Metrics NamedTuple or already a dict
    — alternate engines need not mimic the NamedTuple)."""
    d = metrics if isinstance(metrics, dict) else metrics._asdict()
    return {k: int(v) for k, v in d.items()}


class Heartbeat:
    """Collects per-chunk metric deltas; writes JSON lines to ``stream``
    (``False``: keep the records, print nothing). Metric dicts are
    normalized through the registry, so a missing counter reads as 0."""

    def __init__(self, engine, stream=None, initial_state=None, profiler=None,
                 emit_heartbeat: bool = True, emit_ring: bool = True,
                 guard=None):
        self.engine = engine
        self.guard = guard  # txn.OverflowGuard — source of the retries block
        self.stream = stream if stream is not None else sys.stderr
        self.profiler = profiler
        self.emit_heartbeat = emit_heartbeat
        self.emit_ring = emit_ring
        self.t_start = time.perf_counter()
        self.t_last = self.t_start
        # Seed the baseline from a resumed state so the first delta covers
        # only this invocation, not the checkpointed history.
        self.last: dict[str, int] = (
            normalize(_metrics_mapping(initial_state.metrics))
            if initial_state is not None else {}
        )
        # First ring window still undrained (resume-aware like ``last``).
        self._ring_next: int = self.last.get("windows", 0)
        # Same cursor for the flow-probe ring (telemetry/probes.py).
        self._probe_next: int = self.last.get("windows", 0)
        # And for the link accumulator (telemetry/links.py) — link records
        # are cumulative snapshots, so the cursor only suppresses re-drains
        # of already-emitted boundaries on resume.
        self._link_next: int = self.last.get("windows", 0)
        self.records: list[dict] = []
        self.ring_records: list[dict] = []
        self.flow_records: list[dict] = []
        self.link_records: list[dict] = []

    def _emit(self, rec: dict) -> None:
        if self.stream:
            print(json.dumps(rec), file=self.stream, flush=True)

    def __call__(self, st, done_windows: int) -> None:
        now = time.perf_counter()
        # The ONE device→host fetch of the chunk (never inside a window).
        with maybe_span(self.profiler, PH_DRAIN):
            m = normalize(_metrics_mapping(st.metrics))
            ring_recs = self._drain_ring(st)
            flow_recs = self._drain_probes(st)
            link_recs = self._drain_links(st)
        delta = {k: v - self.last.get(k, 0) for k, v in m.items()}
        dt = now - self.t_last
        sim_ns = int(st.win_start)  # the true sim clock (resume-aware)
        d_windows = delta.get("windows", 0)
        rec = {
            "type": REC_HEARTBEAT,
            "sim_time_s": round(sim_ns / SEC, 6),
            "wall_s": round(now - self.t_start, 3),
            "windows": done_windows,
            "events_per_sec": round(delta.get("events", 0) / dt, 1)
            if dt > 0 else None,
            "sim_per_wall": round(
                (getattr(self.engine, "window", 0) * d_windows / SEC) / dt, 4)
            if dt > 0 else None,
            # Occupancy: how many handler rounds the busiest host forced per
            # window this chunk (the per-window fixed-cost multiplier).
            "rounds_per_window": round(delta.get("rounds", 0) / d_windows, 2)
            if d_windows else None,
            "delta": delta,
        }
        # Drop accounting: the nine ways an event/packet can be discarded,
        # grouped under one structured block (with chunk deltas) instead of
        # scattered through ``delta`` — the shape heartbeat_report's
        # drop-reason table and alerting consume. Always present: an
        # all-zero block is the explicit "nothing dropped" signal.
        drops = {f: delta.pop(f, 0) for f in DROP_FIELDS}
        rec["drops"] = {"total": sum(drops.values()), **drops}
        # The overflow-retry plane's host-side counters never appear in
        # engine deltas (normalize injects zeros, dropped here); once the
        # guard has retried, a ``retries`` block carries them.
        for f in HOST_FIELDS:
            delta.pop(f, None)
        if self.guard is not None and self.guard.chunk_retries:
            rec["retries"] = self.guard.report()
        # Fault plane: when churn/outage activity happened this chunk, a
        # ``faults`` block surfaces it directly (restart resets plus the
        # fault-induced rows of the drops table) — docs/OBSERVABILITY.md.
        restarts = delta.pop("host_restarts", 0)
        fault_drops = {k: drops[k] for k in
                       ("down_events", "down_pkts", "link_down_pkts")
                       if k in drops}
        if restarts or any(fault_drops.values()):
            rec["faults"] = {"host_restarts": restarts, **fault_drops}
        # Wasted-work accounting (performance attribution plane): the three
        # per-window boundary samples summed over this chunk, with the
        # denominators a consumer needs to turn them into utilization
        # fractions (n_hosts, the chunk's window count). Running sums, not
        # rates — they leave ``delta`` like the fill gauges and ride a
        # ``work`` block; tools/heartbeat_report.py's work-efficiency
        # section consumes it (and reads n_hosts from here for the
        # per-window ring fractions).
        work = {f: delta.pop(f, 0) for f in
                ("active_hosts", "elig_events", "outbox_hosts")}
        n_hosts = getattr(getattr(self.engine, "exp", None), "n_hosts", None)
        if any(work.values()):
            rec["work"] = dict(work)
            if n_hosts:
                rec["work"]["n_hosts"] = n_hosts
                if d_windows:
                    rec["work"]["active_frac"] = round(
                        work["active_hosts"] / (d_windows * n_hosts), 6)
        # Capacity occupancy: run-max fill gauges against their caps — the
        # data the cap controller and tools/captune.py size caps from.
        # High-water marks, not rates: they leave ``delta`` and ride a
        # ``fill`` block with the caps they are measured against.
        params = getattr(self.engine, "params", None)
        fill = {}
        for gauge, cap_field in (("ev_max_fill", "ev_cap"),
                                 ("ob_max_fill", "outbox_cap"),
                                 ("compact_max_fill", "compact_cap")):
            if delta.pop(gauge, 0) or m.get(gauge):
                fill[gauge] = m.get(gauge)
                if params is not None:
                    fill[cap_field] = getattr(params, cap_field)
        if fill:
            rec["fill"] = fill
        self.records.append(rec)
        if self.emit_heartbeat:
            self._emit(rec)
        for r in ring_recs:
            self.ring_records.append(r)
            if self.emit_ring:
                self._emit(r)
        for r in flow_recs:
            self.flow_records.append(r)
            if self.emit_ring:
                self._emit(r)
        for r in link_recs:
            self.link_records.append(r)
            if self.emit_ring:
                self._emit(r)
        self.t_last = now
        self.last = m

    def _drain_ring(self, st) -> list[dict]:
        """Per-window ring rows accumulated since the last chunk boundary."""
        if getattr(st, "telem", None) is None:
            return []
        from shadow1_tpu_torch.telemetry.ring import drain_ring

        recs = drain_ring(st, self.engine.window, start=self._ring_next)
        self._ring_next = int(st.metrics.windows)
        return recs

    def _drain_probes(self, st) -> list[dict]:
        """Per-window flow-probe rows since the last chunk boundary."""
        if getattr(st, "probes", None) is None:
            return []
        from shadow1_tpu_torch.telemetry.probes import drain_probes

        probes = getattr(getattr(self.engine, "params", None), "probes", ())
        recs = drain_probes(st, self.engine.window, probes,
                            start=self._probe_next)
        self._probe_next = int(st.metrics.windows)
        return recs

    def _drain_links(self, st) -> list[dict]:
        """Cumulative per-edge link snapshot at this chunk boundary."""
        if getattr(st, "links", None) is None:
            return []
        from shadow1_tpu_torch.telemetry.links import drain_links

        recs = drain_links(st, self.engine.window, start=self._link_next)
        self._link_next = int(st.metrics.windows)
        return recs


def build_kernels(device, profiler=None) -> None:
    """Build and load the CUDA kernels (``core/_build.py``) inside the
    compile span, before anything launches one: an ``Engine`` whose hosts
    can restart does at construction, ``init_state`` always (a model's
    init pushes its seed events). The port's counterpart of the
    reference's warm-up compile: one span per profiler, empty on the CPU
    and near zero once the process has loaded the library."""
    if profiler is not None and PH_COMPILE in profiler.span_names():
        return
    with maybe_span(profiler, PH_COMPILE):
        if device.type == "cuda":
            from shadow1_tpu_torch.core import _build

            _build.library()


def run_with_heartbeat(engine, st=None, n_windows=None, every_windows=None,
                       stream=None, ckpt_path=None, ckpt_every_s=120.0,
                       profiler=None, emit_heartbeat=True, emit_ring=True,
                       controller=None, guard=None, selfcheck=False,
                       ckpt_keep=3, drain=None):
    """Run the engine emitting a heartbeat every ``every_windows`` windows.

    With ``ckpt_path``, the state is snapshotted there at heartbeat
    boundaries (throttled to ~``ckpt_every_s`` of wall, and always at the
    end) through a ``ckpt_keep``-deep generation set
    (``lineage.Lineage``), and a ``.progress`` sidecar with the completed
    window count is refreshed at every chunk boundary — so a fault mid-run
    loses at most the windows since the last save, and the CLI's
    supervisor respawns a process that resumes from the snapshot.
    Determinism makes the resumed run bit-identical to an uninterrupted
    one. ``SHADOW1_OBS_CRASH_AT_NS`` kills the process (exit 41) right
    after a save at that sim time, once per respawn chain in practice: the
    resumed run starts past it.

    With ``profiler`` (telemetry.PhaseProfiler) the kernel build (the
    compile phase, ``build_kernels``: the port has no trace-and-compile),
    the init, every run-chunk, drain and checkpoint save is a Chrome-trace
    span. A caller that built an engine or a state before (the CLI) calls
    ``build_kernels`` with the same profiler first.

    The recovery planes ride the chunk runner (``ckpt.run_chunked``):
    ``controller`` (tune.CapController, ``--auto-caps``) may swap in an
    engine at other caps between chunks; ``guard`` (txn.OverflowGuard,
    ``--on-overflow retry|halt``) makes chunks transactional, and
    heartbeats then carry a ``retries`` block once a retry happened;
    ``selfcheck`` checks the drop-accounting identity at every committed
    boundary; ``drain`` (preempt.DrainHandler) forces the snapshot at the
    next boundary regardless of the wall throttle, then the runner raises
    preempt.PreemptedExit. Heartbeat fill blocks report the caps of the
    engine that ran the chunk.

    Returns (final_state, heartbeat): heartbeat.records holds the stream,
    heartbeat.ring_records / flow_records / link_records the drained plane
    records."""
    total = n_windows if n_windows is not None else engine.n_windows
    if every_windows is None:
        every_windows = max(total // 10, 1)
    # A sharded run (``shard/engine.py``): every rank runs the chunks and
    # takes the same snapshot decisions; rank 0 alone writes the records,
    # the snapshots (the gathered global state, through ``on_root``, which
    # the other ranks wait for) and the sidecar. The solo engines' API is
    # the same, as a world of one.
    root = engine.rank == 0
    if not root:
        stream = False
    build_kernels(engine.device, profiler)
    if st is None:
        with maybe_span(profiler, PH_INIT):
            st = engine.init_state()
    hb = Heartbeat(engine, stream=stream, initial_state=st, profiler=profiler,
                   emit_heartbeat=emit_heartbeat, emit_ring=emit_ring,
                   guard=guard)
    retune = None
    if controller is not None:
        def retune(eng_cur, s):
            eng_new, s = controller(eng_cur, s)
            hb.engine = eng_new  # heartbeat caps track the live engine
            return eng_new, s
    if guard is not None:
        guard.on_engine_swap = lambda eng_new: setattr(hb, "engine", eng_new)
    hooks = dict(profiler=profiler, retune=retune, guard=guard,
                 selfcheck=selfcheck, drain=drain)
    if ckpt_path is None:
        st = run_chunked(engine, st, n_windows=total, chunk=every_windows,
                         on_chunk=hb, **hooks)
        return st, hb

    from shadow1_tpu_torch.lineage import Lineage, write_json_atomic
    from shadow1_tpu_torch.preempt import run_injection_hooks

    lineage = Lineage(ckpt_path, keep=ckpt_keep)
    last_save = time.perf_counter()
    last_seq = [None]

    def on_chunk(s, done):
        nonlocal last_save
        hb(s, done)
        sim_ns = int(s.win_start)
        run_injection_hooks(sim_ns)
        now = time.perf_counter()
        draining = drain is not None and drain.requested
        saved = False
        due = done >= total or now - last_save > ckpt_every_s or draining
        due = engine.agree(due)
        if due:
            with maybe_span(profiler, PH_CHECKPOINT):
                snap = engine.gather_state(s)
                last_seq[0] = engine.on_root(lambda: lineage.save(
                    snap, {"win_start": sim_ns, "done_windows": done}))
                snap = None
            last_save = now
            saved = True
        # The progress sidecar ticks at every chunk boundary; win_start is
        # the absolute sim clock, monotonic across respawned processes.
        if root:
            write_json_atomic(ckpt_path + ".progress",
                              {"done_windows": done, "total": total,
                               "win_start": sim_ns, "seq": last_seq[0]})
        crash_at = os.environ.get("SHADOW1_OBS_CRASH_AT_NS")
        if saved and crash_at is not None and sim_ns == int(crash_at):
            os._exit(41)

    st = run_chunked(engine, st, n_windows=total, chunk=every_windows,
                     on_chunk=on_chunk, **hooks)
    return st, hb
