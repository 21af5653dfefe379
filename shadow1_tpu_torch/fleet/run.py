"""Chunked fleet runner — heartbeats, rings, checkpoints, recovery, records
(port of ``fleet/run.py``; its records are the reference's, field for
field).

The fleet twin of ``obs.run_with_heartbeat`` + the CLI's final-JSON
assembly, built per-experiment from the ground up:

* the telemetry ring drains PER EXPERIMENT (``type: "ring"`` records with
  an ``exp`` field — the per-window series and digest words of lane e are
  exactly a solo run's, docs/OBSERVABILITY.md §"Fleet records");
* heartbeats carry the fleet-aggregate deltas plus a compact per-
  experiment events vector (one record per chunk, not E);
* ``--on-overflow halt`` and ``--selfcheck`` run their boundary checks
  per experiment — a CapacityExceededError names the experiment (and its
  seed) whose cap overflowed;
* checkpoints snapshot the WHOLE fleet state (one .npz in the reference's
  layout, every leaf with its leading [E] axis: ``convert.fleet_to_saved``)
  at heartbeat boundaries, same atomic write + progress sidecar as the
  solo path — a resumed fleet continues bit-identically, in either
  package, and ``fleet.engine.slice_experiment`` extracts any one lane as
  a solo-resumable state.

**The fleet recovery plane** (docs/SEMANTICS.md §"Fleet recovery
contract") lives in this module's chunk loop — ``ckpt.run_chunked``
cannot express a mid-loop change of E, so the loop is owned here with the
same boundary semantics (commit before heartbeat/snapshot, drain latch
sampled before the save, a window never split):

* **transactional retry** (``--on-overflow retry``): the whole fleet state
  is the rollback point (a device copy: the CUDA kernels update planes in
  place); any lane's fresh overflow taints the chunk (txn.OverflowGuard
  sums the [E] counters), the fleet-uniform cap grows one ladder step via
  ``tune/resize.py`` (the slot axis, column by column: per lane the solo
  migration), and the SAME chunk replays bit-exactly, so every committed
  chunk is overflow-free in every lane and per-lane digest streams match
  the straight big-cap fleet run;
* **lane quarantine** (``--on-lane-fail quarantine``): a lane that fails
  DETERMINISTICALLY (capacity halt / retry-ladder exhaustion attributed
  to it, per-lane selfcheck violation) is sliced out of the chunk-START
  state into a solo-resumable checkpoint plus a structured
  ``fleet_quarantine`` record, the survivors repack into an E-1 fleet
  (survivor streams unchanged — a lane never reads another's columns)
  and the chunk replays — the sweep finishes at E-k/E.
  When every lane quarantines, the last failure re-raises so the exit
  taxonomy is preserved (capacity → EXIT_CAPACITY);
* **mid-sweep finalization** (``--lane-finalize``): lanes whose event
  buffer has fully drained are finalized at committed boundaries — their
  ``fleet_exp`` final record (``finished_early: true``) emits
  immediately and they are sliced out the quarantine way.

Every repacked-fleet snapshot carries the surviving global lane ids in
its lineage manifest entry (``lanes``), so a resume mid-quarantined-sweep
rebuilds exactly the surviving sub-fleet (cli._fleet_main).
"""

from __future__ import annotations

import json
import os
import sys
import time

from shadow1_tpu_torch.consts import SEC
from shadow1_tpu_torch.telemetry.registry import (
    DROP_FIELDS,
    HOST_FIELDS,
    normalize,
)


class FleetHeartbeat:
    """Per-chunk fleet heartbeat: aggregate deltas + per-experiment events.

    One record per chunk boundary (type ``heartbeat`` with a ``fleet``
    block), so existing consumers (tools/heartbeat_report.py) read the
    aggregate series unchanged while fleet-aware ones use the block.

    The runner mutates ``engine``/``labels`` live (cap-grow re-jits,
    quarantine/finalize repacks) and carries its recovery ledger on
    ``recovery`` — callers keep unpacking ``(st, hb)`` and read the final
    fleet shape off the heartbeat."""

    def __init__(self, engine, stream=None, initial_state=None,
                 emit_heartbeat=True, emit_ring=True, guard=None):
        self.engine = engine
        self.stream = stream if stream is not None else sys.stderr
        self.emit_heartbeat = emit_heartbeat
        self.emit_ring = emit_ring
        self.guard = guard  # txn.OverflowGuard — source of the retries block
        self.t_start = time.perf_counter()
        self.t_last = self.t_start
        self.last = (normalize(engine.metrics_dict(initial_state))
                     if initial_state is not None else {})
        self.last_per_exp = (engine.metrics_per_exp(initial_state)
                             if initial_state is not None else None)
        self._ring_next = self.last.get("windows", 0)
        self.records: list[dict] = []
        self.ring_records: list[dict] = []
        self.labels: list[dict] = []        # live per-lane identity
        self.recovery: dict = {"quarantined": [], "finished": [],
                               "retry_records": []}

    def rebase(self, engine, st) -> None:
        """Re-baseline after the runner swapped the engine AND the state no
        longer continues the last-seen one (a rollback replay or a lane
        repack): the next delta must cover exactly the committed chunk."""
        self.engine = engine
        self.last = normalize(engine.metrics_dict(st))
        self.last_per_exp = engine.metrics_per_exp(st)
        self._ring_next = self.last.get("windows", 0)

    def _emit(self, rec: dict) -> None:
        if self.stream:
            print(json.dumps(rec), file=self.stream, flush=True)

    def __call__(self, st, done_windows: int, per_exp=None) -> None:
        now = time.perf_counter()
        m = normalize(self.engine.metrics_dict(st))
        # The chunk runner already fetched the per-experiment dicts for its
        # halt/selfcheck boundary checks — reuse them, don't re-sync.
        if per_exp is None:
            per_exp = self.engine.metrics_per_exp(st)
        ring_recs = self.engine.drain_rings(st, start=self._ring_next)
        self._ring_next = m.get("windows", 0)
        delta = {k: v - self.last.get(k, 0) for k, v in m.items()
                 if isinstance(v, int)}
        dt = now - self.t_last
        d_windows = delta.get("windows", 0)
        ev_per_exp = [int(d["events"]) for d in per_exp]
        if (self.last_per_exp is not None
                and len(self.last_per_exp) == len(per_exp)):
            ev_per_exp = [e - int(l["events"]) for e, l in
                          zip(ev_per_exp, self.last_per_exp)]
        rec = {
            "type": "heartbeat",
            "sim_time_s": round(int(st.win_start.max()) / SEC, 6),
            "wall_s": round(now - self.t_start, 3),
            "windows": done_windows,
            "events_per_sec": round(delta.get("events", 0) / dt, 1)
            if dt > 0 else None,
            "rounds_per_window": round(delta.get("rounds", 0) / d_windows, 2)
            if d_windows else None,
            "delta": delta,
            "fleet": {
                "experiments": self.engine.n_exp,
                # Global ids beside the vector: after a quarantine/finalize
                # the surviving positions are non-contiguous.
                "exps": [l.get("exp") for l in self.labels]
                if self.labels else list(range(self.engine.n_exp)),
                "events_per_exp": ev_per_exp,
            },
        }
        drops = {f: delta.pop(f, 0) for f in DROP_FIELDS}
        rec["drops"] = {"total": sum(drops.values()), **drops}
        # Host-side retry counters never ride engine deltas (registry
        # HOST_FIELDS); the retries block carries them cumulatively.
        for f in HOST_FIELDS:
            delta.pop(f, None)
        if self.guard is not None and self.guard.chunk_retries:
            rec["retries"] = self.guard.report()
        self.records.append(rec)
        if self.emit_heartbeat:
            self._emit(rec)
        for r in ring_recs:
            self.ring_records.append(r)
            if self.emit_ring:
                self._emit(r)
        self.t_last = now
        self.last = m
        self.last_per_exp = per_exp


def _check_halt(engine, plan_labels, per_exp, prev_per_exp, done, step):
    """Per-experiment overflow halt: the first lane with fresh overflow
    raises a CapacityExceededError that names it (``lanes`` carries the
    local index for the quarantine policy)."""
    from shadow1_tpu_torch.txn import CapacityExceededError
    from shadow1_tpu_torch.tune.ladder import recommend_cap

    checks = (("ev_overflow", "ev_cap", "ev_max_fill"),
              ("ob_overflow", "outbox_cap", "ob_max_fill"))
    for e, m in enumerate(per_exp):
        prev = prev_per_exp[e] if prev_per_exp else {}
        for counter, knob, gauge in checks:
            fresh = int(m.get(counter, 0)) - int(prev.get(counter, 0))
            if fresh > 0:
                label = plan_labels[e] if plan_labels else {"exp": e}
                gv = int(m.get(gauge, 0))
                raise CapacityExceededError(
                    knob=knob, counter=counter,
                    cap=getattr(engine.params, knob), overflow=fresh,
                    window_range=(done, done + step),
                    recommended=recommend_cap(gv) if gv else None,
                    detail=(f" (fleet experiment {label.get('exp', e)}, "
                            f"seed {label.get('seed', '?')})"),
                    lanes=[e],
                )


def lane_record(engine, st, i: int, label: dict, windows: int,
                m: dict | None = None) -> dict:
    """One ``fleet_exp`` final record for lane ``i`` of a fleet state —
    the unit final_records() assembles and the early-finalize path emits
    immediately (docs/OBSERVABILITY.md §"Fleet records"). ``m`` reuses an
    already-fetched per-experiment metrics dict."""
    if m is None:
        m = engine.metrics_per_exp(st)[i]
    params = engine.params
    drops = {f: int(m.get(f, 0)) for f in DROP_FIELDS}
    rec = {
        "type": "fleet_exp",
        **label,
        "engine": "fleet",
        "hosts": engine.exp.n_hosts,
        "window_ns": engine.window,
        "windows": windows,
        "caps": {"ev_cap": params.ev_cap, "outbox_cap": params.outbox_cap,
                 "compact_cap": params.compact_cap},
        "metrics": m,
        "drops": {"total": sum(drops.values()), **drops},
    }
    restarts = int(m.get("host_restarts", 0))
    fault_drops = {k: drops[k] for k in
                   ("down_events", "down_pkts", "link_down_pkts")}
    if restarts or any(fault_drops.values()):
        rec["faults"] = {"host_restarts": restarts, **fault_drops}
    return rec


def run_fleet(engine, st=None, n_windows=None, every_windows=None,
              stream=None, ckpt_path=None, ckpt_every_s=120.0,
              emit_heartbeat=True, emit_ring=True, selfcheck=False,
              labels=None, ckpt_keep=3, drain=None, auto_caps=False,
              quarantine_base=None, emit_record=None, resume_meta=None,
              recovery_seed=None, final_snapshot=True):
    """Run the fleet in chunks. Returns (final_state, FleetHeartbeat).

    Mirrors ``obs.run_with_heartbeat`` (compile excluded from the first
    chunk's rate, checkpoints rotated through a ``ckpt_keep``-deep
    lineage.Lineage generation set throttled to ``ckpt_every_s``, the
    ``.progress`` sidecar refreshed atomically at EVERY chunk boundary,
    a pending ``drain`` request forcing the snapshot then raising
    preempt.PreemptedExit) — plus the fleet recovery plane described in
    the module docstring, driven by ``engine.params``:

    * ``on_overflow == "retry"`` → a txn.OverflowGuard makes chunks
      transactional over the whole [E, ...] pytree;
    * ``on_overflow == "halt"`` → the per-lane boundary check raises a
      CapacityExceededError naming the experiment;
    * ``on_lane_fail == "quarantine"`` → deterministic per-lane failures
      slice the lane out (checkpoint at ``quarantine_base``.q<exp>.npz,
      default the --ckpt path or "fleet_lane") and the sweep continues;
    * ``lane_finalize`` → drained lanes emit their final record and leave
      the fleet at committed boundaries;
    * ``auto_caps`` → a tune.CapController retunes caps between chunks
      from the fleet-global fill gauges.

    ``emit_record`` (callable) receives each immediately-final stdout
    record (``fleet_quarantine``, early ``fleet_exp``) so the CLI can
    print them as they happen; ``resume_meta`` keys ride every lineage
    manifest entry (the sub-batch cursor); ``recovery_seed``
    ({"quarantined": [gids], "finished": [gids]} from a resumed
    generation's meta) pre-populates the ledger so a respawned process's
    final summary still reports lanes that left the fleet before the
    crash. ``final_snapshot=False`` skips the snapshot of the last
    boundary (the serve daemon deletes a finished batch's lineage at
    once). The heartbeat's ``engine`` /
    ``labels`` / ``recovery`` attributes expose the live fleet shape."""
    from shadow1_tpu_torch import ckpt as _ckpt
    from shadow1_tpu_torch.convert import clone_state, fleet_to_saved
    from shadow1_tpu_torch.fleet.engine import FleetEngine
    from shadow1_tpu_torch.lineage import Lineage, write_json_atomic
    from shadow1_tpu_torch.preempt import PreemptedExit, run_injection_hooks
    from shadow1_tpu_torch.txn import (
        CapacityExceededError,
        OverflowGuard,
        SelfCheckError,
        check_boundary_identity,
    )

    params = engine.params
    total = n_windows if n_windows is not None else engine.n_windows
    if every_windows is None:
        every_windows = max(total // 10, 1)
    if st is None:
        st = engine.init_state()
    labels = ([dict(l) for l in labels] if labels else
              [{"exp": i + engine.exp_base, "seed": int(e.seed)}
               for i, e in enumerate(engine.exps)])
    engine.exp_ids = [l.get("exp", i) for i, l in enumerate(labels)]

    halt = params.on_overflow == "halt"
    retry = params.on_overflow == "retry"
    quarantine = params.on_lane_fail == "quarantine"
    finalize = bool(params.lane_finalize)
    qbase = quarantine_base or ckpt_path or "fleet_lane"

    # Engine factories close over the LIVE lane set; a quarantine/finalize
    # repack replaces the policies wholesale (their engine caches hold
    # stale-E programs), carrying the counters/floors over.
    def _make_factory():
        exps = list(engine.exps)
        mr = list(engine.max_rounds)
        ids = list(engine.exp_ids or range(len(exps)))
        base = engine.exp_base

        dev = engine.device

        def make(p):
            eng = FleetEngine(exps, p, mr, device=dev)
            eng.exp_base = base
            eng.exp_ids = ids
            return eng

        return make

    controller = None
    if auto_caps:
        from shadow1_tpu_torch.tune import CapController

        controller = CapController(engine, _make_factory(),
                                   initial_state=st)
    guard = (OverflowGuard(engine, make_engine=_make_factory(),
                           mode="retry", controller=controller)
             if retry else None)
    hb = FleetHeartbeat(engine, stream=stream, initial_state=st,
                        emit_heartbeat=emit_heartbeat, emit_ring=emit_ring,
                        guard=guard)
    hb.labels = labels
    recovery = hb.recovery
    if recovery_seed:
        # Lanes that left the fleet before the snapshot this run resumed
        # from: their full records were emitted by the earlier process;
        # the bare gids keep the final summary truthful across respawns.
        recovery["quarantined"] = [{"exp": int(g), "resumed": True}
                                   for g in
                                   recovery_seed.get("quarantined", [])]
        recovery["finished"] = [{"exp": int(g), "resumed": True}
                                for g in recovery_seed.get("finished", [])]
    if guard is not None:
        guard.bind(engine, st)
        guard.on_engine_swap = lambda eng_new: setattr(hb, "engine", eng_new)
    prev_per_exp = engine.metrics_per_exp(st)
    lineage = Lineage(ckpt_path, keep=ckpt_keep) if ckpt_path else None
    last_save = time.perf_counter()
    last_seq = [None]
    retry_seen = 0

    def _record(rec: dict) -> None:
        """An immediately-final record: a stderr log line plus the
        caller's stdout hook (the port's record stream, ``stream``, may
        itself be stdout)."""
        if stream is not False:
            print(json.dumps(rec), file=sys.stderr, flush=True)
        if emit_record is not None:
            emit_record(rec)

    def _drain_retry_records(discarded: bool = False) -> None:
        """Emit one fleet_retry log record per new guard grow, with lane
        attribution mapped to sweep-global ids through the CURRENT labels.
        Must run BEFORE any repack shrinks ``labels`` — stale local
        indices would remap onto the wrong experiment. ``discarded`` marks
        grows whose attempt ended in a quarantine: the caps (and the
        chunk) were rolled back, so the record is audit-only."""
        nonlocal retry_seen
        if guard is None or len(guard.resizes) <= retry_seen:
            return
        for rz in guard.resizes[retry_seen:]:
            rrec = {"type": "fleet_retry", **rz}
            if "lanes" in rrec:
                rrec["lanes"] = {
                    c: [labels[i].get("exp", i) for i in idxs
                        if i < len(labels)]
                    for c, idxs in rrec["lanes"].items()}
            if discarded:
                rrec["discarded"] = True
            recovery["retry_records"].append(rrec)
            # Log-stream only (unlike quarantine/early-final records): a
            # retry is an audit event, not a per-lane result — the stdout
            # contract stays fleet_exp/.../fleet_summary.
            if stream is not False:
                print(json.dumps(rrec), file=sys.stderr, flush=True)
        retry_seen = len(guard.resizes)

    def _repack(keep: list[int], st_from):
        """Survivors of ``st_from`` as a fresh E'=len(keep) fleet: rebuild
        the engine at the CURRENT committed params, refresh the policies
        (stale-E caches dropped, counters/floors carried), re-baseline the
        heartbeat. Returns the repacked state."""
        nonlocal engine, guard, controller, prev_per_exp
        st_new = engine.select_lanes(st_from, keep)
        labels[:] = [labels[i] for i in keep]
        new_eng = FleetEngine([engine.exps[i] for i in keep], params_live(),
                              [engine.max_rounds[i] for i in keep],
                              device=engine.device)
        new_eng.exp_base = engine.exp_base
        new_eng.exp_ids = [l.get("exp") for l in labels]
        engine = new_eng
        if controller is not None:
            old = controller
            controller = type(old)(engine, _make_factory(),
                                   policy=old.policy, initial_state=st_new)
            controller._floor = dict(old._floor)
            controller.resizes = old.resizes
        if guard is not None:
            old = guard
            guard = OverflowGuard(engine, make_engine=_make_factory(),
                                  mode="retry", controller=controller)
            guard.chunk_retries = old.chunk_retries
            guard.retry_windows_rerun = old.retry_windows_rerun
            guard.resizes = old.resizes
            guard.bind(engine, st_new)
            guard.on_engine_swap = \
                lambda eng_new: setattr(hb, "engine", eng_new)
            hb.guard = guard
        hb.rebase(engine, st_new)
        prev_per_exp = hb.last_per_exp  # rebase just fetched it
        return st_new

    def params_live():
        # The last COMMITTED params: grows from failed (quarantined)
        # attempts are discarded with the tainted chunk.
        return engine.params

    def _quarantine(fail_lanes: list[int], reason: str, err, st_roll,
                    w0: int, retries_discarded: bool):
        """Slice deterministic failures out of the chunk-start state; the
        quarantined lane checkpoint is written FIRST, then the survivors
        repack (the survivors' own snapshot — with the shrunken ``lanes``
        manifest — follows at this boundary's save). Raises ``err`` when
        no lane survives, preserving the exit taxonomy.

        ``retries_discarded``: grows from a guard.commit attempt that
        RAISED were rolled back with the tainted chunk (the outer engine
        never swapped) — audit-only records. Grows COMMITTED earlier in
        the same boundary (a halt/selfcheck quarantine after a successful
        retry) persist: the repack migrates ``st_roll`` onto the live
        caps below, so their records stay real."""
        fail_lanes = sorted(set(fail_lanes))
        # Flush grow audit records against the CURRENT labels before the
        # repack shrinks them — stale local indices would remap onto the
        # wrong experiment.
        _drain_retry_records(discarded=retries_discarded)
        survivors = engine.n_exp - len(fail_lanes)
        for i in fail_lanes:
            label = labels[i]
            gid = label.get("exp", i)
            qpath = f"{qbase}.q{gid}.npz"
            _ckpt.save_state(engine.slice_experiment(st_roll, i), qpath)
            rec = {
                "type": "fleet_quarantine",
                "exp": gid,
                "seed": label.get("seed"),
                "reason": reason,
                "window": w0,
                "ckpt": qpath,
                "survivors": survivors,
                "error": str(err)[:400],
            }
            for f in ("knob", "counter"):
                if getattr(err, f, None):
                    rec[f] = getattr(err, f)
            recovery["quarantined"].append(rec)
            _record(rec)
        if survivors == 0:
            raise err
        keep = [i for i in range(engine.n_exp) if i not in fail_lanes]
        # A grow COMMITTED at this same boundary (before a halt/selfcheck
        # quarantine) leaves the live params at bigger caps than the
        # chunk-start state's planes — migrate before the repack (grow is
        # bit-exact, tune/resize.py), so state shapes and engine caps
        # never diverge. The quarantined-lane checkpoints above stay at
        # the ORIGINAL caps: load_state cap-migrates on the solo side.
        p = params_live()
        if (st_roll.evbuf.kind.shape[-2] != p.ev_cap
                or st_roll.outbox.dst.shape[-2] != p.outbox_cap):
            from shadow1_tpu_torch.tune.resize import resize_state

            st_roll = resize_state(st_roll, ev_cap=p.ev_cap,
                                   outbox_cap=p.outbox_cap)
        return _repack(keep, st_roll)

    done = 0
    while done < total and engine.n_exp > 0:
        step = min(every_windows, total - done)
        # Rollback point: a device copy (the CUDA kernels update the
        # planes of the state they are given in place). The state is then
        # handed over, as ``ckpt.run_chunked`` does: no frame holds the
        # chunk-start state while the chunk runs (``mem.py`` prices one
        # window's input and output, and the rollback copy).
        st0 = clone_state(st) if (guard is not None or quarantine) else None
        w0 = int(st.win_start) // engine.window
        held = [st]
        st = None
        st_new = engine.run(held.pop(), n_windows=step)
        if guard is not None:
            try:
                engine, st_new = guard.commit(engine, st0, st_new, done,
                                              step)
            except CapacityExceededError as err:
                if not (quarantine and err.lanes):
                    raise
                # Ladder-top / repeated-overflow exhaustion attributed to
                # specific lanes: quarantine them from the chunk-start
                # state and replay the chunk with the survivors (the
                # raised commit rolled its grows back with the chunk).
                st = _quarantine(err.lanes, "capacity", err, st0, w0,
                                 retries_discarded=True)
                continue
            hb.engine = engine
        per_exp = engine.metrics_per_exp(st_new)
        if halt:
            try:
                _check_halt(engine, labels, per_exp, prev_per_exp, done,
                            step)
            except CapacityExceededError as err:
                if not (quarantine and err.lanes):
                    raise
                st = _quarantine(err.lanes, "capacity", err, st0, w0,
                                 retries_discarded=False)
                continue
        if selfcheck:
            violations: list[tuple[int, SelfCheckError]] = []
            for e, m in enumerate(per_exp):
                try:
                    check_boundary_identity(
                        m, where=(f"fleet experiment "
                                  f"{labels[e].get('exp', e)}, chunk "
                                  f"boundary, window "
                                  f"{m.get('windows', 0)}"))
                except SelfCheckError as err:
                    if not quarantine:
                        raise
                    violations.append((e, err))
            if violations:
                st = _quarantine([e for e, _ in violations], "selfcheck",
                                 violations[0][1], st0, w0,
                                 retries_discarded=False)
                continue
        # ---- chunk COMMITTED -------------------------------------------
        st = st_new
        done += step
        # One parseable fleet_retry record per committed grow+replay
        # (schema in docs/OBSERVABILITY.md) — heartbeat_report's recovery
        # section and the per-lane retry table read these.
        _drain_retry_records()
        prev_per_exp = per_exp
        hb(st, done, per_exp=per_exp)
        sim_ns = int(st.win_start)
        # Fault/preemption/hang injection (preempt.run_injection_hooks) —
        # the same chunk-boundary contract as obs.run_with_heartbeat, so
        # the supervisor, drain and watchdog paths are all testable
        # fleet-shaped too. Inert without the env vars.
        run_injection_hooks(sim_ns)
        # ---- mid-sweep lane lifecycle ----------------------------------
        if finalize and done < total and engine.n_exp > 1:
            flags = engine.lane_done(st)
            done_lanes = [i for i in range(engine.n_exp) if flags[i]]
            # All-drained fleets just run out their remaining (no-op)
            # windows like a solo run would — finalize only a strict
            # subset, so the normal end-of-run path stays intact.
            if done_lanes and len(done_lanes) < engine.n_exp:
                for i in done_lanes:
                    m = per_exp[i]
                    rec = lane_record(engine, st, i, labels[i],
                                      int(m.get("windows", done)), m=m)
                    rec["finished_early"] = True
                    rec["windows_configured"] = total
                    recovery["finished"].append(rec)
                    _record(rec)
                keep = [i for i in range(engine.n_exp)
                        if i not in done_lanes]
                st = _repack(keep, st)
        # ---- between-chunk retune (fleet --auto-caps) ------------------
        if controller is not None and done < total and engine.n_exp > 0:
            new_engine, st = controller(engine, st)
            if new_engine is not engine:
                engine = new_engine
                hb.engine = engine
                if guard is not None:
                    guard.engine = engine
        # ---- snapshot / progress / drain -------------------------------
        now = time.perf_counter()
        draining = drain is not None and drain.requested
        saved = False
        if lineage is not None and engine.n_exp > 0 and (
                final_snapshot if done >= total
                else draining or now - last_save > ckpt_every_s):
            meta = {"win_start": sim_ns, "done_windows": done,
                    "lanes": [l.get("exp") for l in labels]}
            if recovery["quarantined"]:
                meta["quarantined"] = [r["exp"] for r in
                                       recovery["quarantined"]]
            if recovery["finished"]:
                meta["finished"] = [r["exp"] for r in recovery["finished"]]
            if resume_meta:
                meta.update(resume_meta)
            last_seq[0] = lineage.save(fleet_to_saved(st, engine.n_exp), meta)
            last_save = now
            saved = True
        if ckpt_path:
            write_json_atomic(ckpt_path + ".progress",
                              {"done_windows": done, "total": total,
                               "win_start": sim_ns, "seq": last_seq[0]})
        crash_at = os.environ.get("SHADOW1_OBS_CRASH_AT_NS")
        if saved and crash_at is not None and sim_ns == int(crash_at):
            os._exit(41)
        if draining and done < total:
            raise PreemptedExit(st=st, signame=drain.signame,
                                done_windows=done, win_start=sim_ns)
    return st, hb


def final_records(engine, st, labels, n_windows, wall, resumed=False,
                  metrics0=None, recovery=None):
    """The CLI's end-of-run output: one ``fleet_exp`` record per STILL-
    RUNNING experiment plus one ``fleet_summary`` — schemas in
    docs/OBSERVABILITY.md §"Fleet records". ``metrics0`` (per-exp dicts
    from a resumed snapshot) baselines rates to THIS invocation like the
    solo CLI; ``recovery`` (FleetHeartbeat.recovery) folds quarantined /
    early-finished lanes into the summary — their own records were
    emitted when they left the fleet."""
    per_exp = engine.metrics_per_exp(st) if engine.n_exp else []
    sim_s = n_windows * engine.window / 1e9
    recs = []
    ev_run_total = 0
    for e, m in enumerate(per_exp):
        label = labels[e] if labels else {"exp": e}
        ev0 = metrics0[e].get("events", 0) if metrics0 else 0
        ev_run_total += m["events"] - ev0
        recs.append(lane_record(engine, st, e, label, n_windows, m=m))
    agg = engine.metrics_dict(st) if engine.n_exp else {}
    params = engine.params
    summary = {
        "type": "fleet_summary",
        "engine": "fleet",
        "experiments": engine.n_exp,
        "hosts": engine.exp.n_hosts,
        "window_ns": engine.window,
        "windows": n_windows,
        "sim_seconds": round(sim_s, 6),
        "wall_seconds": round(wall, 3),
        "sim_per_wall": round(sim_s / wall, 3) if wall > 0 else None,
        # Aggregate sweep throughput — the fleet-mode headline: events
        # executed across ALL experiments per wall second.
        "events_per_sec": round(ev_run_total / wall, 1) if wall > 0 else None,
        "events_per_exp": [int(m["events"]) for m in per_exp],
        "resumed": bool(resumed),
        "caps": {"ev_cap": params.ev_cap, "outbox_cap": params.outbox_cap,
                 "compact_cap": params.compact_cap},
        "metrics": agg,
    }
    if recovery:
        if recovery.get("quarantined"):
            summary["quarantined"] = [r["exp"] for r in
                                      recovery["quarantined"]]
        if recovery.get("finished"):
            summary["finished_early"] = [r["exp"] for r in
                                         recovery["finished"]]
        if recovery.get("quarantined") or recovery.get("finished"):
            summary["experiments_initial"] = (
                engine.n_exp + len(recovery.get("quarantined", []))
                + len(recovery.get("finished", [])))
    return recs, summary
