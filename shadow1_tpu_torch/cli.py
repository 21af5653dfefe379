"""Command line: run one YAML experiment on the port (port of ``cli.py``'s
run flags).

    python -m shadow1_tpu_torch CFG.yaml [--device cuda|cpu] [--windows N]
        [--engine tpu] [--summary] [--heartbeat W] [--save-state PATH]
        [--resume PATH] [--ckpt PATH [--ckpt-every-s S] [--ckpt-keep K]]
        [--tracker PATH] [--profile DIR] [--trace PATH]
        [--metrics-ring W] [--state-digest on|off] [--watch HOST[:SOCK]]...
        [--link-telem on|off] [--faults on|off] [--log-level LEVEL]

The run goes on CUDA unless ``--device cpu`` is given; with no card it
fails. Its record stream — heartbeats (``--heartbeat W``), the telemetry
ring's per-window rows, the ``flow`` rows of watched entities and the
cumulative per-edge ``link`` records, each in the reference's schema —
goes to stdout, one JSON object per line, and the result line comes last:
the reference's keys (``engine``, ``hosts``, ``window_ns``, ``windows``,
``sim_seconds``, ``wall_seconds``, ``sim_per_wall``, ``events_per_sec``,
``resumed``, ``caps``, ``metrics``, ``drops`` and, when they are nonzero,
``work`` and ``faults``) with the port's ``device`` and ``summary`` (the
model's scalar totals; always printed, so ``--summary`` changes nothing).
Logs and the supervisor's ``resume`` / ``lineage`` records go to stderr.

``--ckpt PATH`` runs the reference's supervisor: the parent never touches
the card; it runs the simulation in a child process that snapshots to a
rotated lineage at PATH, and when a child dies it respawns one that
resumes from the newest generation that passes its integrity check (a
corrupt head falls back one generation), after a backoff that doubles per
crash without progress (``SHADOW1_SUPERVISE_BACKOFF_S``, default 1 s),
and gives up after two crashes at the same sim time. ``--resume PATH``
takes a snapshot written by either package.

Flags of the recovery planes (``--auto-caps``, ``--on-overflow``,
``--on-oom``, ``--selfcheck``, ``--watchdog-s``) and of fleet, shard and
serve (``--fleet``, ``--on-lane-fail``, ``--lane-finalize``, ``--engine
cpu|sharded``) are parsed and refused, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

from shadow1_tpu_torch.consts import EXIT_OK

MAX_RESPAWNS = 8

_RECOVERY = "ROADMAP: Queue A item 5, recovery planes"
_FLEET = "ROADMAP: Queue A item 6, fleet, shard, serve and tools"


def _config_fingerprint(config_path: str) -> str:
    """Identity of the experiment a --ckpt snapshot belongs to: leaf
    shapes alone cannot tell two configs apart that differ only in
    scalars (seed, stop_time)."""
    import hashlib

    with open(config_path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _emit_resume_record(ckpt_path, resolved, win_start, lineage) -> None:
    """One ``resume`` record on stderr per lineage resume: the generation
    the run continued from, the corrupt newer ones skipped, and the
    lineage depth on disk."""
    rec = {"type": "resume", "ckpt": ckpt_path,
           "generation": resolved.seq, "win_start": int(win_start),
           "fallback_skipped": len(resolved.skipped)}
    if resolved.skipped:
        rec["discarded"] = [s["file"] for s in resolved.skipped]
    rec["generations_kept"] = len(lineage.generations())
    print(json.dumps(rec), file=sys.stderr, flush=True)


def _supervise(child_argv, ckpt_path, config_path) -> int:
    """Parent side of ``--ckpt``: run the CLI in a child process; when it
    dies after a snapshot showed forward progress, respawn a fresh child
    that resumes from the lineage (a fault never survives into the next
    attempt, which is a new process).

    * the lineage is resolved before every spawn: a corrupt head with a
      valid generation behind it is announced and left for the child to
      fall back on; when no generation verifies, the set is discarded and
      the run restarts from scratch;
    * a lineage left by a run of another config (its ``.meta``
      fingerprint differs) is discarded;
    * the respawn delay doubles per consecutive crash without progress
      (``SHADOW1_SUPERVISE_BACKOFF_S`` sets the base);
    * two consecutive crashes at the same ``win_start`` mean the fault is
      deterministic there: the supervisor gives up with the child's code.
    """
    import subprocess

    from shadow1_tpu_torch.lineage import Lineage, write_json_atomic

    sidecar = ckpt_path + ".progress"
    meta_path = ckpt_path + ".meta"
    lineage = Lineage(ckpt_path)

    def emit_lineage(event: str, **fields) -> None:
        print(json.dumps({"type": "lineage", "event": event, **fields}),
              file=sys.stderr, flush=True)

    fp = _config_fingerprint(config_path)
    stale = False
    if any(os.path.exists(p) for p in lineage.sidecar_paths()):
        try:
            with open(meta_path) as f:
                stale = json.load(f).get("config_sha256") != fp
        except (OSError, ValueError):
            stale = True
    if stale:
        print(f"[supervise] discarding stale checkpoint {ckpt_path} "
              f"(different or unknown config)", file=sys.stderr, flush=True)
        lineage.remove_all()
        for p in (sidecar, meta_path):
            if os.path.exists(p):
                os.remove(p)
    write_json_atomic(meta_path, {"config_sha256": fp})
    backoff_base = float(os.environ.get("SHADOW1_SUPERVISE_BACKOFF_S", "1.0"))
    last_progress = -1
    no_progress = 0
    rc = 1
    for attempt in range(MAX_RESPAWNS + 1):
        res = lineage.resolve()
        if res is not None and res.path is None:
            why = res.skipped[0]["reason"] if res.skipped else "?"
            print(f"[supervise] discarding corrupt checkpoint {ckpt_path} "
                  f"({why}; no valid generation of {len(res.skipped)}); "
                  f"restarting from scratch", file=sys.stderr, flush=True)
            emit_lineage("discard_all", reason=why,
                         generations=len(res.skipped))
            lineage.remove_all()
            if os.path.exists(sidecar):
                os.remove(sidecar)
            last_progress = -1
        elif res is not None and res.skipped:
            print(f"[supervise] checkpoint head {res.skipped[0]['file']} is "
                  f"corrupt ({res.skipped[0]['reason']}); resume will fall "
                  f"back to generation {res.seq}", file=sys.stderr,
                  flush=True)
            emit_lineage("corrupt_head", fallback_seq=res.seq,
                         skipped=len(res.skipped),
                         reason=res.skipped[0]["reason"])
        rc = subprocess.call([sys.executable, "-m", "shadow1_tpu_torch",
                              *child_argv, "--supervised-child"])
        if rc == EXIT_OK:
            # A finished run's snapshot must not resume a later invocation
            # of the same command into a no-op.
            lineage.remove_all()
            for p in (sidecar, meta_path):
                if os.path.exists(p):
                    os.remove(p)
            return EXIT_OK
        progress = -1
        try:
            with open(sidecar) as f:
                progress = json.load(f).get("win_start", -1)
        except (OSError, ValueError):
            pass
        if progress > last_progress:
            no_progress = 0
            last_progress = progress
        else:
            no_progress += 1
            if no_progress >= 2:
                print(f"[supervise] two consecutive crashes (rc={rc}) with no "
                      f"forward progress at sim_ns={max(progress, 0)} — the "
                      f"fault is deterministic at that point; further "
                      f"respawns would repeat it", file=sys.stderr,
                      flush=True)
                return rc
        if attempt == MAX_RESPAWNS:
            return rc
        delay = backoff_base * (2 ** no_progress)
        print(f"[supervise] child died rc={rc} at sim_ns={progress}; "
              f"respawning ({attempt + 1}/{MAX_RESPAWNS}) after "
              f"{delay:.1f}s backoff", file=sys.stderr, flush=True)
        if delay > 0:
            time.sleep(delay)
    return rc


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m shadow1_tpu_torch",
        description="Run a shadow1_tpu YAML experiment on the PyTorch port.")
    ap.add_argument("config", help="YAML experiment file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--engine", choices=["cpu", "tpu", "sharded"],
                    default=None,
                    help="'tpu' is the port's batched engine (the default); "
                         "'cpu' (the numpy oracle) and 'sharded' are not "
                         "ported")
    ap.add_argument("--windows", type=int, default=None,
                    help="windows to run (default: to the config's "
                         "stop_time; under --resume, the windows left)")
    ap.add_argument("--summary", action="store_true",
                    help="print the model summary totals (the port always "
                         "does)")
    ap.add_argument("--heartbeat", type=int, default=None, metavar="W",
                    help="print a heartbeat record every W windows")
    ap.add_argument("--save-state", default=None, metavar="PATH",
                    help="snapshot the final state to PATH (.npz, the "
                         "reference's format)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume from a snapshot written by either package")
    ap.add_argument("--ckpt", default=None, metavar="PATH",
                    help="supervised run: snapshot to a lineage at PATH at "
                         "heartbeat boundaries and respawn a crashed child "
                         "from it")
    ap.add_argument("--ckpt-every-s", type=float, default=120.0, metavar="S",
                    help="throttle --ckpt snapshots to ~S seconds of wall")
    ap.add_argument("--ckpt-keep", type=int, default=3, metavar="K",
                    help="lineage depth: keep the newest K generations "
                         "(PATH, PATH.gNNNNNN, manifest PATH.lineage)")
    ap.add_argument("--supervised-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tracker", default=None, metavar="PATH",
                    help="write final per-host tracker records (JSON lines)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler trace of the run (CPU ops, CUDA "
                         "kernels, the window phases as record_function "
                         "spans) as DIR/trace.json, and the phase spans as "
                         "DIR/phases.trace.json")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="Chrome trace-event JSON of the host-side phases "
                         "(compile/init/run-chunk/drain/checkpoint)")
    ap.add_argument("--metrics-ring", type=int, default=None, metavar="W",
                    help="keep a W-window on-device telemetry ring (overrides "
                         "engine.metrics_ring)")
    ap.add_argument("--watch", action="append", default=None,
                    metavar="HOST[:SOCK]",
                    help="watch a flow or host (repeatable; merges with the "
                         "config's probes: section): per-window 'flow' "
                         "records; a ring is set when there is none")
    ap.add_argument("--state-digest", choices=["on", "off"], default=None,
                    metavar="on|off",
                    help="per-window state-digest words as ring columns; a "
                         "ring is set when there is none")
    ap.add_argument("--link-telem", choices=["on", "off"], default=None,
                    metavar="on|off",
                    help="per-edge link accumulator, drained as cumulative "
                         "'link' records at chunk boundaries")
    ap.add_argument("--faults", choices=["on", "off"], default="on",
                    metavar="on|off",
                    help="off runs the experiment with its faults: section "
                         "stripped")
    ap.add_argument("--log-level", default="message",
                    choices=["error", "warning", "message", "info", "debug"],
                    help="stderr log verbosity")
    # Parsed so a script written for the reference fails loudly here.
    for flag, kw in (("--auto-caps", dict(action="store_true")),
                     ("--on-overflow", dict(default=None)),
                     ("--on-oom", dict(default=None)),
                     ("--selfcheck", dict(action="store_true")),
                     ("--watchdog-s", dict(default=None)),
                     ("--fleet", dict(action="store_true")),
                     ("--on-lane-fail", dict(default=None)),
                     ("--lane-finalize", dict(action="store_true"))):
        ap.add_argument(flag, help=argparse.SUPPRESS, **kw)
    return ap


def _refuse_unported(ap, args) -> None:
    for flag, item in (("auto_caps", _RECOVERY), ("on_overflow", _RECOVERY),
                       ("on_oom", _RECOVERY), ("selfcheck", _RECOVERY),
                       ("watchdog_s", _RECOVERY), ("fleet", _FLEET),
                       ("on_lane_fail", _FLEET), ("lane_finalize", _FLEET)):
        if getattr(args, flag) not in (None, False):
            ap.error(f"--{flag.replace('_', '-')} is not ported yet ({item})")
    if args.engine in ("cpu", "sharded"):
        ap.error(f"--engine {args.engine} is not ported yet ({_FLEET}); "
                 f"--engine tpu is the port's batched engine")


def _params(ap, args, exp, params):
    """The config's EngineParams with the flags applied, and the reference's
    auto-ring rule: the digest words and the probe rows ride a ring, so one
    is set (the heartbeat's depth, else 64) when neither config nor flag
    gave one."""
    from shadow1_tpu_torch.config.experiment import (
        WatchlistError,
        resolve_watchlist,
    )

    if args.watch:
        try:
            extra = resolve_watchlist(list(args.watch), exp.dns,
                                      params.sockets_per_host)
        except WatchlistError as e:
            ap.error(str(e))
        merged = list(params.probes)
        merged += [p for p in extra if p not in merged]
        params = dataclasses.replace(params, probes=tuple(merged))
    if args.metrics_ring is not None:
        params = dataclasses.replace(params, metrics_ring=args.metrics_ring)
    if args.state_digest is not None:
        params = dataclasses.replace(
            params, state_digest=int(args.state_digest == "on"))
    if args.link_telem is not None:
        params = dataclasses.replace(
            params, link_telem=int(args.link_telem == "on"))
    if ((params.state_digest or params.probes) and params.metrics_ring <= 0
            and args.metrics_ring is None):
        params = dataclasses.replace(params,
                                     metrics_ring=args.heartbeat or 64)
    return params


def _resolve_ckpt_lineage(args, log):
    """Child side of --ckpt: the newest valid lineage generation (corrupt
    newer ones deleted), else an explicit --resume. Returns (resolved,
    lineage, resume_path)."""
    if not args.ckpt:
        return None, None, args.resume
    from shadow1_tpu_torch.lineage import Lineage

    lineage = Lineage(args.ckpt, keep=args.ckpt_keep)
    r = lineage.resolve(discard_invalid=True)
    resolved = r if (r is not None and r.path is not None) else None
    if r is not None and resolved is None:
        log.warning("discarding corrupt checkpoint", path=args.ckpt,
                    reason=(r.skipped[0]["reason"] if r.skipped
                            else "no valid generation"))
    return resolved, lineage, (resolved.path if resolved else args.resume)


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)

    from shadow1_tpu_torch.config.experiment import (
        WatchlistError,
        load_experiment,
    )

    try:
        exp, params, scheduler = load_experiment(args.config)
    except WatchlistError as e:
        ap.error(str(e))
    engine_kind = args.engine or scheduler
    if engine_kind != "tpu":
        ap.error(f"engine.scheduler {engine_kind!r} is not ported yet "
                 f"({_FLEET})")
    if args.faults == "off":
        exp.faults = None
    params = _params(ap, args, exp, params)
    if args.ckpt and args.resume and args.windows is not None:
        # Under supervision --windows is the TOTAL for the whole run; under
        # --resume it means N more windows: ambiguous together.
        ap.error("--ckpt with both --resume and --windows is ambiguous "
                 "(total or N-more?); drop one of them")
    if args.ckpt_keep < 1:
        ap.error("--ckpt-keep must be >= 1")
    if args.ckpt and not args.supervised_child:
        return _supervise(argv, args.ckpt, args.config)

    import torch

    from shadow1_tpu_torch.core.engine import Engine, resolve_device
    from shadow1_tpu_torch.log import SimLogger
    from shadow1_tpu_torch.obs import build_kernels

    log = SimLogger(level=args.log_level)
    phases = None
    if args.trace or args.profile:
        from shadow1_tpu_torch.telemetry import PhaseProfiler

        phases = PhaseProfiler()
    device = resolve_device(args.device)
    # Before the engine: its construction may launch the kernels.
    build_kernels(device, phases)
    eng = Engine(exp, params, device=device)
    log.info("experiment loaded", hosts=exp.n_hosts, engine=engine_kind,
             window_ns=exp.window, device=str(eng.device))
    t0 = time.perf_counter()
    metrics0: dict[str, int] = {}
    st = None
    resolved, ckpt_lineage, resume_path = _resolve_ckpt_lineage(args, log)
    if resume_path:
        from shadow1_tpu_torch.ckpt import CorruptCheckpointError, load_state

        try:
            st = load_state(eng.init_state(), resume_path)
        except CorruptCheckpointError as e:
            # A supervised child falls back to a fresh start; an explicit
            # --resume fails loudly.
            if resolved is None:
                raise
            log.warning("discarding corrupt checkpoint", path=resume_path,
                        reason=str(e))
            st, resume_path, resolved = None, None, None
        else:
            metrics0 = Engine.metrics_dict(st)
            done = int(st.win_start) // exp.window
            if resolved is not None:
                _emit_resume_record(args.ckpt, resolved, int(st.win_start),
                                    ckpt_lineage)
            if args.windows is None:
                args.windows = max(eng.n_windows - done, 0)
            elif resolved is not None:
                # Supervised respawn: --windows is the whole run's total.
                args.windows = max(args.windows - done, 0)
    n_windows = args.windows if args.windows is not None else eng.n_windows
    if args.profile:
        from shadow1_tpu_torch.telemetry import device_trace

        prof = device_trace(args.profile, phases)
    else:
        prof = contextlib.nullcontext()
    ring_w = params.metrics_ring
    with prof:
        if (args.heartbeat or args.ckpt or ring_w or params.link_telem
                or phases is not None):
            from shadow1_tpu_torch.obs import run_with_heartbeat

            st, _hb = run_with_heartbeat(
                eng, st, n_windows=n_windows,
                # Ring-only runs chunk at the ring depth, so the drain keeps
                # up with the overwrites.
                every_windows=args.heartbeat or (ring_w or None),
                stream=sys.stdout, ckpt_path=args.ckpt,
                ckpt_every_s=args.ckpt_every_s, profiler=phases,
                emit_heartbeat=bool(args.heartbeat),
                emit_ring=bool(ring_w or params.link_telem),
                ckpt_keep=args.ckpt_keep)
        else:
            st = eng.run(st, n_windows=n_windows)
        eng.synchronize()
    if phases is not None:
        if args.trace:
            phases.write(args.trace)
        if args.profile:
            phases.write(os.path.join(args.profile, "phases.trace.json"))
    if args.save_state:
        from shadow1_tpu_torch.ckpt import save_state

        save_state(st, args.save_state)
    metrics = Engine.metrics_dict(st)
    summary = eng.model_summary(st)
    if args.tracker:
        from shadow1_tpu_torch.log import tracker_records

        with open(args.tracker, "w") as f:
            for rec in tracker_records(eng, st):
                f.write(json.dumps(rec) + "\n")
    wall = time.perf_counter() - t0
    print(json.dumps(result_record(
        exp, params, metrics, metrics0, summary, n_windows, wall,
        resumed=bool(resume_path),
        device=(torch.cuda.get_device_name(eng.device)
                if eng.device.type == "cuda" else "cpu"))))
    return EXIT_OK


def result_record(exp, params, metrics, metrics0, summary, n_windows, wall,
                  *, resumed: bool, device: str) -> dict:
    """The result line: the reference's keys with their meaning, and the
    port's ``device`` and ``summary``. Rates cover this invocation: under
    --resume the snapshot's metrics are taken out."""
    from shadow1_tpu_torch.telemetry.registry import DROP_FIELDS

    sim_s = n_windows * exp.window / 1e9
    ev_run = metrics["events"] - metrics0.get("events", 0)
    out = {
        "engine": "tpu",
        "device": device,
        "hosts": exp.n_hosts,
        "window_ns": exp.window,
        "windows": n_windows,
        "sim_seconds": round(sim_s, 6),
        "wall_seconds": round(wall, 3),
        "sim_per_wall": round(sim_s / wall, 3) if wall > 0 else None,
        "events_per_sec": round(ev_run / wall, 1) if wall > 0 else None,
        "resumed": resumed,
        "caps": {"ev_cap": params.ev_cap, "outbox_cap": params.outbox_cap,
                 "compact_cap": params.compact_cap},
        "metrics": {k: int(v) for k, v in metrics.items()},
    }
    drops = {f: int(metrics.get(f, 0)) for f in DROP_FIELDS}
    out["drops"] = {"total": sum(drops.values()), **drops}
    work = {f: int(metrics.get(f, 0))
            for f in ("active_hosts", "elig_events", "outbox_hosts")}
    n_win_total = int(metrics.get("windows", 0))
    if any(work.values()):
        out["work"] = {**work, "n_hosts": exp.n_hosts}
        if n_win_total:
            out["work"]["active_frac"] = round(
                work["active_hosts"] / (n_win_total * exp.n_hosts), 6)
    restarts = int(metrics.get("host_restarts", 0))
    fault_drops = {k: drops[k] for k in
                   ("down_events", "down_pkts", "link_down_pkts")}
    if restarts or any(fault_drops.values()):
        out["faults"] = {"host_restarts": restarts, **fault_drops}
    out["summary"] = {k: int(v) for k, v in summary.items()
                      if getattr(v, "ndim", 1) == 0}
    return out
