"""Command line: run one YAML experiment on the port (port of ``cli.py``'s
run flags).

    python -m shadow1_tpu_torch CFG.yaml [--device cuda|cpu] [--windows N]
        [--engine tpu] [--summary] [--heartbeat W] [--save-state PATH]
        [--resume PATH] [--ckpt PATH [--ckpt-every-s S] [--ckpt-keep K]]
        [--tracker PATH] [--profile DIR] [--trace PATH]
        [--metrics-ring W] [--state-digest on|off] [--watch HOST[:SOCK]]...
        [--link-telem on|off] [--faults on|off] [--log-level LEVEL]
        [--on-overflow drop|retry|halt] [--auto-caps] [--selfcheck]
        [--on-oom halt|downshift] [--watchdog-s S]

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

The recovery planes: ``--on-overflow retry|halt`` (transactional chunks:
a tainted chunk is replayed at grown caps, or the run halts with
``EXIT_CAPACITY`` and a ``capacity_exceeded`` record), ``--auto-caps``
(caps follow the fill gauges between chunks), ``--selfcheck`` (the
drop-accounting identity at every chunk boundary), the pre-flight memory
budget (one ``mem`` record on stderr; over budget ``EXIT_MEMORY`` with a
``memory_budget`` record, or with ``--on-oom downshift`` the rollback copy
and then the ring give way), a runtime CUDA out-of-memory error
(``EXIT_MEMORY``, a ``memory_exhausted`` record), the SIGTERM/SIGINT
drain (the in-flight chunk commits, the snapshot is written,
``EXIT_PREEMPTED`` with a ``preempted`` record) and, under ``--ckpt``, the
supervisor's watchdog (``--watchdog-s S`` or ``SHADOW1_WATCHDOG_S``: a
child whose progress sidecar goes stale is killed and respawned; two
hangs without progress give ``EXIT_HUNG``).

``--fleet`` runs the config's ``sweep:`` as one ``FleetEngine``
(``_fleet_main``, ``fleet/run.py``), with ``--on-lane-fail`` and
``--lane-finalize``: one ``fleet_exp`` record per experiment and a
``fleet_summary`` on stdout, ``exp``-tagged ring records and heartbeats on
the record stream, and a rejected sweep as one ``fleet_config`` record
(``EXIT_CONFIG``).

``--engine cpu`` (or ``engine.scheduler: cpu``) runs the numpy oracle
(``cpu_engine/``) on the host: the result line on stdout, its digest,
work, flow and link rows on stderr. It is an explicit host engine, so
``--device`` other than ``cpu`` is refused beside it, as are the batched
engine's chunked-run flags; nothing falls back to it.

``--engine sharded`` (or ``engine.scheduler: sharded``) runs the sharded
engine (``shard/engine.py``) over the ranks of a ``torch.distributed``
world: the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), or, launched alone, a world of one rank. The backend is
NCCL on the card (one card per rank) and gloo under ``--device cpu``;
``--dist-backend gloo`` puts several ranks on one card. Rank 0 alone
writes the records, the snapshots (the gathered global state, which
either package and either engine resumes) and the result line. Under
``--ckpt`` each rank runs as the supervised child does (``torchrun
--max-restarts`` is the supervisor): a rerun resumes from the lineage.

The serve plane (``serve/``) runs through two subcommands, dispatched
before this parser as the reference does::

    python -m shadow1_tpu_torch serve --spool DIR [--device cuda|cpu] ...
    python -m shadow1_tpu_torch submit CFG --spool DIR [--priority P] ...

``serve`` starts the multi-tenant daemon (``serve/daemon.py``) and
``submit`` is its client (``serve/client.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

from shadow1_tpu_torch.consts import (
    EXIT_CAPACITY,
    EXIT_CODES,
    EXIT_HUNG,
    EXIT_MEMORY,
    EXIT_OK,
    EXIT_PREEMPTED,
)

MAX_RESPAWNS = 8


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


def _supervise(child_argv, ckpt_path, config_path,
               watchdog_s: float = 0.0) -> int:
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
    * **preemption** (rc == EXIT_PREEMPTED): a drain is a clean-resume
      exit — no backoff, no crash accounting, checkpoint kept; the
      supervisor exits EXIT_PREEMPTED itself. It forwards its own
      SIGTERM/SIGINT to the child, so signaling either process drains the
      run;
    * **watchdog** (``watchdog_s`` > 0): a child whose ``.progress``
      sidecar goes stale past the deadline (3× before the attempt's first
      beat: the child is importing and building) is killed and classified
      hung, with its own backoff lane; two consecutive hangs without
      forward progress give EXIT_HUNG;
    * **memory and capacity** (rc == EXIT_MEMORY, or a child that died
      with a CUDA out-of-memory error in the last lines of its stderr,
      which is teed through a scanning thread; rc == EXIT_CAPACITY): a
      deterministic config-vs-device condition, never respawned;
    * the respawn delay doubles per consecutive failure without progress,
      per lane (``SHADOW1_SUPERVISE_BACKOFF_S`` sets the base);
    * two consecutive crashes at the same ``win_start`` mean the fault is
      deterministic there: the supervisor gives up with the child's code.
    """
    import signal
    import subprocess
    import threading

    from shadow1_tpu_torch.lineage import Lineage, write_json_atomic
    from shadow1_tpu_torch.mem import is_oom_text
    from shadow1_tpu_torch.preempt import FORCE_GRACE_S

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
    no_progress = 0       # consecutive crashes without forward progress
    no_progress_hung = 0  # consecutive watchdog kills without progress
    rc = 1

    # Forward the first SIGTERM/SIGINT to the child (it debounces a
    # duplicate group delivery); a second one past the grace kills it.
    proc_box: list = [None]
    sig_seen: list = []

    def forward(signum, frame):
        now = time.monotonic()
        child = proc_box[0]
        if sig_seen and now - sig_seen[0] >= FORCE_GRACE_S:
            if child is not None and child.poll() is None:
                child.kill()
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        if not sig_seen:
            sig_seen.append(now)
            print(f"[supervise] {signal.Signals(signum).name} received — "
                  f"forwarding drain request to the child",
                  file=sys.stderr, flush=True)
            if child is not None and child.poll() is None:
                child.send_signal(signal.SIGTERM)

    prev_handlers = {s: signal.signal(s, forward)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for attempt in range(MAX_RESPAWNS + 1):
            if sig_seen:
                # The drain request landed while no child was alive: never
                # respawn past a preemption notice.
                print("[supervise] preemption requested — not respawning; "
                      "checkpoint kept; rerun the same command to resume",
                      file=sys.stderr, flush=True)
                emit_lineage("preempted", rc=EXIT_PREEMPTED)
                return EXIT_PREEMPTED
            res = lineage.resolve()
            if res is not None and res.path is None:
                why = res.skipped[0]["reason"] if res.skipped else "?"
                print(f"[supervise] discarding corrupt checkpoint "
                      f"{ckpt_path} ({why}; no valid generation of "
                      f"{len(res.skipped)}); restarting from scratch",
                      file=sys.stderr, flush=True)
                emit_lineage("discard_all", reason=why,
                             generations=len(res.skipped))
                lineage.remove_all()
                if os.path.exists(sidecar):
                    os.remove(sidecar)
                last_progress = -1
            elif res is not None and res.skipped:
                print(f"[supervise] checkpoint head {res.skipped[0]['file']} "
                      f"is corrupt ({res.skipped[0]['reason']}); resume will "
                      f"fall back to generation {res.seq}", file=sys.stderr,
                      flush=True)
                emit_lineage("corrupt_head", fallback_seq=res.seq,
                             skipped=len(res.skipped),
                             reason=res.skipped[0]["reason"])
            proc = subprocess.Popen(
                [sys.executable, "-m", "shadow1_tpu_torch", *child_argv,
                 "--supervised-child"],
                stderr=subprocess.PIPE, text=True, errors="replace")
            # [lines seen, index of the last out-of-memory line]: the
            # classifier wants the marker near the child's death.
            oom_seen = [0, None]

            def tee(pipe=proc.stderr, seen=oom_seen):
                for line in iter(pipe.readline, ""):
                    seen[0] += 1
                    if is_oom_text(line):
                        seen[1] = seen[0]
                    sys.stderr.write(line)
                sys.stderr.flush()
                pipe.close()

            reader = threading.Thread(target=tee, daemon=True)
            reader.start()
            proc_box[0] = proc
            if sig_seen and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            spawn_wall = time.time()
            hung, hung_stale = False, 0.0
            poll_s = (max(0.1, min(1.0, watchdog_s / 5))
                      if watchdog_s > 0 else 1.0)
            while True:
                try:
                    rc = proc.wait(timeout=poll_s)
                    break
                except subprocess.TimeoutExpired:
                    pass
                if watchdog_s <= 0:
                    continue
                try:
                    beat = os.path.getmtime(sidecar)
                except OSError:
                    beat = None
                beaten = beat is not None and beat > spawn_wall
                deadline = watchdog_s if beaten else 3 * watchdog_s
                stale_s = time.time() - (beat if beaten else spawn_wall)
                if stale_s > deadline:
                    print(f"[supervise] child hung: progress sidecar stale "
                          f"{stale_s:.1f}s > watchdog {deadline:.1f}s — "
                          f"killing pid {proc.pid}", file=sys.stderr,
                          flush=True)
                    proc.kill()
                    rc = proc.wait()
                    hung, hung_stale = True, stale_s
                    break
            proc_box[0] = None
            reader.join(timeout=10.0)
            raw_oom = (rc > 0 and rc not in EXIT_CODES and not hung
                       and oom_seen[1] is not None
                       and oom_seen[0] - oom_seen[1] <= 50)
            if rc == EXIT_MEMORY or raw_oom:
                how = ("rc=EXIT_MEMORY" if rc == EXIT_MEMORY
                       else f"rc={rc}, raw CUDA out-of-memory on stderr")
                print(f"[supervise] child exhausted device memory ({how}) "
                      f"— deterministic config-vs-device condition; not "
                      f"respawning. Apply the memory advice above, rerun "
                      f"with --on-oom downshift, or probe the feasible "
                      f"envelope: python -m shadow1_tpu_torch.tools.memprobe "
                      f"{config_path} --maxfit", file=sys.stderr,
                      flush=True)
                return EXIT_MEMORY
            if rc == EXIT_CAPACITY:
                print(f"[supervise] child halted on a capacity policy "
                      f"(rc={rc}, CapacityExceededError) — deterministic "
                      f"config condition; not respawning. Apply the engine: "
                      f"cap advice above, or rerun with --on-overflow "
                      f"retry.", file=sys.stderr, flush=True)
                return rc
            if rc == EXIT_PREEMPTED:
                print(f"[supervise] child drained after a preemption signal "
                      f"(rc={rc}) — checkpoint kept; rerun the same command "
                      f"to resume", file=sys.stderr, flush=True)
                emit_lineage("preempted", rc=rc)
                return EXIT_PREEMPTED
            if rc == EXIT_OK:
                # A finished run's snapshot must not resume a later
                # invocation of the same command into a no-op.
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
            if hung:
                emit_lineage("watchdog_kill", stale_s=round(hung_stale, 1),
                             sim_ns=max(progress, 0), attempt=attempt)
            if progress > last_progress:
                no_progress = no_progress_hung = 0
                last_progress = progress
            elif hung:
                no_progress_hung += 1
                if no_progress_hung >= 2:
                    print(f"[supervise] two consecutive watchdog kills with "
                          f"no forward progress at sim_ns={max(progress, 0)} "
                          f"— the hang is deterministic at that point; "
                          f"further respawns would repeat it. Check the "
                          f"card and its kernels without this run: "
                          f"python -m shadow1_tpu_torch.tools.faultprobe",
                          file=sys.stderr, flush=True)
                    return EXIT_HUNG
            else:
                no_progress += 1
                if no_progress >= 2:
                    print(f"[supervise] two consecutive crashes (rc={rc}) "
                          f"with no forward progress at "
                          f"sim_ns={max(progress, 0)} — the fault is "
                          f"deterministic at that point; further respawns "
                          f"would repeat it. Diagnose device and kernel "
                          f"faults with python -m "
                          f"shadow1_tpu_torch.tools.faultprobe",
                          file=sys.stderr, flush=True)
                    return rc
            if attempt == MAX_RESPAWNS:
                return rc
            delay = backoff_base * (2 ** (no_progress_hung if hung
                                          else no_progress))
            kind = "hung (watchdog kill)" if hung else f"died rc={rc}"
            print(f"[supervise] child {kind} at sim_ns={progress}; "
                  f"respawning ({attempt + 1}/{MAX_RESPAWNS}) after "
                  f"{delay:.1f}s backoff", file=sys.stderr, flush=True)
            if delay > 0:
                time.sleep(delay)
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
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
                         "'cpu' is the numpy oracle on the host; 'sharded' "
                         "splits the hosts over the ranks of a "
                         "torch.distributed world (torchrun; launched "
                         "alone, one rank)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="--engine sharded: the collectives' backend "
                         "(default: nccl on the card, gloo on the CPU; "
                         "gloo runs several ranks on one card)")
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
    ap.add_argument("--on-overflow", choices=["drop", "retry", "halt"],
                    default=None, metavar="drop|retry|halt",
                    help="overflow policy at chunk boundaries (overrides "
                         "engine.on_overflow): drop counts and goes on; "
                         "retry discards a tainted chunk, grows the cap one "
                         "ladder step and replays it; halt exits 4 with cap "
                         "advice")
    ap.add_argument("--auto-caps", action="store_true",
                    help="grow ev_cap before overflow and shrink it after "
                         "sustained low occupancy, at chunk boundaries, "
                         "migrating the state bit-exactly (overrides "
                         "engine.auto_caps)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="check the drop-accounting identity at every chunk "
                         "boundary")
    ap.add_argument("--on-oom", choices=["halt", "downshift"],
                    default="halt", metavar="halt|downshift",
                    help="memory-budget policy: the pre-flight estimate "
                         "against the card's free memory (SHADOW1_MEM_BYTES "
                         "overrides); halt exits 7 with advice, downshift "
                         "drops the retry rollback copy, then shrinks the "
                         "ring")
    ap.add_argument("--watchdog-s", type=float, default=None, metavar="S",
                    help="--ckpt supervisor watchdog: kill a child whose "
                         "progress sidecar has not ticked for S seconds "
                         "(3S before its first tick) and respawn it; two "
                         "hangs without progress exit 6. Default: env "
                         "SHADOW1_WATCHDOG_S, else off")
    ap.add_argument("--fleet", action="store_true",
                    help="batched experiment sweep (fleet/): expand the "
                         "config's `sweep:` section into E experiments of "
                         "one shape class and run them as one fleet; one "
                         "fleet_exp record per experiment plus a "
                         "fleet_summary; each lane bit-identical to its "
                         "solo run")
    ap.add_argument("--on-lane-fail", choices=["halt", "quarantine"],
                    default=None, metavar="halt|quarantine",
                    help="fleet lane-failure policy (overrides "
                         "engine.on_lane_fail): quarantine slices a lane "
                         "that fails deterministically out into a "
                         "solo-resumable checkpoint and finishes the sweep "
                         "with the rest")
    ap.add_argument("--lane-finalize", action="store_true",
                    help="fleet: lanes whose event buffer drains emit "
                         "their fleet_exp record at once and leave the "
                         "fleet (overrides engine.lane_finalize)")
    return ap


def _refuse_for_oracle(ap, args) -> None:
    """The oracle runs eagerly on the host: no device but the CPU, and
    none of the batched engine's chunked-run flags."""
    if args.device is not None and args.device != "cpu":
        ap.error(f"--engine cpu is the numpy oracle on the host; "
                 f"--device {args.device} contradicts it")
    if (args.save_state or args.resume or args.heartbeat or args.tracker
            or args.profile or args.ckpt or args.trace or args.metrics_ring
            or args.auto_caps or args.on_overflow == "retry"
            or args.on_oom == "downshift"):
        ap.error("--save-state/--resume/--heartbeat/--tracker/--profile/"
                 "--ckpt/--trace/--metrics-ring/--auto-caps/"
                 "--on-overflow retry/--on-oom downshift require a batched "
                 "engine (tpu)")


def _params(ap, args, exp, params, engine_kind: str = "tpu"):
    """The config's EngineParams with the flags applied, and the reference's
    auto-ring rule: the digest words and the probe rows ride a ring, so one
    is set (the heartbeat's depth, else 64) when neither config nor flag
    gave one. The oracle needs no ring: its rows go straight to stderr."""
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
            and args.metrics_ring is None and engine_kind != "cpu"):
        params = dataclasses.replace(params,
                                     metrics_ring=args.heartbeat or 64)
    if args.on_overflow is not None:
        params = dataclasses.replace(params, on_overflow=args.on_overflow)
    if args.selfcheck:
        params = dataclasses.replace(params, selfcheck=1)
    return params


def _resolve_ckpt_lineage(args, log, discard: bool = True):
    """Child side of --ckpt: the newest valid lineage generation (corrupt
    newer ones deleted, unless ``discard`` is off: a sharded run's ranks
    other than 0), else an explicit --resume. Returns (resolved, lineage,
    resume_path)."""
    if not args.ckpt:
        return None, None, args.resume
    from shadow1_tpu_torch.lineage import Lineage

    lineage = Lineage(args.ckpt, keep=args.ckpt_keep)
    r = lineage.resolve(discard_invalid=discard)
    resolved = r if (r is not None and r.path is not None) else None
    if r is not None and resolved is None:
        log.warning("discarding corrupt checkpoint", path=args.ckpt,
                    reason=(r.skipped[0]["reason"] if r.skipped
                            else "no valid generation"))
    return resolved, lineage, (resolved.path if resolved else args.resume)


def _fleet_config_exit(e) -> int:
    """Structured fleet rejection: the message on stderr, one parseable
    ``fleet_config`` record on stdout, the config exit code."""
    from shadow1_tpu_torch.consts import EXIT_CONFIG

    print(f"FleetConfigError: {e}", file=sys.stderr, flush=True)
    print(json.dumps({"error": "fleet_config", "kind": e.kind,
                      "knob": e.knob, "message": str(e)}))
    return EXIT_CONFIG


def main(argv=None) -> int:
    # The serve plane's subcommands: dispatched before the solo parser, so
    # the solo surface (a positional config and flags) stays as it is.
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from shadow1_tpu_torch.serve.daemon import main as serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "submit":
        from shadow1_tpu_torch.serve.client import main as submit_main

        return submit_main(argv[1:])
    ap = _parser()
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.config.experiment import (
        WatchlistError,
        load_experiment,
    )
    from shadow1_tpu_torch.fleet.expand import FleetConfigError

    fleet_plan = None
    if args.fleet:
        bad = [f for f, v in (("--tracker", args.tracker),
                              ("--summary", args.summary),
                              ("--profile", args.profile),
                              ("--trace", args.trace)) if v]
        if bad:
            ap.error(f"--fleet does not support {', '.join(bad)}: use the "
                     f"fleet_exp records and --metrics-ring "
                     f"(per-experiment rows)")
        from shadow1_tpu_torch.fleet.expand import load_sweep

        # The sweep is validated before any supervision or device work.
        try:
            fleet_plan = load_sweep(args.config)
        except FleetConfigError as e:
            return _fleet_config_exit(e)
        except WatchlistError as e:
            ap.error(str(e))
        exp, params = fleet_plan.exps[0], fleet_plan.params
        scheduler = fleet_plan.scheduler
    else:
        try:
            exp, params, scheduler = load_experiment(args.config)
        except WatchlistError as e:
            ap.error(str(e))
    engine_kind = args.engine or scheduler
    if engine_kind == "cpu":
        _refuse_for_oracle(ap, args)
    if engine_kind != "tpu" and args.fleet:
        return _fleet_config_exit(FleetConfigError(
            f"--fleet batches the single-device engine; "
            f"engine={engine_kind!r} is not composable with the "
            f"experiment axis", kind="mode", knob="engine"))
    if args.dist_backend and engine_kind != "sharded":
        ap.error("--dist-backend needs --engine sharded")
    if args.faults == "off":
        # The healthy-world A/B strips every experiment's schedule (a
        # vary[] entry's too); legacy per-group stop_time churn stays.
        for fexp in (fleet_plan.exps if args.fleet else [exp]):
            fexp.faults = None
    params = _params(ap, args, exp, params, engine_kind)
    if args.on_lane_fail is not None or args.lane_finalize:
        if not args.fleet:
            ap.error("--on-lane-fail/--lane-finalize are fleet lane "
                     "policies; they need --fleet")
        repl = {}
        if args.on_lane_fail is not None:
            repl["on_lane_fail"] = args.on_lane_fail
        if args.lane_finalize:
            repl["lane_finalize"] = 1
        params = dataclasses.replace(params, **repl)
    if args.ckpt and args.resume and args.windows is not None:
        # Under supervision --windows is the TOTAL for the whole run; under
        # --resume it means N more windows: ambiguous together.
        ap.error("--ckpt with both --resume and --windows is ambiguous "
                 "(total or N-more?); drop one of them")
    if args.ckpt_keep < 1:
        ap.error("--ckpt-keep must be >= 1")
    if engine_kind == "cpu":
        return _oracle_main(args, exp, params)
    if args.ckpt and not args.supervised_child and engine_kind != "sharded":
        # The parent never touches the card: all device work happens in
        # the supervised children.
        watchdog_s = (args.watchdog_s if args.watchdog_s is not None
                      else float(os.environ.get("SHADOW1_WATCHDOG_S", "0")))
        return _supervise(argv, args.ckpt, args.config,
                          watchdog_s=watchdog_s)

    from shadow1_tpu_torch.core.engine import resolve_device
    from shadow1_tpu_torch.log import SimLogger

    device = resolve_device(args.device)
    world = None
    if engine_kind == "sharded":
        try:
            world = _join_world(args, device)
        except ValueError as e:  # a backend that cannot serve the world
            ap.error(str(e))
        device = world["device"]
    root = world is None or world["rank"] == 0
    log = SimLogger(level=args.log_level, rank=0 if root else 1)
    try:
        return _batched_main(args, exp, params, engine_kind, device, world,
                             log, fleet_plan)
    finally:
        if world is not None:
            _leave_world(world)


def _join_world(args, device) -> dict:
    """Join the sharded run's world (``shard/launch.init_from_env``):
    NCCL on the card, one card per rank (``cuda:LOCAL_RANK``), gloo on
    the CPU or where ``--dist-backend gloo`` asks for it. A rank other
    than 0 prints nothing on stdout."""
    from shadow1_tpu_torch.shard.launch import (
        check_backend,
        init_from_env,
        rank_device,
    )

    backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    check_backend(backend, device, int(os.environ.get("WORLD_SIZE", "1")))
    rank, n, local, tmp = init_from_env(backend)
    dev = rank_device(backend, str(device), local)
    if rank:
        sys.stdout = open(os.devnull, "w")
    return {"rank": rank, "world": n, "device": dev, "tmp": tmp}


def _leave_world(world: dict) -> None:
    import shutil

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    if world["tmp"]:
        shutil.rmtree(world["tmp"], ignore_errors=True)


def _batched_main(args, exp, params, engine_kind, device, world, log,
                  fleet_plan) -> int:
    """The batched engines' run: solo, sharded (``world``) or a fleet."""
    import torch

    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.fleet.expand import FleetConfigError
    from shadow1_tpu_torch.obs import build_kernels
    from shadow1_tpu_torch.preempt import DrainHandler, PreemptedExit
    from shadow1_tpu_torch.txn import CapacityExceededError

    auto_caps = bool(args.auto_caps or params.auto_caps)
    root = world is None or world["rank"] == 0
    n_dev = world["world"] if world is not None else 1
    if engine_kind == "sharded":
        from shadow1_tpu_torch.shard.engine import ShardedEngine as Eng
    else:
        Eng = Engine

    # ---- pre-flight memory budget (mem.py): the estimate from the config
    # alone (a meta-device init, or a host one for a small state; nothing
    # on the card) against what this process can hold on the card, before
    # the engine is built.
    pre_downshift_retry = False  # retry demoted by a memory downshift
    sub_batch = None             # a fleet's lanes per sequential batch
    budget, budget_src = mem.device_budget(device)
    fleet = (fleet_plan.exps, fleet_plan.max_rounds) if args.fleet else None
    try:
        mem_est = mem.estimate(exp, params, fleet=fleet, n_dev=n_dev)
    except Exception as est_err:  # noqa: BLE001 — the estimate fails soft
        mem_est = None
        log.warning("memory estimate unavailable", error=repr(est_err))
    if mem_est is not None and root:
        print(json.dumps(mem_est.record(budget, budget_src,
                                        engine=engine_kind)),
              file=sys.stderr, flush=True)
    if (mem_est is not None and budget is not None
            and mem_est.peak_bytes > budget):
        try:
            if args.on_oom != "downshift":
                mem.check_budget(mem_est, budget, budget_src)
            pre_downshift_retry = params.on_overflow == "retry"
            # A shrunk ring would write a snapshot no engine of this config
            # could load back.
            # Sub-batching composes with --ckpt (a batch cursor in the
            # lineage), not with an explicit snapshot path.
            params, actions = mem.downshift(
                exp, params, budget,
                resumable=bool(args.ckpt or args.resume or args.save_state),
                fleet=fleet, subbatch_resumable=bool(
                    args.ckpt and not args.resume and not args.save_state),
                n_dev=n_dev)
        except mem.MemoryBudgetError as e:
            return _memory_exit(e)
        sub_batch = next((a["lanes"] for a in actions
                          if a["action"] == "sub_batch"), None)
        mem_est = mem.estimate(exp, params, fleet=fleet and (
            fleet[0][:sub_batch], fleet[1][:sub_batch]), n_dev=n_dev)
        if root:
            print(json.dumps(mem.downshift_record(
                actions, mem_est.peak_bytes, budget)),
                file=sys.stderr, flush=True)
        for a in actions:
            log.warning("memory downshift", **a)
    if os.environ.get("SHADOW1_MEM_INJECT_OOM") == "raw":
        # Test hook for the supervisor's stderr scan: die like a crash the
        # structured taxonomy never saw.
        print("torch.OutOfMemoryError: CUDA out of memory. Tried to "
              "allocate 2.00 GiB (injected raw OOM, test hook)",
              file=sys.stderr, flush=True)
        raise SystemExit(1)

    phases = None
    if args.trace or args.profile:
        from shadow1_tpu_torch.telemetry import PhaseProfiler

        phases = PhaseProfiler()
    # Before the engine: its construction may launch the kernels.
    build_kernels(device, phases)
    if args.fleet:
        try:
            if sub_batch:
                return _fleet_subbatched(args, params, fleet_plan, log,
                                         device, sub_batch)
            return _fleet_main(args, params, fleet_plan, log, device,
                               auto_caps=auto_caps,
                               pre_downshift_retry=pre_downshift_retry)
        except FleetConfigError as e:
            # Late rejections (FleetEngine construction) exit as the
            # early validation does.
            return _fleet_config_exit(e)
    try:
        eng = Eng(exp, params, device=device)
    except Exception as e:
        # Construction allocates the ctx tables and the restart capture.
        if mem.is_oom(e):
            return _memory_exit_runtime(args, e, phase="init")
        raise
    log.info("experiment loaded", hosts=exp.n_hosts, engine=engine_kind,
             window_ns=exp.window, device=str(eng.device))
    t0 = time.perf_counter()
    metrics0: dict[str, int] = {}
    st = None
    resolved, ckpt_lineage, resume_path = _resolve_ckpt_lineage(
        args, log, discard=root)
    if resume_path:
        from shadow1_tpu_torch.ckpt import (
            CorruptCheckpointError,
            load_state,
            snapshot_caps,
        )

        params0, eng0 = params, eng
        # A sharded run loads the global state and takes its columns.
        try:
            template = eng.init_global_state()
            if auto_caps or params.on_overflow == "retry" or pre_downshift_retry:
                # A retry or auto-caps run checkpoints at the caps it had
                # grown to, where a host may hold more events than the
                # config's cap: the engine starts at the snapshot's caps.
                snap = snapshot_caps(template, resume_path)
                if snap and snap != (params.ev_cap, params.outbox_cap):
                    params = dataclasses.replace(
                        params, ev_cap=snap[0], outbox_cap=snap[1])
                    eng = Eng(exp, params, device=device)
                    template = eng.init_global_state()
            st = load_state(template, resume_path)
            template = None
            st = eng.place_state(st)
        except CorruptCheckpointError as e:
            # A supervised child falls back to a fresh start; an explicit
            # --resume fails loudly.
            if resolved is None:
                raise
            log.warning("discarding corrupt checkpoint", path=resume_path,
                        reason=str(e))
            st, params, eng = None, params0, eng0
            resume_path, resolved = None, None
        else:
            metrics0 = Engine.metrics_dict(st)
            done = int(st.win_start) // exp.window
            if resolved is not None and root:
                _emit_resume_record(args.ckpt, resolved, int(st.win_start),
                                    ckpt_lineage)
            if args.windows is None:
                args.windows = max(eng.n_windows - done, 0)
            elif resolved is not None:
                # Supervised respawn: --windows is the whole run's total.
                args.windows = max(args.windows - done, 0)
    n_windows = args.windows if args.windows is not None else eng.n_windows
    controller = guard = None
    if auto_caps:
        from shadow1_tpu_torch.tune import CapController

        controller = CapController(eng, eng.at_caps, log=log.info,
                                   initial_state=st)
    if params.on_overflow in ("retry", "halt"):
        from shadow1_tpu_torch.txn import OverflowGuard

        # Engines at other caps share this one's device tables; with the
        # controller, the two planes share one engine cache.
        guard = OverflowGuard(eng, make_engine=eng.at_caps,
                              mode=params.on_overflow,
                              controller=controller, log=log.info)
    if args.profile:
        from shadow1_tpu_torch.telemetry import device_trace

        prof = device_trace(args.profile, phases)
    else:
        prof = contextlib.nullcontext()
    ring_w = params.metrics_ring
    try:
        with prof:
            if os.environ.get("SHADOW1_MEM_INJECT_OOM") == "run":
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB "
                    "(injected, test hook)")
            if (args.heartbeat or args.ckpt or ring_w or params.link_telem
                    or phases is not None or controller is not None
                    or guard is not None or params.selfcheck):
                from shadow1_tpu_torch.obs import run_with_heartbeat

                # SIGTERM/SIGINT request a drain, honored at the next chunk
                # boundary (only the chunked path has boundaries).
                drain = DrainHandler().install()
                st, _hb = run_with_heartbeat(
                    eng, st, n_windows=n_windows,
                    # Ring-only runs chunk at the ring depth, so the drain
                    # keeps up with the overwrites.
                    every_windows=args.heartbeat or (ring_w or None),
                    stream=sys.stdout, ckpt_path=args.ckpt,
                    ckpt_every_s=args.ckpt_every_s, profiler=phases,
                    emit_heartbeat=bool(args.heartbeat),
                    emit_ring=bool(ring_w or params.link_telem),
                    controller=controller, guard=guard,
                    selfcheck=bool(params.selfcheck),
                    ckpt_keep=args.ckpt_keep, drain=drain)
            else:
                st = eng.run(st, n_windows=n_windows)
            eng.synchronize()
    except CapacityExceededError as e:
        return _capacity_exit(e)
    except PreemptedExit as e:
        return _preempted_exit(args, e, resumed=bool(resume_path))
    except Exception as e:
        if mem.is_oom(e):
            return _memory_exit_runtime(args, e)
        raise
    if phases is not None:
        if args.trace:
            phases.write(args.trace)
        if args.profile:
            phases.write(os.path.join(args.profile, "phases.trace.json"))
    if args.save_state:
        from shadow1_tpu_torch.ckpt import save_state

        snap = eng.gather_state(st)
        eng.on_root(lambda: save_state(snap, args.save_state))
        snap = None
    peak_in_use = mem.device_peak_in_use(eng.device)
    if peak_in_use is not None and root:
        # The allocator's measured high-water beside the pre-flight
        # estimate.
        print(json.dumps({"type": "mem", "event": "final",
                          "peak_in_use": peak_in_use,
                          "estimated_peak": (mem_est.peak_bytes
                                             if mem_est is not None
                                             else None)}),
              file=sys.stderr, flush=True)
    metrics = Engine.metrics_dict(st)
    summary = eng.model_summary(st)
    if args.tracker:
        from shadow1_tpu_torch.log import tracker_records

        recs = tracker_records(eng, st)
        if root:
            with open(args.tracker, "w") as f:
                for rec in recs:
                    f.write(json.dumps(rec) + "\n")
    wall = time.perf_counter() - t0
    out = result_record(
        exp, params, metrics, metrics0, summary, n_windows, wall,
        resumed=bool(resume_path),
        device=(torch.cuda.get_device_name(eng.device)
                if eng.device.type == "cuda" else "cpu"),
        guard=guard, controller=controller, engine=engine_kind)
    print(json.dumps(out))
    return EXIT_OK


def _oracle_main(args, exp, params) -> int:
    """``--engine cpu``: the numpy oracle on the host. Config-level
    ``auto_caps`` and ``on_overflow: retry`` stay inert there (it cannot
    re-run a window; halt and the self-check apply as boundary checks),
    with a warning. Its per-window digest, work, flow and link rows, the
    comparands of the batched engine's ring, flow and link records, go to
    stderr; the result line to stdout."""
    from shadow1_tpu_torch.cpu_engine import CpuEngine
    from shadow1_tpu_torch.log import SimLogger
    from shadow1_tpu_torch.txn import CapacityExceededError

    log = SimLogger(level=args.log_level)
    log.info("experiment loaded", hosts=exp.n_hosts, engine="cpu",
             window_ns=exp.window)
    if params.auto_caps:
        log.warning("engine.auto_caps ignored: the cpu oracle runs eagerly "
                    "per event, there is no chunked window loop to retune")
    if params.on_overflow == "retry":
        log.warning("engine.on_overflow=retry ignored: the eager cpu oracle "
                    "cannot replay a window; halt and --selfcheck apply as "
                    "boundary checks")
    t0 = time.perf_counter()
    eng = CpuEngine(exp, params)
    try:
        metrics = eng.run(n_windows=args.windows)
    except CapacityExceededError as e:
        return _capacity_exit(e)
    summary = eng.summary()
    n_windows = args.windows if args.windows is not None else eng.n_windows
    rows = ((eng.digest_rows if params.state_digest else []) + eng.work_rows
            + eng.probe_rows + eng.link_rows)
    for rec in rows:
        print(json.dumps(rec), file=sys.stderr)
    wall = time.perf_counter() - t0
    out = result_record(exp, params, metrics, {}, summary, n_windows, wall,
                        resumed=False, device="cpu", engine="cpu")
    print(json.dumps(out))
    return EXIT_OK


def _fleet_main(args, params, plan, log, device, auto_caps=False,
                pre_downshift_retry=False) -> int:
    """The --fleet path: one FleetEngine over the expanded sweep, driven by
    ``fleet.run.run_fleet`` (the recovery plane follows ``params``), then
    one ``fleet_exp`` record per experiment and a ``fleet_summary`` on
    stdout. Resume resolves first: a lineage generation whose ``lanes``
    meta says the sweep had already quarantined or finalized lanes
    rebuilds exactly that sub-fleet, and a snapshot taken at grown caps
    rebuilds the engine at them (the solo recipe)."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.convert import fleet_to_saved
    from shadow1_tpu_torch.fleet.engine import FleetEngine
    from shadow1_tpu_torch.fleet.run import final_records, run_fleet
    from shadow1_tpu_torch.preempt import DrainHandler, PreemptedExit
    from shadow1_tpu_torch.txn import CapacityExceededError

    t0 = time.perf_counter()
    resolved, ckpt_lineage, resume_path = _resolve_ckpt_lineage(args, log)
    exps, labels, max_rounds = plan.exps, plan.labels, plan.max_rounds
    meta_lanes = (resolved.meta or {}).get("lanes") if resolved else None
    sub_applied = False
    if (meta_lanes is not None
            and list(meta_lanes) != [l["exp"] for l in plan.labels]):
        sub = plan.subset(meta_lanes)
        exps, labels, max_rounds = sub.exps, sub.labels, sub.max_rounds
        sub_applied = True
        log.info("resuming partially-recovered sweep",
                 lanes=list(meta_lanes), of=len(plan.exps))

    def _build(p):
        eng = FleetEngine(exps, p, max_rounds, device=device)
        eng.exp_ids = [l["exp"] for l in labels]
        return eng

    try:
        eng = _build(params)
    except Exception as e:
        if mem.is_oom(e):
            return _memory_exit_runtime(args, e, phase="init")
        raise
    log.info("fleet expanded", experiments=eng.n_exp,
             hosts=eng.exp.n_hosts, window_ns=eng.window,
             device=str(eng.device))
    st = None
    metrics0_by_gid = None
    if resume_path:
        from shadow1_tpu_torch.ckpt import (
            CorruptCheckpointError,
            load_fleet_state,
            snapshot_caps,
        )

        params0, eng0 = params, eng
        try:
            template = eng.init_state()
            if (auto_caps or params.on_overflow == "retry"
                    or pre_downshift_retry):
                snap = snapshot_caps(fleet_to_saved(template, eng.n_exp),
                                     resume_path)
                if snap and snap != (params.ev_cap, params.outbox_cap):
                    params = dataclasses.replace(
                        params, ev_cap=snap[0], outbox_cap=snap[1])
                    eng = _build(params)
                    template = eng.init_state()
            st = load_fleet_state(template, resume_path, eng.n_exp)
        except CorruptCheckpointError as e:
            # A supervised child falls back to a fresh start of the FULL
            # sweep; an explicit --resume fails loudly.
            if resolved is None:
                raise
            log.warning("discarding corrupt fleet checkpoint",
                        path=resume_path, reason=str(e))
            st, resume_path, resolved = None, None, None
            params = params0
            if sub_applied:
                exps, labels, max_rounds = (plan.exps, plan.labels,
                                            plan.max_rounds)
                eng = _build(params)
            else:
                eng = eng0
        else:
            metrics0_by_gid = {l["exp"]: m for l, m in
                               zip(labels, eng.metrics_per_exp(st))}
            done = int(st.win_start) // eng.window
            if resolved is not None:
                _emit_resume_record(args.ckpt, resolved, int(st.win_start),
                                    ckpt_lineage)
            if args.windows is None:
                args.windows = max(eng.n_windows - done, 0)
            elif resolved is not None:
                args.windows = max(args.windows - done, 0)
    ring_w = params.metrics_ring
    drain = DrainHandler().install()
    # Quarantined-lane snapshots land beside the fleet checkpoint, else
    # beside the config.
    qbase = args.ckpt or os.path.splitext(args.config)[0] + ".lane"
    try:
        if os.environ.get("SHADOW1_MEM_INJECT_OOM") == "run":
            import torch

            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB "
                "(injected, test hook)")
        st, hb = run_fleet(
            eng, st, n_windows=args.windows,
            every_windows=args.heartbeat or (ring_w or None),
            stream=(sys.stdout if (args.heartbeat or ring_w
                                   or params.link_telem) else False),
            ckpt_path=args.ckpt, ckpt_every_s=args.ckpt_every_s,
            emit_heartbeat=bool(args.heartbeat),
            emit_ring=bool(ring_w or params.link_telem),
            selfcheck=bool(params.selfcheck), labels=labels,
            ckpt_keep=args.ckpt_keep, drain=drain, auto_caps=auto_caps,
            quarantine_base=qbase,
            recovery_seed=({"quarantined":
                            (resolved.meta or {}).get("quarantined", []),
                            "finished":
                            (resolved.meta or {}).get("finished", [])}
                           if resolved is not None and st is not None
                           else None),
            # Quarantine and early-finalize records print the moment the
            # lane leaves the fleet.
            emit_record=lambda rec: print(json.dumps(rec), flush=True))
        hb.engine.synchronize()
    except CapacityExceededError as e:
        return _capacity_exit(e)
    except PreemptedExit as e:
        return _preempted_exit(args, e, resumed=bool(resume_path))
    except Exception as e:
        if mem.is_oom(e):
            return _memory_exit_runtime(args, e)
        raise
    if args.save_state:
        from shadow1_tpu_torch.ckpt import save_state

        save_state(fleet_to_saved(st, hb.engine.n_exp), args.save_state)
    wall = time.perf_counter() - t0
    n_windows = args.windows if args.windows is not None else eng.n_windows
    metrics0 = ([metrics0_by_gid.get(l["exp"], {}) for l in hb.labels]
                if metrics0_by_gid is not None else None)
    recs, summary = final_records(hb.engine, st, hb.labels, n_windows, wall,
                                  resumed=bool(resume_path),
                                  metrics0=metrics0, recovery=hb.recovery)
    for r in recs:
        print(json.dumps(r))
    print(json.dumps(summary))
    return EXIT_OK


def _fleet_subbatched(args, params, plan, log, device, sub: int) -> int:
    """A memory-downshifted fleet (``--on-oom downshift``): the sweep's E
    lanes run as SEQUENTIAL batches of at most ``sub`` lanes, each its own
    FleetEngine run; lanes never read one another's columns, so each
    lane's results are those of the full fleet. Each batch prints its
    ``fleet_exp`` records with sweep-global ids as it finishes; one merged
    ``fleet_summary`` (counters summed, gauges and the lockstep windows
    and rounds maxed) closes the run.

    Under ``--ckpt`` each batch snapshots its own lanes, and the lineage
    manifest entry carries the batch cursor (``batch``) and the summaries
    of the completed batches (``batch_summaries``): a resume finishes the
    recorded batch from its snapshot and runs the rest; completed batches
    never run again. A drain request stops the sweep at a chunk
    boundary; finished lanes keep their records."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.ckpt import CorruptCheckpointError, load_fleet_state
    from shadow1_tpu_torch.fleet.engine import FleetEngine
    from shadow1_tpu_torch.fleet.run import final_records, run_fleet
    from shadow1_tpu_torch.preempt import DrainHandler, PreemptedExit
    from shadow1_tpu_torch.telemetry.registry import gauge_names
    from shadow1_tpu_torch.txn import CapacityExceededError

    t0 = time.perf_counter()
    n_exp = len(plan.exps)
    n_batches = -(-n_exp // sub)
    log.info("fleet sub-batched for memory", experiments=n_exp,
             lanes_per_batch=sub, batches=n_batches)
    drain = DrainHandler().install()
    ring_w = params.metrics_ring
    summaries: list[dict] = []
    windows_done = args.windows
    lanes_run = 0
    resolved, ckpt_lineage, resume_path = _resolve_ckpt_lineage(args, log)
    start_batch = 0
    if resume_path and resolved is not None and resolved.meta:
        start_batch = int(resolved.meta.get("batch", 0))
        summaries = list(resolved.meta.get("batch_summaries", []))
        lanes_run = start_batch * sub
    for bi, i in enumerate(range(0, n_exp, sub)):
        if bi < start_batch:
            continue  # finished before the crash; its summary is kept
        exps = plan.exps[i:i + sub]
        labels = plan.labels[i:i + sub]
        max_rounds = plan.max_rounds[i:i + sub]
        recovery_seed, st, batch_resumed = None, None, False
        resuming_here = resume_path and bi == start_batch
        if resuming_here and resolved is not None and resolved.meta:
            # The generation may hold a batch that already quarantined or
            # finalized lanes: rebuild exactly that sub-batch.
            meta_lanes = resolved.meta.get("lanes")
            if (meta_lanes is not None
                    and list(meta_lanes) != [l["exp"] for l in labels]):
                by_gid = {l["exp"]: j for j, l in enumerate(labels)}
                keep = [by_gid[g] for g in meta_lanes if g in by_gid]
                exps = [exps[j] for j in keep]
                max_rounds = [max_rounds[j] for j in keep]
                labels = [labels[j] for j in keep]
            recovery_seed = {
                "quarantined": resolved.meta.get("quarantined", []),
                "finished": resolved.meta.get("finished", [])}
        try:
            eng = FleetEngine(exps, params, max_rounds, device=device)
            eng.exp_base = i
            eng.exp_ids = [l["exp"] for l in labels]
            n_windows = (args.windows if args.windows is not None
                         else eng.n_windows)
            remaining = n_windows
            if resuming_here:
                try:
                    st = load_fleet_state(eng.init_state(), resume_path,
                                          eng.n_exp)
                except CorruptCheckpointError as e:
                    if resolved is None:
                        raise
                    log.warning("discarding corrupt sub-batch checkpoint",
                                path=resume_path, reason=str(e))
                    st, recovery_seed = None, None
                    # A fresh start of THIS batch: all of its lanes again.
                    exps = plan.exps[i:i + sub]
                    labels = plan.labels[i:i + sub]
                    eng = FleetEngine(exps, params,
                                      plan.max_rounds[i:i + sub],
                                      device=device)
                    eng.exp_base = i
                    eng.exp_ids = [l["exp"] for l in labels]
                else:
                    batch_resumed = True
                    remaining = max(
                        n_windows - int(st.win_start) // eng.window, 0)
                    _emit_resume_record(args.ckpt, resolved,
                                        int(st.win_start), ckpt_lineage)
            st, hb = run_fleet(
                eng, st, n_windows=remaining,
                every_windows=args.heartbeat or (ring_w or None),
                stream=(sys.stdout if (args.heartbeat or ring_w
                                       or params.link_telem) else False),
                ckpt_path=args.ckpt, ckpt_every_s=args.ckpt_every_s,
                emit_heartbeat=bool(args.heartbeat),
                emit_ring=bool(ring_w or params.link_telem),
                selfcheck=bool(params.selfcheck), labels=labels,
                ckpt_keep=args.ckpt_keep, drain=drain,
                quarantine_base=(args.ckpt or os.path.splitext(
                    args.config)[0] + ".lane"),
                emit_record=lambda rec: print(json.dumps(rec), flush=True),
                resume_meta={"batch": bi, "batch_summaries": summaries},
                recovery_seed=recovery_seed)
            hb.engine.synchronize()
        except CapacityExceededError as e:
            return _capacity_exit(e)
        except PreemptedExit as e:
            return _preempted_exit(args, e, resumed=batch_resumed)
        except Exception as e:
            if mem.is_oom(e):
                return _memory_exit_runtime(args, e)
            raise
        windows_done = n_windows
        # The live batch: quarantine or finalize may have shrunk it.
        recs, summary = final_records(hb.engine, st, hb.labels, n_windows,
                                      time.perf_counter() - t0,
                                      resumed=batch_resumed,
                                      recovery=hb.recovery)
        for r in recs:
            print(json.dumps(r))
        summaries.append(summary)
        lanes_run += len(exps)
        if drain.requested and lanes_run < n_exp:
            return _preempted_exit(args, PreemptedExit(
                st=None, signame=drain.signame, done_windows=n_windows,
                win_start=int(summary.get("sim_seconds", 0) * 1e9)),
                resumed=batch_resumed)
    maxed = set(gauge_names()) | {"windows", "rounds"}
    agg: dict[str, int] = {}
    for s in summaries:
        for k, v in s["metrics"].items():
            agg[k] = (max(agg.get(k, 0), int(v)) if k in maxed
                      else agg.get(k, 0) + int(v))
    wall = time.perf_counter() - t0
    s0 = summaries[0]
    sim_s = s0["sim_seconds"]
    print(json.dumps({
        "type": "fleet_summary",
        "engine": "fleet",
        "experiments": n_exp,
        "hosts": s0["hosts"],
        "window_ns": s0["window_ns"],
        "windows": windows_done,
        "sim_seconds": sim_s,
        "wall_seconds": round(wall, 3),
        "sim_per_wall": round(sim_s / wall, 3) if wall > 0 else None,
        "events_per_sec": (round(agg.get("events", 0) / wall, 1)
                           if wall > 0 else None),
        "events_per_exp": [e for s in summaries
                           for e in s["events_per_exp"]],
        "resumed": False,
        "caps": s0["caps"],
        "metrics": agg,
        "sub_batches": n_batches,
        "lanes_per_batch": sub,
    }))
    return EXIT_OK


def _capacity_exit(e) -> int:
    """Structured halt: the advice on stderr, one parseable error record on
    stdout, the exit code the supervisor never respawns."""
    print(f"CapacityExceededError: {e}", file=sys.stderr, flush=True)
    print(json.dumps({
        "error": "capacity_exceeded",
        "knob": e.knob,
        "counter": e.counter,
        "cap": e.cap,
        "overflow": e.overflow,
        "windows": list(e.window_range),
        "recommended": e.recommended,
    }))
    return EXIT_CAPACITY


def _preempted_exit(args, e, resumed=False) -> int:
    """Graceful-drain exit: the in-flight chunk was committed (and the final
    snapshot written under --ckpt) before this point."""
    e.ckpt = args.ckpt
    print(f"[preempt] drain complete after {e.signame}: {e.done_windows} "
          f"window(s) committed, sim_ns={e.win_start}"
          + (f", snapshot {args.ckpt}" if args.ckpt
             else ", no checkpoint path"), file=sys.stderr, flush=True)
    print(json.dumps({
        "preempted": True,
        "signal": e.signame,
        "windows_done": e.done_windows,
        "win_start": e.win_start,
        "ckpt": args.ckpt,
        "resumed": bool(resumed),
    }))
    return EXIT_PREEMPTED


def _memory_exit(e) -> int:
    """Pre-flight budget rejection: the advice on stderr, one parseable
    error record on stdout, the exit code the supervisor never respawns."""
    print(f"MemoryBudgetError: {e}", file=sys.stderr, flush=True)
    print(json.dumps({
        "error": "memory_budget",
        "estimated": e.estimated,
        "budget": e.budget,
        "budget_source": e.budget_source,
        "planes": e.planes,
        "peaks": e.peaks,
        "advice": e.advice,
    }))
    return EXIT_MEMORY


def _memory_exit_runtime(args, e, phase: str = "run") -> int:
    """A CUDA out-of-memory error past the estimate (transients beyond the
    model, other tenants of the card): a phase-tagged record on stdout,
    EXIT_MEMORY for the supervisor."""
    print(f"[mem] device memory exhausted during {phase}: {str(e)[:2000]}",
          file=sys.stderr, flush=True)
    print(f"[mem] deterministic config-vs-device condition — rerun with "
          f"--on-oom downshift, shrink the dominant plane (the mem record "
          f"above attributes bytes per plane), or probe the feasible "
          f"envelope: python -m shadow1_tpu_torch.tools.memprobe "
          f"{args.config} --maxfit", file=sys.stderr, flush=True)
    print(json.dumps({
        "error": "memory_exhausted",
        "phase": phase,
        "message": str(e)[:500],
    }))
    return EXIT_MEMORY


def result_record(exp, params, metrics, metrics0, summary, n_windows, wall,
                  *, resumed: bool, device: str, guard=None,
                  controller=None, engine: str = "tpu") -> dict:
    """The result line: the reference's keys with their meaning, and the
    port's ``device`` and ``summary``. Rates cover this invocation: under
    --resume the snapshot's metrics are taken out. ``caps`` are the caps
    the run started at; under a guard the metrics carry its host-side
    counters and a ``retries`` block follows, under a controller an
    ``auto_caps`` block."""
    from shadow1_tpu_torch.telemetry.registry import DROP_FIELDS

    if guard is not None:
        metrics = {**metrics, "chunk_retries": guard.chunk_retries,
                   "retry_windows_rerun": guard.retry_windows_rerun}
    sim_s = n_windows * exp.window / 1e9
    ev_run = metrics["events"] - metrics0.get("events", 0)
    out = {
        "engine": engine,
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
    if guard is not None:
        out["retries"] = {**guard.report(), "resizes": guard.resizes}
    if controller is not None:
        out["auto_caps"] = {
            "resizes": controller.resizes,
            "final": controller.final_caps or {
                "ev_cap": params.ev_cap, "outbox_cap": params.outbox_cap}}
    out["summary"] = {k: int(v) for k, v in summary.items()
                      if isinstance(v, int) or getattr(v, "ndim", 1) == 0}
    return out
