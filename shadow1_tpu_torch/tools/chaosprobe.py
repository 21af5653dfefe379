"""Kill-anywhere chaos harness — randomized preemption/crash trials (port
of ``tools/chaosprobe.py``).

    python -m shadow1_tpu_torch.tools.chaosprobe CONFIG [--no-oracle]
        [--windows N] [--chunk C] [--trials T] [--seed S] [--fleet]
        [--keep K] [--jobs N] [--work DIR] [--device DEV] [--json-only]

The preemption contract (docs/SEMANTICS.md) claims a supervised run is
survivable at ANY real-time instant: SIGKILL or SIGTERM, mid-chunk,
mid-checkpoint-write, with a corrupted snapshot head — the completed run's
final state and per-window digest stream must be BIT-IDENTICAL to a run
nothing ever touched. This probe proves it empirically:

1. one STRAIGHT run records the reference digest stream (the flight
   recorder's per-window ring rows) and final state (.npz, every leaf);
2. ``--trials`` supervised runs are attacked and relaunched to completion:

   * ``sigkill_group`` / ``sigterm_group`` / ``sigkill_child`` /
     ``sigterm_child`` — the signal lands at a random real-time offset,
     on the whole process tree or just the engine child (the supervisor
     then drains/respawns on its own);
   * ``drain`` — a deterministic mid-run SIGTERM (the preemption-notice
     shape): the run must exit EXIT_PREEMPTED after committing, and the
     relaunch must resume, not restart;
   * ``torn_head`` — the lineage injection hook tears the newest snapshot
     mid-write (half-truncated head) and kills the process: resume must
     fall back one generation, not restart;
   * ``corrupt_head`` — the tree is SIGKILLed once checkpoints exist,
     then the newest generation is bit-corrupted on disk before the
     relaunch: lineage fallback again;
   * ``mid_write`` — the hook dies exactly between the head rotation and
     the new-head install (no head on disk at all);

3. every trial's final state is compared leaf-by-leaf against the straight
   run's, and every per-window digest row ever emitted (across kills,
   respawns and resumes, deduplicated by window) must bit-match the
   straight stream. ``--fleet`` runs the whole matrix fleet-shaped
   (per-experiment streams).

**The oracle cross-check** (solo only) pins the straight stream to the
eager numpy oracle: ``--engine cpu`` on the same config and windows, its
digest rows (stderr) equal to the straight run's ring rows window by
window, or the probe exits 3 before any trial. ``--no-oracle`` opts out;
the verdict's ``"oracle_checked"`` says whether the check ran.

Every launch runs ``python -m shadow1_tpu_torch`` with the probe's
``--device`` (default: CUDA, which must be present); the children's record
streams (stdout) and logs (stderr) are both read. Configs are YAML or
JSON (the card has no YAML parser: pass JSON there).

**Fleet recovery matrix** (``--extra``): arbitrary CLI flags ride every
launch, so the same kill matrix runs against the recovery plane — e.g.
``--fleet --extra "--on-overflow retry"`` on an under-capped sweep
(forced overflow: every relaunch must replay its transactional chunks to
the same committed stream) or ``--fleet --extra "--on-overflow halt
--on-lane-fail quarantine"`` on a sweep with one doomed lane (forced
lane-halt: the sweep completes E-1/E; ``--expect-quarantine N`` asserts
the straight run AND every trial quarantined exactly N lanes — the
fleet_quarantine records are counted per trial, deduplicated by lane).
Retry and quarantine are deterministic, so the straight reference stream
already embodies them; a killed+relaunched trial must land bit-identical.

Exit codes: 0 = all trials bit-identical, 3 = divergence, 1 = any other
failure (the last stdout line is a JSON verdict either way; on a mismatch
it names the first divergent (exp, window) and the ``paritytrace``
command that localizes it further).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

EXIT_DIVERGED = 3
MAX_LAUNCHES = 8

RANDOM_KINDS = ("sigkill_group", "sigterm_group",
                "sigkill_child", "sigterm_child")
SPECIAL_KINDS = ("drain", "torn_head", "corrupt_head", "mid_write")
SERVE_KINDS = ("random", "waiting_headroom", "retry_backoff", "deadline")


def _child_pids(ppid: int) -> list[int]:
    """Direct children of ``ppid`` via /proc (no ps dependency)."""
    kids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) == ppid:
                kids.append(int(name))
        except (OSError, IndexError, ValueError):
            continue
    return kids


def _paritytrace(config: str, sides: str, windows: int, chunk=None) -> str:
    """The paritytrace command that bisects a divergence to its first
    (window, subsystem)."""
    cmd = (f"python -m shadow1_tpu_torch.tools.paritytrace {config} "
           f"{sides} --windows {windows}")
    return cmd + (f" --chunk {chunk}" if chunk else "")


def _workdir(args, prefix: str) -> str:
    """``--work`` (made if missing), else a fresh temporary directory: the
    launches' snapshots and captures (the straight run's: ``ref.out``)."""
    if args.work:
        os.makedirs(args.work, exist_ok=True)
        return args.work
    return tempfile.mkdtemp(prefix=prefix)


def _outputs(path: str) -> list[str]:
    """A launch's two capture files: stdout (``path``) and stderr."""
    return [path, path + ".err"]


def _collect_stream(stderr_paths, fleet: bool):
    """(exp, window) → digest tuple from every launch's ring records.

    A window re-run after a resume re-emits its row; the rows must agree
    (determinism) — a conflict is itself a divergence."""
    from shadow1_tpu_torch.telemetry.registry import RING_DIGESTS

    stream: dict = {}
    conflict = None
    resumes: list[dict] = []
    lineage_events: list[dict] = []
    quarantined: dict = {}  # lane gid -> fleet_quarantine record (deduped:
    #                         a relaunch replays the chunk and re-emits it)
    for path in stderr_paths:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            t = rec.get("type")
            if t == "resume":
                resumes.append(rec)
            elif t == "lineage":
                lineage_events.append(rec)
            elif t == "fleet_quarantine":
                quarantined[rec.get("exp")] = rec
            elif t == "ring" and RING_DIGESTS[0] in rec:
                key = (rec.get("exp") if fleet else None, rec["window"])
                val = tuple(rec[f] for f in RING_DIGESTS)
                if key in stream and stream[key] != val and conflict is None:
                    conflict = {"window": key[1], "exp": key[0],
                                "reason": "re-emitted row differs"}
                stream[key] = val
    return stream, conflict, resumes, lineage_events, quarantined


def _npz_equal(a_path: str, b_path: str):
    import numpy as np

    with np.load(a_path) as a, np.load(b_path) as b:
        if set(a.files) != set(b.files):
            return f"member sets differ ({len(a.files)} vs {len(b.files)})"
        for k in a.files:
            if not np.array_equal(a[k], b[k]):
                return f"leaf {k} differs"
    return None


def _corrupt_file(path: str) -> None:
    """Truncate to half — the torn-write shape every filesystem can
    produce; guaranteed to fail the zip/integrity checks."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 1))


def _serve_trials(args) -> int:
    """``--serve N``: the kill-anywhere matrix for the serve daemon.

    Each trial: fresh spool → daemon up → submit a job → SIGKILL the
    daemon at a random real-time offset (covering kill-during-accept,
    kill-mid-validate, kill-mid-batch, kill-after-done) → assert the
    spool holds NO torn record (every ``*.json`` parses — the
    write_json_atomic / atomic-move contract) → restart the daemon on
    the same spool → the job must complete with a digest stream
    bit-identical to the solo CLI run (a from-scratch rerun is
    bit-identical by determinism; a finished job survives untouched).
    The final daemon is SIGTERM-drained (EXIT_SERVE_SHUTDOWN checked).

    ``--serve-kinds`` picks the lifecycle instant per trial (cycled):

    * ``random`` — the classic random-offset kill above;
    * ``waiting_headroom`` — a tight memory budget parks a second tenant
      in waiting_headroom behind a long resident batch; the daemon is
      SIGKILLed in exactly that state — both tenants must complete
      bit-identically after the restart;
    * ``retry_backoff`` — an injected transient crash (countdown file)
      puts the batch into its backoff window; the kill lands mid-backoff
      and the restarted daemon (one crash left on the counter) must
      crash once more, retry, and finish bit-exact;
    * ``deadline`` — a --queue-ttl-s tenant expires mid-run, THEN the
      kill lands: the terminal deadline_expired record must survive the
      restart and the surviving tenant must complete bit-exact."""
    from shadow1_tpu_torch.consts import EXIT_SERVE_SHUTDOWN
    from shadow1_tpu_torch.serve import client
    from shadow1_tpu_torch.serve.protocol import Spool
    from shadow1_tpu_torch.tools.serveprobe import (
        _served_stream,
        _Solo,
        _wait_state,
    )

    rng = random.Random(args.seed)
    work = _workdir(args, "chaosserve_")
    say = (lambda *a: None) if args.json_only else (
        lambda *a: print(*a, file=sys.stderr, flush=True))
    env = dict(os.environ)
    kinds = [k.strip() for k in
             (args.serve_kinds or "random").split(",") if k.strip()]
    unknown = [k for k in kinds if k not in SERVE_KINDS]
    if unknown:
        print(json.dumps({"ok": False, "error":
                          f"unknown --serve-kinds {unknown}; "
                          f"pick from {list(SERVE_KINDS)}"}))
        return 1

    solo = _Solo(args.device, args.timeout_s, env, work)
    try:
        ref = solo(args.config, args.windows)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    if not ref:
        print(json.dumps({"ok": False, "error": "solo reference emitted "
                          "no ring digest rows — the config needs "
                          "engine metrics_ring + state_digest"}))
        return 1
    say(f"[chaosprobe --serve] solo reference: {len(ref)} digest rows")
    est = 0
    if "waiting_headroom" in kinds:
        from shadow1_tpu_torch import mem
        from shadow1_tpu_torch.config.experiment import load_experiment

        exp, params, _ = load_experiment(args.config)
        est = mem.estimate(exp, params).peak_bytes
        if est <= 0:
            print(json.dumps({"ok": False, "error": "memory estimator "
                              "returned no estimate for the config — "
                              "waiting_headroom trials need one"}))
            return 1

    def spawn(spool, err_path, trial_env, extra=()):
        ef = open(err_path, "a")
        cmd = [sys.executable, "-m", "shadow1_tpu_torch", "serve",
               "--spool", spool, "--poll-s", "0.05", *extra]
        if args.device is not None:
            cmd += ["--device", args.device]
        p = subprocess.Popen(cmd, env=trial_env, stdout=subprocess.DEVNULL,
                             stderr=ef)
        deadline = time.monotonic() + 120
        while Spool(spool).daemon_alive() is None:
            if p.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"daemon did not start (rc={p.poll()})")
            time.sleep(0.05)
        return p, ef

    verdicts = []
    torn = []
    for ti in range(args.serve):
        kind = kinds[ti % len(kinds)]
        spool = os.path.join(work, f"t{ti}")
        errp = os.path.join(work, f"t{ti}.stderr")
        # Any trial-infrastructure failure (daemon won't start, SIGTERM
        # wait expires, spool IO) must still end in the JSON verdict
        # contract (callers parse the last stdout line), never a raw
        # traceback with empty stdout.
        p = ef = None
        rc = None
        setup_err = None
        # (job_id, expected_state, bit_compare) per tenant of the trial
        jobs: list[tuple[str, str, bool]] = []
        finals: dict[str, dict] = {}
        env1 = env2 = dict(env)
        extra1 = extra2 = ()
        try:
            if kind == "waiting_headroom":
                env1 = env2 = {**env,
                               "SHADOW1_MEM_BYTES": str(int(est * 1.5))}
            elif kind == "retry_backoff":
                crash = os.path.join(work, f"t{ti}.crash")
                with open(crash, "w") as f:
                    f.write("2")  # one crash per daemon incarnation
                env1 = {**env, "SHADOW1_SERVE_CRASH_BATCH": crash,
                        "SHADOW1_SERVE_RETRY_BACKOFF_S": "3.0"}
                env2 = {**env, "SHADOW1_SERVE_CRASH_BATCH": crash,
                        "SHADOW1_SERVE_RETRY_BACKOFF_S": "0"}
                extra1 = extra2 = ("--ckpt-every-s", "0.05")
            p, ef = spawn(spool, errp, env1, extra1)
            if kind == "waiting_headroom":
                j_a = client.submit(spool, args.config, windows=300)
                jobs.append((j_a, "done", True))
                if _wait_state(spool, j_a, ("running",), 120) is None:
                    raise RuntimeError("resident batch never ran")
                j_b = client.submit(spool, args.config)
                jobs.append((j_b, "done", True))
                if _wait_state(spool, j_b, ("waiting_headroom",),
                               120) is None:
                    raise RuntimeError("tenant never reached "
                                       "waiting_headroom")
            elif kind == "retry_backoff":
                jid = client.submit(spool, args.config)
                jobs.append((jid, "done", True))
                deadline = time.monotonic() + 120
                while True:  # kill lands INSIDE the 3s backoff window
                    st = Spool(spool).read_status(jid) or {}
                    if st.get("retrying"):
                        break
                    if time.monotonic() > deadline:
                        raise RuntimeError("batch never entered retry "
                                           "backoff")
                    time.sleep(0.05)
            elif kind == "deadline":
                j1 = client.submit(spool, args.config, windows=300)
                jobs.append((j1, "done", True))
                if _wait_state(spool, j1, ("running",), 120) is None:
                    raise RuntimeError("resident batch never ran")
                j2 = client.submit(spool, args.config, priority=-1,
                                   queue_ttl_s=0.05)
                jobs.append((j2, "failed", False))
                st = _wait_state(spool, j2, ("failed",), 120)
                if st is None or st.get("reason") != "deadline_expired":
                    raise RuntimeError(f"TTL tenant did not expire: {st}")
            else:  # random: the kill offset sweeps the whole lifecycle
                jid = client.submit(spool, args.config)
                jobs.append((jid, "done", True))
                time.sleep(rng.uniform(0.0, args.serve_kill_s))
            p.kill()
            p.wait()
            ef.close()
            # Torn-record sweep: every committed .json must parse whole.
            for root, _, names in os.walk(spool):
                for name in names:
                    if not name.endswith(".json"):
                        continue
                    fp = os.path.join(root, name)
                    try:
                        with open(fp) as f:
                            json.load(f)
                    except ValueError:
                        torn.append(os.path.relpath(fp, spool))
            p, ef = spawn(spool, errp, env2, extra2)
            try:
                for jid, expect, _cmp in jobs:
                    if expect == "done":
                        try:
                            finals[jid] = client.await_job(
                                Spool(spool), jid,
                                timeout_s=args.timeout_s, poll_s=0.05)
                        except TimeoutError as e:
                            finals[jid] = {"state": f"timeout: {e}"}
                    else:
                        finals[jid] = Spool(spool).read_status(jid) or {}
            finally:
                p.send_signal(signal.SIGTERM)
                rc = p.wait(timeout=60)
        except (RuntimeError, OSError,
                subprocess.TimeoutExpired) as e:
            setup_err = str(e)
        finally:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
            if ef is not None:
                ef.close()
        states_ok = bool(jobs) and setup_err is None and all(
            (finals.get(jid) or {}).get("state") == expect
            for jid, expect, _cmp in jobs)
        compared = 0
        bad = []
        for jid, _expect, cmp_ in jobs:
            if not cmp_:
                continue
            served = _served_stream(spool, jid)
            common = sorted(set(served) & set(ref))
            compared += len(common)
            bad += [w for w in common if served[w] != ref[w]]
            if not common:
                states_ok = False
        ok = states_ok and not bad and rc == EXIT_SERVE_SHUTDOWN
        verdicts.append({
            "trial": ti, "kind": kind,
            "states": {j: (finals.get(j) or {}).get("state")
                       for j, _e, _c in jobs},
            "windows_compared": compared,
            "first_divergence": bad[:1],
            "error": setup_err,
            "shutdown_rc": rc, "ok": bool(ok)})
        say(f"[chaosprobe --serve] trial {ti} ({kind}): "
            + (f"ERROR {setup_err}" if setup_err else
               f"{compared} windows vs solo"
               + (" — DIVERGED" if bad else ", bit-identical")))
    ok = not torn and all(v["ok"] for v in verdicts)
    print(json.dumps({"ok": ok, "trials": args.serve,
                      "kinds": kinds,
                      "torn_records": torn, "verdicts": verdicts}))
    if torn or not ok:
        return EXIT_DIVERGED if any(v["first_divergence"]
                                    for v in verdicts) else 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.chaosprobe")
    ap.add_argument("config", help="experiment file, YAML or JSON")
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=10,
                    help="heartbeat/checkpoint chunk (windows)")
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for kill kinds/offsets")
    ap.add_argument("--keep", type=int, default=3,
                    help="--ckpt-keep lineage depth for the trials")
    ap.add_argument("--fleet", action="store_true",
                    help="run the matrix fleet-shaped (config needs a "
                         "sweep: section)")
    ap.add_argument("--extra", default=None, metavar="FLAGS",
                    help="extra CLI flags for every launch (one shell-"
                         "quoted string), e.g. \"--on-overflow retry\" or "
                         "\"--on-overflow halt --on-lane-fail quarantine\" "
                         "— the fleet recovery trial matrix")
    ap.add_argument("--expect-quarantine", type=int, default=None,
                    metavar="N",
                    help="assert the straight run and every trial "
                         "quarantined exactly N lanes (forced-lane-halt "
                         "matrix)")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the cpu-oracle digest cross-check of the "
                         "straight run (solo only; the fleet has none)")
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="run N serve-daemon kill trials instead of the "
                         "supervised matrix: SIGKILL the daemon at a "
                         "random offset after a submission (including "
                         "mid-accept), assert no torn spool record, "
                         "restart, and bit-compare the completed job "
                         "against the solo run (the config needs "
                         "engine metrics_ring + state_digest)")
    ap.add_argument("--serve-kill-s", type=float, default=2.0,
                    help="--serve: max random kill offset after submit")
    ap.add_argument("--serve-kinds", default="random", metavar="K,K,...",
                    help="--serve: comma list cycled across trials — "
                         f"{', '.join(SERVE_KINDS)}. The non-random "
                         "kinds aim the SIGKILL at a specific lifecycle "
                         "instant (tenant parked in waiting_headroom, "
                         "batch inside its retry-backoff window, just "
                         "after a queue-TTL expiry)")
    ap.add_argument("--timeout-s", type=float, default=600.0,
                    help="per-launch wall timeout")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="run up to N trials at once, after the straight "
                         "run (each trial keeps its own files; the kill "
                         "schedule a --seed gives is the same; every "
                         "trial runs, whatever an earlier one found)")
    ap.add_argument("--work", default=None, metavar="DIR",
                    help="keep the launches' snapshots and captures here "
                         "(default: a fresh temporary directory)")
    ap.add_argument("--device", default=None,
                    help="device of every launch (default: cuda, which "
                         "must be present; cpu to run on the CPU)")
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args(argv)

    if args.device is None:
        import torch

        if not torch.cuda.is_available():
            print(json.dumps({"ok": False, "error": "no CUDA device: the "
                              "trials run on the GPU unless asked for the "
                              "CPU (--device cpu)"}))
            return 1
    if args.serve:
        return _serve_trials(args)
    rng = random.Random(args.seed)
    work = _workdir(args, "chaosprobe_")
    say = (lambda *a: None) if args.json_only else (
        lambda *a: print(*a, file=sys.stderr, flush=True))

    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.consts import EXIT_PREEMPTED

    exp, _, _ = load_experiment(args.config)
    window_ns = exp.window
    env0 = {**os.environ, "SHADOW1_SUPERVISE_BACKOFF_S": "0"}

    base = [sys.executable, "-m", "shadow1_tpu_torch", args.config,
            "--windows", str(args.windows), "--heartbeat", str(args.chunk),
            "--state-digest", "on"]
    if args.device is not None:
        base += ["--device", args.device]
    if args.fleet:
        base.append("--fleet")
    if args.extra:
        import shlex

        base.extend(shlex.split(args.extra))

    # ---- straight reference run -----------------------------------------
    ref_npz = os.path.join(work, "ref.npz")
    ref_out = os.path.join(work, "ref.out")
    t0 = time.perf_counter()
    with open(ref_out, "w") as of, open(ref_out + ".err", "w") as ef:
        r = subprocess.run([*base, "--save-state", ref_npz], env=env0,
                           stdout=of, stderr=ef, timeout=args.timeout_s)
    straight_wall = time.perf_counter() - t0
    if r.returncode != 0:
        print(json.dumps({"ok": False, "error": "straight run failed",
                          "rc": r.returncode, "stderr": ref_out + ".err"}))
        return 1
    ref_stream, conflict, _, _, ref_quar = _collect_stream(
        _outputs(ref_out), args.fleet)
    assert conflict is None
    if not ref_stream:
        print(json.dumps({"ok": False,
                          "error": "straight run emitted no digest rows"}))
        return 1
    say(f"[chaosprobe] straight run: {len(ref_stream)} digest rows, "
        f"{straight_wall:.1f}s wall"
        + (f", {len(ref_quar)} lane(s) quarantined" if ref_quar else ""))
    if args.expect_quarantine is not None \
            and len(ref_quar) != args.expect_quarantine:
        print(json.dumps({
            "ok": False,
            "error": f"straight run quarantined {len(ref_quar)} lane(s), "
                     f"expected {args.expect_quarantine}",
            "quarantined": sorted(ref_quar)}))
        return 1

    # ---- cpu-oracle cross-check of the straight stream ------------------
    oracle_checked = False
    if not args.no_oracle and not args.fleet:
        orc_err = os.path.join(work, "oracle.stderr")
        with open(orc_err, "w") as ef:
            r = subprocess.run(
                [sys.executable, "-m", "shadow1_tpu_torch", args.config,
                 "--engine", "cpu", "--windows", str(args.windows),
                 "--state-digest", "on"],
                env=env0, stdout=subprocess.DEVNULL, stderr=ef,
                timeout=args.timeout_s)
        if r.returncode != 0:
            print(json.dumps({"ok": False, "error": "oracle run failed",
                              "rc": r.returncode, "stderr": orc_err}))
            return 1
        from shadow1_tpu_torch.core.digest import DIGEST_FIELDS

        orc = {}
        with open(orc_err) as f:
            for line in f:
                line = line.strip()
                if line.startswith("{"):
                    rec = json.loads(line)
                    if rec.get("type") == "digest":
                        orc[(None, rec["window"])] = tuple(
                            rec[f] for f in DIGEST_FIELDS)
        if orc != ref_stream:
            bad = sorted(w for w in ref_stream
                         if orc.get(w) != ref_stream[w])[:1]
            print(json.dumps({
                "ok": False, "error": "straight run diverges from the cpu "
                "oracle (not a chaos failure — bisect it first)",
                "first_window": bad,
                "paritytrace": _paritytrace(args.config, "tpu cpu",
                                            args.windows)}))
            return EXIT_DIVERGED
        oracle_checked = True
        say(f"[chaosprobe] oracle cross-check ok ({len(orc)} windows)")

    # ---- trial schedule --------------------------------------------------
    kinds = list(SPECIAL_KINDS[:max(0, min(args.trials,
                                           len(SPECIAL_KINDS)))])
    while len(kinds) < args.trials:
        kinds.append(rng.choice(RANDOM_KINDS))
    rng.shuffle(kinds)

    def trial(ti: int, kind: str, offset: float | None) -> dict:
        """One trial, launched and relaunched to completion: its verdict."""
        ck = os.path.join(work, f"t{ti}.npz")
        fin = os.path.join(work, f"t{ti}_fin.npz")
        errs = []
        launches = 0
        preempted = 0
        killed = 0
        trial_err = None
        mid_kill_boundary = (args.windows // 2) * window_ns
        while launches < MAX_LAUNCHES:
            env = dict(env0)
            if kind == "drain" and launches == 0:
                # Deterministic preemption notice at the mid boundary.
                env["SHADOW1_OBS_SIGTERM_SELF_AT_NS"] = str(mid_kill_boundary)
            if kind == "torn_head" and launches == 1:
                env["SHADOW1_LINEAGE_TORN_HEAD"] = os.path.join(
                    work, f"t{ti}.torn.flag")
            if kind == "mid_write" and launches == 1:
                env["SHADOW1_LINEAGE_CRASH_BETWEEN"] = os.path.join(
                    work, f"t{ti}.between.flag")
            out_path = os.path.join(work, f"t{ti}_l{launches}.out")
            errs.extend(_outputs(out_path))
            with open(out_path, "w") as of, open(out_path + ".err", "w") as ef:
                proc = subprocess.Popen(
                    [*base, "--ckpt", ck, "--ckpt-every-s", "0",
                     "--ckpt-keep", str(args.keep), "--save-state", fin],
                    env=env, stdout=of, stderr=ef,
                    start_new_session=True)
                launches += 1
                want_kill = (launches == 1 and
                             (kind in RANDOM_KINDS
                              or kind in ("corrupt_head", "torn_head",
                                          "mid_write")))
                if want_kill and kind in ("corrupt_head", "torn_head",
                                          "mid_write"):
                    # Kill only once checkpoints exist: poll the progress
                    # sidecar, then SIGKILL the whole tree. The relaunch
                    # then carries the injection env (torn_head/mid_write)
                    # or finds the head corrupted (corrupt_head).
                    deadline = time.time() + args.timeout_s
                    while time.time() < deadline and proc.poll() is None:
                        if os.path.exists(ck + ".progress"):
                            break
                        time.sleep(0.05)
                    if proc.poll() is None:
                        killed += 1
                        os.killpg(proc.pid, signal.SIGKILL)
                elif want_kill:
                    sig = (signal.SIGKILL if kind.startswith("sigkill")
                           else signal.SIGTERM)
                    target_end = time.time() + offset
                    while time.time() < target_end and proc.poll() is None:
                        time.sleep(0.02)
                    if proc.poll() is None:
                        killed += 1
                        if kind.endswith("_child"):
                            kids = _child_pids(proc.pid)
                            if kids:
                                for pid in kids:
                                    try:
                                        os.kill(pid, sig)
                                    except ProcessLookupError:
                                        pass
                            else:  # child not up yet: hit the tree
                                os.killpg(proc.pid, sig)
                        else:
                            os.killpg(proc.pid, sig)
                try:
                    rc = proc.wait(timeout=args.timeout_s)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    trial_err = "launch timeout"
                    break
            if rc == 0:
                break
            if rc == EXIT_PREEMPTED:
                preempted += 1
                continue
            if rc in (1, 2):
                trial_err = f"launch exited rc={rc} (not a kill)"
                break
            # killed / crashed tree: corrupt the head once for the
            # corrupt_head kind, then relaunch-to-resume.
            if kind == "corrupt_head" and launches == 1 \
                    and os.path.exists(ck):
                _corrupt_file(ck)
        else:
            trial_err = trial_err or f"no clean exit in {MAX_LAUNCHES} launches"
        if trial_err is None and not os.path.exists(fin):
            trial_err = "final state was never written"
        stream, conflict, resumes, _events, quar = _collect_stream(
            errs, args.fleet)
        fallbacks = sum(1 for r in resumes if r.get("fallback_skipped"))
        # mid_write leaves no corrupt file to skip — the fallback shows as
        # a resume from a generation older than the torn head's seq.
        if kind in ("torn_head", "mid_write", "corrupt_head"):
            fb_text = any("fall back" in line or "discarding corrupt" in line
                          for p in errs if os.path.exists(p)
                          for line in open(p))
            if fallbacks == 0 and fb_text:
                fallbacks = 1
        mismatch = None
        if trial_err is None:
            mismatch = conflict
            if mismatch is None:
                missing = [k for k in ref_stream if k not in stream]
                if missing:
                    mismatch = {"reason": f"{len(missing)} straight "
                                          f"window(s) never re-emitted",
                                "first": list(missing[0])}
            if mismatch is None:
                for key in sorted(ref_stream):
                    if stream[key] != ref_stream[key]:
                        mismatch = {"exp": key[0], "window": key[1],
                                    "reason": "digest row differs"}
                        break
            if mismatch is None and sorted(quar) != sorted(ref_quar):
                # Quarantine is deterministic: a killed+relaunched trial
                # must slice out exactly the lanes the straight run did.
                mismatch = {"reason": f"quarantined lanes differ: trial "
                                      f"{sorted(quar)} vs straight "
                                      f"{sorted(ref_quar)}"}
            if mismatch is None:
                why = _npz_equal(ref_npz, fin)
                if why:
                    mismatch = {"reason": f"final state differs: {why}"}
        v = {"trial": ti, "kind": kind, "launches": launches,
             "killed": killed, "preempted_exits": preempted,
             "lineage_fallbacks": fallbacks,
             "quarantined": sorted(quar),
             "ok": trial_err is None and mismatch is None}
        if trial_err:
            v["error"] = trial_err
        if mismatch:
            v["mismatch"] = mismatch
        say(f"[chaosprobe] trial {ti} ({kind}): "
            f"{'ok' if v['ok'] else 'FAIL'} — {launches} launch(es), "
            f"{preempted} preempted, {fallbacks} fallback(s)")
        return v

    # The random kinds' kill offsets, drawn in trial order up front: the
    # schedule a --seed gives is the same with --jobs.
    offsets = [rng.uniform(0.05, max(straight_wall, 0.5))
               if k in RANDOM_KINDS else None for k in kinds]
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        verdicts = list(pool.map(trial, range(len(kinds)), kinds, offsets))
    total_launches = sum(v["launches"] for v in verdicts)
    total_preempted = sum(v["preempted_exits"] for v in verdicts)
    total_fallbacks = sum(v["lineage_fallbacks"] for v in verdicts)

    ok = all(v["ok"] for v in verdicts)
    summary = {
        "ok": ok,
        "trials": len(verdicts),
        "windows": args.windows,
        "fleet": bool(args.fleet),
        "extra": args.extra,
        "quarantined": sorted(ref_quar),
        "oracle_checked": oracle_checked,
        "digest_rows": len(ref_stream),
        "launches": total_launches,
        "preempted_exits": total_preempted,
        "lineage_fallbacks": total_fallbacks,
        "kinds": {k: sum(1 for v in verdicts if v["kind"] == k)
                  for k in dict.fromkeys(kinds)},
        "straight_wall_s": round(straight_wall, 1),
    }
    if not ok:
        bad = next(v for v in verdicts if not v["ok"])
        summary["first_failure"] = bad
        summary["paritytrace"] = _paritytrace(
            args.config, "tpu tpu+resume", args.windows, args.chunk)
    print(json.dumps(summary))
    return 0 if ok else EXIT_DIVERGED


if __name__ == "__main__":
    raise SystemExit(main())
