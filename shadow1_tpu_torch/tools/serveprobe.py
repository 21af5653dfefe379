"""serveprobe — end-to-end proof of the serving contract (port of
``tools/serveprobe.py``).

Spawns a real daemon (``python -m shadow1_tpu_torch serve``, a
subprocess), drives it like a tenant population through
``python -m shadow1_tpu_torch submit`` and the client library, and
verifies the acceptance gates of the serve plane (docs/SEMANTICS.md
§"Serving contract") in one invocation:

1. **round-trip bit-exactness**: every completed job's digest stream
   (the ring rows routed into its ``result.jsonl``) bit-matches the
   port's solo CLI run of the same config — packed-lane execution is
   invisible to the tenant;
2. **hot-engine cache**: same-shape jobs submitted SEQUENTIALLY (so they
   land in separate batches) must hit the cache from the second batch on
   — asserted from the daemon ledger's hit counter (no engine built);
3. **admission control**: an over-budget submission (``--overbudget``
   config) is rejected before any engine is built with the
   ``error=memory_budget`` advice record and the submit client exits
   EXIT_MEMORY — while the resident jobs complete normally;
4. **graceful shutdown**: SIGTERM drains the daemon and exits
   EXIT_SERVE_SHUTDOWN.

``--resilience`` runs two more daemons, each on its own spool. The
first (a tight memory budget, ``--queue-depth 2``) proves the serve-plane
resilience gates on ONE run: a job admitted as ``waiting_headroom`` (fits
idle, not the live headroom) completes bit-identical to solo once the
resident batch drains; a submission past the queue cap is rejected
``queue_full`` with retry-after advice (EXIT_QUEUE_FULL taxonomy); a
``--queue-ttl-s`` job that never got a lane expires ``deadline_expired``;
and a batch killed by an injected transient crash
(SHADOW1_SERVE_CRASH_BATCH) retries from its last committed generation
and still bit-matches solo. On the second, a priority-1 submission evicts
a running long batch, whose job then resumes from its checkpoint
bit-identical to solo; a second long job is running when the daemon gets
SIGTERM (EXIT_SERVE_SHUTDOWN, its batch checkpointed into
``queue.json``), and a daemon restarted on the same spool finishes it,
bit-identical to solo.

Configs are YAML or JSON; the jobs are written as JSON, which the
daemon reads without a YAML parser. Every daemon and solo run goes on
``--device`` (default: CUDA, which must be present).

Exit codes: 0 = all gates pass; 3 = digest divergence (a determinism
bug, not a serve bug); 1 = any other failure.

Usage::

    python -m shadow1_tpu_torch.tools.serveprobe CONFIG --seeds 5,6 \\
        [--device cpu] [--overbudget BIGCONFIG] [--mem-bytes N] \\
        [--windows W] [--resilience] [--json-only]

CONFIG needs ``engine: {metrics_ring: W, state_digest: 1}`` so both the
daemon lanes and the solo reference emit the digest stream.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

EXIT_DIVERGED = 3
# The long jobs of the resilience and preemption gates (windows): long
# enough that a submission or a signal lands while they run.
LONG_WINDOWS = 300


def _digest_rows(recs) -> dict[int, tuple]:
    from shadow1_tpu_torch.telemetry.registry import RING_DIGESTS

    return {r["window"]: tuple(r[f] for f in RING_DIGESTS)
            for r in recs if r.get("type") == "ring"}


class _Solo:
    """window → digest words of the port's solo CLI run of a config. Each
    (config, windows) runs once, in its own process, started by
    :meth:`start` ahead of need (a process spends seconds reaching the
    device, so the references run beside the daemons); the record stream
    is the CLI's stdout."""

    def __init__(self, device, timeout_s: float, env, work: str):
        self.device, self.timeout_s, self.env = device, timeout_s, env
        self.work = work
        self._procs: dict[tuple, tuple] = {}
        self._runs: dict[tuple, dict[int, tuple]] = {}

    def start(self, config_path: str, windows=None) -> None:
        key = (config_path, windows)
        if key in self._procs:
            return
        cmd = [sys.executable, "-m", "shadow1_tpu_torch", config_path]
        if self.device is not None:
            cmd += ["--device", self.device]
        if windows is not None:
            cmd += ["--windows", str(windows)]
        out = os.path.join(self.work, f"solo{len(self._procs)}.out")
        with open(out, "w") as fo, open(out + ".err", "w") as fe:
            proc = subprocess.Popen(cmd, env=self.env, stdout=fo, stderr=fe)
        self._procs[key] = (proc, out)

    def __call__(self, config_path: str, windows=None) -> dict[int, tuple]:
        key = (config_path, windows)
        if key not in self._runs:
            self.start(config_path, windows)
            proc, out = self._procs[key]
            rc = proc.wait(timeout=self.timeout_s)
            if rc != 0:
                with open(out + ".err") as f:
                    raise RuntimeError(f"solo reference run failed rc={rc}: "
                                       f"{f.read()[-800:]}")
            recs = []
            with open(out) as f:
                for line in f:
                    if line.startswith("{"):
                        try:
                            recs.append(json.loads(line))
                        except ValueError:
                            continue
            self._runs[key] = _digest_rows(recs)
        return self._runs[key]

    def stop(self) -> None:
        for proc, _ in self._procs.values():
            _stop(proc)


def _served_stream(spool_dir: str, job_id: str) -> dict[int, tuple]:
    from shadow1_tpu_torch.serve.protocol import Spool

    return _digest_rows(Spool(spool_dir).read_results(job_id))


def _compare(spool: str, pairs) -> tuple[str | None, int]:
    """(error or None, windows compared) over (job id, solo rows) pairs."""
    compared = 0
    for jid, solo in pairs:
        served = _served_stream(spool, jid)
        common = sorted(set(served) & set(solo))
        if not common:
            return f"job {jid}: no comparable windows", compared
        bad = [w for w in common if served[w] != solo[w]]
        if bad:
            return f"job {jid} diverges from solo at window {bad[0]}", \
                compared
        compared += len(common)
    return None, compared


def _wait_state(spool_dir: str, job_id: str, states: tuple,
                timeout_s: float) -> dict | None:
    from shadow1_tpu_torch.serve.protocol import Spool

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = Spool(spool_dir).read_status(job_id) or {}
        if st.get("state") in states:
            return st
        time.sleep(0.05)
    return None


def _spawn(spool: str, env, device, err_path: str, *extra):
    """A daemon subprocess on ``spool``, not waited for."""
    cmd = [sys.executable, "-m", "shadow1_tpu_torch", "serve", "--spool",
           spool, "--poll-s", "0.05", *extra]
    if device is not None:
        cmd += ["--device", device]
    with open(err_path, "a") as err:
        return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                stderr=err)


def _wait_up(spool: str, proc) -> str | None:
    """None once the daemon on ``spool`` is live, else an error message."""
    from shadow1_tpu_torch.serve.protocol import Spool

    deadline = time.monotonic() + 120
    while Spool(spool).daemon_alive() is None:
        if proc.poll() is not None or time.monotonic() > deadline:
            return f"daemon did not start (rc={proc.poll()})"
        time.sleep(0.1)
    return None


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _write_json(path: str, doc: dict) -> str:
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _resilience_start(cfgs, docs, work, env, args) -> dict:
    """Spawn the resilience gate's daemon (its own spool, a tight memory
    budget, a depth-2 queue, the crash countdown), not waited for."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.serve.daemon import lane_params

    exp, params, _ = load_experiment(cfgs[0])
    # Priced as the daemon prices a job: one lane under its lane policies.
    est = mem.estimate(exp, lane_params(params),
                       fleet=([exp], None)).peak_bytes
    spool = os.path.join(work, "spool_resilience")
    crash_path = os.path.join(work, "crash_count")
    with open(crash_path, "w") as f:
        f.write("0")
    # One resident tenant fits with room to spare; two do not — the
    # second admission must queue as waiting_headroom, never reject.
    env2 = dict(env)
    env2["SHADOW1_MEM_BYTES"] = str(int(est * 1.5))
    env2["SHADOW1_SERVE_RETRY_BACKOFF_S"] = "0.05"
    env2["SHADOW1_SERVE_CRASH_BATCH"] = crash_path
    # a TTL tenant in its own shape class: never packs into anyone's
    # batch, so it genuinely waits (and expires) in the queue
    doc = json.loads(json.dumps(docs[0]))
    doc.setdefault("general", {})["seed"] = 99
    eng = doc.setdefault("engine", {})
    eng["ev_cap"] = int(eng.get("ev_cap", 32)) * 2
    ttl_cfg = _write_json(os.path.join(work, "ttl.json"), doc)
    proc = _spawn(spool, env2, args.device,
                  os.path.join(work, "daemon2.stderr"),
                  "--queue-depth", "2", "--ckpt-every-s", "0.05")
    return dict(proc=proc, spool=spool, crash=crash_path, ttl_cfg=ttl_cfg,
                budget=int(est * 1.5))


def _resilience_phase(gate, cfgs, args, say, solo):
    """The queued-admission / deadline / retry gate (all on ONE daemon
    run). Returns (error_message_or_None, verdict_dict)."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.consts import (
        EXIT_DEADLINE,
        EXIT_QUEUE_FULL,
        EXIT_SERVE_SHUTDOWN,
    )
    from shadow1_tpu_torch.serve import client
    from shadow1_tpu_torch.serve.protocol import Spool, request

    verdict = {}
    daemon, spool = gate["proc"], gate["spool"]
    crash_path, ttl_cfg = gate["crash"], gate["ttl_cfg"]
    try:
        err = _wait_up(spool, daemon)
        if err:
            return f"resilience {err}", verdict
        say("[serveprobe] resilience daemon up "
            f"(budget {mem.fmt_bytes(gate['budget'])}, queue-depth 2)")

        # A long resident batch to queue behind.
        j_a = client.submit(spool, cfgs[0], windows=LONG_WINDOWS)
        if _wait_state(spool, j_a, ("running",), 120) is None:
            return "long job never started running", verdict
        # B fits idle but not live headroom -> waiting_headroom;
        # C (own shape, low priority, tight TTL) expires in the queue;
        # D overflows the depth-2 queue -> queue_full backpressure.
        j_b = client.submit(spool, cfgs[1 % len(cfgs)])
        j_c = client.submit(spool, ttl_cfg, priority=-1,
                            queue_ttl_s=0.35)
        j_d = client.submit(spool, cfgs[0])

        st_b = _wait_state(spool, j_b, ("waiting_headroom",), 120)
        if st_b is None:
            return ("second tenant never reached waiting_headroom "
                    f"(status {Spool(spool).read_status(j_b)})"), verdict
        verdict["waiting_headroom"] = True
        say("[serveprobe] tenant B admitted waiting_headroom behind the "
            "resident batch")

        st_d = _wait_state(spool, j_d, ("rejected",), 120)
        if st_d is None or (st_d.get("error") or {}).get("error") \
                != "queue_full":
            return f"expected queue_full rejection, got {st_d}", verdict
        if (st_d["error"].get("retry_after_s") or 0) <= 0 \
                or client.exit_code_for(st_d) != EXIT_QUEUE_FULL:
            return f"queue_full record lacks retry advice: {st_d}", verdict
        verdict["queue_full"] = True
        say(f"[serveprobe] over-cap submission rejected queue_full "
            f"(retry after {st_d['error']['retry_after_s']}s)")

        st_c = _wait_state(spool, j_c, ("failed", "done"), 120)
        if st_c is None or st_c.get("reason") != "deadline_expired" \
                or client.exit_code_for(st_c) != EXIT_DEADLINE:
            return f"TTL tenant did not expire: {st_c}", verdict
        verdict["queue_ttl_expired"] = True
        say(f"[serveprobe] TTL tenant expired after "
            f"{st_c['error'].get('waited_s')}s in queue")

        for jid, label in ((j_a, "resident"), (j_b, "waiting")):
            st = _wait_state(spool, jid, ("done", "failed"),
                             args.timeout_s)
            if st is None or st.get("state") != "done":
                return f"{label} tenant did not complete: {st}", verdict

        # Transient-crash retry on the same daemon run: the countdown
        # file buys exactly one injected crash; the batch must retry
        # from its last committed generation and stay bit-exact.
        with open(crash_path, "w") as f:
            f.write("1")
        j_e = client.submit(spool, cfgs[1 % len(cfgs)])
        st_e = _wait_state(spool, j_e, ("done", "failed"),
                           args.timeout_s)
        if st_e is None or st_e.get("state") != "done":
            return f"crash-retried tenant did not complete: {st_e}", \
                verdict
        ledger = request(Spool(spool).sock_path, {"op": "ping"})["ledger"]
        if ledger.get("batch_retries", 0) < 1:
            return f"no batch retry recorded in ledger: {ledger}", verdict
        verdict["transient_retried"] = True
        verdict["ledger"] = ledger
        say(f"[serveprobe] injected crash absorbed: "
            f"{ledger['batch_retries']} batch retry(s)")

        # Bit-exactness across ALL resilience paths on this run.
        solo_b = solo(cfgs[1 % len(cfgs)], args.windows)
        err, compared = _compare(spool, (
            (j_a, solo(cfgs[0], LONG_WINDOWS)), (j_b, solo_b),
            (j_e, solo_b)))
        if err:
            return err, verdict
        verdict["bit_exact_jobs"] = 3
        verdict["windows_compared"] = compared
        say(f"[serveprobe] 3 resilience-path jobs bit-identical to solo "
            f"({compared} windows)")

        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=60)
        if rc != EXIT_SERVE_SHUTDOWN:
            return f"resilience daemon drain rc={rc}", verdict
        return None, verdict
    finally:
        _stop(daemon)


def _preemption_start(work, env, args) -> dict:
    """Spawn the eviction and restart gate's daemon on a third spool,
    not waited for."""
    spool = os.path.join(work, "spool_preempt")
    err_path = os.path.join(work, "daemon3.stderr")
    proc = _spawn(spool, env, args.device, err_path, "--ckpt-every-s", "0.05")
    return dict(proc=proc, spool=spool, err_path=err_path, env=env)


def _preemption_phase(gate, cfgs, args, say, solo):
    """Priority eviction and the SIGTERM drain with a restart. Returns
    (error_message_or_None, verdict_dict)."""
    from shadow1_tpu_torch.consts import EXIT_SERVE_SHUTDOWN
    from shadow1_tpu_torch.serve import client
    from shadow1_tpu_torch.serve.protocol import Spool, request

    verdict = {}
    daemon, spool = gate["proc"], gate["spool"]
    cfg_lo, cfg_hi = cfgs[0], cfgs[1 % len(cfgs)]
    try:
        err = _wait_up(spool, daemon)
        if err:
            return f"preemption {err}", verdict
        # A long priority-0 batch, evicted by a priority-1 arrival.
        j_lo = client.submit(spool, cfg_lo, windows=LONG_WINDOWS)
        if _wait_state(spool, j_lo, ("running",), 120) is None:
            return "long job never started running", verdict
        j_hi = client.submit(spool, cfg_hi, priority=1)
        for jid in (j_hi, j_lo):
            st = _wait_state(spool, jid, ("done", "failed"), args.timeout_s)
            if st is None or st.get("state") != "done":
                return f"job {jid} did not complete: {st}", verdict
        ledger = request(Spool(spool).sock_path, {"op": "ping"})["ledger"]
        evicts = [r for r in Spool(spool).read_results(j_lo)
                  if r.get("event") == "evict"]
        if ledger.get("jobs_evicted", 0) < 1 or not evicts:
            return (f"the priority-1 job evicted nothing (ledger "
                    f"{ledger})"), verdict
        verdict["evicted"] = ledger["jobs_evicted"]
        say(f"[serveprobe] priority-1 job evicted the running batch "
            f"({ledger['jobs_evicted']} eviction(s)); both jobs done")

        # SIGTERM while a long job runs; a restart finishes it.
        j_long = client.submit(spool, cfg_hi, windows=LONG_WINDOWS)
        if _wait_state(spool, j_long, ("running",), 120) is None:
            return "drained job never started running", verdict
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=120)
        if rc != EXIT_SERVE_SHUTDOWN:
            return f"SIGTERM drain rc={rc}", verdict
        with open(Spool(spool).queue_path) as f:
            q = json.load(f)
        if not (q.get("queued") or q.get("resume")):
            return f"the drain persisted no work: {q}", verdict
        verdict["shutdown_rc"] = rc
        verdict["persisted"] = {"queued": len(q.get("queued", [])),
                                "resume": len(q.get("resume", []))}
        say(f"[serveprobe] SIGTERM drained the daemon (rc={rc}); queue "
            f"persisted {verdict['persisted']}")
        daemon = gate["proc"] = _spawn(spool, gate["env"], args.device,
                                       gate["err_path"],
                                       "--ckpt-every-s", "0.05")
        err = _wait_up(spool, daemon)
        if err:
            return f"restarted {err}", verdict
        st = _wait_state(spool, j_long, ("done", "failed"), args.timeout_s)
        if st is None or st.get("state") != "done":
            return f"the restart did not finish the queue: {st}", verdict
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=60)
        if rc != EXIT_SERVE_SHUTDOWN:
            return f"restarted daemon drain rc={rc}", verdict
        err, compared = _compare(spool, (
            (j_lo, solo(cfg_lo, LONG_WINDOWS)), (j_hi, solo(cfg_hi,
                                                           args.windows)),
            (j_long, solo(cfg_hi, LONG_WINDOWS))))
        if err:
            return err, verdict
        verdict["bit_exact_jobs"] = 3
        verdict["windows_compared"] = compared
        say(f"[serveprobe] evicted, evicting and restarted jobs "
            f"bit-identical to solo ({compared} windows)")
        return None, verdict
    finally:
        _stop(daemon)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m shadow1_tpu_torch.tools.serveprobe")
    ap.add_argument("config", help="YAML or JSON experiment file (must "
                                   "carry engine metrics_ring + "
                                   "state_digest)")
    ap.add_argument("--seeds", default="5,6",
                    help="comma list: one same-shape job per seed, "
                         "submitted sequentially (cache-hit proof needs "
                         ">= 2)")
    ap.add_argument("--device", default=None,
                    help="the daemons' and solo runs' device (default: "
                         "cuda, which must be present)")
    ap.add_argument("--overbudget", default=None, metavar="CFG",
                    help="config expected to FAIL admission (memory "
                         "budget) — e.g. configs/mem_overbudget.yaml")
    ap.add_argument("--mem-bytes", type=int, default=None,
                    help="SHADOW1_MEM_BYTES for the daemon (the CPU "
                         "reports no device memory)")
    ap.add_argument("--windows", type=int, default=None)
    ap.add_argument("--resilience", action="store_true",
                    help="also prove the resilience gates on two more "
                         "daemons: waiting_headroom admission, queue_full "
                         "backpressure, --queue-ttl-s expiry, "
                         "injected-transient-crash retry, priority "
                         "eviction and the SIGTERM drain with a restart, "
                         "all bit-compared against solo runs")
    ap.add_argument("--timeout-s", type=float, default=600.0)
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.config.experiment import parse_config
    from shadow1_tpu_torch.consts import EXIT_MEMORY, EXIT_SERVE_SHUTDOWN
    from shadow1_tpu_torch.serve.protocol import Spool, request

    say = (lambda *a: None) if args.json_only else (
        lambda *a: print(*a, file=sys.stderr, flush=True))
    work = tempfile.mkdtemp(prefix="serveprobe_")
    spool = os.path.join(work, "spool")
    env = dict(os.environ)
    if args.mem_bytes is not None:
        env["SHADOW1_MEM_BYTES"] = str(args.mem_bytes)
    solo = _Solo(args.device, args.timeout_s, env, work)

    with open(args.config) as f:
        base_doc = parse_config(f.read())
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    cfgs, docs = [], []
    for i, seed in enumerate(seeds):
        doc = json.loads(json.dumps(base_doc))  # deep copy
        doc.setdefault("general", {})["seed"] = seed
        cfgs.append(_write_json(os.path.join(work, f"job{i}.json"), doc))
        docs.append(doc)

    def fail(msg: str, rc: int = 1, **extra) -> int:
        print(json.dumps({"ok": False, "error": msg, **extra}))
        return rc

    # Every process that can start now does: each spends seconds reaching
    # the device. The solo references and the gates' daemons run beside
    # the first daemon.
    daemon = _spawn(spool, env, args.device,
                    os.path.join(work, "daemon.stderr"))
    gates = {}
    try:
        for cfg in cfgs:
            solo.start(cfg, args.windows)
        if args.resilience:
            solo.start(cfgs[0], LONG_WINDOWS)
            solo.start(cfgs[1 % len(cfgs)], LONG_WINDOWS)
            gates["resilience"] = _resilience_start(cfgs, docs, work, env,
                                                    args)
            gates["preemption"] = _preemption_start(work, env, args)
        err = _wait_up(spool, daemon)
        if err:
            return fail(err)
        say(f"[serveprobe] daemon up (pid {daemon.pid})")

        # ---- sequential same-shape jobs (cache-hit proof) ---------------
        job_ids = []
        for i, cfg in enumerate(cfgs):
            cmd = [sys.executable, "-m", "shadow1_tpu_torch", "submit", cfg,
                   "--spool", spool, "--timeout-s", str(args.timeout_s),
                   "--json-only"]
            if args.windows is not None:
                cmd += ["--windows", str(args.windows)]
            r = subprocess.run(cmd, env=env, capture_output=True,
                               text=True, timeout=args.timeout_s + 30)
            if r.returncode != 0:
                return fail(f"job {i} (seed {seeds[i]}) failed "
                            f"rc={r.returncode}", stderr=r.stderr[-500:])
            final = json.loads(r.stdout.strip().splitlines()[-1])
            job_ids.append(final["job"])
            say(f"[serveprobe] job {i} done: {final['job']} "
                f"(cache {final.get('cache')})")

        ledger = request(Spool(spool).sock_path,
                         {"op": "ping"})["ledger"]
        if len(seeds) >= 2 and ledger.get("cache_hits", 0) < len(seeds) - 1:
            return fail(f"expected >= {len(seeds) - 1} engine-cache "
                        f"hit(s), ledger says {ledger}", ledger=ledger)

        # ---- over-budget admission rejection ----------------------------
        rejected = None
        if args.overbudget:
            r = subprocess.run(
                [sys.executable, "-m", "shadow1_tpu_torch", "submit",
                 args.overbudget, "--spool", spool,
                 "--timeout-s", str(args.timeout_s), "--json-only"],
                env=env, capture_output=True, text=True,
                timeout=args.timeout_s + 30)
            if r.returncode != EXIT_MEMORY:
                return fail(f"over-budget submit: expected EXIT_MEMORY="
                            f"{EXIT_MEMORY}, got rc={r.returncode}",
                            stderr=r.stderr[-500:])
            rejected = json.loads(r.stdout.strip().splitlines()[-1])
            err = rejected.get("error") or {}
            if err.get("error") != "memory_budget" \
                    or "Remedies" not in (err.get("advice") or ""):
                return fail("over-budget rejection lacks the "
                            "memory_budget advice record", status=rejected)
            misses = request(Spool(spool).sock_path,
                             {"op": "ping"})["ledger"]["cache_misses"]
            if misses != ledger["cache_misses"]:
                return fail("the over-budget job built an engine "
                            f"({misses - ledger['cache_misses']} cache "
                            f"miss(es))")
            say(f"[serveprobe] over-budget job rejected before any engine "
                f"build ({err['estimated'] >> 20} MiB est vs "
                f"{err['budget'] >> 20} MiB budget), advice present")

        # ---- digest round-trip vs solo CLI ------------------------------
        mismatches = []
        compared = {}
        for i, (jid, cfg) in enumerate(zip(job_ids, cfgs)):
            served = _served_stream(spool, jid)
            ref = solo(cfg, args.windows)
            common = sorted(set(served) & set(ref))
            if not common:
                return fail(f"job {i}: no comparable ring windows "
                            f"(served {len(served)}, solo {len(ref)}) — "
                            f"does the config carry metrics_ring + "
                            f"state_digest?")
            bad = [w for w in common if served[w] != ref[w]]
            compared[jid] = len(common)
            if bad:
                mismatches.append({"job": jid, "first_window": bad[0]})
            say(f"[serveprobe] job {i}: {len(common)} windows compared "
                f"vs solo{' — DIVERGED' if bad else ', bit-identical'}")
        if mismatches:
            print(json.dumps({
                "ok": False, "error": "served digest stream diverges "
                "from the solo CLI run", "mismatches": mismatches}))
            return EXIT_DIVERGED

        # ---- graceful shutdown ------------------------------------------
        daemon.send_signal(signal.SIGTERM)
        rc = daemon.wait(timeout=60)
        if rc != EXIT_SERVE_SHUTDOWN:
            return fail(f"daemon drain: expected EXIT_SERVE_SHUTDOWN="
                        f"{EXIT_SERVE_SHUTDOWN}, got rc={rc}")
        say(f"[serveprobe] daemon drained cleanly (rc={rc})")

        # The two gates' daemons are independent: their phases run at once.
        phases = {"resilience": _resilience_phase,
                  "preemption": _preemption_phase}
        verdicts = {}
        with ThreadPoolExecutor(max_workers=2) as pool:
            runs = {name: pool.submit(phases[name], gate, cfgs, args, say,
                                      solo)
                    for name, gate in gates.items()}
        for name, run in runs.items():
            err, verdicts[name] = run.result()
            if err:
                return fail(f"{name} gate: {err}", **{name: verdicts[name]})
        print(json.dumps({
            "ok": True,
            "jobs": len(job_ids),
            "windows_compared": compared,
            "ledger": ledger,
            "cache_hits": ledger.get("cache_hits", 0),
            "rejected_overbudget": bool(rejected),
            "shutdown_rc": rc,
            "resilience": verdicts.get("resilience"),
            "preemption": verdicts.get("preemption"),
        }))
        return 0
    finally:
        _stop(daemon)
        for gate in gates.values():
            _stop(gate["proc"])
        solo.stop()


if __name__ == "__main__":
    sys.exit(main())
