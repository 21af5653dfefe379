"""The port's serve plane under stress, on the CPU: eviction, two-tier
admission, backpressure, deadlines, the retry plane, sticky device
faults, spool ownership and the client (the rest of the reference's
``tests/test_serve.py``, against the port's solo runs, each held to the
JAX package's solo run of the same config).

* a higher-priority submission evicts the running batch through the
  preemption plane; the evicted job resumes bit-identically;
* a job that fits the idle device but not the live headroom waits as
  ``waiting_headroom`` and then runs bit-identically; the queue caps by
  depth and by bytes reject with ``queue_full`` and retry advice;
* a queue TTL expires a waiting job; a running deadline keeps the
  committed prefix and leaves the cohabitant unharmed;
* a transient crash retries from the last generation; a deterministic
  failure is not retried; bisection isolates a poisonous tenant;
* a sticky CUDA fault is not retried in process: the daemon stops, and a
  restart on the spool requeues the batch's jobs and finishes them
  bit-identically;
* a stale spool lock is reclaimed and a live one refused; the client's
  exit taxonomy, its reconnects and its watch fallback;
* (slow) a daemon subprocess drains on SIGTERM and a restart finishes the
  queue; ``tools/serveprobe.py`` passes every gate on the CPU.

Tolerance: zero (every compared value is an integer).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from shadow1_tpu_torch.consts import (
    EXIT_CAPACITY,
    EXIT_CONFIG,
    EXIT_DEADLINE,
    EXIT_MEMORY,
    EXIT_OK,
    EXIT_QUEUE_FULL,
    EXIT_SERVE_SHUTDOWN,
)
from shadow1_tpu_torch.serve import client
from shadow1_tpu_torch.serve.daemon import (
    DeviceLostError,
    ServeDaemon,
    SpoolError,
)
from shadow1_tpu_torch.serve.protocol import Spool
from tests.test_torch_serve import (
    jax_solo_stream,
    served_stream,
    solo_stream,
    write_cfg,
)
from tests.test_torch_tgen import _one_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
_SOLO: dict[str, dict[int, tuple]] = {}


def solo(cfg_path) -> dict[int, tuple]:
    """The port's solo stream of ``cfg_path``, held (once per config text)
    to the JAX package's solo stream of the same file, so that a fault
    shared by the port's solo engine and its fleet cannot pass."""
    text = Path(cfg_path).read_text()
    if text not in _SOLO:
        ours = solo_stream(cfg_path)
        assert ours == jax_solo_stream(cfg_path), \
            f"{cfg_path}: the port's solo stream differs from the JAX package's"
        _SOLO[text] = ours
    return _SOLO[text]


@pytest.fixture
def daemon(tmp_path):
    d = ServeDaemon(str(tmp_path / "spool"), poll_s=0.05, ckpt_every_s=1e9,
                    device="cpu")
    d.start()
    yield d
    d.close()


def _serve_events(spool_root) -> list[dict]:
    try:
        with open(Spool(spool_root).log_path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except OSError:
        return []


def _late_submit(spool_root, cfg, out: dict, key: str, delay=0.3, **kw):
    """Submit ``cfg`` from another thread after ``delay`` seconds (it
    lands mid-batch; the daemon's latch sees it at a chunk boundary)."""
    def run():
        time.sleep(delay)
        out[key] = client.submit(spool_root, cfg, **kw)

    t = threading.Thread(target=run)
    t.start()
    return t


# ---------------------------------------------------------------------------
# priority eviction → requeue → bit-identical resume
# ---------------------------------------------------------------------------

def test_eviction_requeues_and_resumes_bitexact(tmp_path, daemon):
    lo_cfg = write_cfg(tmp_path, "lo.yaml", seed=5, stop=600)
    hi_cfg = write_cfg(tmp_path, "hi.yaml", seed=6, stop=40)
    j_lo = client.submit(daemon.spool.root, lo_cfg, priority=0)
    seen = {}
    t = _late_submit(daemon.spool.root, hi_cfg, seen, "hi", priority=5)
    daemon.step()   # j_lo's batch — evicted when the hi-pri job arrives
    t.join(timeout=30)
    assert not t.is_alive()
    st_lo = daemon.spool.read_status(j_lo)
    assert st_lo["state"] == "queued" and st_lo.get("resumed"), st_lo
    assert daemon.ledger_dict()["jobs_evicted"] == 1
    assert daemon.resume, "evicted batch must leave a resume cursor"
    daemon.step()   # the high-priority batch
    daemon.step()   # the evicted batch resumes from its checkpoint
    assert daemon.spool.read_status(seen["hi"])["state"] == "done"
    st_lo = daemon.spool.read_status(j_lo)
    assert st_lo["state"] == "done", st_lo
    # The stream spans eviction + resume and still bit-matches solo.
    assert served_stream(daemon.spool.root, j_lo) == solo(lo_cfg)
    assert served_stream(daemon.spool.root, seen["hi"]) == solo(hi_cfg)
    assert any(r.get("event") == "evict"
               for r in daemon.spool.read_results(j_lo))
    assert daemon.spool.scan_inbox() == []


# ---------------------------------------------------------------------------
# two-tier admission: waiting_headroom + queue_full backpressure
# ---------------------------------------------------------------------------

def test_waiting_headroom_admitted_then_bitexact(tmp_path, daemon,
                                                 monkeypatch):
    a_cfg = write_cfg(tmp_path, "a.yaml", seed=5, stop=400)
    b_cfg = write_cfg(tmp_path, "b.yaml", seed=6, stop=40)
    with open(b_cfg) as f:
        est = daemon._validate({"id": "probe",
                                "config_yaml": f.read()}).est_peak
    assert est > 0
    # Budget fits ONE resident tenant with headroom to spare, but not
    # two: the second submission fits an idle device, so it must queue
    # as waiting_headroom — never be rejected for someone else's load.
    monkeypatch.setenv("SHADOW1_MEM_BYTES", str(int(est * 1.5)))
    j_a = client.submit(daemon.spool.root, a_cfg)
    seen = {}
    t = _late_submit(daemon.spool.root, b_cfg, seen, "b")
    daemon.step()   # A's batch; B admitted waiting_headroom mid-flight
    t.join(timeout=30)
    st_b = daemon.spool.read_status(seen["b"])
    assert st_b["state"] == "waiting_headroom", st_b
    assert daemon.ledger_dict()["jobs_waiting"] == 1
    daemon.step()   # A drained the device; B is schedulable now
    assert daemon.spool.read_status(j_a)["state"] == "done"
    assert daemon.spool.read_status(seen["b"])["state"] == "done"
    assert served_stream(daemon.spool.root, j_a) == solo(a_cfg)
    assert served_stream(daemon.spool.root, seen["b"]) == solo(b_cfg)
    assert any(e.get("type") == "serve_queue"
               and e.get("event") == "waiting_headroom"
               for e in _serve_events(daemon.spool.root))


@pytest.mark.parametrize("cap", ["depth", "bytes"])
def test_queue_full_rejects_with_retry_advice(tmp_path, cap):
    if cap == "depth":
        kw = {"queue_depth": 1}
    else:
        probe = ServeDaemon(str(tmp_path / "probe_sp"), device="cpu")
        with open(write_cfg(tmp_path, "p.yaml", seed=5)) as f:
            est = probe._validate({"id": "p",
                                   "config_yaml": f.read()}).est_peak
        assert est > 0
        kw = {"queue_bytes": est}
    d = ServeDaemon(str(tmp_path / "sp"), poll_s=0.05, ckpt_every_s=1e9,
                    device="cpu", **kw).start()
    try:
        j1 = client.submit(d.spool.root, write_cfg(tmp_path, "a.yaml",
                                                   seed=5))
        j2 = client.submit(d.spool.root, write_cfg(tmp_path, "b.yaml",
                                                   seed=6))
        d._intake()
        assert (d.spool.read_status(j1) or {}).get("state") == "queued"
        st2 = d.spool.read_status(j2)
        assert st2["state"] == "rejected", st2
        err = st2["error"]
        assert err["error"] == "queue_full" and err["cap"] == cap
        assert err["retry_after_s"] > 0
        if cap == "depth":
            assert err["queue_depth"] == err["queue_depth_cap"] == 1
        else:
            assert err["queue_bytes_cap"] == kw["queue_bytes"]
        assert client.exit_code_for(st2) == EXIT_QUEUE_FULL
        led = d.ledger_dict()
        assert led["jobs_queue_full"] == 1 and led["queue_depth"] == 1
    finally:
        d.close()


# ---------------------------------------------------------------------------
# deadlines: queue TTL + running wall-time bound (committed prefix)
# ---------------------------------------------------------------------------

def test_queue_ttl_expires_waiting_job(tmp_path, daemon):
    a_cfg = write_cfg(tmp_path, "a.yaml", seed=5, stop=100)
    # another shape class (ev_cap): never packs into A's batch, so it sits
    # queued while A runs and crosses its TTL at a chunk boundary
    t_cfg = write_cfg(tmp_path, "t.yaml", seed=6, ev_cap=64)
    j_a = client.submit(daemon.spool.root, a_cfg)
    j_t = client.submit(daemon.spool.root, t_cfg, queue_ttl_s=0.01)
    daemon.step()
    st_t = daemon.spool.read_status(j_t)
    assert st_t["state"] == "failed" and st_t["reason"] == "deadline_expired"
    assert st_t["error"]["kind"] == "queue_ttl"
    assert st_t["error"]["waited_s"] > 0.01
    assert client.exit_code_for(st_t) == EXIT_DEADLINE
    assert daemon.ledger_dict()["jobs_expired"] == 1
    recs = Spool(daemon.spool.root).read_results(j_t)
    assert any(r.get("type") == "serve_deadline"
               and r.get("kind") == "queue_ttl" for r in recs)
    assert daemon.spool.read_status(j_a)["state"] == "done"


def test_running_deadline_keeps_prefix_cohabitant_unharmed(tmp_path,
                                                           daemon):
    a_cfg = write_cfg(tmp_path, "a.yaml", seed=5, stop=200)
    b_cfg = write_cfg(tmp_path, "b.yaml", seed=6, stop=200)
    j_a = client.submit(daemon.spool.root, a_cfg, deadline_s=0.05)
    j_b = client.submit(daemon.spool.root, b_cfg)
    daemon.step()   # shared batch; A expires at the first chunk boundary
    st_a = daemon.spool.read_status(j_a)
    assert st_a["state"] == "failed" and st_a["reason"] == "deadline_expired"
    assert st_a["error"]["kind"] == "running"
    assert st_a["error"]["ran_s"] > 0.05
    assert client.exit_code_for(st_a) == EXIT_DEADLINE
    # the committed prefix survives, bit-identical to the same prefix of
    # the straight solo run — a deadline is a bound, not a rollback
    solo_a = solo(a_cfg)
    prefix = served_stream(daemon.spool.root, j_a)
    assert prefix and len(prefix) < len(solo_a)
    assert all(solo_a[w] == row for w, row in prefix.items())
    daemon.step()   # B resumes from the sliced snapshot
    st_b = daemon.spool.read_status(j_b)
    assert st_b["state"] == "done", st_b
    assert served_stream(daemon.spool.root, j_b) == solo(b_cfg)
    # the cohabitant resumed from the lane-sliced checkpoint, not a
    # from-scratch rerun
    assert not any(e.get("event") == "cursor_discarded"
                   for e in _serve_events(daemon.spool.root))


# ---------------------------------------------------------------------------
# transient-failure retry, blast-radius bisection, sticky device faults
# ---------------------------------------------------------------------------

def test_transient_crash_retries_bitexact(tmp_path, daemon, monkeypatch):
    import shadow1_tpu_torch.fleet.run as fleet_run

    real = fleet_run.run_fleet
    calls = []

    def flaky(engine, st=None, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected transport flake")
        return real(engine, st, **kw)

    monkeypatch.setattr(fleet_run, "run_fleet", flaky)
    monkeypatch.setenv("SHADOW1_SERVE_RETRY_BACKOFF_S", "0")
    cfg = write_cfg(tmp_path, "a.yaml", seed=5)
    jid = client.submit(daemon.spool.root, cfg)
    assert daemon.step()   # crash -> scheduled for retry, NOT failed
    st = daemon.spool.read_status(jid)
    assert st["state"] == "queued" and st.get("retrying"), st
    assert daemon.ledger_dict()["batch_retries"] == 1
    assert daemon.resume, "transient crash must leave a retry cursor"
    assert daemon.step()   # the retry attempt
    assert daemon.spool.read_status(jid)["state"] == "done"
    assert served_stream(daemon.spool.root, jid) == solo(cfg)
    assert any(e.get("type") == "serve_retry" and e.get("event") == "retry"
               for e in _serve_events(daemon.spool.root))


def test_injected_crash_hook_retries_from_generation(tmp_path, monkeypatch):
    """SHADOW1_SERVE_CRASH_BATCH (serveprobe's handle): one count buys one
    crash at the batch's second chunk boundary, after a generation was
    committed; the retry resumes from it, bit-identical to solo."""
    crash = tmp_path / "crash"
    crash.write_text("1")
    monkeypatch.setenv("SHADOW1_SERVE_CRASH_BATCH", str(crash))
    monkeypatch.setenv("SHADOW1_SERVE_RETRY_BACKOFF_S", "0")
    d = ServeDaemon(str(tmp_path / "sp"), poll_s=0.05, ckpt_every_s=0,
                    device="cpu").start()
    try:
        cfg = write_cfg(tmp_path, "a.yaml", seed=5)
        jid = client.submit(d.spool.root, cfg)
        while d.step():
            pass
        assert crash.read_text() == "0"
        assert d.ledger_dict()["batch_retries"] == 1
        assert d.spool.read_status(jid)["state"] == "done"
        starts = [e for e in _serve_events(d.spool.root)
                  if e.get("event") == "batch_start"]
        assert [s["resumed"] for s in starts] == [False, True]
        assert served_stream(d.spool.root, jid) == solo(cfg)
    finally:
        d.close()


def test_deterministic_failure_not_retried(tmp_path, daemon, monkeypatch):
    import shadow1_tpu_torch.fleet.run as fleet_run
    from shadow1_tpu_torch.txn import SelfCheckError

    def det(engine, st=None, **kw):
        raise SelfCheckError({"pkts_sent": 1}, 1, "injected")

    monkeypatch.setattr(fleet_run, "run_fleet", det)
    jid = client.submit(daemon.spool.root,
                        write_cfg(tmp_path, "a.yaml", seed=5))
    assert daemon.step()
    st = daemon.spool.read_status(jid)
    # a self-check violation reproduces on retry, so the job fails at
    # once — no backoff cursor, no retry counter
    assert st["state"] == "failed" and st["reason"] == "runtime", st
    assert daemon.ledger_dict()["batch_retries"] == 0
    assert not daemon.resume


def test_oom_is_deterministic_memory_exhausted(tmp_path, daemon,
                                               monkeypatch):
    import torch

    import shadow1_tpu_torch.fleet.run as fleet_run

    def oom(engine, st=None, **kw):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB (injected)")

    monkeypatch.setattr(fleet_run, "run_fleet", oom)
    jid = client.submit(daemon.spool.root,
                        write_cfg(tmp_path, "a.yaml", seed=5))
    assert daemon.step()
    st = daemon.spool.read_status(jid)
    assert st["state"] == "failed" and st["reason"] == "memory_exhausted"
    assert client.exit_code_for(st) == EXIT_MEMORY
    assert daemon.ledger_dict()["batch_retries"] == 0


def test_bisection_isolates_poisonous_tenant(tmp_path, daemon,
                                             monkeypatch):
    import shadow1_tpu_torch.fleet.run as fleet_run

    real = fleet_run.run_fleet

    def poisoned(engine, st=None, **kw):
        if any(l.get("seed") == 5 for l in (kw.get("labels") or [])):
            raise RuntimeError("poisonous tenant aboard")
        return real(engine, st, **kw)

    monkeypatch.setattr(fleet_run, "run_fleet", poisoned)
    monkeypatch.setenv("SHADOW1_SERVE_RETRY_BACKOFF_S", "0")
    bad_cfg = write_cfg(tmp_path, "bad.yaml", seed=5)
    ok_cfg = write_cfg(tmp_path, "ok.yaml", seed=6)
    j_bad = client.submit(daemon.spool.root, bad_cfg)
    j_ok = client.submit(daemon.spool.root, ok_cfg)
    assert daemon.step()   # crash #1: the pair retries together
    assert daemon.ledger_dict()["batch_retries"] == 1
    assert daemon.step()   # crash #2: bisect the suspects into solos
    assert daemon.ledger_dict()["jobs_bisected"] == 2
    for j in (j_bad, j_ok):
        st = daemon.spool.read_status(j)
        assert st["state"] == "queued" and st.get("solo"), st
    assert daemon.step()   # j_bad solo -> crash #3 -> retries exhausted
    st_bad = daemon.spool.read_status(j_bad)
    assert st_bad["state"] == "failed" and st_bad["reason"] == \
        "retry_exhausted"
    assert len(st_bad["error"]["crashes"]) == 3  # the full crash ledger
    assert client.exit_code_for(st_bad) == 1
    assert daemon.step()   # j_ok solo runs clean, bit-exact
    assert daemon.spool.read_status(j_ok)["state"] == "done"
    assert served_stream(daemon.spool.root, j_ok) == solo(ok_cfg)
    assert any(e.get("type") == "serve_retry" and e.get("event") == "bisect"
               for e in _serve_events(daemon.spool.root))


@pytest.mark.parametrize("text", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA kernel 'pop' failed to launch: CUDA error: unspecified launch "
    "failure (cudaError 719)",
])
def test_sticky_cuda_fault_stops_daemon_restart_finishes(tmp_path,
                                                         monkeypatch, text):
    """A sticky CUDA fault has lost the process's context: the daemon does
    not retry in process (DeviceLostError, queue persisted, the jobs left
    non-terminal); a daemon restarted on the spool requeues them from
    scratch and finishes them bit-identically."""
    import shadow1_tpu_torch.fleet.run as fleet_run

    real = fleet_run.run_fleet

    def sticky(engine, st=None, **kw):
        raise RuntimeError(text)

    spool = str(tmp_path / "sp")
    cfgs = [write_cfg(tmp_path, f"{s}.yaml", seed=s) for s in (5, 6)]
    d = ServeDaemon(spool, poll_s=0.05, ckpt_every_s=1e9,
                    device="cpu").start()
    try:
        jids = [client.submit(spool, c) for c in cfgs]
        queued = client.submit(spool, write_cfg(tmp_path, "q.yaml", seed=7,
                                                ev_cap=64))
        monkeypatch.setattr(fleet_run, "run_fleet", sticky)
        with pytest.raises(DeviceLostError):
            d.step()
        assert d.ledger_dict()["batch_retries"] == 0
        for j in jids:
            assert Spool(spool).read_status(j)["state"] == "running"
        assert any(e.get("event") == "device_lost"
                   for e in _serve_events(spool))
    finally:
        d.close()
    monkeypatch.setattr(fleet_run, "run_fleet", real)
    d2 = ServeDaemon(spool, poll_s=0.05, ckpt_every_s=1e9,
                     device="cpu").start()
    try:
        while d2.step():
            pass
        for j, c in zip(jids, cfgs):
            assert d2.spool.read_status(j)["state"] == "done"
            assert served_stream(spool, j) == solo(c)
        assert d2.spool.read_status(queued)["state"] == "done"
    finally:
        d2.close()


# ---------------------------------------------------------------------------
# spool ownership: stale-lock reclaim vs live-lock refusal
# ---------------------------------------------------------------------------

def test_stale_lock_reclaimed_live_lock_refused(tmp_path):
    import socket as socketlib

    spool = Spool(str(tmp_path / "s")).ensure()
    # a SIGKILLed same-host daemon: dead pid, heartbeat still fresh —
    # the pid check is authoritative on the same host
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    with open(spool.daemon_path, "w") as f:
        json.dump({"pid": p.pid, "host": socketlib.gethostname(),
                   "started_at": time.time(),
                   "heartbeat_at": time.time()}, f)
    assert spool.daemon_alive() is None
    d = ServeDaemon(spool.root, device="cpu").start()   # reclaims
    try:
        assert any(e.get("event") == "lock_reclaimed"
                   for e in _serve_events(spool.root))
        # while it lives, a second daemon is refused (the flock)
        with pytest.raises(SpoolError):
            ServeDaemon(spool.root, device="cpu").start()
    finally:
        d.close()
    # a live cross-host holder (an NFS spool: its flock is not visible
    # here) with a fresh heartbeat: refused
    with open(spool.daemon_path, "w") as f:
        json.dump({"pid": 1, "host": "elsewhere.example",
                   "heartbeat_at": time.time()}, f)
    with pytest.raises(SpoolError):
        ServeDaemon(spool.root, device="cpu").start()
    # the same holder gone silent past STALE_AFTER_S: reclaimable
    old = time.time() - 3600
    with open(spool.daemon_path, "w") as f:
        json.dump({"pid": 1, "host": "elsewhere.example",
                   "heartbeat_at": old, "started_at": old}, f)
    os.utime(spool.daemon_path, (old, old))
    ServeDaemon(spool.root, device="cpu").start().close()


def test_restart_sweeps_stale_batch_lineage_keeps_quarantines(tmp_path):
    spool = Spool(str(tmp_path / "s")).ensure()
    for name, body in (("b000003.npz", "stale"),
                       ("b000003.npz.lineage", "{}"),
                       ("b000003.npz.q1.npz", "deliverable")):
        Path(spool.batches, name).write_text(body)
    d = ServeDaemon(spool.root, device="cpu").start()
    try:
        assert not os.path.exists(os.path.join(spool.batches, "b000003.npz"))
        assert not os.path.exists(
            os.path.join(spool.batches, "b000003.npz.lineage"))
        assert os.path.exists(os.path.join(spool.batches,
                                           "b000003.npz.q1.npz"))
        assert d._batch_seq == 4
    finally:
        d.close()


# ---------------------------------------------------------------------------
# the client: exit taxonomy, reconnects, watch fallback
# ---------------------------------------------------------------------------

def test_client_exit_taxonomy():
    f = client.exit_code_for
    assert f({"state": "done"}) == EXIT_OK
    assert f({"state": "rejected",
              "error": {"error": "memory_budget"}}) == EXIT_MEMORY
    assert f({"state": "rejected", "error": {"error": "config"}}) == \
        EXIT_CONFIG
    assert f({"state": "failed", "reason": "capacity"}) == EXIT_CAPACITY
    assert f({"state": "failed", "reason": "memory_exhausted"}) == \
        EXIT_MEMORY
    assert f({"state": "rejected", "error": {
        "error": "queue_full", "retry_after_s": 0.5}}) == EXIT_QUEUE_FULL
    for kind in ("queue_ttl", "running"):
        assert f({"state": "failed", "reason": "deadline_expired",
                  "error": {"error": "deadline_expired",
                            "kind": kind}}) == EXIT_DEADLINE
    assert f({"state": "failed", "reason": "retry_exhausted"}) == 1


def test_client_request_retry_reconnects(tmp_path, capsys):
    import socket as socketlib

    sock_path = str(tmp_path / "x.sock")
    srv = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(2)

    def flap_then_serve():
        c1, _ = srv.accept()
        c1.close()          # the flap: drop the first connection cold
        c2, _ = srv.accept()
        f = c2.makefile("rw", encoding="utf-8")
        f.readline()
        f.write('{"ok": true}\n')
        f.flush()
        c2.close()

    t = threading.Thread(target=flap_then_serve, daemon=True)
    t.start()
    out = client.request_retry(sock_path, {"op": "ping"}, attempts=4,
                               base_s=0.01)
    t.join(timeout=5)
    srv.close()
    assert not t.is_alive()
    assert out == {"ok": True}
    assert '"reconnected"' in capsys.readouterr().err


def test_client_watch_falls_back_on_dead_socket(tmp_path):
    # exhausted reconnect budget -> None, the await_job polling fallback
    assert client.watch(str(tmp_path / "absent.sock"), "j", attempts=2,
                        base_s=0.01, timeout_s=2.0) is None


def test_socket_ops_and_watch_stream(tmp_path, daemon):
    """The socket plane: ping carries the ledger, submit writes the inbox,
    status reads the record, watch streams to the terminal state."""
    from shadow1_tpu_torch.serve.protocol import request

    sock = daemon.spool.sock_path
    assert request(sock, {"op": "ping"})["ledger"]["jobs_submitted"] == 0
    with open(write_cfg(tmp_path, "a.yaml")) as f:
        jid = request(sock, {"op": "submit", "job": {
            "config_yaml": f.read(), "priority": 0}})["id"]
    seen = []
    t = threading.Thread(target=lambda: seen.append(client.watch(
        sock, jid, timeout_s=60)), daemon=True)
    t.start()
    daemon.step()
    t.join(timeout=30)
    assert not t.is_alive() and seen[0]["state"] == "done"
    assert request(sock, {"op": "status", "id": jid})["state"] == "done"
    assert request(sock, {"op": "nope"})["ok"] is False


# ---------------------------------------------------------------------------
# subprocesses (slow): the SIGTERM drain and restart; serveprobe
# ---------------------------------------------------------------------------

def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT)}


@pytest.mark.slow
def test_daemon_sigterm_drains_and_restart_finishes(tmp_path):
    spool = str(tmp_path / "spool")
    cfg = write_cfg(tmp_path, "long.yaml", seed=5, stop=400)

    def spawn():
        p = subprocess.Popen(
            [sys.executable, "-m", "shadow1_tpu_torch", "serve", "--spool",
             spool, "--poll-s", "0.05", "--device", "cpu"],
            env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        deadline = time.monotonic() + 60
        while Spool(spool).daemon_alive() is None:
            assert p.poll() is None, p.stderr.read()[-800:]
            assert time.monotonic() < deadline
            time.sleep(0.1)
        return p

    p = spawn()
    try:
        jid = client.submit(spool, cfg)
        deadline = time.monotonic() + 120
        while (Spool(spool).read_status(jid) or {}).get("state") \
                != "running":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=120)
        assert rc == EXIT_SERVE_SHUTDOWN, p.stderr.read()[-800:]
        with open(os.path.join(spool, "queue.json")) as f:
            q = json.load(f)
        assert q["queued"] or q["resume"], q
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    p = spawn()
    try:
        final = client.await_job(Spool(spool), jid, timeout_s=300,
                                 poll_s=0.1)
        assert final["state"] == "done", final
        assert served_stream(spool, jid) == solo(cfg)
    finally:
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == EXIT_SERVE_SHUTDOWN


@pytest.mark.slow
def test_serveprobe_passes_every_gate_on_cpu(tmp_path):
    over = tmp_path / "over.json"
    over.write_text(json.dumps({
        "general": {"seed": 1, "stop_time": "1 s"},
        "engine": {"scheduler": "tpu", "ev_cap": 512, "outbox_cap": 64},
        "network": {"single_vertex": {"latency": "10 ms"}},
        "hosts": [{"name": "h", "count": 4096}],
        "app": {"model": "phold",
                "params": {"mean_delay_ns": 2.0e7, "init_events": 8}}}))
    r = subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch.tools.serveprobe",
         str(ROOT / "configs" / "serve_phold.yaml"), "--device", "cpu",
         "--overbudget", str(over), "--mem-bytes", str(64 << 20),
         "--resilience"],
        env=_env(), capture_output=True, text=True, timeout=900,
        cwd=tmp_path)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["cache_hits"] >= 1 and out["rejected_overbudget"]
    assert out["resilience"]["bit_exact_jobs"] == 3
    assert out["preemption"]["bit_exact_jobs"] == 3
