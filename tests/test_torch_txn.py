"""The port's transactional overflow plane (``shadow1_tpu_torch/txn.py``)
against the JAX package's ``txn.py``, on the CPU.

* retry: an under-capped 8-host PHOLD (``ev_cap`` 8: its fill reaches 14)
  under ``OverflowGuard(mode="retry")`` gives the JAX guard's digest
  stream, metrics, report and resize records, and equals the JAX straight
  run at the final cap; the outbox cap grows the same way (PHOLD's outbox
  use is drop-counted); a TCP model (two fidelity tiles: NIC bounds, RED,
  the virtual CPU, restarts) grows ``ev_cap`` from 24 and equals the JAX
  straight run at the final cap, leaf by leaf;
* the rollback point is a copy: it shares no storage with the state the
  chunk runs on, and with a plain pop that writes its planes in place,
  as the CUDA kernel does, retry stays bit-exact;
* a checkpoint of a retried run resumes at the snapshot's caps;
* halt: ``CapacityExceededError``'s fields and message equal JAX's;
* self-check: a clean run passes every boundary, and a violation names
  its counters as the reference's does;
* the controller absorbs a retry-driven grow (its floor ratchets);
* the CLI: ``--on-overflow retry`` reports its retries in the heartbeats
  and the result line, ``halt`` exits ``EXIT_CAPACITY`` with the
  reference's record, and the supervisor does not respawn it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from shadow1_tpu import txn as txn_j
from shadow1_tpu.ckpt import run_chunked as run_chunked_j
from shadow1_tpu.consts import MS
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.telemetry.ring import drain_ring as drain_j
from shadow1_tpu_torch import ckpt as ckpt_t
from shadow1_tpu_torch import convert, mem
from shadow1_tpu_torch import txn as txn_t
from shadow1_tpu_torch.ckpt import run_chunked as run_chunked_t
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import EXIT_CAPACITY
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.obs import run_with_heartbeat
from shadow1_tpu_torch.telemetry.ring import drain_ring as drain_t
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import _one_thread, assert_same_leaves  # noqa: F401
from tests.test_torch_tune import both

ROOT = Path(__file__).resolve().parents[1]
N_WINDOWS, CHUNK = 40, 10
SMALL_CAP = 8  # overflows this workload (ev_max_fill reaches 14)
PHOLD = dict(n_hosts=8, seed=5, end_time=N_WINDOWS * MS, latency_ns=1 * MS,
             model="phold",
             model_cfg={"mean_delay_ns": float(2 * MS), "init_events": 6})


def ring_params(**kw) -> dict:
    return dict(metrics_ring=CHUNK, state_digest=1, **kw)


def stream(pkg, exp, params: dict, mode=None, windows=N_WINDOWS,
           chunk=CHUNK):
    """(digest rows drained at every committed boundary, final state,
    guard) of a chunked run, under a guard when ``mode`` is given."""
    if pkg == "jax":
        eng = EngineJ(exp, EngineParamsJ(**params))
        guard = (txn_j.OverflowGuard(eng, make_engine=lambda p: EngineJ(exp, p),
                                     mode=mode) if mode else None)
        run, drain = run_chunked_j, drain_j
    else:
        eng = EngineT(exp, EngineParamsT(**params), device="cpu")
        guard = (txn_t.OverflowGuard(eng, make_engine=eng.at_caps, mode=mode)
                 if mode else None)
        run, drain = run_chunked_t, drain_t
    rows, start = [], [0]

    def on_chunk(s, _done):
        rows.extend(drain(s, exp.window, start=start[0]))
        start[0] = int(s.metrics.windows)

    st = run(eng, n_windows=windows, chunk=chunk, on_chunk=on_chunk,
             guard=guard)
    return rows, st, guard


def test_retry_matches_reference_phold():
    exp_j, exp_t = both(PHOLD)
    rows_j, st_j, g_j = stream("jax", exp_j, ring_params(ev_cap=SMALL_CAP),
                               "retry")
    rows_t, st_t, g_t = stream("torch", exp_t, ring_params(ev_cap=SMALL_CAP),
                               "retry")
    assert g_t.chunk_retries >= 1 and g_t.retry_windows_rerun >= CHUNK
    assert g_t.report() == g_j.report() and g_t.resizes == g_j.resizes
    assert rows_t == rows_j and len(rows_t) == N_WINDOWS
    assert EngineT.metrics_dict(st_t) == EngineJ.metrics_dict(st_j)
    assert int(st_t.metrics.ev_overflow) == 0
    # The straight run at the final cap: the same stream.
    final = g_t.final_caps["ev_cap"]
    rows_s, st_s, _ = stream("jax", exp_j, ring_params(ev_cap=final))
    assert rows_t == rows_s
    assert_same_leaves(jax.tree.map(np.asarray, st_s),
                       convert.state_to_numpy(st_t))


def test_retry_grows_outbox_cap_phold():
    exp_j, exp_t = both(PHOLD)
    params = ring_params(ev_cap=32, outbox_cap=4)
    rows_t, st_t, g_t = stream("torch", exp_t, params, "retry")
    assert g_t.chunk_retries >= 1 and int(st_t.metrics.ob_overflow) == 0
    ob = g_t.final_caps["outbox_cap"]
    assert ob > 4
    rows_j, st_j, _ = stream("jax", exp_j, dict(params, outbox_cap=ob))
    assert rows_t == rows_j
    assert EngineT.metrics_dict(st_t) == EngineJ.metrics_dict(st_j)


FID_WINDOWS, FID_CHUNK = 11, 2


def test_retry_grows_ev_cap_on_tcp():
    """Two fidelity tiles (every gate on) from ev_cap 24 in chunks of two
    windows: the guard grows the cap on the way, and the committed run
    equals the JAX straight run at the final cap — digest rows, metrics
    and every state leaf."""
    exp = ct.fidelity_filexfer_experiment(2, 42, 400 * MS)
    params = dict(ev_cap=24, metrics_ring=FID_WINDOWS, state_digest=1)
    rows_t, st_t, g_t = stream("torch", exp, params, "retry",
                               windows=FID_WINDOWS, chunk=FID_CHUNK)
    assert g_t.chunk_retries >= 1
    final = g_t.final_caps["ev_cap"]
    assert final > 24 and all("ev_cap" in r for r in g_t.resizes)
    rows_j, st_j, _ = stream("jax", jax_experiment(exp),
                             dict(params, ev_cap=final), windows=FID_WINDOWS,
                             chunk=FID_WINDOWS)
    assert rows_t == rows_j
    assert EngineT.metrics_dict(st_t) == EngineJ.metrics_dict(st_j)
    assert_same_leaves(jax.tree.map(np.asarray, st_j),
                       convert.state_to_numpy(st_t))


def _in_place_pop(monkeypatch):
    """The engine's pop, writing its planes into the buffer it was given,
    as the CUDA kernel does (the plain version returns new tensors)."""
    from shadow1_tpu_torch.core import engine, events

    def pop_until(buf, until, extract="sum"):
        new, ev = events.pop_until_plain(buf, until, extract)
        buf.kind.copy_(new.kind)
        buf.t32.copy_(new.t32)
        return new._replace(kind=buf.kind, t32=buf.t32), ev

    monkeypatch.setattr(engine, "pop_until", pop_until)


def test_rollback_is_a_copy(monkeypatch):
    """The guard's rollback point shares no storage with the state the
    chunk runs on; with a pop that updates the planes in place, retry
    still equals the straight run at the final cap."""
    _in_place_pop(monkeypatch)
    _, exp = both(PHOLD)
    shared = []
    keep = txn_t.OverflowGuard.rollback_point

    def rollback_point(self, st):
        copy = keep(self, st)
        shared.append(set(mem.storage_ptrs(st)) & set(mem.storage_ptrs(copy)))
        return copy

    monkeypatch.setattr(txn_t.OverflowGuard, "rollback_point", rollback_point)
    rows, st, g = stream("torch", exp, ring_params(ev_cap=SMALL_CAP), "retry")
    assert g.chunk_retries >= 1
    # One rollback per chunk and one fresh clone per replay.
    assert len(shared) == N_WINDOWS // CHUNK + g.chunk_retries
    assert all(not s for s in shared)
    monkeypatch.undo()
    _in_place_pop(monkeypatch)
    rows_s, st_s, _ = stream("torch", exp,
                             ring_params(ev_cap=g.final_caps["ev_cap"]))
    assert rows == rows_s
    assert EngineT.metrics_dict(st) == EngineT.metrics_dict(st_s)


def test_resume_from_ckpt_of_retried_run(tmp_path):
    """A snapshot taken after a retry is at the grown caps; rebuilt at the
    snapshot's caps, the run continues equal to the straight run there."""
    _, exp = both(PHOLD)
    path = str(tmp_path / "retry.npz")
    eng = EngineT(exp, EngineParamsT(**ring_params(ev_cap=SMALL_CAP)),
                  device="cpu")
    guard = txn_t.OverflowGuard(eng, make_engine=eng.at_caps, mode="retry")
    _, hb = run_with_heartbeat(eng, n_windows=N_WINDOWS // 2,
                               every_windows=CHUNK, stream=False,
                               ckpt_path=path, ckpt_every_s=0.0, guard=guard)
    assert guard.chunk_retries >= 1
    rows = [r for r in hb.ring_records if r["type"] == "ring"]
    snap = ckpt_t.snapshot_caps(eng.init_state(), path)
    assert snap is not None and snap[0] > SMALL_CAP
    eng2 = EngineT(exp, EngineParamsT(**ring_params(ev_cap=snap[0],
                                                    outbox_cap=snap[1])),
                   device="cpu")
    guard2 = txn_t.OverflowGuard(eng2, make_engine=eng2.at_caps, mode="retry")
    st2, hb2 = run_with_heartbeat(
        eng2, ckpt_t.load_state(eng2.init_state(), path),
        n_windows=N_WINDOWS // 2, every_windows=CHUNK, stream=False,
        guard=guard2)
    rows += [r for r in hb2.ring_records if r["type"] == "ring"]
    rows_s, st_s, _ = stream(
        "torch", exp, ring_params(ev_cap=guard2.final_caps["ev_cap"]))
    assert rows == [r for r in rows_s if r["type"] == "ring"]
    assert EngineT.metrics_dict(st2) == EngineT.metrics_dict(st_s)


def test_halt_matches_reference():
    exp_j, exp_t = both(PHOLD)
    errs = []
    for pkg, exp in (("jax", exp_j), ("torch", exp_t)):
        with pytest.raises(RuntimeError) as ei:
            stream(pkg, exp, ring_params(ev_cap=SMALL_CAP, on_overflow="halt"),
                   "halt")
        errs.append(ei.value)
    ej, et = errs
    assert isinstance(et, txn_t.CapacityExceededError)
    fields = ("knob", "counter", "cap", "overflow", "window_range",
              "recommended", "advice")
    assert {f: getattr(et, f) for f in fields} == {
        f: getattr(ej, f) for f in fields}
    # The text is the reference's; its pointer names the port's captune.
    assert str(et) == str(ej).replace("shadow1_tpu.tools.captune",
                                      "shadow1_tpu_torch.tools.captune")
    assert "python -m shadow1_tpu_torch.tools.captune" in str(et)
    assert et.knob == "ev_cap" and et.window_range == (0, CHUNK)
    assert et.recommended > SMALL_CAP


def test_selfcheck_clean_and_violation():
    exp = ct.fidelity_filexfer_experiment(1, 42, 400 * MS)
    st = run_chunked_t(EngineT(exp, EngineParamsT(ev_cap=64), device="cpu"),
                       n_windows=FID_WINDOWS, chunk=FID_CHUNK, selfcheck=True)
    m = EngineT.metrics_dict(st)
    assert m["pkts_sent"] > 0 and m["link_down_pkts"] + m["down_pkts"] > 0
    assert txn_t.accounting(m) == txn_j.accounting(m)
    for bad, where in (({"pkts_sent": 10, "pkts_delivered": 4,
                         "pkts_lost": 1, "ev_overflow": 2}, "window 7"),
                       ({"pkts_sent": 3, "pkts_delivered": 4}, "")):
        got = []
        for mod in (txn_j, txn_t):
            with pytest.raises(RuntimeError) as ei:
                mod.check_boundary_identity(bad, where=where)
            got.append(ei.value)
        assert isinstance(got[1], txn_t.SelfCheckError)
        assert (got[1].terms, got[1].gap, got[1].where, str(got[1])) == (
            got[0].terms, got[0].gap, got[0].where, str(got[0]))


def test_controller_absorbs_retry_grow():
    from shadow1_tpu_torch.tune import CapController, CapPolicy

    _, exp = both(PHOLD)
    eng = EngineT(exp, EngineParamsT(ev_cap=SMALL_CAP), device="cpu")
    ctl = CapController(eng, eng.at_caps, policy=CapPolicy(shrink_patience=1))
    ctl.note_lossy("ev_cap", 24)
    assert ctl._decide("ev_cap", high_water=4, cap=24) == 24
    eng24 = ctl.engine_for(EngineParamsT(ev_cap=24))
    guard = txn_t.OverflowGuard(eng24, mode="retry", controller=ctl)
    assert guard._engine_for(EngineParamsT(ev_cap=24)) is eng24


ENV = {**os.environ, "OMP_NUM_THREADS": "1", "SHADOW1_SUPERVISE_BACKOFF_S": "0"}


def undercapped_cfg(tmp_path) -> str:
    cfg = tmp_path / "of_phold.yaml"
    cfg.write_text(
        "general: {seed: 5, stop_time: 40 ms}\n"
        "engine: {scheduler: tpu, ev_cap: 8}\n"
        "network: {single_vertex: {latency: 1 ms}}\n"
        "hosts:\n"
        "  - {name: h, count: 8}\n"
        "app:\n"
        "  model: phold\n"
        "  params: {mean_delay_ns: 2000000.0, init_events: 6}\n")
    return str(cfg)


def port_cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch", *args, "--device", "cpu"],
        cwd=ROOT, env={**ENV, **(env or {})}, capture_output=True, text=True,
        timeout=300)


def test_cli_retry_and_halt(tmp_path):
    cfg = undercapped_cfg(tmp_path)
    r = port_cli(cfg, "--on-overflow", "retry", "--heartbeat", "10")
    assert r.returncode == 0, r.stderr[-800:]
    recs = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    out = recs[-1]
    assert out["retries"]["chunk_retries"] >= 1
    assert out["retries"]["policy"] == "retry"
    assert out["retries"]["caps"]["ev_cap"] > SMALL_CAP
    assert out["metrics"]["chunk_retries"] >= 1
    assert out["metrics"]["ev_overflow"] == 0
    assert any(b.get("retries", {}).get("chunk_retries", 0) >= 1
               for b in recs if b.get("type") == "heartbeat")
    r = port_cli(cfg, "--on-overflow", "halt")
    assert r.returncode == EXIT_CAPACITY, (r.returncode, r.stderr[-600:])
    err = json.loads(r.stdout.strip().splitlines()[-1])
    assert err["error"] == "capacity_exceeded" and err["knob"] == "ev_cap"
    assert err["recommended"] > SMALL_CAP
    assert "Paste-ready fix" in r.stderr and "engine:" in r.stderr


def test_supervisor_does_not_respawn_a_capacity_halt(tmp_path):
    cfg = undercapped_cfg(tmp_path)
    r = port_cli(cfg, "--on-overflow", "halt", "--ckpt",
                 str(tmp_path / "ck.npz"), "--heartbeat", "10")
    assert r.returncode == EXIT_CAPACITY, (r.returncode, r.stderr[-600:])
    assert "halted on a capacity policy" in r.stderr
    assert "respawning (" not in r.stderr
