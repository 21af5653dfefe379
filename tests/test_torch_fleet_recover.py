"""The port's fleet recovery plane and fleet snapshots, on the CPU
(docs/SEMANTICS.md "Fleet recovery contract"; the reference's
``tests/test_fleet_recover.py`` experiments).

* fleet snapshots: a port snapshot resumes bit-identically in the port; a
  JAX ``FleetEngine`` snapshot loads into the port and continues equal to
  the JAX run; a port snapshot loads into the JAX ``FleetEngine`` and
  continues equal; a sliced lane resumes in the port's solo ``Engine``;
* transactional retry from an under-sized cap equals the straight big-cap
  fleet, and the JAX ``FleetEngine`` at the final caps;
* halt names the lane and its seed; quarantine survivors equal an E-1
  fleet run from scratch; ``--lane-finalize`` emits its ``fleet_exp``
  record (``finished_early``); the auto-caps gauges are fleet-global.

Tolerance: zero (everything compared is an integer).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from shadow1_tpu import ckpt as ckpt_j
from shadow1_tpu.config.compiled import single_vertex_experiment as sve_j
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.fleet.engine import FleetEngine as FleetEngineJ
from shadow1_tpu_torch import ckpt as ckpt_t
from shadow1_tpu_torch.config.compiled import single_vertex_experiment
from shadow1_tpu_torch.consts import MS
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.convert import fleet_to_saved, state_to_numpy
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.fleet.engine import FleetEngine as FleetEngineT
from shadow1_tpu_torch.fleet.run import final_records, run_fleet
from shadow1_tpu_torch.txn import CapacityExceededError
from tests.test_torch_tgen import (  # noqa: F401  (fixture)
    _one_thread,
    assert_same_leaves,
)

N = 20
UNDER = dict(ev_cap=8, metrics_ring=N, state_digest=1)


def mk(seed, loss=0.0, stop=None, n_hosts=8, sve=single_vertex_experiment):
    kw = {"stop_time": np.full(n_hosts, stop, np.int64)} if stop else {}
    return sve(n_hosts=n_hosts, seed=seed, end_time=40 * MS,
               latency_ns=1 * MS, loss=loss, model="phold",
               model_cfg={"mean_delay_ns": float(2 * MS), "init_events": 6},
               **kw)


def fleet(exps, **params):
    return FleetEngineT(exps, EngineParamsT(**dict(UNDER, **params)),
                        device="cpu")


def lane_rings(eng, st):
    """Per-lane ring records keyed by the sweep-global id."""
    out = {}
    for r in eng.drain_rings(st):
        out.setdefault(r["exp"], []).append(
            {k: v for k, v in r.items() if k != "exp"})
    return out


# ---------------------------------------------------------------------------
# fleet snapshots, both ways
# ---------------------------------------------------------------------------

SNAP = [(5, 0.0), (6, 0.0), (7, 0.1)]


def test_port_snapshot_resumes_in_port(tmp_path):
    eng = fleet([mk(s, lo) for s, lo in SNAP], ev_cap=32)
    straight = eng.run(n_windows=N)
    half = eng.run(n_windows=N // 2)
    path = str(tmp_path / "f.npz")
    ckpt_t.save_state(fleet_to_saved(half, eng.n_exp), path)
    eng2 = fleet([mk(s, lo) for s, lo in SNAP], ev_cap=32)
    st = ckpt_t.load_fleet_state(eng2.init_state(), path, eng2.n_exp)
    st = eng2.run(st, n_windows=N - N // 2)
    assert_same_leaves(state_to_numpy(fleet_to_saved(straight, 3)),
                       state_to_numpy(fleet_to_saved(st, 3)))


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX FleetEngine of the snapshot sweep: its state at N/2 and at
    N (numpy leaves)."""
    eng = FleetEngineJ([mk(s, lo, sve=sve_j) for s, lo in SNAP],
                       EngineParamsJ(**dict(UNDER, ev_cap=32)))
    half = eng.run(n_windows=N // 2)
    end = eng.run(half, n_windows=N - N // 2)
    return eng, half, jax.tree.map(np.asarray, end)


def test_jax_snapshot_continues_in_port(jax_fleet, tmp_path):
    eng_j, half, end = jax_fleet
    path = str(tmp_path / "j.npz")
    ckpt_j.save_state(half, path)
    eng = fleet([mk(s, lo) for s, lo in SNAP], ev_cap=32)
    st = ckpt_t.load_fleet_state(eng.init_state(), path, eng.n_exp)
    st = eng.run(st, n_windows=N - N // 2)
    assert_same_leaves(end, state_to_numpy(fleet_to_saved(st, 3)))


def test_port_snapshot_continues_in_jax(jax_fleet, tmp_path):
    eng_j, _, end = jax_fleet
    eng = fleet([mk(s, lo) for s, lo in SNAP], ev_cap=32)
    half = eng.run(n_windows=N // 2)
    path = str(tmp_path / "t.npz")
    ckpt_t.save_state(fleet_to_saved(half, eng.n_exp), path)
    st = ckpt_j.load_state(eng_j.init_state(), path)
    st = eng_j.run(st, n_windows=N - N // 2)
    assert_same_leaves(end, jax.tree.map(np.asarray, st))


def test_sliced_lane_resumes_in_port_solo(tmp_path):
    exps = [mk(s, lo) for s, lo in SNAP]
    eng = fleet(exps, ev_cap=32)
    half = eng.run(n_windows=N // 2)
    path = str(tmp_path / "lane2.npz")
    ckpt_t.save_state(eng.slice_experiment(half, 2), path)
    solo = EngineT(exps[2], eng.params, device="cpu")
    st = solo.run(ckpt_t.load_state(solo.init_state(), path),
                  n_windows=N - N // 2)
    straight = solo.run(n_windows=N)
    assert_same_leaves(state_to_numpy(straight), state_to_numpy(st))


# ---------------------------------------------------------------------------
# retry, halt, quarantine, finalize, auto-caps
# ---------------------------------------------------------------------------

RETRY = [(5, 0.0), (6, 0.0), (7, 0.1)]


def test_retry_from_small_cap_equals_big_cap_fleet():
    """Every committed chunk is overflow-free in every lane, so the
    retried sweep's lanes equal the straight fleet at the final caps, in
    the port and in the JAX FleetEngine."""
    eng = fleet([mk(s, lo) for s, lo in RETRY], on_overflow="retry")
    st, hb = run_fleet(eng, n_windows=N, every_windows=5, stream=False)
    assert hb.guard.chunk_retries > 0
    final = hb.engine.params.ev_cap
    assert final > UNDER["ev_cap"]
    assert all(m["ev_overflow"] == 0 for m in hb.engine.metrics_per_exp(st))
    big = fleet([mk(s, lo) for s, lo in RETRY], ev_cap=final)
    assert lane_rings(hb.engine, st) == lane_rings(big, big.run(n_windows=N))
    eng_j = FleetEngineJ([mk(s, lo, sve=sve_j) for s, lo in RETRY],
                         EngineParamsJ(**dict(UNDER, ev_cap=final)))
    st_j = eng_j.run(n_windows=N)
    assert lane_rings(hb.engine, st) == lane_rings(eng_j, st_j)


def test_halt_names_the_lane_and_its_seed():
    eng = fleet([mk(5, 0.5), mk(6), mk(7, 0.5)], on_overflow="halt")
    with pytest.raises(CapacityExceededError) as ei:
        run_fleet(eng, n_windows=N, every_windows=5, stream=False)
    assert "fleet experiment 1, seed 6" in str(ei.value)
    assert ei.value.lanes == [1] and ei.value.knob == "ev_cap"


def test_quarantine_survivors_equal_e1_fleet(tmp_path):
    """Lane 1 (lossless) overflows ev_cap 8 under halt; lanes 0 and 2 (50 %
    loss) survive and equal a 2-lane fleet of them run from scratch; the
    quarantined lane's chunk-start checkpoint resumes solo."""
    exps = [mk(5, 0.5), mk(6), mk(7, 0.5)]
    eng = fleet(exps, on_overflow="halt", on_lane_fail="quarantine")
    records = []
    st, hb = run_fleet(eng, n_windows=N, every_windows=5, stream=False,
                       quarantine_base=str(tmp_path / "lane"),
                       emit_record=records.append)
    (q,) = hb.recovery["quarantined"]
    assert (q["exp"], q["seed"], q["reason"], q["knob"]) == \
        (1, 6, "capacity", "ev_cap")
    assert q["survivors"] == 2 and os.path.exists(q["ckpt"])
    assert records == [q]
    assert [l["exp"] for l in hb.labels] == [0, 2]
    scratch = fleet([exps[0], exps[2]], on_overflow="halt")
    st2 = scratch.run(n_windows=N)
    scratch.exp_ids = [0, 2]
    assert lane_rings(hb.engine, st) == lane_rings(scratch, st2)
    recs, summary = final_records(hb.engine, st, hb.labels, N, 1.0,
                                  recovery=hb.recovery)
    assert [r["exp"] for r in recs] == [0, 2]
    assert summary["quarantined"] == [1]
    assert summary["experiments_initial"] == 3
    solo = EngineT(exps[1], hb.engine.params, device="cpu")
    lane = ckpt_t.load_state(solo.init_state(), q["ckpt"])
    assert int(lane.win_start) == q["window"] * solo.window


def test_lane_finalize_emits_finished_early():
    """A lane whose hosts all stop (legacy stop_time) drains and is
    finalized mid-sweep: its fleet_exp record (finished_early) emits at
    once; the survivor equals the straight run's lane."""
    exps = [mk(5, 0.5), mk(6, 0.5, stop=10 * MS)]
    eng = fleet(exps, ev_cap=32, lane_finalize=1)
    records = []
    st, hb = run_fleet(eng, n_windows=N, every_windows=5, stream=False,
                       emit_record=records.append)
    (rec,) = hb.recovery["finished"]
    assert records == [rec]
    assert rec["type"] == "fleet_exp" and rec["exp"] == 1
    assert rec["finished_early"] is True
    assert rec["windows"] < N and rec["windows_configured"] == N
    assert hb.engine.n_exp == 1
    straight = fleet(exps, ev_cap=32)
    st2 = straight.run(n_windows=N)
    assert lane_rings(hb.engine, st)[0] == lane_rings(straight, st2)[0]
    m2 = straight.metrics_per_exp(st2)[1]
    for k in ("events", "pkts_sent", "pkts_delivered", "down_pkts"):
        assert rec["metrics"][k] == m2[k], k
    _, summary = final_records(hb.engine, st, hb.labels, N, 1.0,
                               recovery=hb.recovery)
    assert summary["finished_early"] == [1]


def test_auto_caps_gauges_are_fleet_global():
    """The controller reads the max fill over lanes and the summed
    overflow: an over-provisioned sweep shrinks to a cap above every
    lane's high-water, bit-exactly."""
    exps = [mk(5), mk(6, 0.3)]
    eng = fleet(exps, ev_cap=64)
    st, hb = run_fleet(eng, n_windows=N, every_windows=4, stream=False,
                       auto_caps=True)
    assert hb.engine.params.ev_cap < 64
    ref = fleet(exps, ev_cap=64)
    st_ref = ref.run(n_windows=N)
    assert lane_rings(hb.engine, st) == lane_rings(ref, st_ref)
    fills = [m["ev_max_fill"] for m in ref.metrics_per_exp(st_ref)]
    assert fills[0] != fills[1]
    assert hb.engine.params.ev_cap >= max(fills)
    assert hb.engine.metrics_dict(st)["ev_max_fill"] == max(fills)


SUB_CFG = (
    "general: {seed: 7, stop_time: 60 ms}\n"
    "engine: {scheduler: tpu, ev_cap: 32, outbox_cap: 16}\n"
    "network: {single_vertex: {latency: 10 ms}}\n"
    "hosts: [{name: h, count: 8}]\n"
    "app: {model: phold, params: {mean_delay_ns: 2.0e7, init_events: 2}}\n"
    "sweep: {seeds: [7, 8, 9, 10]}\n")


def _fleet_exps(out):
    return {r["exp"]: r["metrics"] for r in
            map(json.loads, out.strip().splitlines())
            if r.get("type") == "fleet_exp"}


def test_cli_subbatch_downshift_with_ckpt_crash_resume(tmp_path):
    """``--on-oom downshift`` splits a fleet the budget cannot hold into
    sequential sub-batches (the planner's third stage), composes with
    ``--ckpt`` (a crash after a save respawns; the batch cursor in the
    lineage resumes the right batch), and every lane's metrics equal the
    straight full fleet's (the reference's test, in the port)."""
    import subprocess
    import sys
    from pathlib import Path

    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.fleet.expand import load_sweep

    cfg = tmp_path / "sweep.yaml"
    cfg.write_text(SUB_CFG)
    plan = load_sweep(str(cfg))
    e2 = mem.estimate(plan.exps[0], plan.params, (plan.exps[:2], None))
    e4 = mem.estimate(plan.exps[0], plan.params, (plan.exps, None))
    budget = (e2.peak_bytes + e4.peak_bytes) // 2
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": root, mem.MEM_BYTES_ENV: str(budget),
           "SHADOW1_OBS_CRASH_AT_NS": "40000000",
           "SHADOW1_SUPERVISE_BACKOFF_S": "0"}
    run = [sys.executable, "-m", "shadow1_tpu_torch", str(cfg), "--fleet",
           "--device", "cpu"]
    sup = subprocess.run(
        run + ["--on-oom", "downshift", "--ckpt", str(tmp_path / "sb.npz"),
               "--ckpt-every-s", "0", "--heartbeat", "2"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert sup.returncode == 0, sup.stderr[-800:]
    assert "respawning" in sup.stderr
    env = {**os.environ, "PYTHONPATH": root}
    straight = subprocess.run(run, capture_output=True, text=True, env=env,
                              cwd=tmp_path, timeout=600)
    assert straight.returncode == 0, straight.stderr[-800:]
    assert _fleet_exps(sup.stdout) == _fleet_exps(straight.stdout)
    merged = [json.loads(l) for l in sup.stdout.strip().splitlines()
              if '"fleet_summary"' in l][-1]
    assert merged["experiments"] == 4 and merged["sub_batches"] == 2
    assert merged["lanes_per_batch"] == mem.max_lanes(
        plan.exps[0], plan.params, (plan.exps, None), budget) == 3


def test_subbatch_refused_with_an_explicit_snapshot_path(tmp_path, capsys,
                                                         monkeypatch):
    """An explicit ``--save-state`` path names one snapshot of every lane
    and carries no batch cursor: a fleet that only sub-batching would fit
    is refused with the memory record (EXIT_MEMORY)."""
    from shadow1_tpu_torch import cli, mem
    from shadow1_tpu_torch.consts import EXIT_MEMORY
    from shadow1_tpu_torch.fleet.expand import load_sweep

    cfg = tmp_path / "sweep.yaml"
    cfg.write_text(SUB_CFG)
    plan = load_sweep(str(cfg))
    e2 = mem.estimate(plan.exps[0], plan.params, (plan.exps[:2], None))
    monkeypatch.setenv(mem.MEM_BYTES_ENV, str(e2.peak_bytes + 1))
    n = torch.get_num_threads()
    try:
        rc = cli.main([str(cfg), "--fleet", "--device", "cpu",
                       "--on-oom", "downshift", "--save-state",
                       str(tmp_path / "s.npz")])
    finally:
        torch.set_num_threads(n)
    assert rc == EXIT_MEMORY
    out = capsys.readouterr()
    assert "batch cursor" in out.err + out.out


def test_cli_fleet_lane_flags(tmp_path, capsys):
    """``--on-lane-fail quarantine`` and ``--lane-finalize`` run a fleet
    (records for every lane and a summary) and need ``--fleet``."""
    from pathlib import Path

    from shadow1_tpu_torch import cli

    cfg = str(Path(__file__).resolve().parents[1] / "configs"
              / "sweep_phold.yaml")
    assert cli.main([cfg, "--fleet", "--device", "cpu", "--windows", "3",
                     "--on-lane-fail", "quarantine", "--lane-finalize"]) == 0
    recs = [json.loads(l) for l in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["exp"] for r in recs if r["type"] == "fleet_exp"] == [0, 1, 2, 3]
    assert recs[-1]["type"] == "fleet_summary"
    with pytest.raises(SystemExit) as e:
        cli.main([cfg, "--device", "cpu", "--lane-finalize"])
    assert e.value.code == 2
    assert "need --fleet" in capsys.readouterr().err
