"""The port's serve plane (``shadow1_tpu_torch/serve/``) on the CPU: the
engine cache, admission, lane packing — against the port's solo runs, the
JAX package's solo runs and the JAX ``ServeDaemon``.

The serving contract (docs/SEMANTICS.md §"Serving contract"):

* engine-cache keying: a same-shape repeat batch HITS and builds no
  engine (the same ``FleetEngine`` object, no ``FleetEngine.__init__``,
  no kernel build); a changed cap MISSES; the LRU evicts; a rebind the
  engine refuses rolls back;
* admission rejects an over-budget submission before any engine is
  built, with the memory_budget advice record, and rejects bad configs
  (an unknown section, ``sweep:``, ``scheduler: sharded``);
* lane-packed jobs give digest streams bit-identical to the port's solo
  runs and to the JAX package's; incompatible shapes batch apart; a
  halting tenant quarantines without touching its cohabitant;
* the same submissions through the JAX ``ServeDaemon`` and the port's
  give the same job-state sequences, cache outcomes and digest rows;
* a JSON submission builds the experiment its YAML form builds (the card
  has no YAML parser); ``load_experiment`` reads both.

The daemon is driven in process through ``ServeDaemon.step()`` (the live
loop's iteration) on ``device="cpu"``, with the reference tests' 8-host
PHOLD configs. Tolerance: zero (every compared value is an integer).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

import pytest
import torch
import yaml

from shadow1_tpu.ckpt import run_chunked as run_chunked_j
from shadow1_tpu.config.experiment import load_experiment as load_j
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.serve import client as client_j
from shadow1_tpu.serve.daemon import ServeDaemon as ServeDaemonJ
from shadow1_tpu.telemetry.ring import drain_ring as drain_ring_j
from shadow1_tpu_torch import cli
from shadow1_tpu_torch.ckpt import run_chunked
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config.experiment import (
    build_experiment,
    load_experiment,
)
from shadow1_tpu_torch.consts import (
    EXIT_CAPACITY,
    EXIT_CONFIG,
    EXIT_MEMORY,
    EXIT_OK,
)
from shadow1_tpu_torch.core.engine import Engine
from shadow1_tpu_torch.fleet.engine import FleetEngine
from shadow1_tpu_torch.fleet.expand import FleetConfigError
from shadow1_tpu_torch.serve import client
from shadow1_tpu_torch.serve.cache import EngineCache, shape_class_key
from shadow1_tpu_torch.serve.daemon import ServeDaemon, SpoolError
from shadow1_tpu_torch.serve.protocol import Spool
from shadow1_tpu_torch.telemetry.registry import RING_DIGESTS
from shadow1_tpu_torch.telemetry.ring import drain_ring
from tests.test_torch_tgen import _one_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]

BASE = """
general: {{seed: {seed}, stop_time: {stop} ms}}
engine: {{scheduler: tpu, ev_cap: {ev_cap}, metrics_ring: 10,
          state_digest: 1{extra_engine}}}
network: {{single_vertex: {{latency: 1 ms{loss}}}}}
hosts:
  - {{name: h, count: 8}}
app:
  model: phold
  params: {{mean_delay_ns: 2000000.0, init_events: {init_events}}}
"""


def write_cfg(tmp_path, name, seed=5, stop=40, ev_cap=32, loss=None,
              init_events=3, extra_engine=""):
    p = tmp_path / name
    p.write_text(BASE.format(
        seed=seed, stop=stop, ev_cap=ev_cap, init_events=init_events,
        loss=(f", loss: {loss}" if loss is not None else ""),
        extra_engine=extra_engine))
    return str(p)


def _rows(recs) -> dict[int, tuple]:
    return {r["window"]: tuple(r[f] for f in RING_DIGESTS)
            for r in recs if r["type"] == "ring"}


def solo_stream(cfg_path) -> dict[int, tuple]:
    """window → digest words of the port's straight solo run on the CPU
    (chunked at the ring depth so no row is overwritten undrained)."""
    exp, params, _ = load_experiment(cfg_path)
    eng = Engine(exp, params, device="cpu")
    rows: dict[int, tuple] = {}
    start = [0]

    def on_chunk(st, _d):
        rows.update(_rows(drain_ring(st, eng.window, start=start[0])))
        start[0] = int(st.metrics.windows)

    run_chunked(eng, n_windows=eng.n_windows, chunk=params.metrics_ring,
                on_chunk=on_chunk)
    return rows


def jax_solo_stream(cfg_path) -> dict[int, tuple]:
    """The same stream from the JAX package's solo engine
    (``tests/test_serve.py``'s ``solo_stream`` recipe)."""
    exp, params, _ = load_j(cfg_path)
    eng = EngineJ(exp, params)
    rows: dict[int, tuple] = {}
    start = [0]

    def on_chunk(st, _d):
        rows.update(_rows(drain_ring_j(st, eng.window, start=start[0])))
        start[0] = int(st.metrics.windows)

    run_chunked_j(eng, n_windows=eng.n_windows, chunk=params.metrics_ring,
                  on_chunk=on_chunk)
    return rows


def served_stream(spool_dir, job_id) -> dict[int, tuple]:
    return _rows(Spool(spool_dir).read_results(job_id))


@pytest.fixture
def daemon(tmp_path):
    d = ServeDaemon(str(tmp_path / "spool"), poll_s=0.05, ckpt_every_s=1e9,
                    device="cpu")
    d.start()
    yield d
    d.close()


@pytest.fixture
def builds(monkeypatch):
    """Every FleetEngine built to run a batch (the memory estimate's
    builds excluded: on the meta device, or on the host for a small
    state) and every kernel build request."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.core import _build

    seen = {"engines": 0, "kernels": 0}
    init = FleetEngine.__init__
    abstract_state = mem.abstract_state
    estimating = []

    def flagged(*a, **kw):
        estimating.append(True)
        try:
            return abstract_state(*a, **kw)
        finally:
            estimating.pop()

    def counting_init(self, *a, **kw):
        init(self, *a, **kw)
        if self.device.type != "meta" and not estimating:
            seen["engines"] += 1

    def counting_build(*a, **kw):
        seen["kernels"] += 1
        raise AssertionError("the CPU path builds no kernel")

    monkeypatch.setattr(FleetEngine, "__init__", counting_init)
    monkeypatch.setattr(mem, "abstract_state", flagged)
    monkeypatch.setattr(_build, "build", counting_build)
    monkeypatch.setattr(_build, "library", counting_build)
    return seen


# ---------------------------------------------------------------------------
# engine cache
# ---------------------------------------------------------------------------

def test_cache_hit_builds_no_engine(tmp_path, builds):
    cache = EngineCache()
    exp_a = load_experiment(write_cfg(tmp_path, "a.yaml", seed=5))[0]
    exp_b, params, _ = load_experiment(write_cfg(tmp_path, "b.yaml", seed=9))
    eng1, out1 = cache.get([exp_a], params, device="cpu")
    assert out1 == "miss" and builds["engines"] == 1
    eng1.run(n_windows=4)
    eng2, out2 = cache.get([exp_b], params, device="cpu")
    # THE cache contract in the port: a hit builds no engine — the same
    # object, no FleetEngine.__init__, no kernel build.
    assert out2 == "hit" and eng2 is eng1
    assert builds == {"engines": 1, "kernels": 0}
    assert eng2.exp.seed == 9  # rebound to the new lane set
    st = eng2.run(n_windows=4)
    fresh = FleetEngine([exp_b], params, device="cpu").run(n_windows=4)
    assert eng2.metrics_per_exp(st) == FleetEngine.metrics_per_exp(fresh)
    assert eng2.drain_rings(st) == eng2.drain_rings(fresh)
    assert cache.counters()["cache_hits"] == 1


def test_cache_changed_cap_misses(tmp_path):
    cache = EngineCache()
    exp, params, _ = load_experiment(write_cfg(tmp_path, "a.yaml"))
    _, out1 = cache.get([exp], params, device="cpu")
    _, out2 = cache.get([exp], dataclasses.replace(params, ev_cap=64),
                        device="cpu")
    assert (out1, out2) == ("miss", "miss")
    assert cache.counters() == {"cache_hits": 0, "cache_misses": 2,
                                "cache_evictions": 0, "cache_entries": 2}
    # the keys differ by the cap only; the device is part of the key
    k1 = shape_class_key(exp, params, 1, "cpu")
    k2 = shape_class_key(exp, dataclasses.replace(params, ev_cap=64), 1,
                         "cpu")
    assert k1[0] == k2[0] and k1 != k2
    assert shape_class_key(exp, params, 1, "cuda:0") != k1


def test_cache_lru_evicts(tmp_path):
    cache = EngineCache(capacity=1)
    exp, params, _ = load_experiment(write_cfg(tmp_path, "a.yaml"))
    cache.get([exp], params, device="cpu")
    cache.get([exp], dataclasses.replace(params, ev_cap=64), device="cpu")
    assert cache.counters()["cache_evictions"] == 1
    assert len(cache) == 1


def test_rebind_refused_rolls_back(tmp_path, builds):
    exp, params, _ = load_experiment(write_cfg(tmp_path, "a.yaml"))
    eng = FleetEngine([exp], params, device="cpu")
    # a uniform max_rounds is part of the engine's structure
    with pytest.raises(FleetConfigError, match="max_rounds"):
        eng.rebind([exp], max_rounds=[params.max_rounds + 1])
    # a shape-class field differing from the bound engine's is refused
    cfg2 = tmp_path / "lat.yaml"
    cfg2.write_text((tmp_path / "a.yaml").read_text().replace(
        "latency: 1 ms", "latency: 2 ms"))
    exp2 = load_experiment(str(cfg2))[0]
    with pytest.raises(FleetConfigError, match="lat_vv|window"):
        eng.rebind([exp2])
    assert eng.exp is exp and eng.exps == [exp]  # rolled back cleanly
    # through the cache: a refused rebind rebuilds and counts a miss
    cache = EngineCache()
    cache._entries[shape_class_key(exp2, params, 1, "cpu")] = eng
    got, out = cache.get([exp2], params, device="cpu")
    assert out == "miss" and got is not eng and got.exp is exp2
    assert eng.exp is exp


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def test_admission_rejects_overbudget_before_any_build(tmp_path, daemon,
                                                       builds, monkeypatch):
    monkeypatch.setenv("SHADOW1_MEM_BYTES", str(1 << 20))  # 1 MiB
    big = tmp_path / "big.yaml"
    big.write_text(BASE.format(seed=5, stop=40, ev_cap=64, init_events=3,
                               loss="", extra_engine="").replace(
        "count: 8", "count: 4096"))
    jid = client.submit(daemon.spool.root, str(big))
    daemon.step()
    st = daemon.spool.read_status(jid)
    assert st["state"] == "rejected", st
    err = st["error"]
    assert err["error"] == "memory_budget"
    assert err["estimated"] > err["budget"] == (1 << 20)
    assert "Remedies" in err["advice"]
    # rejected before any engine was built (the estimate's meta-device
    # engines aside)
    assert daemon.cache.counters()["cache_misses"] == 0
    assert builds == {"engines": 0, "kernels": 0}
    assert client.exit_code_for(st) == EXIT_MEMORY


def test_admission_rejects_bad_configs(tmp_path, daemon):
    bad = tmp_path / "bad.yaml"
    bad.write_text("general: {seed: 1}\nnot_a_section: {x: 1}\n")
    base = BASE.format(seed=5, stop=40, ev_cap=32, init_events=3, loss="",
                       extra_engine="")
    sweep = tmp_path / "sweep.yaml"
    sweep.write_text(base + "sweep: {count: 2}\n")
    sharded = tmp_path / "sharded.yaml"
    sharded.write_text(base.replace("scheduler: tpu", "scheduler: sharded"))
    scalar = tmp_path / "scalar.json"
    scalar.write_text("[1, 2]")
    jids = [client.submit(daemon.spool.root, str(p))
            for p in (bad, sweep, sharded, scalar)]
    daemon.step()
    for j in jids:
        st = daemon.spool.read_status(j)
        assert st["state"] == "rejected", st
        assert st["error"]["error"] == "config"
        assert client.exit_code_for(st) == EXIT_CONFIG
    msgs = [daemon.spool.read_status(j)["error"]["message"] for j in jids]
    assert "sweep" in msgs[1] and "'sharded'" in msgs[2]
    assert daemon.ledger_dict()["jobs_rejected"] == 4
    assert daemon.cache.counters()["cache_misses"] == 0


def test_serve_without_card_raises(tmp_path):
    """No card and no --device cpu: the daemon refuses to start; it never
    serves on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    spool = tmp_path / "spool"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--spool", str(spool)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeDaemon(str(spool))
    assert not spool.exists()


def test_cli_submit_no_wait(tmp_path, daemon, capsys):
    cfg = write_cfg(tmp_path, "a.yaml")
    assert cli.main(["submit", cfg, "--spool", daemon.spool.root,
                     "--no-wait", "--json-only"]) == EXIT_OK
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["state"] == "submitted"
    (path, job), = daemon.spool.scan_inbox()
    assert job["id"] == rec["job"] and job["config_name"] == "a.yaml"
    assert cli.main(["submit", cfg, "--spool", str(tmp_path / "none")]) \
        == EXIT_CONFIG


# ---------------------------------------------------------------------------
# lane packing ≡ solo, in the port and in the JAX package
# ---------------------------------------------------------------------------

def test_packed_jobs_bitexact_vs_port_and_jax_solo(tmp_path, daemon,
                                                   builds):
    cfgs = [write_cfg(tmp_path, f"j{i}.yaml", seed=5 + i) for i in range(3)]
    jids = [client.submit(daemon.spool.root, c) for c in cfgs]
    assert daemon.step()
    # one batch, three lanes, one engine
    assert daemon.ledger_dict()["batches_run"] == 1
    assert daemon.cache.counters()["cache_misses"] == 1
    assert builds["engines"] == 1
    for jid, cfg in zip(jids, cfgs):
        st = daemon.spool.read_status(jid)
        assert st["state"] == "done" and st["lanes"] == 3, st
        served = served_stream(daemon.spool.root, jid)
        assert len(served) == 40
        assert served == solo_stream(cfg)      # every window, every word
        assert served == jax_solo_stream(cfg)
        assert client.exit_code_for(st) == EXIT_OK
        final = [r for r in daemon.spool.read_results(jid)
                 if r["type"] == "fleet_exp"]
        assert len(final) == 1 and final[0]["job"] == jid


def test_incompatible_shapes_batch_separately(tmp_path, daemon):
    a = client.submit(daemon.spool.root,
                      write_cfg(tmp_path, "a.yaml", seed=5))
    b = client.submit(daemon.spool.root,
                      write_cfg(tmp_path, "b.yaml", seed=6, ev_cap=64))
    daemon.step()
    daemon.step()
    assert daemon.ledger_dict()["batches_run"] == 2
    assert daemon.cache.counters()["cache_misses"] == 2
    for j in (a, b):
        st = daemon.spool.read_status(j)
        assert st["state"] == "done" and st["lanes"] == 1, st


def test_quarantine_isolates_halting_tenant(tmp_path, daemon):
    # One shape class at ev_cap 8 under on_overflow=halt: the lossless
    # tenant overflows, the lossy one fits.
    halting = write_cfg(tmp_path, "halting.yaml", seed=5, ev_cap=8,
                        init_events=6, extra_engine=", on_overflow: halt")
    ok = write_cfg(tmp_path, "ok.yaml", seed=6, ev_cap=8, loss=0.5,
                   init_events=6, extra_engine=", on_overflow: halt")
    j_bad = client.submit(daemon.spool.root, halting)
    j_ok = client.submit(daemon.spool.root, ok)
    daemon.step()
    st_bad = daemon.spool.read_status(j_bad)
    assert st_bad["state"] == "failed" and st_bad["reason"] == "capacity"
    assert client.exit_code_for(st_bad) == EXIT_CAPACITY
    quar = [r for r in Spool(daemon.spool.root).read_results(j_bad)
            if r.get("type") == "fleet_quarantine"]
    assert quar and os.path.exists(quar[0]["ckpt"])
    st_ok = daemon.spool.read_status(j_ok)
    assert st_ok["state"] == "done", st_ok
    assert served_stream(daemon.spool.root, j_ok) == solo_stream(ok)


# ---------------------------------------------------------------------------
# the JAX ServeDaemon and the port's, on the same submissions
# ---------------------------------------------------------------------------

def _job_states(spool_root) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    with open(Spool(spool_root).log_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "serve_job":
                out.setdefault(rec["job"], []).append(rec["state"])
    return out


def _batches(spool_root) -> list[tuple]:
    with open(Spool(spool_root).log_path) as f:
        recs = [json.loads(line) for line in f]
    return [(r["jobs"], r["lanes"], r["cache"]) for r in recs
            if r.get("event") == "batch_start"]


def test_jax_and_port_daemons_agree(tmp_path):
    """Two packed same-shape jobs and one of another shape, then a repeat
    of the first shape (a cache hit): each job's state sequence, each
    batch's lanes and cache outcome and every digest row are the same in
    the JAX ServeDaemon and the port's."""
    rounds = [[("j0", write_cfg(tmp_path, "a.yaml", seed=5)),
               ("j1", write_cfg(tmp_path, "b.yaml", seed=6)),
               ("j2", write_cfg(tmp_path, "c.yaml", seed=7, ev_cap=64))],
              [("j3", write_cfg(tmp_path, "d.yaml", seed=8)),
               ("j4", write_cfg(tmp_path, "e.yaml", seed=9, loss=0.1))]]
    port = ServeDaemon(str(tmp_path / "port"), poll_s=0.05,
                       ckpt_every_s=1e9, device="cpu").start()
    ref = ServeDaemonJ(str(tmp_path / "jax"), poll_s=0.05,
                       ckpt_every_s=1e9).start()
    try:
        for jobs in rounds:
            for d, cl in ((port, client), (ref, client_j)):
                for jid, cfg in jobs:
                    cl.submit(d.spool.root, cfg, job_id=jid)
                while d.step():
                    pass
        ids = [jid for jobs in rounds for jid, _ in jobs]
        states = _job_states(port.spool.root)
        assert states == _job_states(ref.spool.root)
        assert all(states[j] == ["queued", "running", "done"] for j in ids)
        batches = _batches(port.spool.root)
        assert batches == _batches(ref.spool.root)
        assert [b[2] for b in batches] == ["miss", "miss", "hit"]
        for j in ids:
            served = served_stream(port.spool.root, j)
            assert len(served) == 40
            assert served == served_stream(ref.spool.root, j)
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# JSON submissions (the card has no YAML parser)
# ---------------------------------------------------------------------------

def _arrays_sha(exp) -> str:
    return hashlib.sha256(json.dumps(ct.experiment_arrays(exp),
                                     sort_keys=True).encode()).hexdigest()


@pytest.mark.parametrize("name", ["serve_phold.yaml", "dense_tgen50k.yaml"])
def test_json_and_yaml_configs_build_equal_experiments(name, tmp_path):
    """The JSON form of a config (parsed by ``json``, and by ``yaml``,
    which reads JSON too: PyYAML 1.1 would read a number such as 1e-05 as
    a string) compiles to the experiment and params of its YAML form,
    through ``load_experiment`` and through a daemon's admission."""
    text = (ROOT / "configs" / name).read_text()
    doc = yaml.safe_load(text)
    js = json.dumps(doc)
    ref = build_experiment(doc)
    for parsed in (json.loads(js), yaml.safe_load(js)):
        got = build_experiment(parsed)
        assert _arrays_sha(got[0]) == _arrays_sha(ref[0])
        assert got[1:] == ref[1:]
    (tmp_path / "c.yaml").write_text(text)
    (tmp_path / "c.json").write_text(js)
    from_yaml = load_experiment(str(tmp_path / "c.yaml"))
    from_json = load_experiment(str(tmp_path / "c.json"))
    assert _arrays_sha(from_json[0]) == _arrays_sha(from_yaml[0])
    assert from_json[1:] == from_yaml[1:]
    d = ServeDaemon(str(tmp_path / "spool"), device="cpu")
    a = d._validate({"id": "a", "config_yaml": js})
    b = d._validate({"id": "b", "config_yaml": text})
    assert _arrays_sha(a.exp) == _arrays_sha(b.exp)
    assert a.params == b.params and a.est_peak == b.est_peak > 0


def test_tgen50k_json_is_the_golden_experiment():
    """The card's served tgen50k job (``chip_smoke.py`` phase 16): the
    JSON form of configs/dense_tgen50k.yaml cut to 200 ms compiles to the
    experiment of ``golden/net_tgen50k.json``."""
    doc = yaml.safe_load((ROOT / "configs" / "dense_tgen50k.yaml")
                         .read_text())
    doc["general"]["stop_time"] = "200 ms"
    doc["engine"]["state_digest"] = 1
    gold = json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / "net_tgen50k.json").read_text())
    exp, params, _ = build_experiment(json.loads(json.dumps(doc)))
    assert _arrays_sha(exp) == gold["experiment_sha256"]
    assert {k: getattr(params, k) for k in gold["params"]} == gold["params"]


# ---------------------------------------------------------------------------
# spool protocol
# ---------------------------------------------------------------------------

def test_spool_submit_is_atomic_and_accept_moves_once(tmp_path):
    spool = Spool(str(tmp_path / "s")).ensure()
    jid = spool.submit({"config_yaml": "x: 1", "priority": 0})
    (path, job), = spool.scan_inbox()
    assert job["id"] == jid
    # a .tmp from an in-flight atomic write is invisible
    (Path(spool.inbox) / "zz.json.tmp").write_text("{")
    assert len(spool.scan_inbox()) == 1
    spool.accept(path, job)
    assert spool.scan_inbox() == []
    with open(spool.job_path(jid)) as f:
        assert json.load(f)["id"] == jid


def test_unparseable_submission_rejected_not_fatal(tmp_path, daemon):
    (Path(daemon.spool.inbox) / "hand.json").write_text("{torn")
    daemon._intake()
    assert daemon.ledger_dict()["jobs_rejected"] == 1
    assert os.path.exists(os.path.join(daemon.spool.inbox, "hand.json.bad"))


def test_spool_refuses_second_daemon(tmp_path, daemon):
    with pytest.raises(SpoolError):
        ServeDaemon(daemon.spool.root, device="cpu").start()
