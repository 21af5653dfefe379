"""The port's flow probes and link accumulator against the JAX package, on
the CPU.

* Two fidelity tiles with 5 % loss (``test_torch_ckpt.obs_experiment``:
  host cycles, a link outage, NIC queue bounds, so every link column is
  nonzero somewhere): the port's flow rows and link records equal the JAX
  engine's; each drop column of the link records adds up to its global
  counter; the digest words are the same with the planes off; a run
  resumed from a snapshot mid-way drains the same flow and link streams
  as a straight run.
* Probes on a small Tor run with active-host compaction off and on, and
  on PHOLD (the host view: only ``pending_events`` moves), against the
  JAX package's numpy oracle (``CpuEngine.probe_rows``, which its own
  tests hold bit-exact to its ``Engine``).
* ``flow_gap`` and ``link_gap`` records equal the reference drain's on
  the same buffers; ``resolve_watchlist`` equals the reference's, typo
  suggestions included; the ``probes:`` section resolves as the
  reference's and ``engine: {probes: ...}`` is refused as there; the
  guards (probes need a ring, ``link_telem`` 1 only, the dense bound) and
  a planes-off state's layout.
"""

import copy
from pathlib import Path

import pytest
import yaml

from shadow1_tpu.config import experiment as xj
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.cpu_engine import CpuEngine
from shadow1_tpu.telemetry import links as links_j
from shadow1_tpu.telemetry import probes as probes_j
from shadow1_tpu_torch import ckpt, convert
from shadow1_tpu_torch.config import experiment as xt
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core import compact
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.obs import run_with_heartbeat
from shadow1_tpu_torch.telemetry.links import (
    check_link_params,
    drain_links,
)
from shadow1_tpu_torch.telemetry.probes import drain_probes
from tests.test_tor_parity import tor_exp
from tests.test_torch_ckpt import (
    MID,
    OBS_PARAMS,
    PROBES,
    WINDOWS,
    jax_obs_run,
    obs_experiment,
    records,
)
from tests.test_torch_fault import _phold_churn_exp
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import _one_thread, port_experiment  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_run():
    return jax_obs_run()


@pytest.fixture(scope="module")
def port_run():
    eng = EngineT(obs_experiment(), EngineParamsT(**OBS_PARAMS), device="cpu")
    st = eng.run(n_windows=WINDOWS)
    return eng, st


def test_flow_and_link_records_match_jax(jax_run, port_run):
    eng, st = port_run
    recs = records(st, eng.window)
    assert recs == jax_run.recs
    assert EngineT.metrics_dict(st) == jax_run.metrics
    assert len(recs["flow"]) == WINDOWS * len(PROBES)
    for col, metric in (("loss_drops", "pkts_lost"),
                        ("link_down_drops", "link_down_pkts"),
                        ("nic_backlog_drops", "nic_tx_drops"),
                        ("pkts", "pkts_sent")):
        total = sum(r[col] for r in recs["link"])
        assert total == jax_run.metrics[metric] > 0, col


def test_digest_words_unchanged_with_planes_on(port_run):
    eng, st = port_run
    off = EngineT(obs_experiment(), EngineParamsT(**dict(
        OBS_PARAMS, probes=(), link_telem=0)), device="cpu")
    st_off = off.run(n_windows=WINDOWS)
    assert st_off.probes is None and st_off.links is None
    on_rows = records(st, eng.window)["ring"]
    assert records(st_off, off.window, probes=())["ring"] == on_rows
    assert EngineT.metrics_dict(st_off) == EngineT.metrics_dict(st)


def test_resumed_streams_equal_straight(port_run, tmp_path):
    """run_with_heartbeat to window MID, a snapshot, a fresh engine resumed
    from it to the end: the flow rows of both halves are the straight
    run's, and the last link snapshot is its final one."""
    eng, st_full = port_run
    _, hb1 = run_with_heartbeat(eng, n_windows=MID, every_windows=MID,
                                stream=False, ckpt_path=str(tmp_path / "c"),
                                ckpt_every_s=0.0)
    fresh = EngineT(obs_experiment(), EngineParamsT(**OBS_PARAMS),
                    device="cpu")
    st = ckpt.load_state(fresh.init_state(), str(tmp_path / "c"))
    st, hb2 = run_with_heartbeat(fresh, st, n_windows=WINDOWS - MID,
                                 every_windows=3, stream=False)
    straight = records(st_full, eng.window)
    assert hb1.flow_records + hb2.flow_records == straight["flow"]
    assert [r["window"] for r in hb2.link_records] == (
        [MID + 2] * 2 + [WINDOWS - 1] * 2)
    assert hb2.link_records[-2:] == straight["link"]
    assert hb1.ring_records + hb2.ring_records == straight["ring"]


def _key(r):
    return (r["window"], r["host"], r["sock"])


@pytest.mark.parametrize("compact_cap", [0, 8])
def test_tor_probes_match_oracle(compact_cap):
    """Tor (24 hosts; clients, relays, a dirauth and an idle host watched;
    50 windows): the port's flow rows, with compaction off and at 8
    lanes, equal the oracle's."""
    windows = 50
    exp = tor_exp(end=windows * 10_000_000, n_circuits=1, n_streams=1,
                  mean_cells=10.0)
    probes = ((0, 0), (3, -1), (10, 0), (12, 1), (9, -1), (23, -1))
    params = dict(ev_cap=256, sockets_per_host=32, metrics_ring=windows,
                  probes=probes)
    oracle = CpuEngine(exp, EngineParamsJ(**params))
    oracle.run(n_windows=windows)
    for k in compact.WINDOWS:
        compact.WINDOWS[k] = 0
    eng = EngineT(port_experiment(exp), EngineParamsT(
        **params, compact_cap=compact_cap), device="cpu")
    st = eng.run(n_windows=windows)
    rows = drain_probes(st, eng.window, probes)
    assert sorted(rows, key=_key) == sorted(oracle.probe_rows, key=_key)
    assert any(r["cwnd"] > 0 and r["srtt"] > 0 for r in rows)
    if compact_cap:
        assert compact.WINDOWS["compact"] > 0 and compact.WINDOWS["full"] > 0


def test_phold_host_view_matches_oracle():
    probes = ((1, -1), (5, -1), (7, -1))
    params = dict(metrics_ring=20, probes=probes)
    exp = _phold_churn_exp()
    oracle = CpuEngine(jax_experiment(_phold_churn_exp()),
                       EngineParamsJ(**params))
    oracle.run(n_windows=20)
    eng = EngineT(exp, EngineParamsT(**params), device="cpu")
    rows = drain_probes(eng.run(n_windows=20), eng.window, probes)
    assert sorted(rows, key=_key) == sorted(oracle.probe_rows, key=_key)
    assert any(r["pending_events"] > 0 for r in rows)
    assert all(r["cwnd"] == 0 and r["nic_tx_bytes"] == 0 for r in rows)


def test_gap_records_match_reference(port_run):
    """A 4-window probe ring drained from window 0 after 11 windows: one
    ``flow_gap`` then the 4 kept windows; a link drain from a cursor past
    the state: one ``link_gap`` — as the reference's drains of the same
    buffers."""
    _, st = port_run
    ring = st.probes.buf[-4:]
    st4 = st._replace(probes=st.probes._replace(buf=ring.roll(
        -(WINDOWS % 4), 0)))
    got = drain_probes(st4, 39_000_000, PROBES)
    assert got[0]["type"] == "flow_gap" and got[0]["windows_lost"] == 7
    st4_np = convert.state_to_numpy(st4)
    assert got == probes_j.drain_probes(st4_np, 39_000_000, PROBES)
    gap = drain_links(st, 39_000_000, start=WINDOWS + 2)
    assert gap == links_j.drain_links(convert.state_to_numpy(st), 39_000_000,
                                      start=WINDOWS + 2)
    assert gap == [{"type": "link_gap", "window": WINDOWS,
                    "expected_window": WINDOWS + 2}]
    assert drain_links(st, 39_000_000, start=WINDOWS) == []


def _docs():
    doc = yaml.safe_load((ROOT / "configs" / "churn_filexfer.yaml")
                         .read_text())
    return doc, str(ROOT / "configs")


@pytest.mark.parametrize("entries", [
    ["server", "client-2:1", "client[0]:0", 3, {"host": "client[1]"},
     {"host": 0, "sock": 2}],
    ["server", "server", 0, "@client:0"],
    "client-0:1",
    ["clinet:0"], ["client-0:99"], [99], ["client:x"], [{"hots": "client"}],
    ["client[x]"], 5,
])
def test_resolve_watchlist_matches_reference(entries):
    doc, base = _docs()
    exp_j, par_j, _ = xj.build_experiment(copy.deepcopy(doc), base_dir=base)
    exp_t, par_t, _ = xt.build_experiment(copy.deepcopy(doc), base_dir=base)

    def run(mod, exp):
        try:
            return mod.resolve_watchlist(copy.deepcopy(entries), exp.dns, 4)
        except mod.WatchlistError as e:
            return ("error", str(e))

    want = run(xj, exp_j)
    assert run(xt, exp_t) == want
    if entries == ["clinet:0"]:
        assert "did you mean 'client'" in want[1]


def test_probes_section_and_engine_key():
    doc, base = _docs()
    doc["probes"] = ["server:1", "client[3]", {"host": "client-1", "sock": 0}]
    _, par_j, _ = xj.build_experiment(copy.deepcopy(doc), base_dir=base)
    _, par_t, _ = xt.build_experiment(copy.deepcopy(doc), base_dir=base)
    assert par_t.probes == par_j.probes == ((0, 1), (4, -1), (2, 0))
    bad = copy.deepcopy(doc)
    bad["engine"]["probes"] = [0]
    for mod in (xj, xt):
        with pytest.raises(AssertionError, match="probes"):
            mod.build_experiment(copy.deepcopy(bad), base_dir=base)
    doc["probes"] = ["serevr"]
    with pytest.raises(xt.WatchlistError, match="did you mean 'server'"):
        xt.build_experiment(doc, base_dir=base)


def test_guards_and_off_layout():
    exp = _phold_churn_exp()
    with pytest.raises(ValueError, match="metrics_ring"):
        EngineT(exp, EngineParamsT(probes=((1, -1),)), device="cpu")
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="top-K"):
        check_link_params(SimpleNamespace(link_telem=2), 4)
    with pytest.raises(ValueError, match="dense"):
        check_link_params(EngineParamsT(link_telem=1), 2000)
    off = EngineT(exp, EngineParamsT(metrics_ring=4), device="cpu")
    on = EngineT(exp, EngineParamsT(metrics_ring=4, probes=((1, -1),),
                                    link_telem=1), device="cpu")
    n_off = len(convert.flatten_like_jax(off.init_state()))
    st_on = on.init_state()
    assert off.init_state().probes is None and off.init_state().links is None
    assert len(convert.flatten_like_jax(st_on)) == n_off + 2
    assert tuple(st_on.links.buf.shape) == (1, 1, 7)
    assert tuple(st_on.probes.buf.shape) == (4, 1, 14)
