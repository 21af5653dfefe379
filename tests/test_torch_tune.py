"""The port's capacity tuning (``shadow1_tpu_torch/tune/``) against the JAX
package's ``tune/``, on the CPU.

* ``ladder``: ``cap_ladder``, ``quantize_cap``, ``next_step``,
  ``recommend_cap`` and ``classify`` equal the reference's over the range;
* ``resize_state``: a grow, and a shrink that packs occupied slots from
  above the new cap, equal the reference's migration leaf by leaf on the
  same state (a PHOLD state, and a TCP state with restarts and the
  probe/link planes); a shrink that would drop an event raises, as the
  reference's does;
* ``Engine.at_caps`` shares the device tables and runs as a fresh engine
  at those caps does;
* ``CapController`` (retry attached): the resize records, the guard's
  report and the final digests, metrics and state leaves equal the JAX
  controller's, for a shrink (an over-provisioned PHOLD) and a grow
  (tgen's slow-start ramp past its starting cap);
* cross-cap resume: a JAX ``.npz`` saved at one cap loads in the port at
  another as the JAX package's own migrated load does, and runs on to
  the JAX run's end.
"""

import dataclasses

import jax
import numpy as np
import pytest

from shadow1_tpu import ckpt as ckpt_j
from shadow1_tpu.ckpt import run_chunked as run_chunked_j
from shadow1_tpu.config.compiled import single_vertex_experiment as sve_j
from shadow1_tpu.consts import MS, SEC
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.telemetry.ring import drain_ring as drain_j
from shadow1_tpu.tune import autocap as autocap_j
from shadow1_tpu.tune import ladder as ladder_j
from shadow1_tpu.tune import resize as resize_j
from shadow1_tpu.txn import OverflowGuard as GuardJ
from shadow1_tpu_torch import ckpt as ckpt_t
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.ckpt import run_chunked as run_chunked_t
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.telemetry.ring import drain_ring as drain_t
from shadow1_tpu_torch.tune import autocap as autocap_t
from shadow1_tpu_torch.tune import ladder as ladder_t
from shadow1_tpu_torch.tune import resize as resize_t
from shadow1_tpu_torch.txn import OverflowGuard as GuardT
from tests.test_torch_ckpt import obs_experiment
from tests.test_torch_tgen import _one_thread, assert_same_leaves  # noqa: F401


def phold_kw(n_hosts=32, seed=17, end_time=100 * MS, init_events=2):
    return dict(n_hosts=n_hosts, seed=seed, end_time=end_time,
                latency_ns=1 * MS, model="phold",
                model_cfg={"mean_delay_ns": float(2 * MS),
                           "init_events": init_events})


def tgen_kw(n_hosts=8, seed=21, streams=2, mean_bytes=120_000, end=3 * SEC):
    return dict(n_hosts=n_hosts, seed=seed, end_time=end, latency_ns=10 * MS,
                bw_bits=10**7, model="net", model_cfg={
                    "app": "tgen",
                    "active": np.ones(n_hosts, np.int64),
                    "streams": np.full(n_hosts, streams, np.int64),
                    "mean_bytes": np.full(n_hosts, mean_bytes, np.float64),
                    "mean_think_ns": np.full(n_hosts, 50 * MS, np.float64),
                    "start_time": np.full(n_hosts, 1 * MS, np.int64)})


def both(kw):
    """The same experiment for each package."""
    return sve_j(**kw), ct.single_vertex_experiment(**kw)


def test_ladder_matches_reference():
    assert ladder_t.cap_ladder() == ladder_j.cap_ladder()
    assert ladder_t.cap_ladder(600) == ladder_j.cap_ladder(600)
    for v in (ladder_t.LADDER_MIN, ladder_t.HEADROOM, ladder_t.MIN_HEADROOM):
        assert v in (ladder_j.LADDER_MIN, ladder_j.HEADROOM,
                     ladder_j.MIN_HEADROOM)
    for n in range(-3, 5000):
        assert ladder_t.quantize_cap(n) == ladder_j.quantize_cap(n), n
        assert ladder_t.next_step(n) == ladder_j.next_step(n), n
        assert ladder_t.recommend_cap(n) == ladder_j.recommend_cap(n), n
    for peak, cap in ((0, 8), (43, 512), (43, 64), (43, 52), (300, 256),
                      (7, 8), (1000, 1024)):
        assert ladder_t.classify(peak, cap) == ladder_j.classify(peak, cap)


def _net_state():
    """A TCP state with restarts, the ring, digests, probes and the link
    accumulator, after 8 windows (its fullest host's peak has drained, so
    events sit above the current fill)."""
    from tests.test_torch_ckpt import OBS_PARAMS

    eng = EngineT(obs_experiment(), EngineParamsT(**OBS_PARAMS), device="cpu")
    return eng.run(n_windows=8)


def _phold_state():
    _, exp = both(phold_kw(init_events=6))
    return EngineT(exp, EngineParamsT(ev_cap=64, outbox_cap=48),
                   device="cpu").run(n_windows=7)


@pytest.mark.parametrize("which", ["phold", "net"])
def test_resize_state_matches_reference(which):
    """Grow and shrink, each package's migration on the same state: leaf by
    leaf equal, dtypes included; the shrink packs occupied slots that sat
    above the new cap."""
    st = _phold_state() if which == "phold" else _net_state()
    host = convert.state_to_numpy(st)
    cap = host.evbuf.kind.shape[-2]
    ob_cap = host.outbox.dst.shape[-2]
    # The shrink goes down to the fullest host's count, so a host whose
    # events sit above that slot has them packed down.
    small = int((host.evbuf.kind != 0).sum(axis=0).max())
    assert small < cap
    assert bool((host.evbuf.kind[small:] != 0).any())
    for ev, ob in ((2 * cap, ob_cap + 16), (small, ob_cap),
                   (small, ob_cap // 2)):
        want = resize_j.resize_state(host, ev_cap=ev, outbox_cap=ob)
        got = resize_t.resize_state(st, ev_cap=ev, outbox_cap=ob)
        assert got.evbuf.kind.shape[-2] == ev and got.outbox.dst.shape[-2] == ob
        assert_same_leaves(want, convert.state_to_numpy(got))
        # The input's planes are left as they were.
        assert_same_leaves(host, convert.state_to_numpy(st))


def test_shrink_refuses_to_drop_events():
    st = _phold_state()
    fill = int((st.evbuf.kind != 0).sum(dim=0).max())
    host = convert.state_to_numpy(st)
    with pytest.raises(ValueError, match="cannot shrink ev_cap") as ej:
        resize_j.resize_state(host, ev_cap=fill - 1)
    with pytest.raises(ValueError, match="cannot shrink ev_cap") as et:
        resize_t.resize_state(st, ev_cap=fill - 1)
    assert str(et.value) == str(ej.value)


def test_at_caps_shares_tables_and_runs_as_a_fresh_engine():
    exp = obs_experiment()
    from tests.test_torch_ckpt import OBS_PARAMS

    params = EngineParamsT(**OBS_PARAMS)
    eng = EngineT(exp, params, device="cpu")
    sib = eng.at_caps(dataclasses.replace(params, ev_cap=96))
    assert sib.ctx.init_model is eng.ctx.init_model
    assert sib.ctx.lat_vv is eng.ctx.lat_vv and sib.params.ev_cap == 96
    fresh = EngineT(exp, dataclasses.replace(params, ev_cap=96), device="cpu")
    assert_same_leaves(convert.state_to_numpy(fresh.run(n_windows=5)),
                       convert.state_to_numpy(sib.run(n_windows=5)))
    with pytest.raises(ValueError, match="ev_cap and outbox_cap only"):
        eng.at_caps(dataclasses.replace(params, metrics_ring=3))


def _auto(pkg, exp, params, windows, chunk, policy):
    """run_chunked under a CapController with a retry guard attached; the
    digest rows drained at every committed boundary."""
    if pkg == "jax":
        eng = EngineJ(exp, EngineParamsJ(**params))
        ctl = autocap_j.CapController(
            eng, lambda p: EngineJ(exp, p),
            policy=autocap_j.CapPolicy(**policy))
        guard = GuardJ(eng, mode="retry", controller=ctl)
        run, drain = run_chunked_j, drain_j
    else:
        eng = EngineT(exp, EngineParamsT(**params), device="cpu")
        ctl = autocap_t.CapController(eng, eng.at_caps,
                                      policy=autocap_t.CapPolicy(**policy))
        guard = GuardT(eng, mode="retry", controller=ctl)
        run, drain = run_chunked_t, drain_t
    rows, start = [], [0]

    def on_chunk(s, _done):
        rows.extend(drain(s, exp.window, start=start[0]))
        start[0] = int(s.metrics.windows)

    st = run(eng, n_windows=windows, chunk=chunk, on_chunk=on_chunk,
             guard=guard, retune=ctl)
    return st, ctl, guard, rows


@pytest.mark.parametrize("case", ["shrink_phold", "grow_tgen"])
def test_controller_matches_reference(case):
    """The controller's resize records, the guard's report, every digest
    row and the final state equal the JAX controller's: a shrink of a 4×
    over-provisioned PHOLD, and a grow ahead of tgen's slow-start ramp."""
    if case == "shrink_phold":
        kw, windows, chunk = phold_kw(), 100, 20
        params = dict(ev_cap=64, metrics_ring=chunk, state_digest=1)
        policy = {}
    else:
        kw, windows, chunk = tgen_kw(n_hosts=4, end=300 * MS), 30, 5
        params = dict(ev_cap=48, metrics_ring=chunk, state_digest=1)
        policy = dict(shrink_patience=1000)
    exp_j, exp_t = both(kw)
    st_j, ctl_j, g_j, rows_j = _auto("jax", exp_j, params, windows, chunk,
                                     policy)
    st_t, ctl_t, g_t, rows_t = _auto("torch", exp_t, params, windows, chunk,
                                     policy)
    assert ctl_j.resizes, "the controller must resize"
    assert ctl_t.resizes == ctl_j.resizes
    assert ctl_t.final_caps == ctl_j.final_caps
    assert g_t.report() == g_j.report() and g_t.resizes == g_j.resizes
    assert rows_t == rows_j and len(rows_t) == windows
    assert EngineT.metrics_dict(st_t) == EngineJ.metrics_dict(st_j)
    assert_same_leaves(jax.tree.map(np.asarray, st_j),
                       convert.state_to_numpy(st_t))
    if case == "shrink_phold":
        assert ctl_t.final_caps["ev_cap"] < 64
    else:
        assert ctl_t.final_caps["ev_cap"] > 48
        assert int(st_t.metrics.ev_overflow) == 0


def test_cross_cap_resume_matches_reference(tmp_path):
    """A JAX snapshot at ev_cap 48 / outbox_cap 64, loaded at 96 / 32 by
    each package: the same leaves; the port run continues to the JAX
    run's end at those caps."""
    exp_j, exp_t = both(phold_kw(init_events=4))
    eng_a = EngineJ(exp_j, EngineParamsJ(ev_cap=48, metrics_ring=8,
                                         state_digest=1))
    path = str(tmp_path / "cap48.npz")
    ckpt_j.save_state(eng_a.run(n_windows=40), path)
    pj = EngineParamsJ(ev_cap=96, outbox_cap=32, metrics_ring=8,
                       state_digest=1)
    eng_bj = EngineJ(exp_j, pj)
    want = ckpt_j.load_state(eng_bj.init_state(), path)
    eng_bt = EngineT(exp_t, EngineParamsT(**dataclasses.asdict(pj)),
                     device="cpu")
    assert ckpt_t.snapshot_caps(eng_bt.init_state(), path) == (48, 64)
    got = ckpt_t.load_state(eng_bt.init_state(), path)
    assert_same_leaves(jax.tree.map(np.asarray, want),
                       convert.state_to_numpy(got))
    end_j = eng_bj.run(want, n_windows=20)
    end_t = eng_bt.run(got, n_windows=20)
    assert EngineT.metrics_dict(end_t) == EngineJ.metrics_dict(end_j)
    assert drain_t(end_t, exp_t.window) == drain_j(end_j, exp_j.window)
    # A shrink below a host's events refuses, naming the way out.
    tiny = EngineT(exp_t, EngineParamsT(ev_cap=8, metrics_ring=8,
                                        state_digest=1), device="cpu")
    with pytest.raises(ValueError, match="cannot migrate"):
        ckpt_t.load_state(tiny.init_state(), path)
