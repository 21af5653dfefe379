"""The port's checkpoints against the JAX package's, on the CPU.

A snapshot is the reference's ``.npz`` (format v12: ``leaf_{i}`` in
``jax.tree_util`` order, ``format``, ``integrity``), so it crosses between
the packages both ways and the run that continues is bit-identical to a
straight run. The run: ``fidelity_filexfer_experiment`` at two tiles (16
hosts, every fidelity gate, host cycles, a link outage and a loss ramp)
with 5 % path loss, the telemetry ring, the digest words, five flow
probes and the link accumulator on, 11 windows, cut at window 5:

* port snapshot → JAX ``ckpt.load_state`` → the JAX run continues equal to
  a straight JAX run (every metric, summary array, ring row with its
  digest words, flow record, link record and state leaf);
* JAX snapshot → the port's ``load_state`` → the port run continues equal
  to a straight port run and to the JAX one;
* the port's ``_integrity_digest`` equals the reference's; a truncated
  file and a flipped bit raise ``CorruptCheckpointError``; a snapshot of
  another config raises ``ValueError``; one saved at other caps loads
  through the cap migration, as the JAX package's load of it does;
  ``verify_file`` and
  ``snapshot_caps`` agree with the reference's on both packages' files
  (a small PHOLD with the ring, the digest and a host probe on).

``obs_experiment`` / ``OBS_PARAMS`` / ``jax_obs_run`` serve
``test_torch_probes_links.py``: one JAX program for both files.
"""

import types

import jax
import numpy as np
import pytest
import torch

from shadow1_tpu import ckpt as ckpt_j
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.telemetry.links import drain_links as links_j
from shadow1_tpu.telemetry.probes import drain_probes as probes_j
from shadow1_tpu.telemetry.ring import drain_ring as ring_j
from shadow1_tpu_torch import ckpt as ckpt_t
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.telemetry.links import drain_links as links_t
from shadow1_tpu_torch.telemetry.probes import drain_probes as probes_t
from shadow1_tpu_torch.telemetry.ring import drain_ring as ring_t
from tests.test_torch_fault import _phold_churn_exp
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import _one_thread, assert_same_leaves  # noqa: F401

MS = 10**6
WINDOWS, MID = 11, 5
PROBES = ((0, -1), (1, 0), (2, 0), (3, 0), (9, 0))
OBS_PARAMS = dict(ev_cap=512, metrics_ring=WINDOWS, state_digest=1,
                  probes=PROBES, link_telem=1)


def obs_experiment():
    """Two fidelity tiles with 5 % path loss, so every link column (the
    loss, link-down and NIC-backlog drops too) is nonzero somewhere."""
    exp = ct.fidelity_filexfer_experiment(2, 42, 400 * MS)
    exp.loss_vv = np.full_like(exp.loss_vv, 0.05)
    return exp


def records(st, window: int, probes=PROBES, start: int = 0) -> dict:
    """A port state's ring, flow and link records."""
    return dict(ring=ring_t(st, window, start), flow=probes_t(
        st, window, probes, start), link=links_t(st, window))


def jax_records(st, window: int, probes=PROBES, start: int = 0) -> dict:
    return dict(ring=ring_j(st, window, start), flow=probes_j(
        st, window, probes, start), link=links_j(st, window))


def jax_obs_run():
    """The JAX engine on ``obs_experiment``: the engine, the states at
    windows MID and WINDOWS and the end's records and metrics."""
    exp = jax_experiment(obs_experiment())
    eng = EngineJ(exp, EngineParamsJ(**OBS_PARAMS))
    st_mid = eng.run(n_windows=MID)
    st_end = eng.run(st_mid, n_windows=WINDOWS - MID)
    return types.SimpleNamespace(
        eng=eng, mid=st_mid, end=st_end, window=exp.window,
        recs=jax_records(st_end, exp.window),
        metrics=EngineJ.metrics_dict(st_end),
        summary=jax.tree.map(np.asarray, eng.model_summary(st_end)))


@pytest.fixture(scope="module")
def jax_run():
    return jax_obs_run()


@pytest.fixture(scope="module")
def port_run():
    eng = EngineT(obs_experiment(), EngineParamsT(**OBS_PARAMS), device="cpu")
    st_mid = eng.run(n_windows=MID)
    mid = convert.state_to_numpy(st_mid)
    st_end = eng.run(st_mid, n_windows=WINDOWS - MID)
    return types.SimpleNamespace(eng=eng, mid=mid, end=st_end,
                                 recs=records(st_end, eng.window))


def port_summary(st):
    """The port's model summary of a state (an engine of OBS_PARAMS)."""
    eng = EngineT(obs_experiment(), EngineParamsT(**OBS_PARAMS),
                  device="cpu")
    return eng.model_summary(st)


def assert_end_equal(jax_run, st_j=None, st_t=None):
    """A JAX and/or a port end state equal the straight JAX run's."""
    if st_j is not None:
        assert EngineJ.metrics_dict(st_j) == jax_run.metrics
        summ = jax_run.eng.model_summary(st_j)
        for k, v in jax_run.summary.items():
            np.testing.assert_array_equal(np.asarray(summ[k]), v, err_msg=k)
        assert jax_records(st_j, jax_run.window) == jax_run.recs
        for a, b in zip(jax.tree.leaves(jax_run.end), jax.tree.leaves(st_j)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    if st_t is not None:
        assert EngineT.metrics_dict(st_t) == jax_run.metrics
        assert records(st_t, jax_run.window) == jax_run.recs
        summ = port_summary(st_t)
        assert set(summ) == set(jax_run.summary)
        for k, v in jax_run.summary.items():
            np.testing.assert_array_equal(summ[k], v, err_msg=k)
        assert_same_leaves(jax.tree.map(np.asarray, jax_run.end),
                           convert.state_to_numpy(st_t))


def test_straight_runs_agree(jax_run, port_run):
    """The two straight runs agree, and the run reached every plane:
    flows moved, and every link column is nonzero on some edge."""
    assert_end_equal(jax_run, st_t=port_run.end)
    recs = jax_run.recs
    assert len(recs["flow"]) == WINDOWS * len(PROBES)
    assert any(r["cwnd"] > 0 for r in recs["flow"])
    for f in ("pkts", "bytes", "loss_drops", "link_down_drops",
              "nic_backlog_drops", "queued_ns_sum", "queued_ns_max"):
        assert any(r[f] > 0 for r in recs["link"]), f


def test_port_snapshot_resumes_in_jax(jax_run, port_run, tmp_path):
    path = str(tmp_path / "port.npz")
    st_mid = convert.state_from_numpy(port_run.mid, "cpu")
    ckpt_t.save_state(st_mid, path)
    ok, why = ckpt_j.verify_file(path)
    assert ok, why
    st = ckpt_j.load_state(jax_run.eng.init_state(), path)
    st = jax_run.eng.run(st, n_windows=WINDOWS - MID)
    assert_end_equal(jax_run, st_j=st)


def test_jax_snapshot_resumes_in_port(jax_run, port_run, tmp_path):
    path = str(tmp_path / "jax.npz")
    ckpt_j.save_state(jax_run.mid, path)
    eng = port_run.eng
    st = ckpt_t.load_state(eng.init_state(), path)
    assert_same_leaves(jax.tree.map(np.asarray, jax_run.mid),
                       convert.state_to_numpy(st))
    st = eng.run(st, n_windows=WINDOWS - MID)
    assert_end_equal(jax_run, st_t=st)
    assert records(st, eng.window) == port_run.recs


def test_snapshot_files_are_the_references(jax_run, port_run, tmp_path):
    """The same state saved by either package: the same members, leaf for
    leaf the same dtype, shape and bytes, the same integrity word."""
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    ckpt_j.save_state(jax_run.mid, pj)
    ckpt_t.save_state(convert.state_from_numpy(port_run.mid, "cpu"), pt)
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("seed", range(3))
def test_integrity_digest_matches_reference(seed):
    g = np.random.default_rng(seed)
    leaves = [g.integers(-2**62, 2**62, size=g.integers(0, 40)),
              g.integers(-2**31, 2**31, size=(3, 5)).astype(np.int32),
              g.random(7) < 0.5, np.zeros(0, np.int32),
              g.integers(0, 2**63, size=3, dtype=np.uint64),
              np.asarray(seed, np.int64)]
    assert ckpt_t._integrity_digest(leaves) == ckpt_j._integrity_digest(leaves)
    flipped = [x.copy() for x in leaves]
    flipped[1][1, 2] ^= 1 << (seed * 7)
    assert (ckpt_t._integrity_digest(flipped)
            == ckpt_j._integrity_digest(flipped)
            != ckpt_t._integrity_digest(leaves))


def _phold(**kw):
    params = dict(metrics_ring=8, state_digest=1, probes=((1, -1),))
    params.update(kw)
    return EngineT(_phold_churn_exp(), EngineParamsT(**params), device="cpu")


def _phold_j(**kw):
    params = dict(metrics_ring=8, state_digest=1, probes=((1, -1),))
    params.update(kw)
    return EngineJ(jax_experiment(_phold_churn_exp()),
                   EngineParamsJ(**params))


def test_corrupt_snapshot_raises(tmp_path):
    eng = _phold()
    st = eng.run(n_windows=4)
    path = str(tmp_path / "s.npz")
    ckpt_t.save_state(st, path)
    data = bytearray(open(path, "rb").read())
    bad = tmp_path / "torn.npz"
    bad.write_bytes(bytes(data[:len(data) // 2]))
    with pytest.raises(ckpt_t.CorruptCheckpointError):
        ckpt_t.load_state(eng.init_state(), str(bad))
    assert not ckpt_t.verify_file(str(bad))[0]
    # A flipped bit: the file rewritten with one leaf changed and the old
    # integrity word.
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["leaf_3"] = arrays["leaf_3"].copy()
    arrays["leaf_3"].reshape(-1)[0] ^= 1
    flip = str(tmp_path / "flip.npz")
    np.savez_compressed(flip, **arrays)
    with pytest.raises(ckpt_t.CorruptCheckpointError, match="integrity"):
        ckpt_t.load_state(eng.init_state(), flip)
    assert ckpt_t.verify_file(flip) == ckpt_j.verify_file(flip)
    assert ckpt_t.verify_file(flip)[0] is False


def test_snapshot_of_another_config_raises(tmp_path):
    path = str(tmp_path / "s.npz")
    ckpt_t.save_state(_phold().init_state(), path)
    # No probe ring: one leaf fewer.
    with pytest.raises(ValueError, match="leaves"):
        ckpt_t.load_state(_phold(probes=()).init_state(), path)
    # A deeper ring: the same leaves, another shape.
    with pytest.raises(ValueError, match="config mismatch"):
        ckpt_t.load_state(_phold(metrics_ring=9).init_state(), path)


def test_caps_mismatch_is_refused(tmp_path):
    """The name is historical: a snapshot at other caps was refused until
    the recovery planes ported the cap migration. It loads now, as the
    JAX package's migrated load of the same file does, leaf by leaf; with
    ``migrate_caps=False`` it still fails the shape check."""
    from shadow1_tpu_torch.tune.resize import resize_state

    path = str(tmp_path / "s.npz")
    eng = _phold()
    saved = eng.run(n_windows=6)
    ckpt_t.save_state(saved, path)
    cap = 2 * EngineParamsT().ev_cap
    other = _phold(ev_cap=cap).init_state()
    got = ckpt_t.load_state(other, path)
    assert got.evbuf.kind.shape[-2] == cap
    assert_same_leaves(convert.state_to_numpy(resize_state(saved, ev_cap=cap)),
                       convert.state_to_numpy(got))
    want = ckpt_j.load_state(_phold_j(ev_cap=cap).init_state(), path)
    assert_same_leaves(jax.tree.map(np.asarray, want),
                       convert.state_to_numpy(got))
    with pytest.raises(ValueError, match="config mismatch"):
        ckpt_t.load_state(other, path, migrate_caps=False)


def test_verify_file_and_snapshot_caps_match_reference(tmp_path):
    eng_t, eng_j = _phold(), _phold_j(outbox_cap=48)
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ckpt_t.save_state(eng_t.init_state(), pt)
    ckpt_j.save_state(eng_j.init_state(), pj)
    for p in (pt, pj):
        assert ckpt_t.verify_file(p) == ckpt_j.verify_file(p) == (True, None)
        assert (ckpt_t.snapshot_caps(eng_t.init_state(), p)
                == ckpt_j.snapshot_caps(eng_j.init_state(), p))
    assert ckpt_t.snapshot_caps(eng_t.init_state(), pj) == (
        eng_t.params.ev_cap, 48)
    missing = str(tmp_path / "none.npz")
    assert ckpt_t.verify_file(missing)[0] is False
    assert ckpt_j.verify_file(missing)[0] is False


def test_leaf_order_is_jax_tree_order(port_run):
    """``flatten_like_jax`` lists a port state's leaves as
    ``jax.tree_util`` flattens the reference's tree (dict keys sorted), and
    ``unflatten_like_jax`` puts them back where they were."""
    st = convert.state_from_numpy(port_run.mid, "cpu")
    leaves = convert.flatten_like_jax(st)
    ref = jax.tree.leaves(port_run.mid)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    back = convert.unflatten_like_jax(st, [x.clone() for x in leaves])
    assert list(back.model.tcp) == list(st.model.tcp)
    for a, b in zip(convert.flatten_like_jax(back), leaves):
        assert torch.equal(a, b)
