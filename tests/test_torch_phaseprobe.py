"""The port's ``phaseprobe``, ``roundprobe`` and ``popprof`` against the
JAX package's.

* ``attribution`` of the 256-host smoke config (6 windows after 3) gives
  the JAX ``attribution``'s rounds per window and events, four phases, the
  two sub-phase rows and a coverage of at least 0.9 (min over reps);
* the staged composition (``capture_frames``) equals the port's
  ``window_step`` and the JAX engine's state after the same windows, leaf
  by leaf through ``convert.py``; the kept frames are copies;
* the CLI prints one JSON line, exits 1 under ``--min-coverage`` it misses,
  writes a device trace with the four phase spans, and loads the JSON
  mirror of rung1 (its GraphML named from the repository root);
* ``roundprobe.seeded_buf`` and k steps of its pop, push, cycle and obox
  probes equal the JAX primitives' results on the same numpy inputs; the
  CLI runs every probe at a tiny shape (``--check`` bit equal) and refuses
  the probes with no subject in the port; ``popprof``'s grid runs;
  ``phold_win`` runs ``min(iters, WINDOWS)`` windows; with no device named,
  each entry point asks for the card and raises when there is none.
"""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu.consts import NP
from shadow1_tpu.core import events as ev_j
from shadow1_tpu.core import outbox as ob_j
from shadow1_tpu.tools import phaseprobe as ref
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.core.engine import window_step
from shadow1_tpu_torch.tools import phaseprobe as port
from shadow1_tpu_torch.tools import popprof
from shadow1_tpu_torch.tools import roundprobe as rp

HOSTS, WINDOWS, WARMUP = 256, 6, 3
RUNG1 = "shadow1_tpu_torch/tools/benchgate_configs/rung1_filexfer.json"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(module, argv) -> tuple[int, list, str]:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = module.main(argv)
    return rc, [json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith("{")], err.getvalue()


def test_attribution_matches_the_reference():
    eng_j, label_j = ref.build_engine("smoke", hosts=HOSTS)
    want = ref.attribution(eng_j, n_windows=WINDOWS, warmup=WARMUP, reps=2)
    eng, label = port.build_engine("smoke", hosts=HOSTS, device="cpu")
    got = port.attribution(eng, n_windows=WINDOWS, warmup=WARMUP, reps=5)
    assert label == label_j == "smoke_phold"
    for k in ("rounds_per_window", "events", "windows"):
        assert got[k] == want[k], k
    assert list(got["phases"]) == list(want["phases"]) == [
        "prepare", "rounds", "deliver", "telem"]
    assert set(got["subphases"]) == {"rounds.pop_est", "deliver.route_est"}
    assert got["coverage"] >= 0.9, got
    assert got["phases"]["rounds"]["pct"] > 50  # rounds dominate phold


def test_staged_run_equals_window_step_and_the_jax_state():
    eng, _ = port.build_engine("smoke", hosts=HOSTS, device="cpu")
    st0 = eng.run(eng.init_state(), n_windows=WARMUP)
    phases, frames, st_cap = port.capture_frames(
        eng, convert.clone_state(st0), WINDOWS)
    assert [n for n, _ in phases] == ["prepare", "rounds", "deliver",
                                      "telem"]
    assert all(len(f) == WINDOWS for f in frames.values())
    st = convert.clone_state(st0)
    for _ in range(WINDOWS):
        st = window_step(st, eng.ctx, eng._handlers,
                         eng._model.make_handlers, eng._pre_window)
    a, b = convert.flatten_like_jax(st_cap), convert.flatten_like_jax(st)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # The kept frames are copies: the first rounds frame still holds the
    # window's pending events.
    assert not torch.equal(frames["rounds"][0].st.evbuf.kind,
                           st_cap.evbuf.kind)
    eng_j, _ = ref.build_engine("smoke", hosts=HOSTS)
    st_j = jax.tree.map(np.asarray,
                        eng_j.run(eng_j.init_state(),
                                  n_windows=WARMUP + WINDOWS))
    flat = jax.tree_util.tree_flatten_with_path(st_j)[0]
    mine = jax.tree.leaves(convert.state_to_numpy(st_cap))
    assert len(flat) == len(mine)
    for (path, want), got in zip(flat, mine):
        path = jax.tree_util.keystr(path)
        assert want.dtype == got.dtype and want.shape == got.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    assert EngineT.metrics_dict(st_cap)["events"] > 0


def test_cli_json_md_min_coverage_and_device_trace(tmp_path):
    args = ["smoke", "--hosts", "64", "--windows", "3", "--warmup", "2",
            "--reps", "2", "--device", "cpu"]
    rc, lines, err = _main(port, [*args, "--md", "--min-coverage", "50"])
    assert rc == 1 and len(lines) == 1
    line = lines[0]
    assert line["probe"] == "phaseprobe" and line["backend"] == "cpu"
    assert line["config"] == "smoke_phold" and line["coverage"] > 0
    assert "| phase | ms/window |" in err and "below 50" in err
    trace_dir = tmp_path / "trace"
    rc, lines, _ = _main(port, [*args, "--device-trace", str(trace_dir)])
    assert rc == 0 and lines[0]["device_trace"] == str(trace_dir)
    trace = json.loads((trace_dir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"phase:prepare", "phase:rounds", "phase:deliver",
            "phase:telem", "device-trace"} <= names
    host = json.loads((trace_dir / "phases.trace.json").read_text())
    assert "device-trace" in {e["name"] for e in host["traceEvents"]}


def test_rung1_mirror_builds_and_attributes():
    eng, label = port.build_engine(RUNG1, device="cpu")
    assert label == "rung1_filexfer.json" and eng.exp.n_hosts == 2
    att = port.attribution(eng, n_windows=1, warmup=8, reps=1,
                           subphases=False)
    assert att["rounds_per_window"] > 10 and att["events"] > 0


# -- roundprobe and popprof -------------------------------------------------

H, C, K = 12, 8, 5


def _jax_seeded(n_hosts, cap, fill, g):
    """The reference's ``seeded_buf`` (a closure of its ``main``)."""
    buf = ev_j.evbuf_init(n_hosts, cap)
    t = jnp.asarray(g.integers(0, 1 << 30, (cap, n_hosts)), jnp.int64)
    tb = jnp.asarray(g.integers(0, 1 << 40, (cap, n_hosts)), jnp.int64)
    thi, tlo = ev_j.tb_split(t)
    hi, lo = ev_j.tb_split(tb)
    live = jnp.asarray(np.arange(cap)[:, None] < fill, bool)
    buf = buf._replace(
        time_hi=jnp.where(live, thi, buf.time_hi),
        time_lo=jnp.where(live, tlo, buf.time_lo),
        tb_hi=jnp.where(live, hi, buf.tb_hi),
        tb_lo=jnp.where(live, lo, buf.tb_lo),
        kind=jnp.where(live, 1, buf.kind),
    )
    return ev_j.rebase(buf, 0)


def _assert_same(jax_tuple, torch_tuple):
    for f in torch_tuple._fields:
        want = np.asarray(getattr(jax_tuple, f))
        got = getattr(torch_tuple, f).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_seeded_buf_matches_the_reference():
    want = _jax_seeded(H, C, C // 2, np.random.default_rng(3))
    got = rp.seeded_buf(H, C, C // 2, np.random.default_rng(3), "cpu")
    _assert_same(want, got)


def _jax_steps(name):
    """The reference's probe steps (closures of its ``main``)."""
    until = jnp.int64(rp.UNTIL)
    k = jnp.ones(H, jnp.int32)
    pay = jnp.zeros((NP, H), jnp.int32)
    m = jnp.ones(H, bool)
    if name == "pop":
        def step(buf):
            buf, p = ev_j.pop_until(buf, until)
            return buf._replace(self_ctr=buf.self_ctr + p.time)
    elif name == "push":
        def step(buf):
            buf2, _ = ev_j.push_local(buf, m, buf.self_ctr + 1, k, pay)
            return buf2._replace(kind=buf.kind)
    elif name == "cycle":
        def step(buf):
            buf, p = ev_j.pop_until(buf, until)
            buf, _ = ev_j.push_local(buf, p.mask & m, p.time + 7, k, pay)
            return buf
    else:
        dst = jnp.ones(H, jnp.int32)

        def step(box):
            box2, _ = ob_j.outbox_append(box, m, dst, k, box.pkt_ctr + 7,
                                         pay)
            return box2._replace(cnt=box.cnt)
    return step


@pytest.mark.parametrize("name", ["pop", "push", "cycle", "obox"])
def test_probe_steps_match_the_reference(name):
    step, carry = rp.probe_setup(name, H, C, "cpu", rp.Prims(), seed=11)
    g = np.random.default_rng(11)
    if name == "obox":
        want = ob_j.outbox_init(H, rp.OBOX_CAP)
    else:
        fill = C if name == "pop" else C // 2
        want = _jax_seeded(H, C, fill, g)
    _assert_same(want, carry)
    jstep = _jax_steps(name)
    for _ in range(K):
        want = jstep(want)
        carry = step(carry)
    _assert_same(want, carry)


def test_roundprobe_cli_runs_every_probe_and_checks():
    rc, lines, _ = _main(rp, ["--hosts", "16", "--cap", "8", "--iters", "5",
                              "--check", "--device", "cpu"])
    assert rc == 0
    head, rows = lines[0], {r["probe"]: r for r in lines[1:]}
    assert head == {"backend": "cpu", "hosts": 16, "cap": 8, "iters": 5}
    assert list(rows) == list(rp.PROBES)
    for name in rp.KERNEL_PROBES:
        assert rows[name]["bit_equal"] is True, name
        assert rows[name]["us_per_iter"] > 0
    pw = rows["phold_win"]
    assert pw["windows"] == 5 and pw["rounds_per_window"] > 0
    rc, lines, _ = _main(rp, ["pop_f", "--iters", "2", "--hosts", "4",
                              "--cap", "4", "--device", "cpu"])
    assert rc == 0 and lines[1]["probe"] == "pop_f"


@pytest.mark.parametrize("argv", [["pop_nop"], ["pop_gat"], ["--pallas"],
                                  ["nosuch"]])
def test_roundprobe_refuses_what_has_no_subject(argv):
    rc, lines, _ = _main(rp, [*argv, "--device", "cpu"])
    assert rc == 2 and len(lines) == 1 and "error" in lines[0]
    if argv[0] != "nosuch":
        assert "no subject" in lines[0]["error"]


@pytest.mark.parametrize("call", [
    lambda: rp.seeded_buf(4, 4, 2, np.random.default_rng(0)),
    lambda: rp.run_probe("pop", 4, 4, 2),
    lambda: rp.phold_win(16, 8, 2),
    lambda: popprof.grid(4, 4, 2),
], ids=["seeded_buf", "run_probe", "phold_win", "popprof_grid"])
def test_entry_points_default_to_the_card(call, monkeypatch):
    """With no device named, each entry point asks for the card and, with
    none, raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_phold_win_runs_at_most_WINDOWS_windows(monkeypatch):
    monkeypatch.setattr(rp, "WINDOWS", 2)
    assert rp.phold_win(16, 8, 5, "cpu")["windows"] == 2
    assert rp.phold_win(16, 8, 1, "cpu")["windows"] == 1


def test_popprof_grid():
    rows = popprof.grid(16, 8, 5, "cpu")
    assert [r["probe"] for r in rows] == ["pop_c8", "pop_c2"]
    assert all(r["bit_equal"] and r["us_per_iter"] > 0 for r in rows)
    rc, lines, _ = _main(popprof, ["--hosts", "8", "--cap", "8", "--iters",
                                   "3", "--device", "cpu"])
    assert rc == 0 and [r.get("probe") for r in lines[1:]] == ["pop_c8",
                                                                "pop_c2"]
