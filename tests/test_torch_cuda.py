"""The port's CUDA kernels on the card: each against its plain version, and
the PHOLD engine on CUDA against the same engine on the CPU.

These need a CUDA device and ``nvcc``; they are marked ``cuda`` and skip
where there is no card. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from shadow1_tpu_torch.config.compiled import single_vertex_experiment
from shadow1_tpu_torch.consts import MS, NP, EngineParams
from shadow1_tpu_torch.core import events as ev
from shadow1_tpu_torch.core import outbox as ob_mod
from shadow1_tpu_torch.core import popk
from shadow1_tpu_torch.core.engine import Engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _filled(g, c, h, dev):
    """An event buffer with random events pushed through the plain path."""
    buf = ev.evbuf_init(h, c, dev)
    k = torch.full((h,), 1, dtype=torch.int32, device=dev)
    for _ in range(c - 2):
        m = torch.from_numpy(g.random(h) < 0.8).to(dev)
        t = torch.from_numpy(g.integers(0, 50, h)).to(dev)
        p = torch.from_numpy(g.integers(0, 99, (NP, h)).astype(np.int32)).to(dev)
        buf, _ = ev.push_local_plain(buf, m, t, k, p)
    return ev.rebase(buf, torch.tensor(0, device=dev),
                     torch.tensor(30, device=dev))


def _clone(tree):
    return type(tree)(*(x.clone() for x in tree))


def _equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _equal(x, y)
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("h", [1, 33, 4096])
def test_pop_kernel_matches_plain(dev, h):
    g = np.random.default_rng(h)
    buf = _filled(g, 16, h, dev)
    for _ in range(16):
        want = popk.pop_until_plain(buf, torch.tensor(30, device=dev))
        got = popk.pop_until(_clone(buf), torch.tensor(30, device=dev))
        _equal(want, got)
        buf = want[0]


@pytest.mark.parametrize("h", [1, 33, 4096])
def test_push_and_obox_kernels_match_plain(dev, h):
    g = np.random.default_rng(h + 1)
    buf = _filled(g, 12, h, dev)
    ob = ob_mod.outbox_init(h, 6, dev)
    k = torch.full((h,), 1, dtype=torch.int32, device=dev)
    for _ in range(8):
        m = torch.from_numpy(g.random(h) < 0.9).to(dev)
        t = torch.from_numpy(g.integers(0, 50, h)).to(dev)
        p = torch.from_numpy(g.integers(0, 99, (NP, h)).astype(np.int32)).to(dev)
        want = popk.push_local_plain(buf, m, t, k, p)
        got = popk.push_local(_clone(buf), m, t, k, p)
        _equal(want, got)
        buf = want[0]
        dst = torch.from_numpy(g.integers(0, h, h).astype(np.int32)).to(dev)
        want = popk.outbox_append_plain(ob, m, dst, k, t, p)
        got = popk.outbox_append(_clone(ob), m, dst, k, t, p)
        _equal(want, got)
        ob = want[0]


def test_engine_cuda_matches_cpu(dev):
    exp = single_vertex_experiment(
        n_hosts=1024, seed=5, end_time=8 * MS, latency_ns=1 * MS, loss=0.02,
        model="phold", model_cfg={"mean_delay_ns": 2.0 * MS, "init_events": 8})
    params = EngineParams(ev_cap=32, outbox_cap=16)
    cpu = Engine(exp, params, device="cpu")
    gpu = Engine(exp, params, device=dev)
    for k in popk.LAUNCHES:
        popk.LAUNCHES[k] = 0
    m_gpu = Engine.metrics_dict(gpu.run())
    assert all(n > 0 for n in popk.LAUNCHES.values()), popk.LAUNCHES
    assert m_gpu == Engine.metrics_dict(cpu.run())
