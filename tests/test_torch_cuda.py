"""The port's CUDA kernels on the card: each against its plain version, and
the PHOLD engine on CUDA against the same engine on the CPU.

These need a CUDA device and ``nvcc``; they are marked ``cuda`` and skip
where there is no card. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: ``tests/conftest.py`` imports JAX, which these tests do
not need.)

Every comparison is bit-exact. The pop and push cases cover the kernels'
hazards: host counts that leave a ragged last tile (H = 33, 4097) or a
single host, whole tiles (H = 4096), planes off the 16-byte grid, slot
counts that do not divide among the slot groups (C = 1, 7, 49), tie-break low words at and above 2**31, ties on t32 and on tb_hi,
past-due keys, hosts with nothing eligible, a bound at or below the epoch,
a bound per host (the fleet's form: a lane at its cap pops nothing),
times at I64_MAX and far in the past, full buffers, and push-back
tie-breaks near 2**62. The outbox cases cover H = 1, 33, 4096, 4097 × P =
1, 6, 24, packet counters at and above 2**31, 2**32 and 2**33 and at
I64_MAX, departures with low words at and above 2**31 and at I64_MAX, 0-d
dst, kind and depart, idle 32-host tiles, full outboxes and cnt at P - 1.

At the net model's shapes (C = 128 and 512 event slots, P = 64 outbox
slots, H = 33, 4097 and 16,384 hosts) each kernel is held to its plain
version again: pop over many 48-slot batches, with the best slot in a
later batch and ties across batches; push into nearly full 512-slot
buffers; the outbox at P = 64. A filexfer engine run on CUDA equals the
same run on the CPU, its per-window digest words included, and so do
small tgen, Tor and dgram runs with active-host compaction on, a small
Bitcoin flood, and a two-tile run with every fidelity gate on, whose
virtual CPU launches the push kernel through ``push_back`` every round
and defers events through it. The overflow guard's rollback point is a
copy on the card too, and a PHOLD retried there equals the straight run
at the final cap. The profiler's raw device events count what
``key_averages()`` counts (``chip_smoke.py`` counts the raw events). Each
tool of the attribution plane (opcensus, phaseprobe, roundprobe, popprof)
runs once on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from shadow1_tpu_torch.config.compiled import (
    single_vertex_experiment,
    tiled_filexfer_experiment,
)
from shadow1_tpu_torch.consts import MS, NP, EngineParams
from shadow1_tpu_torch.core import events as ev
from shadow1_tpu_torch.core import outbox as ob_mod
from shadow1_tpu_torch.core import popk
from shadow1_tpu_torch.core.engine import Engine

pytestmark = pytest.mark.cuda

I64_MAX = (1 << 63) - 1
EPOCH = 1 << 40
SHAPES = [(h, c) for h in (1, 33, 4096, 4097) for c in (1, 7, 48, 49)]
NET_SHAPES = [(h, c) for h in (33, 4097, 16384) for c in (128, 512)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _random_buf(g, c, h, dev, *, fill=0.6):
    """An event buffer with unique (t32, tb) keys per host: t32 in a small
    range (many ties), some past due; tb_hi in {0, 1} (ties); tb_lo a
    per-host set of distinct words over the whole i32 range (low words
    above 2**31 included); a few free slots with a stale t32 below any
    bound (kind decides eligibility); every fifth host from the fourth
    empty."""
    kind = np.where(g.random((c, h)) < fill, g.integers(1, 7, (c, h)), 0)
    kind[:, 3::5] = 0
    kind[0, 0] = 1  # something to pop at every shape
    t32 = g.integers(-40, 60, (c, h))
    t32[g.random((c, h)) < 0.05] = ev.I32_PASTDUE
    stale = (kind == 0) & (g.random((c, h)) < 0.1)
    t32 = np.where((kind != 0) | stale, t32, ev.I32_FREE)
    perm = g.permuted(np.broadcast_to(np.arange(c, dtype=np.int64), (h, c)),
                      axis=1).T
    lo = (perm * 2654435761 + g.integers(0, 2**32, h)) % 2**32 - 2**31

    def rnd(*shape):
        return g.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)

    i32 = np.int32
    return ev.EventBuf(
        time_hi=_t(rnd(c, h), dev), time_lo=_t(rnd(c, h), dev),
        t32=_t(t32.astype(i32), dev), tb_hi=_t(g.integers(0, 2, (c, h)).astype(i32), dev),
        tb_lo=_t(lo.astype(i32), dev), kind=_t(kind.astype(i32), dev),
        p=_t(rnd(NP, c, h), dev),
        self_ctr=_t(g.integers(0, 2**40, h), dev),
        epoch=torch.tensor(EPOCH, dtype=torch.int64, device=dev),
        n_elig=_t(g.integers(0, c + 1, h).astype(i32), dev),
        u32=torch.tensor(30, dtype=torch.int32, device=dev))


def _push_rows(g, h, dev):
    """mask (one host in three idle, and hosts 128 .. 383 idle: whole tiles
    of either kernel shape), times (normal, at I64_MAX, past due by more
    than 2**31), kind and payload."""
    mask = g.random(h) < 0.67
    mask[128:384] = False
    time = EPOCH + g.integers(-100, 100, h)
    r = g.random(h)
    time[r < 0.1] = I64_MAX
    time[(r >= 0.1) & (r < 0.2)] = EPOCH - (1 << 33) - g.integers(0, 9)
    kind = g.integers(1, 7, h).astype(np.int32)
    p = g.integers(-2**31, 2**31, (NP, h), dtype=np.int64).astype(np.int32)
    return _t(mask, dev), _t(time, dev), _t(kind, dev), _t(p, dev)


def _clone(tree):
    return type(tree)(*(x.clone() for x in tree))


def _equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _equal(x, y)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)


def _pop_both(buf, until):
    want = popk.pop_until_plain(buf, until)
    n = popk.LAUNCHES["pop"]
    got = popk.pop_until(_clone(buf), until)
    assert popk.LAUNCHES["pop"] == n + 1
    _equal(want, got)
    return want


@pytest.mark.parametrize("h,c", SHAPES)
def test_pop_kernel_matches_plain(dev, h, c):
    g = np.random.default_rng(h * 100 + c)
    buf = _random_buf(g, c, h, dev)
    popped = 0
    for until in (EPOCH + 30, EPOCH + 30, EPOCH + 10**6):
        for _ in range(c + 1):
            buf, out = _pop_both(buf, torch.tensor(until, device=dev))
            popped += int(out.mask.sum())
    # Everything live was below the last bound: the buffer drained.
    assert popped > 0 and not bool((buf.kind != 0).any())


@pytest.mark.parametrize("h,c", SHAPES)
def test_push_kernel_matches_plain(dev, h, c):
    g = np.random.default_rng(h * 100 + c + 1)
    buf = _random_buf(g, c, h, dev, fill=0.9)
    over = 0
    for step in range(6):
        rows = _push_rows(g, h, dev)
        for local in (True, False):
            n = popk.LAUNCHES["push"]
            if local:
                want = popk.push_local_plain(buf, *rows)
                got = popk.push_local(_clone(buf), *rows)
            else:
                # Tie-breaks near 2**62, with low words on both sides of 2**31.
                tb = _t((1 << 62) + g.integers(-2**33, 2**33, h), dev)
                want = popk.push_back_plain(buf, rows[0], rows[1], tb, *rows[2:])
                got = popk.push_back(_clone(buf), rows[0], rows[1], tb, *rows[2:])
            assert popk.LAUNCHES["push"] == n + 1
            _equal(want, got)
            over += int(want[1].sum())
            buf = want[0]
    assert over > 0 or h == 1  # the buffers filled up and overflowed


def _misaligned(x):
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return y.view(x.shape).copy_(x)


def test_misaligned_planes_match_plain(dev):
    """Planes off the 16-byte grid (aligned only to their 4-byte words):
    both kernels equal the plain versions."""
    g = np.random.default_rng(5)
    buf = _random_buf(g, 48, 4096, dev, fill=0.7)
    planes = ("t32", "tb_hi", "tb_lo", "kind")
    for _ in range(3):
        until = torch.tensor(EPOCH + 30, device=dev)
        want = popk.pop_until_plain(buf, until)
        mis = buf._replace(**{f: _misaligned(getattr(buf, f)) for f in planes})
        assert mis.kind.data_ptr() % 16 == 4
        _equal(want, popk.pop_until(mis, until))
        buf = want[0]
        rows = _push_rows(g, 4096, dev)
        want = popk.push_local_plain(buf, *rows)
        mis = _clone(buf)._replace(kind=_misaligned(buf.kind))
        _equal(want, popk.push_local(mis, *rows))
        buf = want[0]


def test_pop_at_or_below_epoch(dev):
    """until <= epoch: u32 = 0, so only past-due keys (t32 < 0) pop; with
    none left, nothing pops."""
    g = np.random.default_rng(7)
    buf = _random_buf(g, 48, 4097, dev)
    for until in (EPOCH, EPOCH - 5, 0):
        _, out = _pop_both(buf, torch.tensor(until, device=dev))
        assert bool(out.mask.any())
        assert bool((out.time[out.mask] < EPOCH).all())
    buf = buf._replace(t32=torch.where(buf.t32 < 0, 0, buf.t32))
    for until in (EPOCH, EPOCH - 5, 0):
        _, out = _pop_both(buf, torch.tensor(until, device=dev))
        assert not bool(out.mask.any())


@pytest.mark.parametrize("h,c", [(33, 7), (4097, 49), (16384, 512)])
def test_pop_per_host_bound(dev, h, c):
    """The fleet's form of the bound, one per host (``until`` [H], the
    kernel's host stride 1): hosts of a lane held at its ``max_rounds`` cap
    get ``epoch + I32_PASTDUE`` and pop nothing, past-due keys included;
    the others pop exactly as under the one bound they share. Bit-equal
    to ``pop_until_plain``."""
    g = np.random.default_rng(h + c)
    buf = _random_buf(g, c, h, dev)
    lane = np.arange(h) * 3 // h                 # three lanes of columns
    never = EPOCH + ev.I32_PASTDUE
    until = _t(np.where(lane == 1, never, EPOCH + 30), dev)
    got = _pop_both(buf, until)[1]
    held = torch.from_numpy(lane == 1).to(dev)
    assert not bool(got.mask[held].any())
    assert bool((buf.t32[:, held] < 0).any())     # past-due keys were there
    _, shared = popk.pop_until_plain(buf, torch.tensor(EPOCH + 30, device=dev))
    assert torch.equal(got.mask[~held], shared.mask[~held])
    assert torch.equal(got.tb[~held], shared.tb[~held])
    # The per-host form at or below the epoch, host by host.
    until = _t(EPOCH - g.integers(-40, 40, h), dev)
    _pop_both(buf, until)


def test_pop_edges(dev):
    """Past-due keys pop first; a host's argmin decided by tb_hi and then
    by a low word above 2**31; Python-int bound."""
    h, c = 3, 4
    buf = ev.evbuf_init(h, c, dev)
    kind = torch.ones((c, h), dtype=torch.int32, device=dev)
    t32 = torch.tensor([[5, 5, ev.I32_PASTDUE], [5, 5, 7], [5, 6, 7],
                        [9, 5, 7]], dtype=torch.int32, device=dev)
    hi = torch.tensor([[1, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                      dtype=torch.int32, device=dev)
    lo = torch.tensor([[0, 2**31 - 1, 0], [3, -2**31, 1], [4, 0, 2],
                       [5, 1, 3]], dtype=torch.int32, device=dev)
    buf = buf._replace(t32=t32, kind=kind, tb_hi=hi, tb_lo=lo,
                       epoch=torch.tensor(100, device=dev))
    _, out = _pop_both(buf, 200)
    assert out.time.tolist() == [105, 105, 100 + ev.I32_PASTDUE]
    assert out.tb.tolist() == [2**31 + 3, 0, 2**31]


def test_results_are_fresh(dev):
    """pop_until and push_local return new n_elig / self_ctr tensors and
    leave the input's as they were."""
    g = np.random.default_rng(11)
    buf = _random_buf(g, 48, 4097, dev)
    n0, c0 = buf.n_elig.clone(), buf.self_ctr.clone()
    after, out = popk.pop_until(buf, torch.tensor(EPOCH + 30, device=dev))
    assert after.n_elig.data_ptr() != buf.n_elig.data_ptr()
    assert torch.equal(buf.n_elig, n0)
    assert torch.equal(after.n_elig, n0 - out.mask.to(torch.int32))
    rows = _push_rows(g, 4097, dev)
    after, over = popk.push_local(buf, *rows)
    assert after.n_elig.data_ptr() != buf.n_elig.data_ptr()
    assert after.self_ctr.data_ptr() != buf.self_ctr.data_ptr()
    assert torch.equal(buf.n_elig, n0) and torch.equal(buf.self_ctr, c0)
    ok = rows[0] & ~over
    assert torch.equal(after.self_ctr, c0 + ok.to(torch.int64))


def _outbox(g, h, cap, dev):
    """An outbox with random planes, cnt over [0, P] (host 0 full where
    H > 1, the last host at P - 1) and pkt_ctr at and above 2**31 - 1,
    2**31, 2**32, 2**33 and at I64_MAX (the next append wraps)."""
    def rnd(*shape):
        return _t(g.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32), dev)

    cnt = g.integers(0, cap + 1, h).astype(np.int32)
    cnt[0], cnt[-1] = cap, cap - 1
    ctr = g.choice(np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1, 2**32,
                             2**33 + 9, I64_MAX]), h)
    return ob_mod.Outbox(
        dst=rnd(cap, h), kind=rnd(cap, h), depart_hi=rnd(cap, h),
        depart_lo=rnd(cap, h), ctr=rnd(cap, h), p=rnd(NP, cap, h),
        cnt=_t(cnt, dev), pkt_ctr=_t(ctr, dev))


def _obox_rows(g, h, step, dev):
    """mask (hosts 128 .. 383 idle: whole 32-host tiles), dst and kind (0-d
    on odd steps), depart (low words at and above 2**31, some at I64_MAX;
    0-d on step 2) and payload."""
    mask = g.random(h) < 0.8
    mask[128:384] = False
    dst = g.integers(0, h, h).astype(np.int32)
    kind = g.integers(1, 7, h).astype(np.int32)
    if step % 2:
        dst, kind = np.array(h // 2, np.int32), np.array(4, np.int32)
    lo = g.choice(np.array([0, 2**31 - 1, 2**31, 2**31 + 3, 2**32 - 1]), h)
    depart = (EPOCH + g.integers(0, 2**20, h)) & ~0xFFFFFFFF | lo
    depart[g.random(h) < 0.1] = I64_MAX
    if step == 2:
        depart = np.array(EPOCH + 2**31 + 1, np.int64)
    p = g.integers(-2**31, 2**31, (NP, h), dtype=np.int64).astype(np.int32)
    return (_t(mask, dev), _t(dst, dev), _t(kind, dev), _t(depart, dev),
            _t(p, dev))


@pytest.mark.parametrize("h,c", [(h, c) for h in (1, 33, 4096, 4097)
                                 for c in (1, 6, 24)])
def test_obox_kernel_matches_plain(dev, h, c):
    g = np.random.default_rng(h * 100 + c + 2)
    ob = _outbox(g, h, c, dev)
    n_ok = n_drop = 0
    for step in range(8):
        rows = _obox_rows(g, h, step, dev)
        want = popk.outbox_append_plain(ob, *rows)
        got = popk.outbox_append(_clone(ob), *rows)
        _equal(want, got)
        n_ok += int(want[1].sum())
        n_drop += int((rows[0] & ~want[1]).sum())
        ob = want[0]
    assert n_ok > 0 and n_drop > 0  # appends landed, full outboxes dropped


def test_obox_results_are_fresh(dev):
    """outbox_append returns new ok / cnt / pkt_ctr tensors, leaves the
    caller's cnt and pkt_ctr as they were, and updates the planes it was
    given in place."""
    g = np.random.default_rng(13)
    ob = _outbox(g, 4097, 24, dev)
    cnt0, ctr0 = ob.cnt.clone(), ob.pkt_ctr.clone()
    rows = _obox_rows(g, 4097, 0, dev)
    want = popk.outbox_append_plain(ob, *rows)
    after, ok = popk.outbox_append(ob, *rows)
    _equal(want, (after, ok))
    for new, old in ((after.cnt, ob.cnt), (after.pkt_ctr, ob.pkt_ctr),
                     (ok, rows[0])):
        assert new.data_ptr() != old.data_ptr()
    assert torch.equal(ob.cnt, cnt0) and torch.equal(ob.pkt_ctr, ctr0)
    assert after.dst.data_ptr() == ob.dst.data_ptr()
    assert torch.equal(after.cnt, cnt0 + ok.to(torch.int32))


def test_obox_one_launch_per_call(dev):
    """Each outbox_append call on CUDA adds exactly one to the obox launch
    count, [H] and 0-d rows alike."""
    g = np.random.default_rng(17)
    ob = _outbox(g, 4096, 24, dev)
    for step in range(3):
        n = popk.LAUNCHES["obox"]
        ob, _ = popk.outbox_append(ob, *_obox_rows(g, 4096, step, dev))
        assert popk.LAUNCHES["obox"] == n + 1


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


@pytest.mark.parametrize("h,c", NET_SHAPES)
def test_pop_kernel_net_shape(dev, h, c):
    """Many 48-slot batches: random states, then a state whose least key of
    every host lies in the last batch, tied on t32 with slots of every
    earlier batch and decided by the tie-break."""
    g = np.random.default_rng(h + c)
    buf = _random_buf(g, c, h, dev)
    for until in (EPOCH + 30, EPOCH + 10**6):
        for _ in range(4):
            buf, _ = _pop_both(buf, torch.tensor(until, device=dev))
    t32 = torch.full((c, h), 20, dtype=torch.int32, device=dev)
    t32[::48] = 5                        # a tie in every batch
    hi = torch.ones((c, h), dtype=torch.int32, device=dev)
    hi[c - 1] = 0                        # the last slot wins the tie
    lo = torch.from_numpy(g.integers(-2**31, 2**31, (c, h), dtype=np.int64)
                          .astype(np.int32)).to(dev)
    t32[c - 1] = 5
    buf = buf._replace(t32=t32, tb_hi=hi, tb_lo=lo,
                       kind=torch.ones((c, h), dtype=torch.int32, device=dev))
    _, out = _pop_both(buf, torch.tensor(EPOCH + 30, device=dev))
    assert bool(out.mask.all())
    assert torch.equal(out.tb, (lo[c - 1].to(torch.int64) + 2**31))


@pytest.mark.parametrize("h,c", NET_SHAPES)
def test_push_kernel_net_shape(dev, h, c):
    g = np.random.default_rng(h + c + 1)
    buf = _random_buf(g, c, h, dev, fill=0.995)
    over = 0
    for _ in range(4):
        rows = _push_rows(g, h, dev)
        want = popk.push_local_plain(buf, *rows)
        _equal(want, popk.push_local(_clone(buf), *rows))
        over += int(want[1].sum())
        buf = want[0]
    assert over > 0


@pytest.mark.parametrize("h", [33, 4097, 16384])
def test_obox_kernel_net_shape(dev, h):
    g = np.random.default_rng(h + 3)
    ob = _outbox(g, h, 64, dev)
    for step in range(4):
        rows = _obox_rows(g, h, step, dev)
        want = popk.outbox_append_plain(ob, *rows)
        _equal(want, popk.outbox_append(_clone(ob), *rows))
        ob = want[0]


def test_filexfer_cuda_matches_cpu(dev):
    """Four groups of the filexfer16k layout with 2 % loss: metrics, the
    summary and every ring row (digest words included) on CUDA equal the
    CPU's, and every kernel launched."""
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    exp = tiled_filexfer_experiment(4, seed=42, end_time=12 * 40 * MS,
                                    loss=0.02)
    params = EngineParams(ev_cap=512, metrics_ring=12, state_digest=1)
    runs = []
    for d in ("cpu", dev):
        eng = Engine(exp, params, device=d)
        for k in popk.LAUNCHES:
            popk.LAUNCHES[k] = 0
        st = eng.run()
        runs.append((Engine.metrics_dict(st), drain_ring(st, eng.window),
                     {k: v.tolist() for k, v in eng.model_summary(st).items()}))
    assert all(n > 0 for n in popk.LAUNCHES.values()), popk.LAUNCHES
    assert runs[0][0]["events"] > 0 and runs[0][0]["pops_deliver"] > 0
    assert runs[1] == runs[0]


def _apps():
    """Small tgen, Tor and dgram experiments built in code, with the
    compact_cap each runs with (below the host count: both branches)."""
    from shadow1_tpu_torch.config.compiled import (
        dgram_ring_experiment,
        tgen_experiment,
        tor_experiment,
    )

    tgen = tgen_experiment(12, 21, 60 * 10 * MS, latency_ns=10 * MS,
                           bw_bits=10**7, streams=2, mean_bytes=20_000.0,
                           mean_think_ns=50.0 * MS, start_time=1 * MS)
    tor = tor_experiment(n_guard=3, n_middle=2, n_exit=3, n_dirauth=2,
                         n_client=12, seed=31, end_time=60 * 10 * MS,
                         latency_ns=10 * MS, relay_bw=10**7, client_bw=10**7,
                         n_circuits=1, n_streams=1, mean_stream_cells=10.0,
                         mean_think_ns=100.0 * MS, start_time=1 * MS)
    dgram = dgram_ring_experiment(64, 5, 12 * 10 * MS, latency_ns=10 * MS,
                                  loss=0.05, payload=1200, interval=2 * MS,
                                  count=20, start_time=1 * MS)
    return {"tgen": (tgen, dict(ev_cap=256), 6),
            "tor": (tor, dict(ev_cap=256, sockets_per_host=32), 8),
            "dgram": (dgram, dict(), 16)}


@pytest.mark.parametrize("app", ["tgen", "tor", "dgram"])
def test_apps_cuda_match_cpu(dev, app):
    """Each app with compaction on: metrics, summary and every ring row
    (digest words included) on CUDA equal the CPU's; every kernel
    launched, and windows ran on both sides of the bucket."""
    from shadow1_tpu_torch.core import compact
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    exp, kw, cap = _apps()[app]
    windows = exp.end_time // exp.window
    params = EngineParams(**kw, compact_cap=cap, metrics_ring=windows,
                          state_digest=1)
    runs = []
    for d in ("cpu", dev):
        eng = Engine(exp, params, device=d)
        for k in popk.LAUNCHES:
            popk.LAUNCHES[k] = 0
        for k in compact.WINDOWS:
            compact.WINDOWS[k] = 0
        st = eng.run()
        runs.append((Engine.metrics_dict(st), drain_ring(st, eng.window),
                     {k: v.tolist() for k, v in eng.model_summary(st).items()},
                     dict(compact.WINDOWS)))
    assert all(n > 0 for n in popk.LAUNCHES.values()), popk.LAUNCHES
    assert runs[0][0]["events"] > 0
    assert runs[1] == runs[0]
    if app != "dgram":
        assert runs[1][3]["compact"] > 0 and runs[1][3]["full"] > 0


def _run_both(dev, exp, params):
    """(metrics, ring rows, summary, push launches by entry) of a run on
    the CPU and of the same run on the card."""
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    runs = []
    for d in ("cpu", dev):
        eng = Engine(exp, params, device=d)
        for counts in (popk.LAUNCHES, popk.PUSH_ENTRIES):
            for k in counts:
                counts[k] = 0
        st = eng.run()
        runs.append((Engine.metrics_dict(st), drain_ring(st, eng.window),
                     {k: v.tolist()
                      for k, v in eng.model_summary(st).items()}))
    assert all(n > 0 for n in popk.LAUNCHES.values()), popk.LAUNCHES
    assert runs[1] == runs[0]
    return runs[1][0], dict(popk.PUSH_ENTRIES)


def test_bitcoin_cuda_matches_cpu(dev):
    """A 40-host Bitcoin flood (ring-chord k = 4, 6 transactions): metrics,
    the summary (who saw which tx, and when) and every ring row on CUDA
    equal the CPU's."""
    from shadow1_tpu_torch.config.compiled import bitcoin_experiment

    exp = bitcoin_experiment(40, 3, 40 * 20 * MS, latency_ns=20 * MS,
                             bw_bits=10**7, k=4, n_tx=6, tx_start=100 * MS,
                             tx_interval=50 * MS)
    m, _ = _run_both(dev, exp, EngineParams(
        ev_cap=96, sockets_per_host=16, msgq_cap=16, max_rounds=1024,
        metrics_ring=40, state_digest=1))
    assert m["events"] > 0


def test_push_back_in_path_cuda_matches_cpu(dev):
    """Two tiles of the fidelity16k layout (every gate on, compact_cap 8):
    on CUDA the virtual CPU launches the push kernel through push_back
    once per round, defers events through it, and the run equals the
    CPU's."""
    from shadow1_tpu_torch.config.compiled import fidelity_filexfer_experiment

    exp = fidelity_filexfer_experiment(2, 42, 400 * MS)
    seen = []
    push_back = popk.push_back

    def counting(buf, mask, *args):
        seen.append(int(mask.sum()))
        return push_back(buf, mask, *args)

    popk.push_back = counting
    try:
        m, entries = _run_both(dev, exp, EngineParams(
            ev_cap=512, compact_cap=8, metrics_ring=11, state_digest=1))
    finally:
        popk.push_back = push_back
    assert entries["push_back"] == m["rounds"] and entries["push_local"] > 0
    assert sum(seen) > 0 and m["host_restarts"] == 6


def _obs_params():
    return EngineParams(ev_cap=512, compact_cap=8, metrics_ring=11,
                        state_digest=1, link_telem=1,
                        probes=((0, -1), (1, 0), (2, 0), (9, 0)))


def _obs_records(st, eng):
    from shadow1_tpu_torch.telemetry.links import drain_links
    from shadow1_tpu_torch.telemetry.probes import drain_probes
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    return (Engine.metrics_dict(st), drain_ring(st, eng.window),
            drain_probes(st, eng.window, eng.params.probes),
            drain_links(st, eng.window))


def test_cuda_snapshot_continues_on_cpu(dev, tmp_path):
    """Two fidelity tiles with the probes and the link accumulator on: a
    state saved on the card at window 5 loads into the CPU port, which
    runs on equal to the card's own run — metrics, ring rows, flow and
    link records — and to a straight CPU run."""
    from shadow1_tpu_torch.ckpt import load_state, save_state
    from shadow1_tpu_torch.config.compiled import fidelity_filexfer_experiment

    exp = fidelity_filexfer_experiment(2, 42, 400 * MS)
    eng_c = Engine(exp, _obs_params(), device=dev)
    st = eng_c.run(n_windows=5)
    path = str(tmp_path / "card.npz")
    save_state(st, path)
    st = eng_c.run(st, n_windows=6)
    card = _obs_records(st, eng_c)
    eng = Engine(exp, _obs_params(), device="cpu")
    resumed = eng.run(load_state(eng.init_state(), path), n_windows=6)
    assert _obs_records(resumed, eng) == card
    assert _obs_records(eng.run(n_windows=11), eng) == card


def test_cuda_lineage_resolves_on_cpu(dev, tmp_path):
    """A lineage written on the card (obs.run_with_heartbeat, a generation
    every 2 windows, keep 2) resolves on the CPU to its head, and the
    generation behind it when the head is torn; each loads into a CPU
    engine."""
    import os

    from shadow1_tpu_torch.ckpt import load_state
    from shadow1_tpu_torch.config.compiled import fidelity_filexfer_experiment
    from shadow1_tpu_torch.lineage import Lineage
    from shadow1_tpu_torch.obs import run_with_heartbeat

    exp = fidelity_filexfer_experiment(2, 42, 400 * MS)
    path = str(tmp_path / "lin.npz")
    run_with_heartbeat(Engine(exp, _obs_params(), device=dev), n_windows=6,
                       every_windows=2, stream=False, ckpt_path=path,
                       ckpt_every_s=0.0, ckpt_keep=2)
    eng = Engine(exp, _obs_params(), device="cpu")
    r = Lineage(path, keep=2).resolve()
    assert r.path == path and r.meta["done_windows"] == 6 and not r.skipped
    assert int(load_state(eng.init_state(), r.path).metrics.windows) == 6
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    r = Lineage(path, keep=2).resolve()
    assert r.path != path and r.meta["done_windows"] == 4
    assert len(r.skipped) == 1
    assert int(load_state(eng.init_state(), r.path).metrics.windows) == 4


def test_retry_rollback_is_a_copy_on_cuda(dev):
    """The overflow guard's rollback point on the card: it shares no
    storage with the state the chunk then runs on (the kernels write that
    state's planes in place), and an under-capped PHOLD retried on CUDA
    equals the straight run at the final cap on the CPU, digest words
    included."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.telemetry.ring import drain_ring
    from shadow1_tpu_torch.txn import OverflowGuard

    exp = single_vertex_experiment(
        n_hosts=8, seed=5, end_time=40 * MS, latency_ns=1 * MS,
        model="phold", model_cfg={"mean_delay_ns": float(2 * MS),
                                  "init_events": 6})
    params = EngineParams(ev_cap=8, metrics_ring=40, state_digest=1)
    eng = Engine(exp, params, device=dev)
    guard = OverflowGuard(eng, make_engine=eng.at_caps, mode="retry")
    keep, shared = guard.rollback_point, []

    def rollback_point(st):
        copy = keep(st)
        shared.append(set(mem.storage_ptrs(st)) & set(mem.storage_ptrs(copy)))
        return copy

    guard.rollback_point = rollback_point
    st = run_chunked(eng, n_windows=40, chunk=10, guard=guard)
    assert guard.chunk_retries >= 1 and not any(shared)
    assert len(shared) == 4 + guard.chunk_retries
    final = guard.final_caps["ev_cap"]
    ref_eng = Engine(exp, EngineParams(ev_cap=final, metrics_ring=40,
                                       state_digest=1), device="cpu")
    ref = ref_eng.run(n_windows=40)
    assert Engine.metrics_dict(st) == Engine.metrics_dict(ref)
    assert drain_ring(st, eng.window) == drain_ring(ref, eng.window)


def test_serve_two_lanes_on_cuda_matches_cpu(dev, tmp_path):
    """The serve daemon on the card: two PHOLD tenants (JSON configs, no
    YAML parser needed) packed into one 2-lane batch launch the kernels,
    and each tenant's record stream equals its solo run on the CPU; a
    second pair is a cache hit that builds no engine."""
    import json

    from shadow1_tpu_torch.config.experiment import build_experiment
    from shadow1_tpu_torch.serve import client
    from shadow1_tpu_torch.serve.daemon import ServeDaemon
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    def doc(seed):
        return {"general": {"seed": seed, "stop_time": "40 ms"},
                "engine": {"scheduler": "tpu", "ev_cap": 32,
                           "metrics_ring": 10, "state_digest": 1},
                "network": {"single_vertex": {"latency": "1 ms"}},
                "hosts": [{"name": "h", "count": 8}],
                "app": {"model": "phold", "params": {
                    "mean_delay_ns": 2000000.0, "init_events": 3}}}

    d = ServeDaemon(str(tmp_path / "spool"), ckpt_every_s=1e9,
                    device=dev).start()
    try:
        for batch, seeds in ((0, (5, 6)), (1, (7, 8))):
            jids = []
            for s in seeds:
                cfg = tmp_path / f"s{s}.json"
                cfg.write_text(json.dumps(doc(s)))
                jids.append(client.submit(d.spool.root, str(cfg)))
            before = popk.LAUNCHES["pop"]
            assert d.step()
            assert popk.LAUNCHES["pop"] > before
            for jid, s in zip(jids, seeds):
                st = d.spool.read_status(jid)
                assert st["state"] == "done" and st["lanes"] == 2, st
                assert st["cache"] == ("miss", "hit")[batch]
                exp, params, _ = build_experiment(doc(s))
                ref = Engine(exp, dataclasses.replace(params,
                                                      metrics_ring=40),
                             device="cpu").run(n_windows=40)
                rows = [{k: v for k, v in r.items()
                         if k not in ("exp", "job")}
                        for r in d.spool.read_results(jid)
                        if r["type"] == "ring"]
                assert rows == drain_ring(ref, exp.window)
        assert d.cache.counters()["cache_misses"] == 1
    finally:
        d.close()


def test_raw_events_count_as_key_averages(dev):
    """``chip_smoke.py``'s ``CountedWindows`` counts a window's device
    operations from the profiler's raw events; ``key_averages()`` counts
    the same, far slower (an event object each). One window of the
    filexfer16k layout (16,384 hosts) traced with CPU and CUDA activities,
    one with CUDA alone: the two counts are equal and not 0. With ``-s``
    it prints both counts and the seconds each way took."""
    import time

    from torch.autograd.profiler import _filter_name
    from torch.profiler import ProfilerActivity, profile

    exp = tiled_filexfer_experiment(2048, seed=42, end_time=800 * MS)
    eng = Engine(exp, EngineParams(ev_cap=512), device=dev)
    st = eng.run(n_windows=10)
    torch.cuda.synchronize()
    for acts in ([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 [ProfilerActivity.CUDA]):
        r0 = int(st.metrics.rounds)
        with profile(activities=acts) as prof:
            st = eng.run(st, n_windows=1)
            torch.cuda.synchronize()
        t = time.perf_counter()
        raw = sum(1 for e in prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA")
                  and not _filter_name(e.name()))
        t_raw = time.perf_counter() - t
        t = time.perf_counter()
        ka = sum(e.count for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA") and e.count > 0)
        t_ka = time.perf_counter() - t
        print(f"activities {[a.name for a in acts]}: rounds "
              f"{int(st.metrics.rounds) - r0}, raw events {raw} "
              f"({t_raw:.2f} s), key_averages {ka} ({t_ka:.2f} s)")
        assert raw == ka and raw > 0


def test_attribution_tools_on_card(dev):
    """Each tool of the attribution plane once on the card: the census
    counts each kernel launch as one op (the pop: one launch, nothing
    else dispatched) and is deterministic, its reads and counted window
    equal to the CPU census's; the launch census's trace holds every
    launch of the three kernels; phaseprobe's staged run equals the
    straight run (``attribution`` asserts it); roundprobe's kernel probes
    and popprof's grid are bit equal to their plain loops; with no device
    named, roundprobe's entry points run on the card."""
    from shadow1_tpu_torch.tools import opcensus, phaseprobe, popprof
    from shadow1_tpu_torch.tools import roundprobe as rp

    eng, _ = phaseprobe.build_engine("smoke", hosts=256, device=dev)
    a = opcensus.census(eng, warmup=3, fusion=True)
    b = opcensus.census(eng, warmup=3)
    for k in ("ops", "reads", "launches", "window"):
        assert a[k] == b[k], k
    assert a["launches"]["pop"] == {"pop": 1, "push": 0, "obox": 0}
    assert a["fusions"]["complete"], a["fusions"]
    assert all(a["launches"]["rounds"][k] > 0 for k in opcensus.KERNELS)
    cpu, _ = phaseprobe.build_engine("smoke", hosts=256, device="cpu")
    c = opcensus.census(cpu, warmup=3)
    assert c["reads"] == a["reads"] and c["window"] == a["window"]
    att = phaseprobe.attribution(eng, n_windows=4, warmup=3, reps=2)
    assert att["events"] > 0 and att["coverage"] > 0
    for name in rp.KERNEL_PROBES:
        _, got = rp.run_probe(name, 64, 16, 50, dev)
        _, want = rp.run_probe(name, 64, 16, 50, dev, plain=True)
        assert rp.carries_equal(got, want), name
    assert all(r["bit_equal"] for r in popprof.grid(64, 16, 50, dev))
    # With no device named, the entry points run on the card.
    assert rp.seeded_buf(8, 4, 2, np.random.default_rng(0)).kind.is_cuda
    assert rp.run_probe("pop", 8, 4, 3)[1].kind.is_cuda
    assert rp.phold_win(16, 8, 3)["windows"] == 3
