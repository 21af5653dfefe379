"""TCP's receive path: the rx_ack and rx_data kernels (``csrc/popk.cu``)
against their plain versions on the card, and the plain split against the
receive path as it stood before the split, on the CPU.

On the CPU (no card needed): ``tcp.tcp_rx``, now ``rx_ack_plain``, the
flush, ``rx_data_plain`` and the immediate ACK, equals a frozen copy of the
one-piece ``tcp_rx`` it replaced, state leaf for state leaf and Notif row
for Notif row, on the calls kept from CPU runs of ``configs/rung1_filexfer
.yaml``, a small Tor network and a small Bitcoin flood; and a CPU run
launches no kernel.

On the card (marked ``cuda``; run with

    python -m pytest tests/test_torch_rxk.py -m cuda -q --noconftest

) each kernel equals its plain block bit for bit, over every TCP plane,
every Notif row and every mask: on random states at the Tor shape (S 128,
Q 64), the Bitcoin shape (S 32, Q 64) and the net model's default (S 16,
Q 32), at H = 33, 4,097 and 16,384, whose segments cover sequence numbers
that wrap near 2**31, RTT samples with a negative error and a first
sample, ``ds >= S``, hosts outside the mask and SYNs to a listener, a
SYN_SENT client learning its peer, the third duplicate ACK with and
without ``recover`` behind ``snd_una``, a FIN in each state, and sockets
freed by an ACK and by a FIN; and on the calls kept from CUDA runs of the
small Tor network and Bitcoin flood.
"""

import numpy as np
import pytest
import torch

from shadow1_tpu_torch.config.compiled import (
    bitcoin_experiment,
    tor_experiment,
)
from shadow1_tpu_torch.consts import (
    CWND_MAX,
    F_ACK,
    F_FIN,
    F_SYN,
    MS,
    N_ACCEPTED,
    N_CLOSED,
    N_DATA,
    N_ESTABLISHED,
    N_MSG,
    N_PEER_FIN,
    N_SPACE,
    NP,
    TCP_CLOSE_WAIT,
    TCP_CLOSING,
    TCP_CONN_STATES,
    TCP_ESTABLISHED,
    TCP_FIN_WAIT_1,
    TCP_FIN_WAIT_2,
    TCP_FREE,
    TCP_LAST_ACK,
    TCP_LISTEN,
    TCP_RCV_STATES,
    TCP_SYN_RCVD,
    TCP_SYN_SENT,
    EngineParams,
)
from shadow1_tpu_torch.core import graph, popk
from shadow1_tpu_torch.core.dense import last_true
from shadow1_tpu_torch.core.engine import Engine
from shadow1_tpu_torch.core.events import tb_split
from shadow1_tpu_torch.core.lanes import lsum
from shadow1_tpu_torch.tcp import tcp as T
from shadow1_tpu_torch.telemetry.profiler import read
from shadow1_tpu_torch.tools.phaseprobe import clone_tree

I32 = 1 << 32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the one-piece receive path as it stood before the split (the CPU's yardstick)
# ---------------------------------------------------------------------------

def _tcp_rx_before(st, ctx, mask, p, now):
    pr = ctx.params
    src = p[0]
    packed = p[1]
    ss = packed & 0xFF
    ds = (packed >> 8) & 0xFF
    flags = (packed >> 16) & 0xFF
    seq, ackno, length = p[2], p[3], p[4]
    wnd, mend, mmeta = p[5], p[6], p[7]
    is_syn = (flags & F_SYN) != 0
    is_ack = (flags & F_ACK) != 0
    is_fin = (flags & F_FIN) != 0
    nf = T.notif_none(ctx.n_hosts, ctx.device)

    r0 = T.Sock(st.model.tcp, ds, mask)
    syn_to_listen = mask & is_syn & ~is_ack & (r0.g("st") == TCP_LISTEN)
    if read("tcp_listen", bool, syn_to_listen.any()):
        tcp = st.model.tcp
        dup = ((tcp["peer_host"] == src[None, :])
               & (tcp["peer_sock"] == ss[None, :])
               & (tcp["st"] != TCP_FREE)
               & (tcp["st"] != TCP_LISTEN)).any(dim=0)
        new_conn0, child = last_true(tcp["st"] == TCP_FREE)
        new_conn = syn_to_listen & ~dup & new_conn0
        rc = T.Sock(tcp, child, new_conn)
        T._init_conn(rc, ctx, new_conn, src, ss, TCP_SYN_RCVD, 1)
        rc.s("peer_wnd", wnd, new_conn)
        st = st._replace(model=st.model._replace(tcp=rc.d))
        st = T.tcp_flush(st, ctx, new_conn, child, now)

    r = T.Sock(st.model.tcp, ds, mask)
    state = r.g("st")
    learn_peer = (state == TCP_SYN_SENT) & is_syn & is_ack
    v = (mask & ~syn_to_listen & T._state_in(state, TCP_CONN_STATES)
         & (r.g("peer_host") == src)
         & ((r.g("peer_sock") == ss) | learn_peer))
    r.s("peer_sock", ss, v & learn_peer)
    r.s("peer_wnd", torch.clamp(wnd, min=1), v & is_ack)
    a = v & is_ack
    snd_una, snd_nxt = r.g("snd_una"), r.g("snd_nxt")
    snd_max = r.g("snd_max")
    new_ack = a & ((ackno - snd_una) > 0) & ((ackno - snd_max) <= 0)
    ts_ok = new_ack & r.g("ts_act") & ((ackno - r.g("ts_seq")) >= 0)
    rtt = torch.clamp(now - r.g("ts_time"), min=1)
    srtt, rttvar = r.g("srtt"), r.g("rttvar")
    first = srtt == 0
    err = rtt - srtt
    srtt_n = torch.where(first, rtt, srtt + (err >> 3))
    rttvar_n = torch.where(first, rtt // 2,
                           rttvar + ((torch.abs(err) - rttvar) >> 2))
    rto_n = torch.clamp(srtt_n + torch.clamp(4 * rttvar_n, min=1_000_000),
                        pr.rto_min, pr.rto_max)
    r.s("srtt", srtt_n, ts_ok)
    r.s("rttvar", rttvar_n, ts_ok)
    r.s("rto", rto_n, ts_ok)
    r.s("ts_act", False, ts_ok)
    cwnd = r.g("cwnd")
    grow = torch.where(cwnd < r.g("ssthresh"), pr.mss,
                       torch.clamp((pr.mss * pr.mss)
                                   // torch.clamp(cwnd, min=1), min=1))
    r.s("cwnd", torch.clamp(cwnd + grow, max=CWND_MAX), new_ack)
    r.s("snd_una", ackno, new_ack)
    r.s("snd_nxt", ackno, new_ack & ((ackno - snd_nxt) > 0))
    r.s("dupacks", 0, new_ack)
    r.s("mq_valid", r.g("mq_valid") & ((r.g("mq_end") - ackno[None, :]) > 0),
        new_ack)
    outstanding = (snd_max - ackno) > 0
    r.s("rtx_t", torch.where(outstanding, now + r.g("rto"), 0), new_ack)
    est_sr = new_ack & (state == TCP_SYN_RCVD)
    r.s("st", TCP_ESTABLISHED, est_sr)
    nf = T._notify(nf, est_sr, ds, N_ACCEPTED)
    est_ss = a & is_syn & (state == TCP_SYN_SENT) & (ackno == 1)
    r.s("st", TCP_ESTABLISHED, est_ss)
    r.s("rcv_nxt", 1, est_ss)
    nf = T._notify(nf, est_ss, ds, N_ESTABLISHED)
    total_end = r.g("app_end") + r.g("fin_pend")
    fin_acked = new_ack & (r.g("fin_pend") == 1) & (ackno == total_end)
    r.s("st", TCP_FIN_WAIT_2, fin_acked & (state == TCP_FIN_WAIT_1))
    closed_by_ack = fin_acked & ((state == TCP_CLOSING) | (state == TCP_LAST_ACK))
    nf = T._notify(nf, closed_by_ack, ds, N_CLOSED)
    sp = (new_ack & ((state == TCP_ESTABLISHED) | (state == TCP_CLOSE_WAIT))
          & ~closed_by_ack)
    nf = T._notify(nf, sp, ds, N_SPACE,
                   space=pr.sndbuf - (r.g("app_end") - ackno))
    dup_a = (a & ~new_ack & (ackno == snd_una) & outstanding & (length == 0)
             & ~is_syn & ~is_fin)
    dp = r.g("dupacks") + 1
    r.s("dupacks", dp, dup_a)
    frx = dup_a & (dp == pr.dupack_thresh) & ((snd_una - r.g("recover")) >= 0)
    ssth = torch.clamp((snd_nxt - snd_una) // 2, min=2 * pr.mss)
    r.s("ssthresh", ssth, frx)
    r.s("cwnd", ssth, frx)
    r.s("recover", snd_nxt, frx)
    r.s("snd_nxt", snd_una, frx)
    r.s("ts_act", False, frx)
    st = st._replace(model=st.model._replace(tcp=r.d))
    met = st.metrics
    st = st._replace(metrics=met._replace(
        tcp_fast_rtx=met.tcp_fast_rtx + lsum(ctx, frx)))
    st = T.tcp_flush(st, ctx, new_ack | frx, ds, now)

    r = T.Sock(st.model.tcp, ds, mask)
    state2 = r.g("st")
    can_rcv = v & T._state_in(state2, TCP_RCV_STATES)
    has_data = can_rcv & (length > 0)
    in_order = has_data & (seq == r.g("rcv_nxt"))
    r.s("rcv_nxt", r.g("rcv_nxt") + length, in_order)
    nf = T._notify(nf, in_order, ds, N_DATA, dlen=length)
    nf = T._notify(nf, in_order & (mend != 0), ds, N_MSG, meta=mmeta)
    closed_by_fin = torch.zeros_like(v)
    if read("tcp_fin", bool, (v & is_fin).any()):
        fin_here = (v & is_fin & ((seq + length) == r.g("rcv_nxt"))
                    & T._state_in(state2, (TCP_ESTABLISHED, TCP_FIN_WAIT_1,
                                           TCP_FIN_WAIT_2)))
        r.s("rcv_nxt", r.g("rcv_nxt") + 1, fin_here)
        to_cw = fin_here & (state2 == TCP_ESTABLISHED)
        r.s("st", TCP_CLOSE_WAIT, to_cw)
        nf = T._notify(nf, to_cw, ds, N_PEER_FIN)
        r.s("st", TCP_CLOSING, fin_here & (state2 == TCP_FIN_WAIT_1))
        closed_by_fin = fin_here & (state2 == TCP_FIN_WAIT_2)
        nf = T._notify(nf, closed_by_fin, ds, N_CLOSED)
    freed = closed_by_ack | closed_by_fin
    r.s("st", TCP_FREE, freed)
    r.s("rtx_t", 0, freed)
    need_ack = has_data | (v & is_fin) | est_ss
    st = st._replace(model=st.model._replace(tcp=r.d))
    st = T._ack_now(st, ctx, need_ack, ds, now)
    met = st.metrics
    st = st._replace(metrics=met._replace(
        tcp_ooo_drops=met.tcp_ooo_drops
        + lsum(ctx, has_data & ~in_order)))
    return st, nf


# ---------------------------------------------------------------------------
# runs whose receive-path calls are kept
# ---------------------------------------------------------------------------

def _tor():
    exp = tor_experiment(n_guard=3, n_middle=2, n_exit=3, n_dirauth=2,
                         n_client=12, seed=31, end_time=40 * 10 * MS,
                         latency_ns=10 * MS, relay_bw=10**7,
                         client_bw=10**7, n_circuits=1, n_streams=1,
                         mean_stream_cells=10.0, mean_think_ns=100.0 * MS,
                         start_time=1 * MS)
    return exp, EngineParams(ev_cap=256, sockets_per_host=32)


def _bitcoin():
    exp = bitcoin_experiment(40, 3, 30 * 20 * MS, latency_ns=20 * MS,
                             bw_bits=10**7, k=4, n_tx=6, tx_start=100 * MS,
                             tx_interval=50 * MS)
    return exp, EngineParams(ev_cap=96, sockets_per_host=16, msgq_cap=16,
                             max_rounds=1024)


def _rung1():
    """``configs/rung1_filexfer.yaml`` with a 40 kB flow, so that its
    handshake, data, FINs and frees all fall in 12 windows."""
    import os

    from shadow1_tpu_torch.config.experiment import (
        build_experiment,
        parse_config,
    )

    path = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                        "rung1_filexfer.yaml")
    with open(path) as f:
        doc = parse_config(f.read())
    doc["app"]["groups"]["client"]["flow_bytes"] = 40_000
    exp, params, _ = build_experiment(doc, base_dir=os.path.dirname(path))
    return exp, params


RUNS = {"rung1": (_rung1, 12), "tor": (_tor, 40), "bitcoin": (_bitcoin, 30)}


def _interesting(mask, p) -> bool:
    """A call worth keeping: a masked host sends a SYN or a FIN."""
    flags = (p[1] >> 16) & 0xFF
    return bool((mask & ((flags & (F_SYN | F_FIN)) != 0)).any())


def _kept_calls(monkeypatch, name, device, every=7, cap=40):
    """(the calls of ``T.tcp_rx`` kept from a run of ``RUNS[name]``: clones
    of (st, ctx, mask, p, now) taken before each call; every call with a
    SYN or a FIN and every ``every``-th other one, up to ``cap``)."""
    make, windows = RUNS[name]
    exp, params = make()
    eng = Engine(exp, params, device=device)
    real = T.tcp_rx
    kept, seen = [], [0]

    def hook(st, ctx, mask, p, now):
        seen[0] += 1
        if len(kept) < cap and (seen[0] % every == 0
                                or _interesting(mask, p)):
            kept.append((clone_tree(st), ctx, mask.clone(), p.clone(),
                         now.clone()))
        return real(st, ctx, mask, p, now)

    monkeypatch.setattr(T, "tcp_rx", hook)
    eng.run(n_windows=windows)
    monkeypatch.setattr(T, "tcp_rx", real)
    assert kept, f"{name}: no receive-path call kept"
    return kept


def _assert_trees_equal(got, want, what):
    a, b = graph._leaves(got, []), graph._leaves(want, [])
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


@pytest.mark.parametrize("name", sorted(RUNS))
def test_plain_split_equals_tcp_rx_before(monkeypatch, name):
    """The split receive path on the CPU equals the one-piece one on every
    kept call: every state leaf and every Notif row."""
    kept = _kept_calls(monkeypatch, name, "cpu")
    flags = 0
    for i, (st, ctx, mask, p, now) in enumerate(kept):
        want = _tcp_rx_before(clone_tree(st), ctx, mask, p, now)
        got = T.tcp_rx(clone_tree(st), ctx, mask, p, now)
        _assert_trees_equal(got, want, f"{name} call {i}")
        flags |= int(np.bitwise_or.reduce(got[1].flags.numpy()))
    # The kept calls held handshakes and data (and rung1's, its close).
    assert flags & N_DATA and flags & (N_ESTABLISHED | N_ACCEPTED), flags
    if name == "rung1":
        assert flags & N_PEER_FIN and flags & N_CLOSED, flags


def test_cpu_run_launches_no_kernel(monkeypatch):
    before = dict(popk.LAUNCHES)
    _kept_calls(monkeypatch, "rung1", "cpu", cap=1)
    assert popk.LAUNCHES == before


def test_launch_counter_names_the_rx_kernels():
    assert {"rx_ack", "rx_data"} <= set(popk.LAUNCHES)
    assert set(popk.CORE) | {"rx_ack", "rx_data"} == set(popk.LAUNCHES)


# ---------------------------------------------------------------------------
# the kernels against their plain blocks (the card)
# ---------------------------------------------------------------------------

def _wrap32(x):
    return ((np.asarray(x, np.int64) + (1 << 31)) % I32 - (1 << 31)).astype(
        np.int32)


def _random_case(g, s, q, h, dev):
    """A random TCP state of S sockets, Q boundary slots and H hosts, with
    one segment per host aimed at the branches of the receive path.
    Returns (tcp, mask, syn_to_listen, p, now, params)."""
    params = EngineParams(sockets_per_host=s, msgq_cap=q)
    sh = (s, h)
    states = np.array([TCP_FREE, TCP_LISTEN, TCP_SYN_SENT, TCP_SYN_RCVD,
                       TCP_ESTABLISHED, TCP_FIN_WAIT_1, TCP_FIN_WAIT_2,
                       TCP_CLOSE_WAIT, TCP_LAST_ACK, TCP_CLOSING, 10, 11])
    weights = np.array([4, 4, 12, 10, 30, 9, 8, 7, 6, 5, 2, 3], float)
    st = g.choice(states, size=sh, p=weights / weights.sum())
    # Sequence bases: anywhere, just below the i32 wrap, or small.
    pick = g.integers(0, 3, sh)
    base = np.where(pick == 0, g.integers(-(1 << 31), 1 << 31, sh),
                    np.where(pick == 1, (1 << 31) - g.integers(1, 6000, sh),
                             g.integers(0, 6000, sh)))
    snd_una = base
    snd_nxt = snd_una + g.integers(0, 6000, sh)
    snd_max = snd_nxt + g.integers(0, 3000, sh)
    snd_nxt = np.where(g.random(sh) < 0.1, snd_max + 5, snd_nxt)
    fin_pend = (g.random(sh) < 0.4).astype(np.int64)
    app_end = np.where(g.random(sh) < 0.4, snd_max - fin_pend,
                       snd_max + g.integers(0, 4000, sh))
    rcv_nxt = np.where(g.random(sh) < 0.3, (1 << 31) - g.integers(1, 3000, sh),
                       g.integers(-(1 << 31), 1 << 31, sh))
    now0 = g.integers(1 << 30, 1 << 40, h)
    cols = {
        "st": st, "peer_host": g.integers(0, 64, sh),
        "peer_sock": g.integers(0, 256, sh),
        "snd_una": snd_una, "snd_nxt": snd_nxt, "snd_max": snd_max,
        "rcv_nxt": rcv_nxt, "app_end": app_end, "fin_pend": fin_pend,
        "cwnd": np.where(g.random(sh) < 0.05, CWND_MAX - g.integers(0, 800, sh),
                         g.integers(-2, 200_000, sh)),
        "ssthresh": g.integers(1, 200_000, sh),
        "peer_wnd": g.integers(0, 200_000, sh),
        "dupacks": g.choice([0, 1, 2, 2, 2, 3, 7], size=sh),
        "recover": snd_una + g.integers(-3000, 3000, sh),
        "ts_seq": snd_una + g.integers(-2000, 8000, sh),
        "txr": g.integers(0, 2, sh),
    }
    tcp = {k: torch.from_numpy(_wrap32(v)).to(dev) for k, v in cols.items()}
    i64 = {
        "srtt": np.where(g.random(sh) < 0.3, 0, g.integers(1, 10**9, sh)),
        "rttvar": g.integers(0, 5 * 10**8, sh),
        "rto": g.integers(2 * 10**8, 6 * 10**10, sh),
        "rtx_t": np.where(g.random(sh) < 0.3, 0, g.integers(1, 1 << 41, sh)),
        "ts_time": now0[None, :] - g.integers(-10**6, 10**9, sh),
    }
    for k, v in i64.items():
        hi, lo = tb_split(torch.from_numpy(v.astype(np.int64)))
        tcp[k + "_hi"], tcp[k + "_lo"] = hi.to(dev), lo.to(dev)
    tcp["ts_act"] = torch.from_numpy(g.random(sh) < 0.6).to(dev)
    tcp["timer_armed"] = torch.from_numpy(g.random(sh) < 0.5).to(dev)
    tcp["mq_valid"] = torch.from_numpy(g.random((q, s, h)) < 0.5).to(dev)
    tcp["mq_end"] = torch.from_numpy(_wrap32(
        snd_una[None] + g.integers(-2000, 8000, (q, s, h)))).to(dev)
    tcp["mq_meta"] = torch.from_numpy(_wrap32(
        g.integers(-(1 << 31), 1 << 31, (q, s, h)))).to(dev)
    assert set(tcp) == set(T.tcp_init(1, 1, 1, params, "cpu"))

    # One segment per host, aimed at its socket's column (ds >= S reads
    # the clamped socket S - 1, as the plain version does).
    hs = np.arange(h)
    ds = np.where(g.random(h) < 0.85, g.integers(0, s, h),
                  g.integers(min(s, 255), 256, h))
    c = np.minimum(ds, s - 1)
    col = {k: v[c, hs] for k, v in cols.items() if v.shape == sh}
    src = np.where(g.random(h) < 0.85, col["peer_host"], g.integers(0, 64, h))
    ss = np.where(g.random(h) < 0.85, col["peer_sock"], g.integers(0, 256, h))
    flags = g.choice([F_ACK, F_ACK, F_ACK, F_ACK, F_ACK, F_ACK, F_SYN,
                      F_SYN | F_ACK, F_FIN | F_ACK, F_FIN | F_ACK, 0,
                      F_SYN | F_FIN | F_ACK], size=h)
    span = np.maximum(col["snd_max"] - col["snd_una"], 1)
    choice = g.integers(0, 8, h)
    ackno = np.select(
        [choice == 0, choice == 1, choice == 2, choice == 3, choice == 4,
         choice == 5, choice == 6],
        [col["snd_una"], col["snd_una"] + 1 + g.integers(0, span),
         col["snd_max"], col["snd_max"] + g.integers(1, 100, h),
         np.ones(h, np.int64), col["app_end"] + col["fin_pend"],
         col["snd_una"]],
        g.integers(-(1 << 31), 1 << 31, h))
    length = np.where(g.random(h) < 0.55, 0, g.integers(1, 1461, h))
    seq = np.where(g.random(h) < 0.65, col["rcv_nxt"],
                   col["rcv_nxt"] + g.integers(-3000, 3000, h))
    rows = [src, ss | (ds << 8) | (flags << 16), seq, ackno, length,
            g.integers(-5, 200_000, h),
            np.where(g.random(h) < 0.5, 0, g.integers(1, 1 << 20, h)),
            g.integers(-(1 << 31), 1 << 31, h)]
    rows += [g.integers(-(1 << 31), 1 << 31, h)] * (NP - len(rows))
    p = torch.from_numpy(np.stack([_wrap32(r) for r in rows])).to(dev)
    now = torch.from_numpy(now0).to(dev)
    mask = torch.from_numpy(g.random(h) < 0.9).to(dev)
    stl = mask & torch.from_numpy(g.random(h) < 0.05).to(dev)
    return tcp, mask, stl, p, now, params


def _clone_tcp(tcp):
    return {k: v.clone() for k, v in tcp.items()}


def _assert_tcp_equal(got, want, what):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: plane {k}"


def _rows(nf):
    """A Notif as six fresh contiguous rows (the kernel updates rows in
    place; notif_none's rows are one tensor)."""
    return T.Notif(*(x.clone().contiguous() for x in nf))


def _both(tcp, params, mask, stl, p, now):
    """rx_ack and then rx_data, plain and kernel, on clones of the same
    input; each kernel's input is the plain block's (so each is held to
    its block alone). Returns (plain, kernel) results of each block."""
    sg = T._segment(p)
    want_a = T.rx_ack_plain(_clone_tcp(tcp), params, mask, sg, stl, now)
    n = popk.LAUNCHES["rx_ack"]
    tcp_k = _clone_tcp(tcp)
    nf_k, ack_k = popk.tcp_rx_ack(tcp_k, params, mask, stl, p, now)
    assert popk.LAUNCHES["rx_ack"] == n + 1
    got_a = (tcp_k, T.Notif(*nf_k), T.RxAck(*ack_k))

    tcp1, nf1, ack1 = want_a
    want_d = T.rx_data_plain(_clone_tcp(tcp1), mask, sg, _rows(nf1), ack1)
    n = popk.LAUNCHES["rx_data"]
    tcp_k = _clone_tcp(tcp1)
    nf_k = _rows(nf1)
    need_ack, ooo = popk.tcp_rx_data(tcp_k, p, nf_k, ack1.v, ack1.est_ss,
                                     ack1.closed_by_ack)
    assert popk.LAUNCHES["rx_data"] == n + 1
    torch.cuda.synchronize()
    got_d = (tcp_k, nf_k, need_ack, ooo)
    return (want_a, got_a), (want_d, got_d)


def _assert_blocks_equal(res, what):
    (want_a, got_a), (want_d, got_d) = res
    _assert_tcp_equal(got_a[0], want_a[0], f"{what} rx_ack")
    for f in T.Notif._fields:
        assert torch.equal(getattr(got_a[1], f), getattr(want_a[1], f)), \
            f"{what} rx_ack: Notif.{f}"
    for f in T.RxAck._fields:
        assert torch.equal(getattr(got_a[2], f), getattr(want_a[2], f)), \
            f"{what} rx_ack: {f}"
    _assert_tcp_equal(got_d[0], want_d[0], f"{what} rx_data")
    for f in T.Notif._fields:
        assert torch.equal(getattr(got_d[1], f), getattr(want_d[1], f)), \
            f"{what} rx_data: Notif.{f}"
    assert torch.equal(got_d[2], want_d[2]), f"{what} rx_data: need_ack"
    assert torch.equal(got_d[3], want_d[3]), f"{what} rx_data: out_of_order"


# (S, Q): Tor's, Bitcoin's, the net model's default.
RX_SHAPES = [(128, 64), (32, 64), (16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,q", RX_SHAPES)
@pytest.mark.parametrize("h", [33, 4097, 16384])
def test_rx_kernels_match_plain_on_random_states(dev, s, q, h):
    g = np.random.default_rng(1000 * s + h)
    for _ in range(3):
        tcp, mask, stl, p, now, params = _random_case(g, s, q, h, dev)
        _assert_blocks_equal(_both(tcp, params, mask, stl, p, now),
                             f"S {s} Q {q} H {h}")


def test_random_case_covers_the_branches_on_the_cpu():
    """The random states reach every branch the card's test names (the
    plain blocks on the CPU)."""
    g = np.random.default_rng(7)
    tcp, mask, stl, p, now, params = _random_case(g, 32, 64, 4097, "cpu")
    sg = T._segment(p)
    tcp1, nf, ack = T.rx_ack_plain(_clone_tcp(tcp), params, mask, sg, stl,
                                   now)
    tcp2, nf2, need_ack, ooo = T.rx_data_plain(_clone_tcp(tcp1), mask, sg,
                                               _rows(nf), ack)
    assert bool(ack.frx.any()) and bool(ack.closed_by_ack.any())
    assert bool(ack.est_ss.any()) and bool(ooo.any()) and bool(need_ack.any())
    for bit in (N_SPACE, N_ACCEPTED, N_PEER_FIN, N_MSG, N_DATA):
        assert bool((nf2.flags & bit).any()), bit
    # Sockets freed by a FIN as well as by an ACK.
    by_fin = ((nf2.flags & N_CLOSED) != 0) & ~ack.closed_by_ack
    assert bool(by_fin.any())
    # A SYN_SENT client learned its peer; ds >= S read the clamped socket.
    assert not torch.equal(tcp1["peer_sock"], tcp["peer_sock"])
    assert bool((ack.v & (sg.ds >= 32)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tor", "bitcoin"])
def test_rx_kernels_match_plain_on_kept_calls(dev, monkeypatch, name):
    """On each call of ``rx_ack`` and ``rx_data`` kept from a CUDA run, the
    kernel equals its plain block."""
    make, windows = RUNS[name]
    exp, params = make()
    eng = Engine(exp, params, device=dev)
    real_ack, real_data = T.rx_ack, T.rx_data
    acks, datas = [], []

    def ack_hook(tcp, pr, mask, p, sg, stl, now):
        if len(acks) < 24 and bool(mask.any()):
            acks.append((_clone_tcp(tcp), pr, mask.clone(), p.clone(),
                         stl.clone(), now.clone()))
        return real_ack(tcp, pr, mask, p, sg, stl, now)

    def data_hook(tcp, mask, p, sg, nf, ack):
        if len(datas) < 24 and bool(mask.any()):
            datas.append((_clone_tcp(tcp), mask.clone(), p.clone(),
                          _rows(nf), T.RxAck(*(x.clone() for x in ack))))
        return real_data(tcp, mask, p, sg, nf, ack)

    monkeypatch.setattr(T, "rx_ack", ack_hook)
    monkeypatch.setattr(T, "rx_data", data_hook)
    n = popk.LAUNCHES["rx_ack"]
    eng.run(n_windows=windows)
    monkeypatch.setattr(T, "rx_ack", real_ack)
    monkeypatch.setattr(T, "rx_data", real_data)
    assert popk.LAUNCHES["rx_ack"] > n
    assert acks and datas
    for i, (tcp, pr, mask, p, stl, now) in enumerate(acks):
        want = T.rx_ack_plain(_clone_tcp(tcp), pr, mask, T._segment(p), stl,
                              now)
        tcp_k = _clone_tcp(tcp)
        nf, ack = popk.tcp_rx_ack(tcp_k, pr, mask, stl, p, now)
        _assert_tcp_equal(tcp_k, want[0], f"{name} rx_ack call {i}")
        assert tuple(want[1]) and all(
            torch.equal(a, b) for a, b in zip(nf, want[1])), i
        assert all(torch.equal(a, b) for a, b in zip(ack, want[2])), i
    for i, (tcp, mask, p, nf, ack) in enumerate(datas):
        want = T.rx_data_plain(_clone_tcp(tcp), mask, T._segment(p),
                               _rows(nf), ack)
        tcp_k, nf_k = _clone_tcp(tcp), _rows(nf)
        got = popk.tcp_rx_data(tcp_k, p, nf_k, ack.v, ack.est_ss,
                               ack.closed_by_ack)
        _assert_tcp_equal(tcp_k, want[0], f"{name} rx_data call {i}")
        assert all(torch.equal(a, b) for a, b in zip(nf_k, want[1])), i
        assert torch.equal(got[0], want[2]) and torch.equal(got[1], want[3])
