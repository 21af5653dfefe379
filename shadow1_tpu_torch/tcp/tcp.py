"""Vectorized virtual TCP — every socket of every host updated at once
(port of ``tcp/tcp.py``).

3-way handshake, sliding window, Reno congestion control (slow start,
AIMD, fast retransmit on 3 duplicate ACKs, RTO with exponential backoff),
RFC 6298 integer RTT estimation and FIN teardown, with the reference's
simplifications: a Go-Back-N receiver (in-order segments only), immediate
ACKs, byte counts only, at most one message boundary per segment.

State is a dict of ``[S, H]`` planes (socket-major, host-minor) plus the
``[Q, S, H]`` message-boundary FIFO (``mq_*``). Sequence numbers are i32
that wrap; the five i64 fields (``_FIELDS_I64``) are stored as (hi, lo)
i32 plane pairs through ``events.tb_split`` / ``tb_join``, and all their
arithmetic runs on the joined i64 values. Every operation is a masked
per-host gather (``get_col``) or one-hot write (``set_col``) over a plane.

Segments leave through ``popk.outbox_append`` (the obox kernel on CUDA):
``_emit`` for pure ACKs, and ``tcp_flush`` once per burst lane. The
reference's flush writes the whole burst with one dense merge; the lanes'
slots are ``cnt + rank``, and a lane sends only while the outbox has room,
so every sent lane lands and appending lane by lane writes the same
planes, ``cnt`` and ``pkt_ctr``. Retransmit timers and transmit resumes
are pushed through ``popk.push_local`` (``engine.push_local_event``).

The reference's two ``lax.cond`` blocks (``_accept``, ``_fin``) are a
Python ``if`` on one device→host read each: every write in their bodies is
masked, so skipping an all-false body is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch.consts import (
    CWND_MAX,
    F_ACK,
    F_FIN,
    F_SYN,
    K_PKT,
    K_TCP_TIMER,
    K_TX_RESUME,
    N_ACCEPTED,
    N_CLOSED,
    N_DATA,
    N_ESTABLISHED,
    N_MSG,
    N_PEER_FIN,
    N_SPACE,
    SSTHRESH_INIT,
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
    TCP_SENDABLE_STATES,
    TCP_SYN_RCVD,
    TCP_SYN_SENT,
    WIRE_OVERHEAD,
)
from shadow1_tpu_torch.core.dense import (
    col_index,
    extract_col,
    first_true_idx,
    get_col,
    last_true,
    onehot_col,
    payload,
    set_col,
    set_sel,
)
from shadow1_tpu_torch.core.engine import push_local_event
from shadow1_tpu_torch.core.events import tb_join, tb_split
from shadow1_tpu_torch.core.outbox import outbox_space
from shadow1_tpu_torch.core.popk import outbox_append
from shadow1_tpu_torch.net.nic import ctx_aqm, tx_stamp
from shadow1_tpu_torch.telemetry.links import link_nic_drops

# Fields of the TCP state dict, all [S, H]. ``snd_max`` is the highest
# sequence ever sent: cumulative-ACK acceptance tests against it, not the
# possibly rewound snd_nxt.
_FIELDS_I32 = (
    "st", "peer_host", "peer_sock",
    "snd_una", "snd_nxt", "snd_max", "rcv_nxt", "app_end",  # seq (u32 wrap)
    "fin_pend", "cwnd", "ssthresh", "peer_wnd",
    "dupacks", "recover", "ts_seq", "txr",
)
# i64 fields, stored as (hi, lo) i32 plane pairs.
_FIELDS_I64 = ("srtt", "rttvar", "rto", "rtx_t", "ts_time")
_I64_SET = frozenset(_FIELDS_I64)
_FIELDS_BOOL = ("timer_armed", "ts_act")
_I32_MAX = (1 << 31) - 1


def _split_const(v: int) -> tuple[int, int]:
    """``tb_split`` of a Python int: the (hi, lo) words as Python ints."""
    return v >> 32, (v & 0xFFFFFFFF) - (1 << 31)


def tcp_init(n_hosts: int, n_socks: int, mq_cap: int, params, device) -> dict:
    zhi, zlo = _split_const(0)
    i32 = dict(dtype=torch.int32, device=device)
    d = {}
    for f in _FIELDS_I32:
        d[f] = torch.zeros((n_socks, n_hosts), **i32)
    for f in _FIELDS_I64:
        d[f + "_hi"] = torch.full((n_socks, n_hosts), zhi, **i32)
        d[f + "_lo"] = torch.full((n_socks, n_hosts), zlo, **i32)
    for f in _FIELDS_BOOL:
        d[f] = torch.zeros((n_socks, n_hosts), dtype=torch.bool, device=device)
    d["mq_valid"] = torch.zeros((mq_cap, n_socks, n_hosts), dtype=torch.bool,
                                device=device)
    d["mq_end"] = torch.zeros((mq_cap, n_socks, n_hosts), **i32)
    d["mq_meta"] = torch.zeros((mq_cap, n_socks, n_hosts), **i32)
    return d


class Sock:
    """Masked (host → socket) view over the TCP dict: reads and writes are
    [H] vectors at [sock[h], h]; writes apply only where the (optionally
    narrowed) mask holds. Reads are cached until the field is written."""

    def __init__(self, tcp: dict, sock, mask):
        self.d = dict(tcp)
        self.S = tcp["st"].shape[0]
        self.sock = sock
        self.mask = mask
        self._idx = col_index(torch.where(mask, sock, 0), self.S)
        self._onehot = onehot_col(sock, self.S)   # [S, H], unmasked
        self._cache = {}

    def g(self, k):
        v = self._cache.get(k)
        if v is None:
            if k in _I64_SET:
                v = tb_join(get_col(self.d[k + "_hi"], None, self._idx),
                            get_col(self.d[k + "_lo"], None, self._idx))
            else:
                v = get_col(self.d[k], None, self._idx)
            self._cache[k] = v
        return v

    def s(self, k, val, where=None):
        m = self.mask if where is None else (self.mask & where)
        sel = self._onehot & m[None, :]
        self._cache.pop(k, None)
        if k in _I64_SET:
            if isinstance(val, torch.Tensor):
                hi, lo = tb_split(val.to(torch.int64))
            else:
                hi, lo = _split_const(int(val))
            self.d[k + "_hi"] = set_sel(self.d[k + "_hi"], sel, hi)
            self.d[k + "_lo"] = set_sel(self.d[k + "_lo"], sel, lo)
            return
        self.d[k] = set_sel(self.d[k], sel, val)

    def put(self, k, plane):
        """Replace a whole plane (a write the caller built itself)."""
        self._cache.pop(k, None)
        self.d[k] = plane


class Notif(NamedTuple):
    """Per-round, per-host transport→app notification."""

    sock: torch.Tensor   # i32 [H]
    flags: torch.Tensor  # i32 [H] bitmask of N_*
    meta: torch.Tensor   # i32 [H] message meta (N_MSG / N_DGRAM)
    meta2: torch.Tensor  # i32 [H] second dgram meta
    dlen: torch.Tensor   # i32 [H] stream/dgram bytes delivered
    space: torch.Tensor  # i32 [H] send-buffer space (N_SPACE)


def notif_none(n_hosts: int, device) -> Notif:
    z = torch.zeros(n_hosts, dtype=torch.int32, device=device)
    return Notif(z, z, z, z, z, z)


def _notify(nf: Notif, mask, sock, flag, meta=None, meta2=None, dlen=None,
            space=None) -> Notif:
    def upd(cur, v):
        return torch.where(mask, v, cur).to(torch.int32)

    return Notif(
        sock=upd(nf.sock, sock),
        flags=torch.where(mask, nf.flags | flag, nf.flags),
        meta=nf.meta if meta is None else upd(nf.meta, meta),
        meta2=nf.meta2 if meta2 is None else upd(nf.meta2, meta2),
        dlen=nf.dlen if dlen is None else upd(nf.dlen, dlen),
        space=nf.space if space is None else upd(nf.space, space),
    )


def _state_in(state: torch.Tensor, states) -> torch.Tensor:
    """bool: ``state`` is one of ``states`` (all in [0, 31))."""
    bits = sum(1 << s for s in states)
    return ((bits >> state) & 1) != 0


# --------------------------------------------------------------------------
# Packet emission
# --------------------------------------------------------------------------
def pack_meta(src_sock, dst_sock, flags):
    return src_sock | (dst_sock << 8) | (flags << 16)


def _k_pkt(ctx) -> torch.Tensor:
    return torch.full((ctx.n_hosts,), K_PKT, dtype=torch.int32,
                      device=ctx.device)


def _emit(st, ctx, r: Sock, mask, flags, seq, length, mend, mmeta, now):
    """Emit one segment per host where ``mask``: NIC stamp and outbox
    append. The caller has checked for outbox space."""
    h = ctx.n_hosts
    p = payload(h, ctx.hosts, pack_meta(r.sock, r.g("peer_sock"), flags),
                seq, r.g("rcv_nxt"), length, ctx.params.rcvbuf, mend, mmeta,
                device=ctx.device)
    wire = length.to(torch.int64) + WIRE_OVERHEAD
    nic, depart, sent, red = tx_stamp(
        st.model.nic, mask, wire, now, ctx.bw_up,
        ctx.tx_qlen_ns if ctx.has_tx_qlen else None, aqm=ctx_aqm(ctx))
    # A queue-dropped segment behaves like path loss: sequence state
    # advanced, packet never routed.
    outbox, ok = outbox_append(st.outbox, sent, r.g("peer_host"), _k_pkt(ctx),
                               depart, p)
    m = st.metrics
    return st._replace(
        model=st.model._replace(nic=nic), outbox=outbox,
        metrics=m._replace(
            nic_tx_drops=m.nic_tx_drops
            + (mask & ~sent & ~red).sum(dtype=torch.int64),
            nic_aqm_drops=m.nic_aqm_drops + red.sum(dtype=torch.int64),
            ob_overflow=m.ob_overflow + (sent & ~ok).sum(dtype=torch.int64),
        ),
        # Link plane: egress-edge attribution of the drop-tail drops.
        links=link_nic_drops(st.links, ctx, mask & ~sent & ~red,
                             r.g("peer_host")),
    )


# --------------------------------------------------------------------------
# Flush: packetize [snd_nxt, limit) — data, SYN, FIN — up to send_burst segs.
# --------------------------------------------------------------------------
def tcp_flush(st, ctx, mask, sock, now):
    """Send as many pending segments of ``sock`` as burst, window and
    outbox allow; schedule K_TX_RESUME to continue if still pending.

    The socket's fields are gathered once; each of the ``send_burst``
    lanes computes its segment (sequence advance, window and outbox budget,
    message-boundary truncation, NIC clock) in [H]-vector arithmetic and
    appends it; the TCP fields are written back once.

    Two device→host reads cut the work the reference does on hosts with
    nothing to send, exactly: with no sendable socket the whole flush is a
    no-op (every write is masked by ``sendable``), and a lane in which no
    host can send ends the burst (a host that cannot send in lane b leaves
    nxt and space as they were, so it cannot send in lane b + 1)."""
    pr = ctx.params
    h = ctx.n_hosts
    tcp = st.model.tcp
    sock_safe = torch.where(mask, sock, 0)
    idx = col_index(sock_safe, tcp["st"].shape[0])

    def g(f):
        return get_col(tcp[f], None, idx)

    def g64(f):
        return tb_join(g(f + "_hi"), g(f + "_lo"))

    state = g("st")
    sendable = mask & _state_in(state, TCP_SENDABLE_STATES)
    if not bool(sendable.any()):
        return st
    snd_una = g("snd_una")
    nxt0 = g("snd_nxt")
    app_end, fin_p = g("app_end"), g("fin_pend")
    limit = torch.minimum(g("cwnd"), g("peer_wnd"))
    rcv_nxt = g("rcv_nxt")
    peer_host, peer_sock = g("peer_host"), g("peer_sock")
    rto = g64("rto")
    mqv, mqe, mqm = g("mq_valid"), g("mq_end"), g("mq_meta")  # [Q, H]
    is_synrcvd = state == TCP_SYN_RCVD
    syn_flags = torch.where(is_synrcvd, F_SYN | F_ACK, F_SYN).to(torch.int32)

    nxt = nxt0
    space = outbox_space(st.outbox)
    nic_run = st.model.nic
    now64 = now.to(torch.int64)
    ts_taken = g("ts_act")
    rtx_armed = g64("rtx_t") != 0
    zero64 = torch.zeros((), dtype=torch.int64, device=ctx.device)
    n_tx_drop = n_red = n_ob_over = zero64
    # Link plane: per-host drop-tail counts across the burst lanes (a host
    # flushes one socket per call, so peer_host is every lane's egress
    # edge); None when the plane is off.
    tx_drop_h = (torch.zeros(h, dtype=torch.int64, device=ctx.device)
                 if st.links is not None else None)
    ts_seq = g("ts_seq")
    ts_time = g64("ts_time")
    ts_first = torch.zeros(h, dtype=torch.bool, device=ctx.device)
    arm_any = ts_first
    ob = st.outbox
    k_pkt = _k_pkt(ctx)
    p1 = pack_meta(sock, peer_sock, 0)
    aqm = ctx_aqm(ctx)
    qlen = ctx.tx_qlen_ns if ctx.has_tx_qlen else None
    end = app_end + fin_p
    for _ in range(pr.send_burst):
        pending = (nxt - end) < 0
        flight = nxt - snd_una
        can = sendable & pending & (flight < limit) & (space > 0)
        if not bool(can.any()):
            break
        seg_syn = can & (nxt == 0)
        seg_fin = can & ~seg_syn & (nxt == app_end) & (fin_p == 1)
        seg_data = can & ~seg_syn & ~seg_fin
        length = torch.where(
            seg_data,
            torch.minimum(torch.clamp(app_end - nxt, max=pr.mss), limit - flight),
            0)
        flags = torch.where(seg_syn, syn_flags,
                            torch.where(seg_fin, F_FIN | F_ACK, F_ACK)
                            .to(torch.int32))
        # Message boundary riding this segment (truncating segmentation):
        # the nearest mq end in (nxt, nxt + length].
        seg_hi = nxt + length
        inrange = mqv & ((mqe - nxt[None, :]) > 0) & ((mqe - seg_hi[None, :]) <= 0)
        has_m = seg_data & inrange.any(dim=0)
        dist = torch.where(inrange, mqe - nxt[None, :], _I32_MAX)
        dmin = dist.amin(dim=0)
        near = inrange & (dist == dmin[None, :])
        mend = torch.where(has_m, extract_col(near, mqe), 0)
        mmeta = torch.where(has_m, extract_col(near, mqm), 0)
        length = torch.where(has_m, dmin, length)
        wire = length.to(torch.int64) + WIRE_OVERHEAD
        nic_run, depart, sent, red = tx_stamp(nic_run, can, wire, now64,
                                              ctx.bw_up, qlen, aqm=aqm)
        n_tx_drop = n_tx_drop + (can & ~sent & ~red).sum(dtype=torch.int64)
        if tx_drop_h is not None:
            tx_drop_h = tx_drop_h + (can & ~sent & ~red)
        n_red = n_red + red.sum(dtype=torch.int64)
        p = payload(h, ctx.hosts, p1 | (flags << 16), nxt, rcv_nxt, length,
                    pr.rcvbuf, mend, mmeta, device=ctx.device)
        ob, ok = outbox_append(ob, sent, peer_host, k_pkt, depart, p)
        n_ob_over = n_ob_over + (sent & ~ok).sum(dtype=torch.int64)
        new_nxt = nxt + length + (seg_syn | seg_fin).to(torch.int32)
        # RTT sample (Karn): the first sample-taking segment of the burst.
        take_ts = can & ~ts_taken
        ts_seq = torch.where(take_ts, new_nxt, ts_seq)
        ts_time = torch.where(take_ts, now64, ts_time)
        ts_taken = ts_taken | take_ts
        ts_first = ts_first | take_ts
        arm_any = arm_any | (can & ~rtx_armed)
        rtx_armed = rtx_armed | can
        nxt = torch.where(can, new_nxt, nxt)
        space = space - sent.to(torch.int32)
    # ``can`` advanced nxt also for queue-dropped segments (can & ~sent):
    # they behave like path loss.

    adv = nxt != nxt0
    d = dict(tcp)
    d["snd_nxt"] = set_col(d["snd_nxt"], sock, nxt, mask & adv)
    smax0 = g("snd_max")
    d["snd_max"] = set_col(d["snd_max"], sock,
                           torch.where((nxt - smax0) > 0, nxt, smax0),
                           mask & adv)
    d["ts_act"] = set_col(d["ts_act"], sock, True, mask & ts_first)
    d["ts_seq"] = set_col(d["ts_seq"], sock, ts_seq, mask & ts_first)
    tshi, tslo = tb_split(ts_time)
    d["ts_time_hi"] = set_col(d["ts_time_hi"], sock, tshi, mask & ts_first)
    d["ts_time_lo"] = set_col(d["ts_time_lo"], sock, tslo, mask & ts_first)
    rthi, rtlo = tb_split(now64 + rto)
    d["rtx_t_hi"] = set_col(d["rtx_t_hi"], sock, rthi, mask & arm_any)
    d["rtx_t_lo"] = set_col(d["rtx_t_lo"], sock, rtlo, mask & arm_any)
    need_ev = arm_any & ~g("timer_armed")
    d["timer_armed"] = set_col(d["timer_armed"], sock, True, mask & need_ev)

    m = st.metrics
    st = st._replace(
        model=st.model._replace(tcp=d, nic=nic_run),
        outbox=ob,
        metrics=m._replace(
            nic_tx_drops=m.nic_tx_drops + n_tx_drop,
            nic_aqm_drops=m.nic_aqm_drops + n_red,
            ob_overflow=m.ob_overflow + n_ob_over,
        ),
    )
    if tx_drop_h is not None:
        st = st._replace(links=link_nic_drops(st.links, ctx, tx_drop_h,
                                              peer_host))
    st = push_local_event(st, ctx, need_ev, now64 + rto, K_TCP_TIMER, p0=sock)

    # Still pending but could not send: one TX_RESUME per socket (deduped).
    # Outbox-blocked sends resume at the next window start (after the
    # drain); burst-limited ones at the same time, next round.
    pending = (nxt - end) < 0
    wnd_ok = (nxt - snd_una) < limit
    blocked_outbox = outbox_space(st.outbox) <= 0
    txr0 = get_col(st.model.tcp["txr"], None, idx)
    more = sendable & pending & wnd_ok & (txr0 == 0)
    t_resume = torch.where(blocked_outbox,
                           (now // ctx.window + 1) * ctx.window, now)
    d2 = dict(st.model.tcp)
    d2["txr"] = set_col(d2["txr"], sock, 1, more)
    st = st._replace(model=st.model._replace(tcp=d2))
    return push_local_event(st, ctx, more, t_resume, K_TX_RESUME, p0=sock)


def _ack_now(st, ctx, mask, sock, now):
    """Emit an immediate pure ACK (no data, no sequence consumed)."""
    r = Sock(st.model.tcp, sock, mask)
    can = mask & (outbox_space(st.outbox) > 0)
    z = torch.zeros(ctx.n_hosts, dtype=torch.int32, device=ctx.device)
    return _emit(st, ctx, r, can, F_ACK, r.g("snd_nxt"), z, z, z, now)


# --------------------------------------------------------------------------
# App-facing API (vectorized, masked)
# --------------------------------------------------------------------------
def tcp_listen(st, ctx, mask, sock):
    r = Sock(st.model.tcp, sock, mask)
    r.s("st", TCP_LISTEN)
    return st._replace(model=st.model._replace(tcp=r.d))


def _init_conn(r: Sock, ctx, mask, peer_host, peer_sock, state, rcv_nxt):
    pr = ctx.params
    r.s("st", state, mask)
    r.s("peer_host", peer_host, mask)
    r.s("peer_sock", peer_sock, mask)
    r.s("snd_una", 0, mask)
    r.s("snd_nxt", 0, mask)
    r.s("snd_max", 0, mask)
    r.s("rcv_nxt", rcv_nxt, mask)
    r.s("app_end", 1, mask)
    r.s("fin_pend", 0, mask)
    r.s("cwnd", pr.init_cwnd_mss * pr.mss, mask)
    r.s("ssthresh", SSTHRESH_INIT, mask)
    r.s("peer_wnd", pr.mss, mask)  # lets the SYN out; the real wnd comes with the first ACK
    r.s("srtt", 0, mask)
    r.s("rttvar", 0, mask)
    r.s("rto", pr.rto_init, mask)
    r.s("rtx_t", 0, mask)
    r.s("dupacks", 0, mask)
    r.s("recover", 0, mask)
    r.s("ts_act", False, mask)
    r.s("txr", 0, mask)
    r.s("mq_valid", r.g("mq_valid") & ~mask[None, :], mask)


def tcp_connect(st, ctx, mask, sock, dst_host, dst_sock, now):
    r = Sock(st.model.tcp, sock, mask)
    _init_conn(r, ctx, mask, dst_host, dst_sock, TCP_SYN_SENT, 0)
    st = st._replace(model=st.model._replace(tcp=r.d))
    return tcp_flush(st, ctx, mask, sock, now)


def tcp_send(st, ctx, mask, sock, nbytes, meta, now):
    """Queue up to ``nbytes`` on the socket (clamped to send-buffer space);
    attach ``meta`` as a message boundary at the end iff fully queued and
    meta != 0. Returns (st, accepted[H])."""
    pr = ctx.params
    r = Sock(st.model.tcp, sock, mask)
    snd_una, app_end = r.g("snd_una"), r.g("app_end")
    buffered = (app_end - snd_una) - (snd_una == 0).to(torch.int32)
    space = torch.clamp(pr.sndbuf - buffered, min=0)
    accepted = torch.minimum(torch.clamp(nbytes, min=0), space)
    accepted = torch.where(mask, accepted, 0)
    new_end = app_end + accepted
    r.s("app_end", new_end, accepted > 0)
    want_meta = mask & (accepted > 0) & (accepted == nbytes) & (meta != 0)
    mqv = r.g("mq_valid")                       # [Q, H]
    has_free, slot = first_true_idx(~mqv)
    ok = want_meta & has_free
    # Dense (slot, sock, host) one-hot write.
    sel = (onehot_col(slot, mqv.shape[0])[:, None, :]
           & onehot_col(r.sock, r.S, ok)[None, :, :])
    r.put("mq_valid", r.d["mq_valid"] | sel)
    r.put("mq_end", torch.where(sel, new_end[None, None, :], r.d["mq_end"]))
    r.put("mq_meta", torch.where(sel, meta[None, None, :], r.d["mq_meta"]))
    st = st._replace(model=st.model._replace(tcp=r.d))
    st = tcp_flush(st, ctx, mask & (accepted > 0), sock, now)
    return st, accepted


def tcp_close(st, ctx, mask, sock, now):
    r = Sock(st.model.tcp, sock, mask)
    state = r.g("st")
    est = mask & (state == TCP_ESTABLISHED)
    cw = mask & (state == TCP_CLOSE_WAIT)
    r.s("st", TCP_FIN_WAIT_1, est)
    r.s("st", TCP_LAST_ACK, cw)
    r.s("fin_pend", 1, est | cw)
    st = st._replace(model=st.model._replace(tcp=r.d))
    return tcp_flush(st, ctx, est | cw, sock, now)


# --------------------------------------------------------------------------
# Receive path — one packet per host per round, all hosts in parallel:
# connection demux → ACK processing (cwnd/RTT/retransmit) → payload → FIN
# → immediate ACK, then app notifications.
# --------------------------------------------------------------------------
def tcp_rx(st, ctx, mask, p, now):
    """Process one arrived TCP segment per host where ``mask``.
    Returns (st, Notif). ``now`` is the per-host event time."""
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
    nf = notif_none(ctx.n_hosts, ctx.device)

    # ---- passive open: a SYN to a LISTEN socket spawns a child.
    r0 = Sock(st.model.tcp, ds, mask)
    syn_to_listen = mask & is_syn & ~is_ack & (r0.g("st") == TCP_LISTEN)
    if bool(syn_to_listen.any()):
        tcp = st.model.tcp
        dup = ((tcp["peer_host"] == src[None, :])
               & (tcp["peer_sock"] == ss[None, :])
               & (tcp["st"] != TCP_FREE)
               & (tcp["st"] != TCP_LISTEN)).any(dim=0)
        # Children take the HIGHEST free slot: low slots are app-owned.
        new_conn0, child = last_true(tcp["st"] == TCP_FREE)
        new_conn = syn_to_listen & ~dup & new_conn0
        rc = Sock(tcp, child, new_conn)
        _init_conn(rc, ctx, new_conn, src, ss, TCP_SYN_RCVD, 1)
        rc.s("peer_wnd", wnd, new_conn)
        st = st._replace(model=st.model._replace(tcp=rc.d))
        st = tcp_flush(st, ctx, new_conn, child, now)  # emits SYN|ACK

    # ---- established-path demux: the peer must match.
    r = Sock(st.model.tcp, ds, mask)
    state = r.g("st")
    # A client in SYN_SENT connected to the listener; the SYN|ACK comes
    # from the spawned child: accept it by host and learn the peer socket.
    learn_peer = (state == TCP_SYN_SENT) & is_syn & is_ack
    v = (mask & ~syn_to_listen & _state_in(state, TCP_CONN_STATES)
         & (r.g("peer_host") == src)
         & ((r.g("peer_sock") == ss) | learn_peer))
    r.s("peer_sock", ss, v & learn_peer)
    r.s("peer_wnd", torch.clamp(wnd, min=1), v & is_ack)

    # ---- ACK processing, against snd_max (highest ever sent).
    a = v & is_ack
    snd_una, snd_nxt = r.g("snd_una"), r.g("snd_nxt")
    snd_max = r.g("snd_max")
    new_ack = a & ((ackno - snd_una) > 0) & ((ackno - snd_max) <= 0)
    # RTT sample (RFC 6298, integer ns; err >> 3 is floor division by 8).
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
    # cwnd growth: slow start below ssthresh, else AIMD.
    cwnd = r.g("cwnd")
    grow = torch.where(cwnd < r.g("ssthresh"), pr.mss,
                       torch.clamp((pr.mss * pr.mss)
                                   // torch.clamp(cwnd, min=1), min=1))
    r.s("cwnd", torch.clamp(cwnd + grow, max=CWND_MAX), new_ack)
    r.s("snd_una", ackno, new_ack)
    # An ACK beyond the rewound snd_nxt pulls it forward.
    r.s("snd_nxt", ackno, new_ack & ((ackno - snd_nxt) > 0))
    r.s("dupacks", 0, new_ack)
    # Retire message boundaries the peer has fully acked.
    r.s("mq_valid", r.g("mq_valid") & ((r.g("mq_end") - ackno[None, :]) > 0),
        new_ack)
    # Restart (or clear) the retransmit deadline.
    outstanding = (snd_max - ackno) > 0
    r.s("rtx_t", torch.where(outstanding, now + r.g("rto"), 0), new_ack)

    # State transitions driven by this ACK.
    est_sr = new_ack & (state == TCP_SYN_RCVD)
    r.s("st", TCP_ESTABLISHED, est_sr)
    nf = _notify(nf, est_sr, ds, N_ACCEPTED)
    est_ss = a & is_syn & (state == TCP_SYN_SENT) & (ackno == 1)
    r.s("st", TCP_ESTABLISHED, est_ss)
    r.s("rcv_nxt", 1, est_ss)
    nf = _notify(nf, est_ss, ds, N_ESTABLISHED)
    total_end = r.g("app_end") + r.g("fin_pend")
    fin_acked = new_ack & (r.g("fin_pend") == 1) & (ackno == total_end)
    r.s("st", TCP_FIN_WAIT_2, fin_acked & (state == TCP_FIN_WAIT_1))
    closed_by_ack = fin_acked & ((state == TCP_CLOSING) | (state == TCP_LAST_ACK))
    nf = _notify(nf, closed_by_ack, ds, N_CLOSED)
    sp = (new_ack & ((state == TCP_ESTABLISHED) | (state == TCP_CLOSE_WAIT))
          & ~closed_by_ack)
    nf = _notify(nf, sp, ds, N_SPACE, space=pr.sndbuf - (r.g("app_end") - ackno))

    # Duplicate ACKs → fast retransmit (Go-Back-N rewind) at the threshold.
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
        tcp_fast_rtx=met.tcp_fast_rtx + frx.sum(dtype=torch.int64)))
    st = tcp_flush(st, ctx, new_ack | frx, ds, now)

    # ---- payload (in order only: Go-Back-N receiver) and FIN
    r = Sock(st.model.tcp, ds, mask)
    state2 = r.g("st")
    can_rcv = v & _state_in(state2, TCP_RCV_STATES)
    has_data = can_rcv & (length > 0)
    in_order = has_data & (seq == r.g("rcv_nxt"))
    r.s("rcv_nxt", r.g("rcv_nxt") + length, in_order)
    nf = _notify(nf, in_order, ds, N_DATA, dlen=length)
    nf = _notify(nf, in_order & (mend != 0), ds, N_MSG, meta=mmeta)
    # FIN: in order once the preceding data is consumed.
    closed_by_fin = torch.zeros_like(v)
    if bool((v & is_fin).any()):
        fin_here = (v & is_fin & ((seq + length) == r.g("rcv_nxt"))
                    & _state_in(state2, (TCP_ESTABLISHED, TCP_FIN_WAIT_1,
                                         TCP_FIN_WAIT_2)))
        r.s("rcv_nxt", r.g("rcv_nxt") + 1, fin_here)
        to_cw = fin_here & (state2 == TCP_ESTABLISHED)
        r.s("st", TCP_CLOSE_WAIT, to_cw)
        nf = _notify(nf, to_cw, ds, N_PEER_FIN)
        r.s("st", TCP_CLOSING, fin_here & (state2 == TCP_FIN_WAIT_1))
        closed_by_fin = fin_here & (state2 == TCP_FIN_WAIT_2)
        nf = _notify(nf, closed_by_fin, ds, N_CLOSED)

    # Free fully closed sockets (slot reuse; stale packets fail the
    # peer-match guard above).
    freed = closed_by_ack | closed_by_fin
    r.s("st", TCP_FREE, freed)
    r.s("rtx_t", 0, freed)

    # Immediate ACK: any data (a duplicate ACK when out of order), any FIN,
    # and the last step of the client handshake.
    need_ack = has_data | (v & is_fin) | est_ss
    st = st._replace(model=st.model._replace(tcp=r.d))
    st = _ack_now(st, ctx, need_ack, ds, now)
    met = st.metrics
    st = st._replace(metrics=met._replace(
        tcp_ooo_drops=met.tcp_ooo_drops
        + (has_data & ~in_order).sum(dtype=torch.int64)))
    return st, nf


# --------------------------------------------------------------------------
# Timer and TX-resume event handlers
# --------------------------------------------------------------------------
def on_tcp_timer(st, ctx, ev):
    """K_TCP_TIMER: one lazy retransmit-timer event per socket. If the
    deadline moved into the future it re-arms there; if it is gone the
    event dies; else RTO: backoff, cwnd to one segment, Go-Back-N rewind,
    retransmit."""
    pr = ctx.params
    m = ev.mask & (ev.kind == K_TCP_TIMER)
    sock = ev.p[0]
    now = ev.time
    r = Sock(st.model.tcp, sock, m)
    r.s("timer_armed", False, m)
    deadline = r.g("rtx_t")
    live = m & (deadline != 0)
    future = live & (now < deadline)
    r.s("timer_armed", True, future)
    fire = live & ~future
    outstanding = (r.g("snd_max") - r.g("snd_una")) > 0
    rto_fire = fire & outstanding & _state_in(r.g("st"), TCP_SENDABLE_STATES)
    flight = r.g("snd_nxt") - r.g("snd_una")
    r.s("ssthresh", torch.clamp(flight // 2, min=2 * pr.mss), rto_fire)
    r.s("cwnd", pr.mss, rto_fire)
    rto_n = torch.clamp(r.g("rto") * 2, max=pr.rto_max)
    r.s("rto", rto_n, rto_fire)
    r.s("snd_nxt", r.g("snd_una"), rto_fire)
    r.s("ts_act", False, rto_fire)
    r.s("dupacks", 0, rto_fire)
    r.s("recover", r.g("snd_una"), rto_fire)
    r.s("rtx_t", now + rto_n, rto_fire)
    r.s("timer_armed", True, rto_fire)
    r.s("rtx_t", 0, fire & ~rto_fire)
    st = st._replace(model=st.model._replace(tcp=r.d))
    met = st.metrics
    st = st._replace(metrics=met._replace(
        tcp_rto=met.tcp_rto + rto_fire.sum(dtype=torch.int64)))
    # One pending event per socket: re-push at whichever deadline applies.
    t_ev = torch.where(future, deadline, now + rto_n)
    st = push_local_event(st, ctx, future | rto_fire, t_ev, K_TCP_TIMER,
                          p0=sock)
    return tcp_flush(st, ctx, rto_fire, sock, now)


def on_tx_resume(st, ctx, ev):
    """K_TX_RESUME: continue a burst- or outbox-bounded flush."""
    m = ev.mask & (ev.kind == K_TX_RESUME)
    sock = ev.p[0]
    r = Sock(st.model.tcp, sock, m)
    r.s("txr", 0, m)
    st = st._replace(model=st.model._replace(tcp=r.d))
    return tcp_flush(st, ctx, m, sock, ev.time)
