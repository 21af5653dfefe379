"""tor — circuit-layer Tor model over the virtual TCP stack (port of
``apps/tor.py``; BASELINE rungs 3 and 4).

Clients fetch a consensus from a dirauth over TCP, then build telescoped
circuits over bandwidth-weighted guard/middle/exit relays
(CREATE/CREATED, EXTEND/EXTENDED relayed through the partial circuit;
relays open or reuse onward TCP conns and multiplex circuits over them)
and run streams on them: BEGIN to the exit, a cell-stream reply (one
message of n_cells × 512 B), END; think, then the next stream or circuit.
Cells are 512-byte message boundaries on TCP (meta = circ<<18 | aux<<4 |
cmd). Fan-out (dials, cell sends, pending-CREATE drains) goes through
self-scheduled K_APP events; the OP_TX_CELL site retries next window when
the send buffer or the message-boundary FIFO is full.

model_cfg: ``role`` (0 relay, 1 client, 2 dirauth, 3 idle),
``relay_weight``, ``is_guard``, ``is_exit``, ``n_circuits``,
``n_streams``, ``mean_stream_cells``, ``mean_think_ns``, ``start_time``
([H] arrays); ``consensus_bytes`` (2048), ``cells_max`` (120) and
``ct_cap`` (64) are scalars.

The path-selection tables (``tables``) are constants of the config and
stay out of engine state, as in the reference. The net model builds them
in ``make_handlers`` and its handlers read them from ``ctx.app_tables``;
``model_cfg`` stays plain arrays and scalars.

The reference's nine ``lax.cond`` blocks are Python ``if``s on device
reads; every write in them is masked, so skipping an all-false block is
exact. The reads are merged where that is exact too: ``on_wakeup``'s four
predicates depend only on the popped events, so one read serves all four;
``on_notify``'s five are all read at once on entry, and a predicate is
read again only when a block before it ran (only then can the state it
tests have changed).
"""

from __future__ import annotations

import numpy as np
import torch

from shadow1_tpu_torch import rng
from shadow1_tpu_torch.consts import (
    K_APP,
    N_ESTABLISHED,
    N_MSG,
    N_PEER_FIN,
    NP,
    R_TOR_PATH,
    TCP_ESTABLISHED,
    TCP_FREE,
    TCP_LISTEN,
)
from shadow1_tpu_torch.core.dense import add_col, first_true_idx, get_col, set_col
from shadow1_tpu_torch.core.engine import push_local_event
from shadow1_tpu_torch.core.lanes import lsum
from shadow1_tpu_torch.core.popk import push_local
from shadow1_tpu_torch.tcp import tcp as T

CELL = 512

# meta = circ<<18 | aux<<4 | cmd  (circ ≤ 8191, aux ≤ 16383, cmd ≤ 15)
C_CREATE = 1
C_CREATED = 2
C_EXTEND = 3
C_EXTENDED = 4
C_BEGIN = 5
C_DATA = 6
C_END = 7
C_DIRREQ = 8
C_DIRRESP = 9

# K_APP opcodes
OP_START = 1
OP_TX_CELL = 2        # p1=sock p2=meta p3=nbytes
OP_CONNECT_RELAY = 3  # p1=sock p2=peer relay id
OP_DRAIN = 4          # p1=sock
OP_THINK = 5

# Client bootstrap/circuit states
CL_IDLE = 0
CL_DIR_CONN = 1
CL_DIR_FETCH = 2
CL_GUARD_CONN = 3
CL_BUILDING = 4
CL_STREAM = 5
CL_DONE = 7


def _meta(circ, aux, cmd):
    def i32(x):
        return x.to(torch.int32) if isinstance(x, torch.Tensor) else x

    return (i32(circ) << 18) | (i32(aux) << 4) | cmd


def _decode(meta):
    return meta >> 18, (meta >> 4) & 0x3FFF, meta & 0xF


def _build_tables(cfg) -> dict:
    role = np.asarray(cfg["role"], np.int32)
    weight = np.asarray(cfg["relay_weight"], np.int64)
    is_relay = role == 0

    def cum_ids(member):
        ids = np.nonzero(member)[0].astype(np.int32)
        w = weight[ids]
        assert len(ids) > 0 and (w > 0).all()
        cum = np.cumsum(w)
        assert cum[-1] < 2**31, "total weight must fit i31 for exact randint"
        return ids, cum

    g_ids, g_cum = cum_ids(is_relay & np.asarray(cfg["is_guard"], bool))
    e_ids, e_cum = cum_ids(is_relay & np.asarray(cfg["is_exit"], bool))
    r_ids, r_cum = cum_ids(is_relay)
    dir_ids = np.nonzero(role == 2)[0].astype(np.int32)
    assert len(dir_ids) > 0, "need at least one dirauth"
    return {"guard_ids": g_ids, "guard_cum": g_cum,
            "exit_ids": e_ids, "exit_cum": e_cum,
            "relay_ids": r_ids, "relay_cum": r_cum,
            "dir_ids": dir_ids}


def tables(cfg, device) -> dict:
    """The static path-selection tables of a config: member ids and
    cumulative bandwidth weights for guard/middle/exit sampling and the
    dirauth ids, as tensors on ``device``, and each kind's total weight
    (``<kind>_total``, a Python int, so a pick needs no device read)."""
    host = _build_tables(cfg)
    t = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    for kind in ("guard", "exit", "relay"):
        t[f"{kind}_total"] = int(host[f"{kind}_cum"][-1])
    return t


def init(ctx, evbuf, tcpd):
    cfg = ctx.model_cfg
    _build_tables(cfg)  # validate the config early
    h, s, dev = ctx.n_hosts, ctx.params.sockets_per_host, ctx.device
    ct = int(cfg.get("ct_cap", 64))

    def t(name, dtype):
        return torch.as_tensor(cfg[name], device=dev).to(dtype)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=dev)

    i32, i64 = torch.int32, torch.int64
    role = t("role", i32)
    app = {
        # Per-host config columns live in app state, so they follow the
        # host axis (sharding, compaction).
        "role": role,
        "cfg_n_streams": t("n_streams", i32),
        "cfg_mean_cells": t("mean_stream_cells", torch.float32),
        "cfg_mean_think": t("mean_think_ns", torch.float32),
        # client
        "cl_state": full((h,), 0, i32),
        "cl_guard": full((h,), -1, i32),
        "cl_circ": full((h,), 0, i32),
        "cl_hop": full((h,), 0, i32),
        "cl_mid": full((h,), 0, i32),
        "cl_exit": full((h,), 0, i32),
        "cl_circs_left": t("n_circuits", i32),
        "cl_streams_left": full((h,), 0, i32),
        "cl_cells_want": full((h,), 0, i32),
        "ctr": full((h,), 0, i64),
        "streams_done": full((h,), 0, i32),
        "cells_rx": full((h,), 0, i64),
        "bootstrap_time": full((h,), 0, i64),
        "done_time": full((h,), 0, i64),
        # relay link conns + circuit table
        "rc_peer": full((s, h), -1, i32),
        "rc_next_circ": full((s, h), 1, i32),
        "ct_used": full((ct, h), False, torch.bool),
        "ct_in_sock": full((ct, h), 0, i32),
        "ct_in_circ": full((ct, h), 0, i32),
        "ct_out_sock": full((ct, h), -1, i32),
        "ct_out_circ": full((ct, h), 0, i32),
        "ct_pend": full((ct, h), False, torch.bool),
        "cells_fwd": full((h,), 0, i64),
        "ct_overflow": full((h,), 0, i64),
        "cell_retries": full((h,), 0, i64),
    }
    tcpd = dict(tcpd)
    st = tcpd["st"].clone()
    st[0] = torch.where((role == 0) | (role == 2), TCP_LISTEN, st[0])
    tcpd["st"] = st
    starts = (role == 1) & (t("n_circuits", i64) > 0)
    p = torch.zeros((NP, h), dtype=i32, device=dev)
    p[0] = OP_START
    k = full((h,), K_APP, i32)
    evbuf, over = push_local(evbuf, starts, t("start_time", i64), k, p)
    return app, evbuf, lsum(ctx, over), tcpd


def _set_app(st, app):
    return st._replace(model=st.model._replace(app=app))


def _any(*masks) -> list:
    """``mask.any()`` of each mask, in one device→host read."""
    return torch.stack([m.any() for m in masks]).tolist()


# -- draws -----------------------------------------------------------------
def _draw_bits(ctx, app, mask):
    """One u32 per host from the host's R_TOR_PATH stream; advances ctr
    where ``mask``."""
    bits = rng.bits(ctx.key, R_TOR_PATH, ctx.hosts, app["ctr"])
    app["ctr"] = app["ctr"] + mask.to(torch.int64)
    return bits


def _pick_weighted(bits, ids, cum, total=None):
    """Bandwidth-weighted relay pick: u ∈ [0, Σw) by multiply-shift, then
    the first cumulative bucket exceeding u. ``total`` is Σw (``cum[-1]``,
    read here when not given: a device read for a tensor on the card)."""
    u = rng.randint(bits, int(cum[-1]) if total is None else total)
    idx = torch.searchsorted(cum, u.to(torch.int64), right=True)
    return ids[torch.clamp(idx, max=ids.shape[0] - 1)]


def _pick(ctx, bits, kind: str):
    """``_pick_weighted`` over the ``kind`` members (guard, exit, relay)
    of the config's tables (``ctx.app_tables``)."""
    t = ctx.app_tables
    return _pick_weighted(bits, t[f"{kind}_ids"], t[f"{kind}_cum"],
                          t[f"{kind}_total"])


def stream_cells(ctx, app, bits):
    """A stream's cell count: the exponential draw of ``bits`` with the
    host's mean, clipped to [1, cells_max]; i32 [H]."""
    cells_max = int(ctx.model_cfg.get("cells_max", 120))
    return torch.clamp(rng.exponential_ns(bits, app["cfg_mean_cells"]),
                       1, cells_max).to(torch.int32)


def _push_cell(st, ctx, mask, sock, meta, nbytes, now):
    return push_local_event(st, ctx, mask, now, K_APP, p0=OP_TX_CELL,
                            p1=sock, p2=meta, p3=nbytes)


def _row(ctx, v: int):
    """An i32 [H] row of ``v`` (a socket number, a zero)."""
    return torch.full((ctx.n_hosts,), v, dtype=torch.int32, device=ctx.device)


# -- client steps ----------------------------------------------------------
def _client_begin_circuit(st, ctx, mask, now):
    """Draw middle+exit, CREATE on the guard conn (sock 1)."""
    app = dict(st.model.app)
    mid = _pick(ctx, _draw_bits(ctx, app, mask), "relay")
    ext = _pick(ctx, _draw_bits(ctx, app, mask), "exit")
    circ = app["cl_circ"] + 1
    app["cl_circ"] = torch.where(mask, circ, app["cl_circ"])
    app["cl_mid"] = torch.where(mask, mid, app["cl_mid"])
    app["cl_exit"] = torch.where(mask, ext, app["cl_exit"])
    app["cl_hop"] = torch.where(mask, 1, app["cl_hop"])
    app["cl_state"] = torch.where(mask, CL_BUILDING, app["cl_state"])
    app["cl_streams_left"] = torch.where(mask, app["cfg_n_streams"],
                                         app["cl_streams_left"])
    return _push_cell(_set_app(st, app), ctx, mask, _row(ctx, 1),
                      _meta(circ, 0, C_CREATE), CELL, now)


def _client_begin_stream(st, ctx, mask, now):
    """Draw the stream size and BEGIN it on the current circuit."""
    app = dict(st.model.app)
    want = stream_cells(ctx, app, _draw_bits(ctx, app, mask))
    app["cl_cells_want"] = torch.where(mask, want, app["cl_cells_want"])
    app["cl_state"] = torch.where(mask, CL_STREAM, app["cl_state"])
    circ = app["cl_circ"]
    return _push_cell(_set_app(st, app), ctx, mask, _row(ctx, 1),
                      _meta(circ, want, C_BEGIN), CELL, now)


def _client_think(st, ctx, mask, now):
    app = dict(st.model.app)
    think = rng.exponential_ns(_draw_bits(ctx, app, mask),
                               app["cfg_mean_think"])
    return push_local_event(_set_app(st, app), ctx, mask, now + think, K_APP,
                            p0=OP_THINK)


# -- relay machinery -------------------------------------------------------
def _ct_find(app, sock, circ, side):
    """First circuit-table slot matching (sock, circ) on ``side`` ∈
    {'in', 'out'}. Returns (found[H], idx[H])."""
    m = (app["ct_used"] & (app[f"ct_{side}_sock"] == sock[None, :])
         & (app[f"ct_{side}_circ"] == circ[None, :]))
    return first_true_idx(m)


def _relay_on_cell(st, ctx, m, sock, meta, now):
    """The relay cell machine: one cell per host per round."""
    circ, aux, cmd = _decode(meta)
    app = dict(st.model.app)

    # --- C_CREATE: allocate a table entry, reply CREATED on the same leg.
    cr = m & (cmd == C_CREATE)
    has_free, slot = first_true_idx(~app["ct_used"])
    ok = cr & has_free
    app["ct_overflow"] = app["ct_overflow"] + (cr & ~has_free).to(torch.int64)
    app["ct_used"] = set_col(app["ct_used"], slot, True, ok)
    app["ct_in_sock"] = set_col(app["ct_in_sock"], slot, sock, ok)
    app["ct_in_circ"] = set_col(app["ct_in_circ"], slot, circ, ok)
    app["ct_out_sock"] = set_col(app["ct_out_sock"], slot, -1, ok)
    app["ct_pend"] = set_col(app["ct_pend"], slot, False, ok)
    st = _push_cell(_set_app(st, app), ctx, ok, sock,
                    _meta(circ, 0, C_CREATED), CELL, now)

    # --- locate the entry for every other cell, by in-side then out-side.
    app = dict(st.model.app)
    other = m & (cmd != C_CREATE)
    f_in, i_in = _ct_find(app, sock, circ, "in")
    f_out, i_out = _ct_find(app, sock, circ, "out")
    from_in = other & f_in
    from_out = other & ~f_in & f_out
    idx = torch.where(from_in, i_in, torch.where(from_out, i_out, 0))
    out_sock0 = get_col(app["ct_out_sock"], idx)

    # --- C_EXTEND from the in-side with no out leg yet: open/reuse the
    # onward conn and queue its CREATE.
    ext = from_in & (cmd == C_EXTEND) & (out_sock0 < 0)
    target = aux
    # reuse: first outbound conn already dialed to this relay
    any_reuse, r_sock = first_true_idx(app["rc_peer"] == target[None, :])
    has_reuse = ext & any_reuse
    # else: lowest FREE socket ≥ 1 (children take the top; see tcp.py)
    tcp_free = st.model.tcp["st"] == TCP_FREE
    tcp_free[0] = False
    need_dial = ext & ~has_reuse
    any_free, d_sock = first_true_idx(tcp_free)
    can_dial = need_dial & any_free
    app["ct_overflow"] = (app["ct_overflow"]
                          + (need_dial & ~can_dial).to(torch.int64))
    osock = torch.where(has_reuse, r_sock, d_sock)
    oks = has_reuse | can_dial
    # allocate the out-circ id from the conn's counter
    ocirc = get_col(app["rc_next_circ"], osock)
    app["rc_next_circ"] = add_col(app["rc_next_circ"], osock, 1, oks)
    app["rc_peer"] = set_col(app["rc_peer"], d_sock, target, can_dial)
    app["ct_out_sock"] = set_col(app["ct_out_sock"], idx, osock, oks)
    app["ct_out_circ"] = set_col(app["ct_out_circ"], idx, ocirc, oks)
    # CREATE goes out now if the conn is up, else when it establishes.
    conn_up = has_reuse & (get_col(st.model.tcp["st"], osock)
                           == TCP_ESTABLISHED)
    app["ct_pend"] = set_col(app["ct_pend"], idx, ~conn_up, oks)
    st = _push_cell(_set_app(st, app), ctx, conn_up, osock,
                    _meta(ocirc, 0, C_CREATE), CELL, now)
    st = push_local_event(st, ctx, can_dial, now, K_APP,
                          p0=OP_CONNECT_RELAY, p1=d_sock, p2=target)

    # --- C_CREATED arriving on an out leg: translate to EXTENDED inward.
    app = st.model.app
    created = from_out & (cmd == C_CREATED)
    in_sock = get_col(app["ct_in_sock"], idx)
    in_circ = get_col(app["ct_in_circ"], idx)
    st = _push_cell(st, ctx, created, in_sock, _meta(in_circ, 0, C_EXTENDED),
                    CELL, now)

    # --- C_BEGIN landing at the exit (in-side entry, no out leg): serve the
    # stream — one DATA message of aux cells, then END.
    at_exit = from_in & (cmd == C_BEGIN) & (out_sock0 < 0)
    st = _push_cell(st, ctx, at_exit, sock, _meta(circ, aux, C_DATA),
                    aux * CELL, now)
    st = _push_cell(st, ctx, at_exit, sock, _meta(circ, 0, C_END), CELL, now)

    # --- forwarding: everything else crosses the relay.
    app = st.model.app
    out_sock = get_col(app["ct_out_sock"], idx)
    out_circ = get_col(app["ct_out_circ"], idx)
    # EXTEND with an existing out leg telescopes onward (the next relay does
    # the extending); only the ext-handled case (fresh out leg this round)
    # must not also forward.
    fwd_in = from_in & ~ext & (cmd != C_CREATED) & ~at_exit & (out_sock >= 0)
    fwd_out = from_out & (cmd != C_CREATED)
    nbytes = torch.where(cmd == C_DATA, aux * CELL, CELL)
    napp = dict(app)
    napp["cells_fwd"] = napp["cells_fwd"] + (fwd_in | fwd_out).to(torch.int64)
    st = _set_app(st, napp)
    st = _push_cell(st, ctx, fwd_in, out_sock, _meta(out_circ, aux, cmd),
                    nbytes, now)
    return _push_cell(st, ctx, fwd_out, in_sock, _meta(in_circ, aux, cmd),
                      nbytes, now)


# -- event handlers --------------------------------------------------------
def on_wakeup(st, ctx, ev, mask):
    op = ev.p[0]
    now = ev.time
    zero = _row(ctx, 0)
    start = mask & (op == OP_START)
    dial = mask & (op == OP_CONNECT_RELAY)
    drain = mask & (op == OP_DRAIN)
    think = mask & (op == OP_THINK)
    # The four rare blocks' tests read only the popped events: one read.
    any_start, any_dial, any_drain, any_think = _any(start, dial, drain, think)

    # OP_START: the client dials a dirauth on sock 2.
    if any_start:
        t = ctx.app_tables
        app = dict(st.model.app)
        b = _draw_bits(ctx, app, start)
        d_idx = rng.randint(b, len(t["dir_ids"]))
        dirauth = t["dir_ids"][d_idx.long()]
        app["cl_state"] = torch.where(start, CL_DIR_CONN, app["cl_state"])
        st = T.tcp_connect(_set_app(st, app), ctx, start, _row(ctx, 2),
                           dirauth, zero, now)

    # OP_TX_CELL: the single transport-send site. Admission: the full
    # message must fit the send buffer and a boundary slot must be free;
    # otherwise retry at the next window start (deterministic backoff).
    tx = mask & (op == OP_TX_CELL)
    sock, meta, nbytes = ev.p[1], ev.p[2], ev.p[3]
    tcp = st.model.tcp
    sk = torch.where(tx, sock, 0)
    snd_una = get_col(tcp["snd_una"], sk)
    app_end = get_col(tcp["app_end"], sk)
    buffered = (app_end - snd_una) - (snd_una == 0).to(torch.int32)
    fits = (ctx.params.sndbuf - buffered) >= nbytes
    mq_ok = ~get_col(tcp["mq_valid"], sk).all(dim=0)
    can = tx & fits & mq_ok
    retry = tx & ~can
    st, _acc = T.tcp_send(st, ctx, can, sock, nbytes, meta, now)
    app = dict(st.model.app)
    app["cell_retries"] = app["cell_retries"] + retry.to(torch.int64)
    st = _set_app(st, app)
    t_retry = (now // ctx.window + 1) * ctx.window
    st = push_local_event(st, ctx, retry, t_retry, K_APP, p0=OP_TX_CELL,
                          p1=sock, p2=meta, p3=nbytes)

    # OP_CONNECT_RELAY: dial an onward relay conn.
    if any_dial:
        st = T.tcp_connect(st, ctx, dial, ev.p[1], ev.p[2], zero, now)

    # OP_DRAIN: send one pending CREATE on an established conn; loop while
    # more remain.
    if any_drain:
        dsock = ev.p[1]
        app = dict(st.model.app)
        pend = (app["ct_used"] & app["ct_pend"]
                & (app["ct_out_sock"] == dsock[None, :]))
        any_p, idx = first_true_idx(pend)
        has = drain & any_p
        ocirc = get_col(app["ct_out_circ"], idx)
        app["ct_pend"] = set_col(app["ct_pend"], idx, False, has)
        more = drain & (pend.sum(dim=0) > 1)
        st = _push_cell(_set_app(st, app), ctx, has, dsock,
                        _meta(ocirc, 0, C_CREATE), CELL, now)
        st = push_local_event(st, ctx, more, now, K_APP, p0=OP_DRAIN,
                              p1=dsock)

    # OP_THINK: next stream on this circuit, or next circuit.
    if any_think:
        next_stream = think & (st.model.app["cl_streams_left"] > 0)
        st = _client_begin_stream(st, ctx, next_stream, now)
        next_circ = (think & ~next_stream
                     & (st.model.app["cl_circs_left"] > 0))
        st = _client_begin_circuit(st, ctx, next_circ, now)
    return st


def on_notify(st, ctx, nf: T.Notif, now, mask):
    f = nf.flags
    sock = nf.sock
    role = st.model.app["role"]
    is_client = role == 1
    est = (f & N_ESTABLISHED) != 0
    msg = (f & N_MSG) != 0
    circ, aux, cmd = _decode(nf.meta)
    one, two = _row(ctx, 1), _row(ctx, 2)

    # The client bootstrap and circuit-build blocks (rare: a handful of
    # times per client) and the dirauth block. Their tests are read at
    # once here; a test whose state an earlier block may have changed is
    # read again only if that block ran.
    def dir_up_of(app):
        return (mask & is_client & est & (sock == 2)
                & (app["cl_state"] == CL_DIR_CONN))

    def got_dir_of(app):
        return (mask & is_client & msg & (sock == 2) & (cmd == C_DIRRESP)
                & (app["cl_state"] == CL_DIR_FETCH))

    def guard_up_of(app):
        return (mask & is_client & est & (sock == 1)
                & (app["cl_state"] == CL_GUARD_CONN))

    def build_of(app):
        cl_msg = mask & is_client & msg & (sock == 1) & (circ == app["cl_circ"])
        hop = app["cl_hop"]
        return (cl_msg & (cmd == C_CREATED) & (hop == 1),
                cl_msg & (cmd == C_EXTENDED) & (hop == 2),
                cl_msg & (cmd == C_EXTENDED) & (hop == 3))

    dreq = mask & (role == 2) & msg & (cmd == C_DIRREQ)
    d_fin = mask & (role == 2) & ((f & N_PEER_FIN) != 0)
    app = st.model.app
    dir_up, got_dir, guard_up = dir_up_of(app), got_dir_of(app), guard_up_of(app)
    creatd, ext2, ext3 = build_of(app)
    ran = _any(dir_up, got_dir, guard_up, creatd | ext2 | ext3, dreq | d_fin)
    any_dirauth = ran.pop()
    changed = False

    # Client: dirauth conn up → request the consensus.
    if ran[0]:
        napp = dict(st.model.app)
        napp["cl_state"] = torch.where(dir_up, CL_DIR_FETCH, napp["cl_state"])
        st = _push_cell(_set_app(st, napp), ctx, dir_up, two,
                        _meta(0, 0, C_DIRREQ), CELL, now)
        changed = True

    # Client: consensus received → close dir conn, dial the drawn guard.
    if changed:
        got_dir = got_dir_of(st.model.app)
        ran[1] = bool(got_dir.any())
    if ran[1]:
        napp = dict(st.model.app)
        guard = _pick(ctx, _draw_bits(ctx, napp, got_dir), "guard")
        napp["cl_guard"] = torch.where(got_dir, guard, napp["cl_guard"])
        napp["bootstrap_time"] = torch.where(got_dir, now,
                                             napp["bootstrap_time"])
        napp["cl_state"] = torch.where(got_dir, CL_GUARD_CONN,
                                       napp["cl_state"])
        st = T.tcp_close(_set_app(st, napp), ctx, got_dir, two, now)
        st = T.tcp_connect(st, ctx, got_dir, one, guard, _row(ctx, 0), now)
        changed = True

    # Client: guard conn up → first circuit.
    if changed:
        guard_up = guard_up_of(st.model.app)
        ran[2] = bool(guard_up.any())
    if ran[2]:
        st = _client_begin_circuit(st, ctx, guard_up, now)
        changed = True

    # Client: circuit-build and stream cells on the guard conn.
    app = st.model.app
    cl_msg = mask & is_client & msg & (sock == 1) & (circ == app["cl_circ"])
    if changed:
        creatd, ext2, ext3 = build_of(app)
        ran[3] = bool((creatd | ext2 | ext3).any())
    if ran[3]:
        napp = dict(app)
        napp["cl_hop"] = torch.where(creatd | ext2, app["cl_hop"] + 1,
                                     napp["cl_hop"])
        st = _push_cell(_set_app(st, napp), ctx, creatd, one,
                        _meta(app["cl_circ"], app["cl_mid"], C_EXTEND), CELL,
                        now)
        st = _push_cell(st, ctx, ext2, one,
                        _meta(app["cl_circ"], app["cl_exit"], C_EXTEND), CELL,
                        now)
        st = _client_begin_stream(st, ctx, ext3, now)

    # Client: stream data/end.
    app = st.model.app
    data = cl_msg & (cmd == C_DATA) & (app["cl_state"] == CL_STREAM)
    napp = dict(app)
    napp["cells_rx"] = napp["cells_rx"] + torch.where(data, aux, 0).to(
        torch.int64)
    ended = cl_msg & (cmd == C_END) & (napp["cl_state"] == CL_STREAM)
    napp["streams_done"] = napp["streams_done"] + ended.to(torch.int32)
    napp["cl_streams_left"] = napp["cl_streams_left"] - ended.to(torch.int32)
    circ_done = ended & (napp["cl_streams_left"] == 0)
    napp["cl_circs_left"] = napp["cl_circs_left"] - circ_done.to(torch.int32)
    all_done = circ_done & (napp["cl_circs_left"] == 0)
    napp["done_time"] = torch.where(all_done, now, napp["done_time"])
    napp["cl_state"] = torch.where(all_done, CL_DONE, napp["cl_state"])
    st = _client_think(_set_app(st, napp), ctx, ended & ~all_done, now)

    # Dirauth: serve consensus requests; reap disconnected clients.
    if any_dirauth:
        consensus_bytes = int(ctx.model_cfg.get("consensus_bytes", 2048))
        st = _push_cell(st, ctx, dreq, sock, _meta(0, 0, C_DIRRESP),
                        consensus_bytes, now)
        st = T.tcp_close(st, ctx, d_fin, sock, now)

    # Relay: onward conn established → drain pending CREATEs.
    dialed = get_col(st.model.app["rc_peer"], sock) >= 0
    r_est = mask & (role == 0) & est & dialed
    st = push_local_event(st, ctx, r_est, now, K_APP, p0=OP_DRAIN, p1=sock)

    # Relay: the cell machine.
    return _relay_on_cell(st, ctx, mask & (role == 0) & msg, sock, nf.meta,
                          now)


def summary(app) -> dict:
    return {
        "streams_done": app["streams_done"],
        "cells_rx": app["cells_rx"],
        "bootstrap_time": app["bootstrap_time"],
        "done_time": app["done_time"],
        "cells_fwd": app["cells_fwd"],
        "ct_overflow": app["ct_overflow"],
        "cell_retries": app["cell_retries"],
        "total_streams_done": app["streams_done"].sum(),
        "total_cells_rx": app["cells_rx"].sum(),
        "total_cells_fwd": app["cells_fwd"].sum(),
        "total_ct_overflow": app["ct_overflow"].sum(),
        "clients_done": (app["done_time"] > 0).sum(),
    }
