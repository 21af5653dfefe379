"""bitcoin — inv/getdata/tx gossip over a P2P graph (port of
``apps/bitcoin.py``, BASELINE rung 5).

Nodes hold persistent TCP connections along the edges of a configured
peer graph; a transaction created at its origin is announced with small
INV messages, fetched with GETDATA, transferred as a tx-sized payload and
re-announced by each node on first receipt — the flood. The output is
propagation: which nodes saw each tx, and when.

Wire model: INV/GETDATA/TX are message boundaries on the TCP byte stream
(meta = cmd << 20 | txid). Fan-out (dial K neighbours, announce a tx on K
conns) is K self-scheduled events at the same time, as in the reference:
``init`` makes one push per neighbour slot and one per transaction, and
each ``_announce`` makes K masked pushes.

The reference's three ``lax.cond`` blocks are Python ``if``s. In
``on_wakeup`` the dial and the tx-creation tests read only the popped
event, so one device→host read serves both; in ``on_notify`` the accept
test reads only the notification. Every write in them is masked, so
skipping an all-false block is exact.

model_cfg:
  peers      i32 [H, K] neighbour ids (symmetric: n in peers[h] ⇔ h in
             peers[n])
  tx_origin  i64 [T] origin host per transaction
  tx_time    i64 [T] creation time per transaction
  tx_size    int, payload bytes of a transaction (default 400)
  inv_size   int, bytes of INV/GETDATA messages (default 36)
  connect_time  int ns, when the conn mesh is dialed (default 0)
"""

from __future__ import annotations

import numpy as np
import torch

from shadow1_tpu_torch.consts import K_APP, N_ACCEPTED, N_MSG, NP, TCP_LISTEN
from shadow1_tpu_torch.core.dense import get_col, set_col
from shadow1_tpu_torch.core.engine import push_local_event
from shadow1_tpu_torch.core.lanes import lsum
from shadow1_tpu_torch.core.popk import push_local
from shadow1_tpu_torch.tcp import tcp as T

OP_CONNECT_ONE = 1   # p1 = neighbour slot j
OP_TX_CREATE = 2     # p1 = txid
OP_TX_MSG = 3        # p1 = socket, p2 = meta, p3 = nbytes

CMD_INV = 1
CMD_GET = 2
CMD_TX = 3

TXID_BITS = 20
TXID_MASK = (1 << TXID_BITS) - 1


def _meta(cmd, txid):
    return (cmd << TXID_BITS) | txid


def init(ctx, evbuf, tcpd):
    cfg = ctx.model_cfg
    h, dev = ctx.n_hosts, ctx.device
    peers = torch.as_tensor(np.asarray(cfg["peers"]).T.copy(),
                            device=dev).to(torch.int32)        # [K, H]
    tx_origin = np.asarray(cfg["tx_origin"], np.int64)
    tx_time = np.asarray(cfg["tx_time"], np.int64)
    n_tx = len(tx_origin)
    assert n_tx <= TXID_MASK
    k_max = peers.shape[0]
    app = {
        "peers": peers,
        # Socket reaching neighbour j (outbound 1 + j at dial time; inbound
        # learned on N_ACCEPTED); -1 = no conn yet.
        "nbr_sock": torch.full((k_max, h), -1, dtype=torch.int32, device=dev),
        "seen": torch.zeros((n_tx, h), dtype=torch.bool, device=dev),
        "req": torch.zeros((n_tx, h), dtype=torch.bool, device=dev),
        "seen_time": torch.zeros((n_tx, h), dtype=torch.int64, device=dev),
        "tx_rx": torch.zeros(h, dtype=torch.int64, device=dev),
        "msg_retries": torch.zeros(h, dtype=torch.int64, device=dev),
    }
    tcpd = dict(tcpd)
    st = tcpd["st"].clone()
    st[0] = TCP_LISTEN
    tcpd["st"] = st
    kk = torch.full((h,), K_APP, dtype=torch.int32, device=dev)
    n_over = torch.zeros((), dtype=torch.int64, device=dev)

    def seed(evbuf, n_over, mask, time, op, arg):
        p = torch.zeros((NP, h), dtype=torch.int32, device=dev)
        p[0], p[1] = op, arg
        evbuf, over = push_local(evbuf, mask, time, kk, p)
        return evbuf, n_over + lsum(ctx, over)

    # Dial the conn mesh: one OP_CONNECT_ONE per outbound neighbour slot.
    connect_time = torch.full((h,), int(cfg.get("connect_time", 0)),
                              dtype=torch.int64, device=dev)
    for j in range(k_max):
        evbuf, n_over = seed(evbuf, n_over, peers[j] > ctx.hosts,
                             connect_time, OP_CONNECT_ONE, j)
    # Seed tx-creation wakeups, one masked push per transaction.
    for t in range(n_tx):
        evbuf, n_over = seed(
            evbuf, n_over, ctx.hosts == int(tx_origin[t]),
            torch.full((h,), int(tx_time[t]), dtype=torch.int64, device=dev),
            OP_TX_CREATE, t)
    return app, evbuf, n_over, tcpd


def _set_app(st, app):
    return st._replace(model=st.model._replace(app=app))


def _push_msg(st, ctx, mask, sock, meta, nbytes, now):
    """Queue a protocol message send (admission-checked in OP_TX_MSG)."""
    return push_local_event(st, ctx, mask, now, K_APP, p0=OP_TX_MSG, p1=sock,
                            p2=meta, p3=nbytes)


def _announce(st, ctx, mask, txid, skip_sock, now):
    """Queue one INV per live neighbour conn except ``skip_sock``: K
    masked pushes."""
    inv_size = int(ctx.model_cfg.get("inv_size", 36))
    nbr_sock = st.model.app["nbr_sock"]
    meta = _meta(CMD_INV, txid)
    for j in range(nbr_sock.shape[0]):
        ns = nbr_sock[j]
        m = mask & (ns >= 0) & (ns != skip_sock)
        st = _push_msg(st, ctx, m, ns, meta, inv_size, now)
    return st


def _mark_seen(app, mask, txid, now):
    t_safe = torch.where(mask, txid, 0)
    new = mask & ~get_col(app["seen"], t_safe)
    app["seen"] = set_col(app["seen"], t_safe, True, new)
    app["seen_time"] = set_col(app["seen_time"], t_safe, now, new)
    return app, new


def on_wakeup(st, ctx, ev, mask):
    op = ev.p[0]
    h, dev = ctx.n_hosts, ctx.device
    conn = mask & (op == OP_CONNECT_ONE)
    create = mask & (op == OP_TX_CREATE)
    any_conn, any_create = torch.stack([conn.any(), create.any()]).tolist()

    # OP_CONNECT_ONE: dial neighbour slot j = p1 on socket 1 + j.
    if any_conn:
        app = dict(st.model.app)
        j = torch.where(conn, ev.p[1], 0)
        peer = get_col(app["peers"], j)
        sock = (1 + j).to(torch.int32)
        app["nbr_sock"] = set_col(app["nbr_sock"], j, sock, conn)
        zero = torch.zeros(h, dtype=torch.int32, device=dev)
        st = T.tcp_connect(_set_app(st, app), ctx, conn, sock, peer, zero,
                           ev.time)

    # OP_TX_CREATE: the origin marks the tx seen and queues announcements.
    if any_create:
        txid = ev.p[1]
        app, new = _mark_seen(dict(st.model.app), create, txid, ev.time)
        none = torch.full((h,), -1, dtype=torch.int32, device=dev)
        st = _announce(_set_app(st, app), ctx, new, txid, none, ev.time)

    # OP_TX_MSG: the one transport-send site. Admission: the message must
    # fit the send buffer and a boundary slot must be free, else retry at
    # the next window start.
    tx = mask & (op == OP_TX_MSG)
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
    st, _acc = T.tcp_send(st, ctx, can, sock, nbytes, meta, ev.time)
    app = dict(st.model.app)
    app["msg_retries"] = app["msg_retries"] + retry.to(torch.int64)
    t_retry = (ev.time // ctx.window + 1) * ctx.window
    return push_local_event(_set_app(st, app), ctx, retry, t_retry, K_APP,
                            p0=OP_TX_MSG, p1=sock, p2=meta, p3=nbytes)


def on_notify(st, ctx, nf: T.Notif, now, mask):
    f = nf.flags
    sock = nf.sock
    tx_size = int(ctx.model_cfg.get("tx_size", 400))
    inv_size = int(ctx.model_cfg.get("inv_size", 36))

    # Inbound conn accepted: bind it to its neighbour slot. Each slot j
    # reads and writes only row j, so the reference's loop over the K
    # slots is one [K, H] pass.
    acc = mask & ((f & N_ACCEPTED) != 0)
    if bool(acc.any()):
        app = dict(st.model.app)
        peer = get_col(st.model.tcp["peer_host"], torch.where(acc, sock, 0))
        m = (acc[None, :] & (app["peers"] == peer[None, :])
             & (app["nbr_sock"] < 0))
        app["nbr_sock"] = torch.where(m, sock.to(torch.int32)[None, :],
                                      app["nbr_sock"])
        st = _set_app(st, app)

    # Protocol messages (one boundary per host-round at most).
    msg = mask & ((f & N_MSG) != 0)
    cmd = nf.meta >> TXID_BITS
    txid = nf.meta & TXID_MASK
    app = dict(st.model.app)
    t_safe = torch.where(msg, txid, 0)
    seen = get_col(app["seen"], t_safe)
    req = get_col(app["req"], t_safe)

    # INV for an unknown tx → GETDATA back on the same conn.
    want = msg & (cmd == CMD_INV) & ~seen & ~req
    app["req"] = set_col(app["req"], t_safe, True, want)
    st = _set_app(st, app)

    # GETDATA for a tx we hold → send the payload. The two responses are
    # exclusive per host-round, so they share one queued send.
    give = msg & (cmd == CMD_GET) & seen
    nbytes = torch.where(give, tx_size, inv_size).to(torch.int32)
    rmeta = torch.where(give, _meta(CMD_TX, txid),
                        _meta(CMD_GET, torch.where(msg, txid, 0)))
    st = _push_msg(st, ctx, want | give, sock, rmeta, nbytes, now)

    # TX payload → first sight: record, then announce everywhere else.
    got = msg & (cmd == CMD_TX)
    app = dict(st.model.app)
    app["tx_rx"] = app["tx_rx"] + got.to(torch.int64)
    app, new = _mark_seen(app, got, txid, now)
    return _announce(_set_app(st, app), ctx, new, txid, sock, now)


def summary(app) -> dict:
    seen = app["seen"]                        # [T, H]
    return {
        "seen": seen.T,                       # [H, T], the oracle's layout
        "seen_time": app["seen_time"].T,
        "tx_rx": app["tx_rx"],
        "reach": seen.sum(dim=1),             # nodes reached per tx
        "msg_retries": app["msg_retries"],
        "total_seen": seen.sum(),
        "total_tx_rx": app["tx_rx"].sum(),
    }
