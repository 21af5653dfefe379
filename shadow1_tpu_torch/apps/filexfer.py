"""filexfer — bulk file transfer over the virtual TCP stack (port of
``apps/filexfer.py``).

Clients connect to their server at a start time, stream ``flow_bytes``
with a FLOW_DONE message boundary at the end, close, and repeat
``flow_count`` times. Servers listen on socket 0 and count delivered bytes
and completed flows.

model_cfg (numpy arrays, [H]): ``role`` (0 server, 1 client, 2 idle),
``server`` (server host per client), ``flow_bytes``, ``start_time`` (ns),
``flow_count``.

The reference's two ``lax.cond`` blocks (the server's close on a peer FIN,
the client's next flow on a full close) are a Python ``if`` on one
device→host read each; every write in them is masked.
"""

from __future__ import annotations

import torch

from shadow1_tpu_torch.consts import (
    K_APP,
    N_CLOSED,
    N_DATA,
    N_ESTABLISHED,
    N_MSG,
    N_PEER_FIN,
    N_SPACE,
    NP,
    TCP_LISTEN,
)
from shadow1_tpu_torch.core.popk import push_local
from shadow1_tpu_torch.tcp import tcp as T

FLOW_DONE = 1
OP_START = 1


def init(ctx, evbuf, tcpd):
    cfg = ctx.model_cfg
    h, dev = ctx.n_hosts, ctx.device

    def t(name, dtype):
        return torch.as_tensor(cfg[name], device=dev).to(dtype)

    role = t("role", torch.int32)
    app = {
        "role": role,
        "server": t("server", torch.int32),
        "flow_bytes": t("flow_bytes", torch.int32),
        "remaining": torch.zeros(h, dtype=torch.int32, device=dev),
        "flows_left": t("flow_count", torch.int32),
        "closed_sent": torch.zeros(h, dtype=torch.bool, device=dev),
        "rx_bytes": torch.zeros(h, dtype=torch.int64, device=dev),
        "flows_done": torch.zeros(h, dtype=torch.int32, device=dev),
        "done_time": torch.zeros(h, dtype=torch.int64, device=dev),
    }
    # Servers listen on socket 0 from t=0.
    tcpd = dict(tcpd)
    st = tcpd["st"].clone()
    st[0] = torch.where(role == 0, TCP_LISTEN, st[0])
    tcpd["st"] = st
    # Clients wake up at their start time.
    p = torch.zeros((NP, h), dtype=torch.int32, device=dev)
    p[0] = OP_START
    k = torch.full((h,), K_APP, dtype=torch.int32, device=dev)
    evbuf, over = push_local(evbuf, role == 1, t("start_time", torch.int64),
                             k, p)
    return app, evbuf, over.sum(dtype=torch.int64), tcpd


def _set_app(st, app):
    return st._replace(model=st.model._replace(app=app))


def _client_pump(st, ctx, mask, now):
    """Queue as much of the current flow as the send buffer takes; FLOW_DONE
    rides the final chunk; close once everything is queued."""
    app = st.model.app
    m = mask & (app["remaining"] > 0)
    h, dev = ctx.n_hosts, ctx.device
    meta = torch.full((h,), FLOW_DONE, dtype=torch.int32, device=dev)
    zero = torch.zeros(h, dtype=torch.int32, device=dev)
    st, accepted = T.tcp_send(st, ctx, m, zero, app["remaining"], meta, now)
    app = dict(st.model.app)
    app["remaining"] = app["remaining"] - accepted
    # mask (not m) so zero-byte flows close right at establishment.
    done = mask & (app["remaining"] == 0) & ~app["closed_sent"]
    app["closed_sent"] = app["closed_sent"] | done
    return T.tcp_close(_set_app(st, app), ctx, done, zero, now)


def _client_start(st, ctx, mask, now):
    app = dict(st.model.app)
    app["remaining"] = torch.where(mask, app["flow_bytes"], app["remaining"])
    app["closed_sent"] = app["closed_sent"] & ~mask
    zero = torch.zeros(ctx.n_hosts, dtype=torch.int32, device=ctx.device)
    return T.tcp_connect(_set_app(st, app), ctx, mask, zero, app["server"],
                         zero, now)


def on_wakeup(st, ctx, ev, mask):
    return _client_start(st, ctx, mask & (ev.p[0] == OP_START), ev.time)


def on_notify(st, ctx, nf: T.Notif, now, mask):
    app = st.model.app
    is_client = app["role"] == 1
    is_server = app["role"] == 0
    f = nf.flags

    # Client: connection up or buffer space → pump bytes.
    pump = mask & is_client & (((f & N_ESTABLISHED) != 0) | ((f & N_SPACE) != 0))
    st = _client_pump(st, ctx, pump, now)

    # Server: count stream bytes and completed flows.
    app = dict(st.model.app)
    data = mask & is_server & ((f & N_DATA) != 0)
    app["rx_bytes"] = app["rx_bytes"] + torch.where(data, nf.dlen.to(torch.int64), 0)
    msg = mask & is_server & ((f & N_MSG) != 0) & (nf.meta == FLOW_DONE)
    app["flows_done"] = app["flows_done"] + msg.to(torch.int32)
    st = _set_app(st, app)

    # Server: peer finished → close our side.
    peer_fin = mask & is_server & ((f & N_PEER_FIN) != 0)
    if bool(peer_fin.any()):
        st = T.tcp_close(st, ctx, peer_fin, nf.sock, now)

    # Client: connection fully closed → next flow or done.
    closed = mask & is_client & ((f & N_CLOSED) != 0)
    if bool(closed.any()):
        app = dict(st.model.app)
        app["flows_left"] = app["flows_left"] - closed.to(torch.int32)
        again = closed & (app["flows_left"] > 0)
        app["done_time"] = torch.where(closed & (app["flows_left"] == 0), now,
                                       app["done_time"])
        st = _client_start(_set_app(st, app), ctx, again, now)
    return st


def summary(app) -> dict:
    return {
        "rx_bytes": app["rx_bytes"],
        "flows_done": app["flows_done"],
        "done_time": app["done_time"],
        "total_rx_bytes": app["rx_bytes"].sum(),
        "total_flows_done": app["flows_done"].sum(dtype=torch.int64),
    }
