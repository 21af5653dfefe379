"""dgram — periodic datagram traffic, the UDP-path exerciser (port of
``apps/dgram.py``).

Each sender emits ``count`` datagrams of ``payload`` bytes at ``interval``
spacing to a fixed destination; receivers count deliveries. It drives the
NIC, routing and loss path without TCP.

model_cfg ([H] numpy arrays): ``dst``, ``payload``, ``interval``,
``count``, ``start_time``.
"""

from __future__ import annotations

import torch

from shadow1_tpu_torch import net
from shadow1_tpu_torch.consts import K_APP, N_DGRAM, NP
from shadow1_tpu_torch.core.engine import push_local_event
from shadow1_tpu_torch.core.lanes import lsum
from shadow1_tpu_torch.core.popk import push_local

OP_TICK = 1


def init(ctx, evbuf, tcpd):
    cfg = ctx.model_cfg
    h, dev = ctx.n_hosts, ctx.device

    def t(name, dtype):
        return torch.as_tensor(cfg[name], device=dev).to(dtype)

    app = {
        "dst": t("dst", torch.int32),
        "payload": t("payload", torch.int32),
        "interval": t("interval", torch.int64),
        "left": t("count", torch.int32),
        "rx_count": torch.zeros(h, dtype=torch.int64, device=dev),
        "rx_bytes": torch.zeros(h, dtype=torch.int64, device=dev),
    }
    p = torch.zeros((NP, h), dtype=torch.int32, device=dev)
    p[0] = OP_TICK
    k = torch.full((h,), K_APP, dtype=torch.int32, device=dev)
    evbuf, over = push_local(evbuf, app["left"] > 0,
                             t("start_time", torch.int64), k, p)
    return app, evbuf, lsum(ctx, over), tcpd


def on_wakeup(st, ctx, ev, mask):
    m = mask & (ev.p[0] == OP_TICK)
    app = st.model.app
    send = m & (app["left"] > 0)
    zero = torch.zeros(ctx.n_hosts, dtype=torch.int32, device=ctx.device)
    st = net.udp_send(st, ctx, send, app["dst"], zero, app["payload"],
                      zero + 1, zero, ev.time)
    app = dict(st.model.app)
    app["left"] = app["left"] - send.to(torch.int32)
    st = st._replace(model=st.model._replace(app=app))
    again = send & (app["left"] > 0)
    return push_local_event(st, ctx, again, ev.time + app["interval"], K_APP,
                            p0=OP_TICK)


def on_notify(st, ctx, nf, now, mask):
    app = dict(st.model.app)
    dg = mask & ((nf.flags & N_DGRAM) != 0)
    app["rx_count"] = app["rx_count"] + dg.to(torch.int64)
    app["rx_bytes"] = app["rx_bytes"] + torch.where(
        dg, nf.dlen.to(torch.int64), 0)
    return st._replace(model=st.model._replace(app=app))


def summary(app) -> dict:
    return {
        "rx_count": app["rx_count"],
        "rx_bytes": app["rx_bytes"],
        "total_rx": app["rx_count"].sum(),
    }
