"""tgen — Markov/flow traffic-generator model over the virtual TCP stack
(port of ``apps/tgen.py``).

Every host serves on socket 0; hosts with ``active`` set also run a client
loop on socket 1: pick a uniform random peer, stream an exponentially
sized payload with a STREAM_DONE message boundary, close, think an
exponential pause, repeat (BASELINE ladder rung 2).

All randomness is counter-based (R_APP, global host id, 3·stream + k):
k = 0 peer draw, k = 1 size draw, k = 2 think draw. The peer draw ranges
over ``ctx.n_total``, the global host count, so it stays the same when
compaction narrows ``ctx.n_hosts``.

model_cfg (numpy arrays, [H] unless noted): ``active``, ``streams``,
``mean_bytes``, ``mean_think_ns``, ``start_time``; ``fixed_size`` (Python
bool, optional): stream size = mean_bytes exactly.

The reference's two ``lax.cond`` blocks (the server's close on a peer FIN,
the client's think on a full close) are Python ``if``s; both tests read
only the round's notification, so one device→host read serves the two.
Every write in them is masked, so skipping an all-false block is exact.
"""

from __future__ import annotations

import torch

from shadow1_tpu_torch import rng
from shadow1_tpu_torch.consts import (
    K_APP,
    N_CLOSED,
    N_DATA,
    N_ESTABLISHED,
    N_MSG,
    N_PEER_FIN,
    N_SPACE,
    NP,
    R_APP,
    TCP_LISTEN,
)
from shadow1_tpu_torch.core.engine import push_local_event
from shadow1_tpu_torch.core.lanes import lsum
from shadow1_tpu_torch.core.popk import push_local
from shadow1_tpu_torch.tcp import tcp as T
from shadow1_tpu_torch.telemetry.profiler import read

STREAM_DONE = 1
OP_START = 1
SIZE_MAX = 1 << 30


def init(ctx, evbuf, tcpd):
    cfg = ctx.model_cfg
    h, dev = ctx.n_hosts, ctx.device

    def t(name, dtype):
        return torch.as_tensor(cfg[name], device=dev).to(dtype)

    def z(dtype):
        return torch.zeros(h, dtype=dtype, device=dev)

    active = t("active", torch.int32)
    app = {
        "active": active,
        "streams_left": t("streams", torch.int32),
        "mean_bytes": t("mean_bytes", torch.float32),
        "mean_think": t("mean_think_ns", torch.float32),
        "remaining": z(torch.int32),
        "closed_sent": z(torch.bool),
        "ctr": z(torch.int64),            # stream index
        "rx_bytes": z(torch.int64),
        "streams_served": z(torch.int32),
        "streams_done": z(torch.int32),
        "done_time": z(torch.int64),
    }
    # Every host serves on socket 0.
    tcpd = dict(tcpd)
    st = tcpd["st"].clone()
    st[0] = TCP_LISTEN
    tcpd["st"] = st
    starts = (active == 1) & (app["streams_left"] > 0)
    p = torch.zeros((NP, h), dtype=torch.int32, device=dev)
    p[0] = OP_START
    k = torch.full((h,), K_APP, dtype=torch.int32, device=dev)
    evbuf, over = push_local(evbuf, starts, t("start_time", torch.int64), k, p)
    return app, evbuf, lsum(ctx, over), tcpd


def _set_app(st, app):
    return st._replace(model=st.model._replace(app=app))


def _draw(ctx, app, k_off):
    """One u32 per host for sub-draw ``k_off`` of the current stream."""
    return rng.bits(ctx.key, R_APP, ctx.hosts, 3 * app["ctr"] + k_off)


def stream_size(ctx, app, bits):
    """The next stream's size in bytes: ``mean_bytes`` exactly with
    ``fixed_size``, else the exponential draw of ``bits`` clipped to
    [1, SIZE_MAX]; i32 [H]."""
    if ctx.model_cfg.get("fixed_size"):
        return torch.clamp(app["mean_bytes"].to(torch.int32), min=1)
    return torch.clamp(rng.exponential_ns(bits, app["mean_bytes"]),
                       1, SIZE_MAX).to(torch.int32)


def _start_stream(st, ctx, mask, now):
    """Draw (peer, size) for the next stream and connect socket 1 to it."""
    app = dict(st.model.app)
    draw_dst = rng.randint(_draw(ctx, app, 0), ctx.n_total - 1)
    dst = draw_dst + (draw_dst >= ctx.hosts).to(torch.int32)
    size = stream_size(ctx, app, _draw(ctx, app, 1))
    app["remaining"] = torch.where(mask, size, app["remaining"])
    app["closed_sent"] = app["closed_sent"] & ~mask
    app["ctr"] = app["ctr"] + mask.to(torch.int64)
    h, dev = ctx.n_hosts, ctx.device
    one = torch.ones(h, dtype=torch.int32, device=dev)
    zero = torch.zeros(h, dtype=torch.int32, device=dev)
    return T.tcp_connect(_set_app(st, app), ctx, mask, one, dst, zero, now)


def _client_pump(st, ctx, mask, now):
    app = st.model.app
    m = mask & (app["remaining"] > 0)
    h, dev = ctx.n_hosts, ctx.device
    one = torch.ones(h, dtype=torch.int32, device=dev)
    meta = torch.full((h,), STREAM_DONE, dtype=torch.int32, device=dev)
    st, accepted = T.tcp_send(st, ctx, m, one, app["remaining"], meta, now)
    app = dict(st.model.app)
    app["remaining"] = app["remaining"] - accepted
    done = mask & (app["remaining"] == 0) & ~app["closed_sent"]
    app["closed_sent"] = app["closed_sent"] | done
    return T.tcp_close(_set_app(st, app), ctx, done, one, now)


def on_wakeup(st, ctx, ev, mask):
    return _start_stream(st, ctx, mask & (ev.p[0] == OP_START), ev.time)


def on_notify(st, ctx, nf: T.Notif, now, mask):
    f = nf.flags
    is_client_sock = nf.sock == 1

    # Client: connection up or buffer space → pump the stream.
    pump = mask & is_client_sock & (((f & N_ESTABLISHED) != 0)
                                    | ((f & N_SPACE) != 0))
    st = _client_pump(st, ctx, pump, now)

    # Server (listener children live on high sockets): count bytes/streams.
    app = dict(st.model.app)
    srv = mask & ~is_client_sock
    data = srv & ((f & N_DATA) != 0)
    app["rx_bytes"] = app["rx_bytes"] + torch.where(
        data, nf.dlen.to(torch.int64), 0)
    msg = srv & ((f & N_MSG) != 0) & (nf.meta == STREAM_DONE)
    app["streams_served"] = app["streams_served"] + msg.to(torch.int32)
    st = _set_app(st, app)

    # Server: peer finished → close our side. Client: stream fully closed
    # → think, then next stream (or done). Both tests read only the
    # notification, so one device read serves the two.
    peer_fin = srv & ((f & N_PEER_FIN) != 0)
    closed = mask & is_client_sock & ((f & N_CLOSED) != 0)
    any_fin, any_closed = read("tgen_notify", torch.Tensor.tolist,
                               torch.stack([peer_fin.any(), closed.any()]))
    if any_fin:
        st = T.tcp_close(st, ctx, peer_fin, nf.sock, now)
    if any_closed:
        app = dict(st.model.app)
        app["streams_left"] = app["streams_left"] - closed.to(torch.int32)
        app["streams_done"] = app["streams_done"] + closed.to(torch.int32)
        again = closed & (app["streams_left"] > 0)
        app["done_time"] = torch.where(closed & (app["streams_left"] == 0),
                                       now, app["done_time"])
        # The think draw belongs to the stream just completed: ctr was
        # advanced at its start, so its index is ctr - 1.
        think = rng.exponential_ns(
            rng.bits(ctx.key, R_APP, ctx.hosts, 3 * (app["ctr"] - 1) + 2),
            app["mean_think"])
        st = push_local_event(_set_app(st, app), ctx, again, now + think,
                              K_APP, p0=OP_START)
    return st


def summary(app) -> dict:
    return {
        "rx_bytes": app["rx_bytes"],
        "streams_served": app["streams_served"],
        "streams_done": app["streams_done"],
        "done_time": app["done_time"],
        "total_rx_bytes": app["rx_bytes"].sum(),
        "total_streams_served": app["streams_served"].sum(),
        "total_streams_done": app["streams_done"].sum(),
    }
