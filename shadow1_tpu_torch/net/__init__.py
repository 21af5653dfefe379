"""The "net" workload model: NIC + TCP transport + a model application
(port of ``net/__init__.py``).

Per arrived packet: the NIC receive queue → TCP processing
(``K_PKT_DELIVER``) → app notification → app reaction (sends, closes) in
the same round. Retransmit timers (``K_TCP_TIMER``), transmit resumes
(``K_TX_RESUME``) and app wakeups (``K_APP``) are events of their own.

The receive queue runs one of two ways, as in the reference. By default
``make_pre_window`` batches it once per window, turning each window's
K_PKT arrivals into K_PKT_DELIVER events at their queue-cleared times.
With an rx queue bound or the virtual CPU on, every arrival is a K_PKT
event of its own, and the per-round handler ``on_pkt`` stamps the queue
(dropping where the bound says) and pushes its K_PKT_DELIVER.

model_cfg: ``{"app": <name>, ...app-specific numpy arrays}``. The port
runs the ``filexfer``, ``tgen``, ``dgram`` (through ``udp_send``), ``tor``
and ``bitcoin`` apps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from shadow1_tpu_torch.consts import (
    F_DGRAM,
    K_APP,
    K_NONE,
    K_PKT,
    K_PKT_DELIVER,
    K_TCP_TIMER,
    K_TX_RESUME,
    N_DGRAM,
    SEC,
    WIRE_OVERHEAD,
)
from shadow1_tpu_torch.core.dense import payload
from shadow1_tpu_torch.core.events import I64_MAX, tb_join, tb_split
from shadow1_tpu_torch.core import popk
from shadow1_tpu_torch.core.popk import outbox_append
from shadow1_tpu_torch.net.nic import (
    NicState,
    ctx_aqm,
    nic_init,
    rx_stamp,
    tx_stamp,
)
from shadow1_tpu_torch.tcp import tcp as T
from shadow1_tpu_torch.telemetry.links import link_nic_drops


class NetState(NamedTuple):
    nic: NicState
    tcp: dict
    app: Any


# The apps the port runs (``apps/<name>.py``).
APPS = ("filexfer", "dgram", "tgen", "tor", "bitcoin")


def _app_module(name: str):
    if name not in APPS:
        raise ValueError(f"unknown app {name!r}")
    import importlib

    return importlib.import_module(f"shadow1_tpu_torch.apps.{name}")


def init(ctx, evbuf):
    pr = ctx.params
    nic = nic_init(ctx.n_hosts, ctx.device)
    tcpd = T.tcp_init(ctx.n_hosts, pr.sockets_per_host, pr.msgq_cap, pr,
                      ctx.device)
    app, evbuf, over, tcpd = _app_module(ctx.model_cfg["app"]).init(
        ctx, evbuf, tcpd)
    return NetState(nic=nic, tcp=tcpd, app=app), evbuf, over


def udp_send(st, ctx, mask, dst_host, dst_sock, length, meta, meta2, now):
    """Datagram send: NIC uplink stamp, then an outbox packet with
    F_DGRAM; no handshake, no reliability (loss and latency still apply;
    so do the uplink queue bound and RED). With the link plane on, the
    drop-tail drops, which never reach ``route_outbox``, are added to their
    egress edge here."""
    length = torch.as_tensor(length).to(torch.int32)
    p = payload(ctx.n_hosts, ctx.hosts, T.pack_meta(0, dst_sock, F_DGRAM),
                None, None, length, None, None, meta, meta2,
                device=ctx.device)
    wire = length.to(torch.int64) + WIRE_OVERHEAD
    nic, depart, sent, red = tx_stamp(
        st.model.nic, mask, wire, now, ctx.bw_up,
        ctx.tx_qlen_ns if ctx.has_tx_qlen else None, aqm=ctx_aqm(ctx))
    k = torch.full((ctx.n_hosts,), K_PKT, dtype=torch.int32,
                   device=ctx.device)
    outbox, ok = outbox_append(st.outbox, sent, dst_host, k, depart, p)
    m = st.metrics
    return st._replace(
        model=st.model._replace(nic=nic),
        outbox=outbox,
        metrics=m._replace(
            ob_overflow=m.ob_overflow + (sent & ~ok).sum(dtype=torch.int64),
            nic_tx_drops=m.nic_tx_drops
            + (mask & ~sent & ~red).sum(dtype=torch.int64),
            nic_aqm_drops=m.nic_aqm_drops + red.sum(dtype=torch.int64),
        ),
        links=link_nic_drops(st.links, ctx, mask & ~sent & ~red, dst_host),
    )


def make_pre_window(ctx):
    """Batched NIC-arrival processing, once per window before the rounds.

    Every K_PKT eligible in a window is in the event buffer at window start
    (packets are created only by the window-end exchange), and the NIC
    receive chain depends only on arrival order and the ``rx_free`` clock.
    So one pass per host computes the FIFO schedule: sort the host's
    eligible K_PKT slots by (time, tb), run the clock recurrence
    ``free_j = max(free_{j-1}, arr_j) + ser_j``, and turn each slot in
    place into K_PKT_DELIVER at its queue-cleared time
    ``max(free_{j-1}, arr_j)``, keeping the packet's own tie-break.

    The reference sorts with a 3-key ``lax.sort`` and runs the recurrence
    as a max-plus ``associative_scan``. Here the sort is two stable sorts
    (by tie-break, then by time): only the valid slots' order matters, and
    their (time, tb) keys are distinct. The recurrence has an exact integer
    closed form: with ``P_j = cumsum(ser)`` and ``q_i = t_i + ser_i``
    (``-2**62`` on invalid slots, whose ser is 0),
    ``free_j = P_j + max(free0, cummax_{i<=j}(q_i - P_i))`` — the
    reference's prefix term for term, exact in i64.

    Returns None (the per-round ``on_pkt`` then runs) with an rx queue
    bound, whose drops feed back into the clock recurrence, or with the
    virtual CPU, under which every arrival is charged CPU time. Under the
    fault plane a down host discards its arrivals here, unprocessed and
    counted in ``down_events``: they reserve no downlink."""
    if ctx.has_rx_qlen or ctx.has_cpu:
        return None
    neg = -(1 << 62)

    def pre_window(st, _ctx, win_end):
        buf = st.evbuf
        abs_t = buf.abs_time()
        sel = (buf.kind == K_PKT) & (abs_t < win_end)
        kind0, time0, m = buf.kind, abs_t, st.metrics
        if ctx.has_stop:
            from shadow1_tpu_torch.fault.plane import hosts_down_at

            down = sel & hosts_down_at(ctx.fault_down, ctx.fault_up, abs_t)
            sel = sel & ~down
            kind0 = torch.where(down, K_NONE, kind0)
            time0 = torch.where(down, I64_MAX, time0)
            m = m._replace(down_events=m.down_events
                           + down.sum(dtype=torch.int64))
        t_key = torch.where(sel, abs_t, I64_MAX)
        tb = tb_join(buf.tb_hi, buf.tb_lo)
        perm = torch.sort(tb, dim=0, stable=True).indices
        perm = perm.gather(0, torch.sort(t_key.gather(0, perm), dim=0,
                                         stable=True).indices)
        t_s = t_key.gather(0, perm)
        valid = t_s < I64_MAX
        plen = buf.p[4].gather(0, perm)
        wire = torch.where(valid, plen.to(torch.int64) + WIRE_OVERHEAD, 0)
        bw = ctx.bw_dn[None, :]
        ser = torch.where(valid, (wire * (8 * SEC) + bw - 1) // bw, 0)
        p_pre = torch.cumsum(ser, dim=0)
        q = torch.where(valid, t_s + ser, neg)
        free0 = st.model.nic.rx_free[None, :]
        free = p_pre + torch.maximum(free0, torch.cummax(q - p_pre, dim=0).values)
        ready = free - ser
        # Un-sort: slot perm[j] takes row j.
        ready_o = torch.empty_like(ready).scatter_(0, perm, ready)
        vo = torch.zeros_like(valid).scatter_(0, perm, valid)
        nic = st.model.nic._replace(
            rx_free=free[-1, :],
            rx_bytes=st.model.nic.rx_bytes + wire.sum(dim=0),
        )
        thi, tlo = tb_split(torch.where(vo, ready_o, time0))
        evbuf = buf._replace(kind=torch.where(vo, K_PKT_DELIVER, kind0),
                             time_hi=thi, time_lo=tlo)
        return st._replace(evbuf=evbuf, model=st.model._replace(nic=nic),
                           metrics=m)

    return pre_window


def make_handlers(ctx):
    app_mod = _app_module(ctx.model_cfg["app"])
    if hasattr(app_mod, "tables"):
        ctx = dataclasses.replace(
            ctx, app_tables=app_mod.tables(ctx.model_cfg, ctx.device))

    def on_pkt(st, ev):
        """K_PKT: the packet reached the destination NIC — stamp the
        receive queue (drop-tail under its bound), then one push of its
        K_PKT_DELIVER at the queue-cleared time."""
        m = ev.mask & (ev.kind == K_PKT)
        wire = ev.p[4].to(torch.int64) + WIRE_OVERHEAD
        nic, ready, okq = rx_stamp(
            st.model.nic, m, wire, ev.time, ctx.bw_dn,
            ctx.rx_qlen_ns if ctx.has_rx_qlen else None)
        k = torch.full((ctx.n_hosts,), K_PKT_DELIVER, dtype=torch.int32,
                       device=ctx.device)
        evbuf, over = popk.push_local(st.evbuf, okq, ready, k, ev.p)
        met = st.metrics
        return st._replace(
            evbuf=evbuf, model=st.model._replace(nic=nic),
            metrics=met._replace(
                ev_overflow=met.ev_overflow + over.sum(dtype=torch.int64),
                nic_rx_drops=met.nic_rx_drops
                + (m & ~okq).sum(dtype=torch.int64)))

    def on_deliver(st, ev):
        """K_PKT_DELIVER: the packet cleared the NIC — TCP, then the app."""
        m = ev.mask & (ev.kind == K_PKT_DELIVER)
        is_dgram = (((ev.p[1] >> 16) & 0xFF) & F_DGRAM) != 0
        st, nf = T.tcp_rx(st, ctx, m & ~is_dgram, ev.p, ev.time)
        nf = T._notify(nf, m & is_dgram, (ev.p[1] >> 8) & 0xFF, N_DGRAM,
                       meta=ev.p[7], meta2=ev.p[8], dlen=ev.p[4])
        return app_mod.on_notify(st, ctx, nf, ev.time, nf.flags != 0)

    def on_timer(st, ev):
        return T.on_tcp_timer(st, ctx, ev)

    def on_txr(st, ev):
        return T.on_tx_resume(st, ctx, ev)

    def on_app(st, ev):
        return app_mod.on_wakeup(st, ctx, ev, ev.mask & (ev.kind == K_APP))

    handlers = {K_PKT: on_pkt, K_PKT_DELIVER: on_deliver,
                K_TCP_TIMER: on_timer, K_TX_RESUME: on_txr, K_APP: on_app}
    if not (ctx.has_rx_qlen or ctx.has_cpu):
        # make_pre_window converts every arrival: no K_PKT reaches a round.
        del handlers[K_PKT]
    return handlers


def summary(model: NetState, ctx) -> dict:
    d = {"nic_tx_bytes": model.nic.tx_bytes, "nic_rx_bytes": model.nic.rx_bytes}
    d.update(_app_module(ctx.model_cfg["app"]).summary(model.app))
    return d
