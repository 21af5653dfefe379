"""The "net" workload model: NIC + TCP transport + a model application
(port of ``net/__init__.py``).

Per arrived packet: the NIC receive queue (batched once per window by
``make_pre_window``, which turns each window's K_PKT arrivals into
K_PKT_DELIVER events at their queue-cleared times) → TCP processing
(``K_PKT_DELIVER``) → app notification → app reaction (sends, closes) in
the same round. Retransmit timers (``K_TCP_TIMER``), transmit resumes
(``K_TX_RESUME``) and app wakeups (``K_APP``) are events of their own.

model_cfg: ``{"app": <name>, ...app-specific numpy arrays}``. This slice
runs the ``filexfer`` app. Not ported yet, and refused by
``core/engine.py check_supported``: the other apps (``dgram`` with
``udp_send``, ``tgen``, ``tor``, ``bitcoin``), and the per-round K_PKT
handler (``on_pkt``), which the reference runs only with an rx queue bound
or the virtual CPU.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from shadow1_tpu_torch.consts import (
    F_DGRAM,
    K_APP,
    K_PKT,
    K_PKT_DELIVER,
    K_TCP_TIMER,
    K_TX_RESUME,
    N_DGRAM,
    SEC,
    WIRE_OVERHEAD,
)
from shadow1_tpu_torch.core.events import I64_MAX, tb_join, tb_split
from shadow1_tpu_torch.net.nic import NicState, nic_init
from shadow1_tpu_torch.tcp import tcp as T


class NetState(NamedTuple):
    nic: NicState
    tcp: dict
    app: Any


def _app_module(name: str):
    if name == "filexfer":
        from shadow1_tpu_torch.apps import filexfer

        return filexfer
    raise NotImplementedError(
        f"app {name!r} is not ported yet (ROADMAP: the other apps)")


def init(ctx, evbuf):
    pr = ctx.params
    nic = nic_init(ctx.n_hosts, ctx.device)
    tcpd = T.tcp_init(ctx.n_hosts, pr.sockets_per_host, pr.msgq_cap, pr,
                      ctx.device)
    app, evbuf, over, tcpd = _app_module(ctx.model_cfg["app"]).init(
        ctx, evbuf, tcpd)
    return NetState(nic=nic, tcp=tcpd, app=app), evbuf, over


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
    reference's prefix term for term, exact in i64."""
    neg = -(1 << 62)

    def pre_window(st, _ctx, win_end):
        buf = st.evbuf
        abs_t = buf.abs_time()
        sel = (buf.kind == K_PKT) & (abs_t < win_end)
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
        thi, tlo = tb_split(torch.where(vo, ready_o, abs_t))
        evbuf = buf._replace(kind=torch.where(vo, K_PKT_DELIVER, buf.kind),
                             time_hi=thi, time_lo=tlo)
        return st._replace(evbuf=evbuf, model=st.model._replace(nic=nic))

    return pre_window


def make_handlers(ctx):
    app_mod = _app_module(ctx.model_cfg["app"])

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

    # No K_PKT pass: make_pre_window converts every arrival.
    return {K_PKT_DELIVER: on_deliver, K_TCP_TIMER: on_timer,
            K_TX_RESUME: on_txr, K_APP: on_app}


def summary(model: NetState, ctx) -> dict:
    d = {"nic_tx_bytes": model.nic.tx_bytes, "nic_rx_bytes": model.nic.rx_bytes}
    d.update(_app_module(ctx.model_cfg["app"]).summary(model.app))
    return d
