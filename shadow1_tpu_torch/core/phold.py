"""PHOLD — the classic parallel-DES stress workload (port of
``core/phold.py``).

Every host holds live events; executing one draws an exponential delay and
a uniformly random destination and schedules the next hop there — locally
through ``push_local`` when the draw lands on the host itself, else through
the window's outbox. It drives the event core (pop, push, outbox append,
window-end delivery) with no network stack on top.

model_cfg: ``mean_delay_ns`` (float), ``init_events`` (events seeded per
host at t=0, default 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch import rng
from shadow1_tpu_torch.consts import K_PHOLD, NP, R_PHOLD_DELAY, R_PHOLD_DST
from shadow1_tpu_torch.core.events import EventBuf, Popped
from shadow1_tpu_torch.core.graph import capturable
from shadow1_tpu_torch.core.lanes import lsum
from shadow1_tpu_torch.core.popk import outbox_append, push_local


class PholdState(NamedTuple):
    hops: torch.Tensor  # i64 [H] events executed per host
    ctr: torch.Tensor   # i64 [H] per-host draw counter


def init(ctx, evbuf: EventBuf):
    """Seed ``init_events`` local events at t=0 on every host. Returns
    (model_state, evbuf, seed_overflow)."""
    h, dev = ctx.n_hosts, ctx.device
    n = int(ctx.model_cfg.get("init_events", 1))
    zero_p = torch.zeros((NP, h), dtype=torch.int32, device=dev)
    all_hosts = torch.ones(h, dtype=torch.bool, device=dev)
    t0 = torch.zeros(h, dtype=torch.int64, device=dev)
    k = torch.full((h,), K_PHOLD, dtype=torch.int32, device=dev)
    seed_over = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(n):
        evbuf, over = push_local(evbuf, all_hosts, t0, k, zero_p)
        seed_over = seed_over + lsum(ctx, over)
    state = PholdState(
        hops=torch.zeros(h, dtype=torch.int64, device=dev),
        ctr=torch.zeros(h, dtype=torch.int64, device=dev),
    )
    return state, evbuf, seed_over


def make_handlers(ctx):
    mean = float(ctx.model_cfg["mean_delay_ns"])
    hosts = ctx.hosts
    h, dev = ctx.n_hosts, ctx.device
    # Read-only kernel inputs, built once per engine.
    zero_p = torch.zeros((NP, h), dtype=torch.int32, device=dev)
    k = torch.full((h,), K_PHOLD, dtype=torch.int32, device=dev)

    # No read back to the host and fixed shapes: a graph can replay it.
    @capturable
    def on_phold(st, ev: Popped):
        m = ev.mask & (ev.kind == K_PHOLD)
        model: PholdState = st.model
        delay = rng.exponential_ns(
            rng.bits(ctx.key, R_PHOLD_DELAY, hosts, model.ctr), mean
        )
        dst = rng.randint(rng.bits(ctx.key, R_PHOLD_DST, hosts, model.ctr),
                          ctx.n_total)
        t_next = ev.time + delay
        local = m & (dst == hosts)
        evbuf, over = push_local(st.evbuf, local, t_next, k, zero_p)
        remote = m & ~local
        outbox, ok = outbox_append(st.outbox, remote, dst, k, t_next, zero_p)
        met = st.metrics
        m64 = m.to(torch.int64)
        return st._replace(
            evbuf=evbuf,
            outbox=outbox,
            model=PholdState(hops=model.hops + m64, ctr=model.ctr + m64),
            metrics=met._replace(
                ev_overflow=met.ev_overflow + lsum(ctx, over),
                ob_overflow=met.ob_overflow
                + lsum(ctx, remote & ~ok),
            ),
        )

    return {K_PHOLD: on_phold}


def summary(model: PholdState, ctx=None) -> dict:
    return {"hops": model.hops, "total_hops": model.hops.sum()}
