"""The batched engine: conservative-window discrete-event execution
(port of ``core/engine.py``: the PHOLD model and the net model).

* outer loop — one iteration per conservative window [T, T+W), W = the
  minimum path latency;
* inner loop — rounds: every host pops its minimum-(time, tb) event and the
  masked handlers run, until no host has an event left in the window;
* window end — the outboxes are routed (latency gather, Bernoulli loss
  draws) and delivered into the destination event buffers.

Each window runs the reference's four phases in order (``window_phases``):
prepare (the work gauges, the model's ``pre_window`` hook, rebase), rounds,
deliver, telem (gauges, and the telemetry-ring row with the state-digest
words). The JAX engine runs them as one jitted program; here they are eager
PyTorch, the windows and rounds are Python loops, and every ``lax.cond`` /
``while_loop`` test of the reference is one flag read back from the device:
per round the continue test (``any_eligible``) and one read of which
handler kinds popped, plus the model's own (``tcp/tcp.py``, ``apps/*``);
with ``compact_cap`` one more per window (``core/compact.py``).

The fidelity gates run where the reference runs them: host churn (the
fault plane's down intervals) and the virtual CPU between pop and
dispatch (``run_round``; the CPU's deferrals go back through
``popk.push_back``), edge jitter, link outages and loss ramps in
``route_outbox``, dead destinations in ``deliver_flat``, and the restart
reset before a window's rounds (``ph_prepare``).

With ``probes`` the telem phase also samples the watched entities into the
flow-probe ring (``telemetry/probes.py``), and with ``link_telem`` the
route phase and the NIC drop sites add to the per-edge link accumulator
(``telemetry/links.py``); neither reads from the device. Each phase runs
inside a ``record_function`` scope named as the reference names its
``jax.named_scope`` (``telemetry.profiler.WINDOW_PHASES``), so a
``device_trace`` shows which phase launched each kernel.

Module and function names follow the reference so each counterpart is found
under the same name. The recovery planes work between chunks, outside
the engine (``ckpt.run_chunked`` with ``txn.py`` and ``tune/``); the
engine itself refuses only a model or app it does not know
(``check_supported``).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from shadow1_tpu_torch import rng
from shadow1_tpu_torch.config.compiled import NO_STOP, CompiledExperiment
from shadow1_tpu_torch.consts import (
    K_NONE,
    KIND_METRIC_FIELDS,
    R_JITTER,
    R_LOSS,
    SEC,
    EngineParams,
    packet_tb,
)
from shadow1_tpu_torch.core.events import (
    I32_PASTDUE,
    EventBuf,
    any_eligible,
    deliver_batch,
    evbuf_init,
    rebase,
)
from shadow1_tpu_torch.core.outbox import (
    Outbox,
    outbox_clear,
    outbox_init,
)
from shadow1_tpu_torch.core import popk
from shadow1_tpu_torch.core.lanes import lany, lmax, lsum
from shadow1_tpu_torch.core.popk import pop_until


class Metrics(NamedTuple):
    """Run counters, every one an i64 scalar tensor (``[E]``, one per lane,
    in a fleet); the same fields in the same order as the reference's
    ``Metrics`` (see there for each one's meaning). Fields of parts the
    port does not run stay 0."""

    events: torch.Tensor
    rounds: torch.Tensor
    windows: torch.Tensor
    pkts_sent: torch.Tensor
    pkts_delivered: torch.Tensor
    pkts_lost: torch.Tensor
    ev_overflow: torch.Tensor
    ob_overflow: torch.Tensor
    round_cap_hits: torch.Tensor
    tcp_fast_rtx: torch.Tensor
    tcp_rto: torch.Tensor
    tcp_ooo_drops: torch.Tensor
    x2x_overflow: torch.Tensor
    x2x_max_fill: torch.Tensor
    ev_max_fill: torch.Tensor
    ob_max_fill: torch.Tensor
    compact_max_fill: torch.Tensor
    down_events: torch.Tensor
    down_pkts: torch.Tensor
    nic_tx_drops: torch.Tensor
    nic_rx_drops: torch.Tensor
    nic_aqm_drops: torch.Tensor
    pops_pkt: torch.Tensor
    pops_deliver: torch.Tensor
    pops_timer: torch.Tensor
    pops_txr: torch.Tensor
    pops_app: torch.Tensor
    fires_pkt: torch.Tensor
    fires_deliver: torch.Tensor
    fires_timer: torch.Tensor
    fires_txr: torch.Tensor
    fires_app: torch.Tensor
    link_down_pkts: torch.Tensor
    host_restarts: torch.Tensor
    active_hosts: torch.Tensor
    elig_events: torch.Tensor
    outbox_hosts: torch.Tensor


def _metrics_init(device, n_exp: int = 0) -> Metrics:
    shape = (n_exp,) if n_exp else ()
    return Metrics(*(torch.zeros(shape, dtype=torch.int64, device=device)
                     for _ in Metrics._fields))


class SimState(NamedTuple):
    win_start: torch.Tensor  # i64 scalar
    evbuf: EventBuf
    outbox: Outbox
    model: Any               # workload-model state (PholdState, NetState)
    metrics: Metrics
    cpu_busy: torch.Tensor   # i64 [H] virtual CPU free-at (0: no cpu model)
    # The telemetry planes, each None when off: the ring
    # (telemetry/ring.TelemetryRing, metrics_ring > 0), the flow-probe ring
    # (telemetry/probes.ProbeRing, probes and metrics_ring > 0) and the
    # link accumulator (telemetry/links.LinkAccum, link_telem).
    telem: Any = None
    probes: Any = None
    links: Any = None


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Run constants handed to the model's handler builders. ``n_hosts`` is
    the host-axis size, ``hosts`` the global host ids (``arange`` on one
    device) and ``n_total`` the global host count.

    A fleet ctx (``fleet/engine.py``) folds ``n_exp`` lanes into the host
    axis: ``n_hosts`` is E·H, ``hosts`` is ``arange(H)`` tiled E times,
    ``lane`` the lane of each column, ``key`` an int64 tensor holding each
    column's lane key, and the per-lane tables carry a leading ``[E]``
    axis (``loss_thr_vv``, ``link_fault``, ``loss_ramp``) or are folded
    onto the host axis like the state (``fault_down``, ``fault_up``)."""

    n_hosts: int
    n_total: int
    params: EngineParams
    window: int
    key: int                    # base RNG key (u64 bits as a Python int)
    lat_vv: torch.Tensor        # i64 [V, V]
    loss_thr_vv: torch.Tensor   # i64 [V, V] Bernoulli thresholds (≤ 2**32)
    host_vertex: torch.Tensor   # i32 [H]
    bw_up: torch.Tensor         # i64 [H] uplink bits/s
    bw_dn: torch.Tensor         # i64 [H] downlink bits/s
    model_cfg: dict
    hosts: torch.Tensor         # i32 [H] global host ids
    device: torch.device
    # An app's static tables that are not per-host (Tor's path tables),
    # set by the net model's make_handlers on the ctx its handlers see.
    app_tables: Any = None
    # The [K] index tensors of ``params.probes`` (telemetry/probes.
    # ProbeIndex), or None without probes.
    probe_index: Any = None
    # Fidelity tables (``fidelity_ctx_kwargs``), [H] or [V, V] on the
    # device, and the fault plane's: host h is down at t iff some k has
    # fault_down[k, h] <= t < fault_up[k, h].
    jitter_vv: torch.Tensor = None    # i64 [V, V]
    fault_down: torch.Tensor = None   # i64 [K, H]
    fault_up: torch.Tensor = None     # i64 [K, H] (window-quantized)
    link_fault: Any = None            # (src, dst, t0, t1) [L] or None
    loss_ramp: Any = None             # (src, dst, t0, t1, thr) [R] or None
    init_model: Any = None            # post-init model state (restarts)
    cpu_cost: torch.Tensor = None     # i64 [H] virtual CPU ns per event
    tx_qlen_ns: torch.Tensor = None   # i64 [H] uplink bound (backlog ns)
    rx_qlen_ns: torch.Tensor = None   # i64 [H]
    aqm_min_ns: torch.Tensor = None   # i64 [H] RED min (backlog ns)
    aqm_span_ns: torch.Tensor = None  # i64 [H] RED max − min (≥ 1)
    aqm_pmax_thr: torch.Tensor = None # i64 [H] threshold at pmax (≤ 2**32)
    # Which gates run; a gate that is off runs no operation.
    has_jitter: bool = False
    has_stop: bool = False
    has_restart: bool = False
    has_link_fault: bool = False
    has_loss_ramp: bool = False
    has_cpu: bool = False
    has_tx_qlen: bool = False
    has_rx_qlen: bool = False
    has_aqm: bool = False
    # The fleet's lanes (``core/lanes.py``): one lane in a solo run.
    n_exp: int = 0                    # 0: a solo run, no lane axis
    lane: torch.Tensor = None         # i64 [E·H] lane of each column
    lane_max_rounds: tuple = None     # per-lane max_rounds when they differ


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. With no card and no explicit request this raises — the port
    never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: shadow1_tpu_torch runs on the GPU unless "
                "asked for the CPU (device='cpu', --device cpu)")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def check_supported(exp: CompiledExperiment, params: EngineParams) -> None:
    """Refuse a model or app the port does not know. Every engine knob of
    the solo engine runs since the recovery planes (``txn.py``, ``tune/``,
    ``mem.py``); the sharded scheduler runs ``shard/engine.py``."""
    from shadow1_tpu_torch.net import APPS

    if exp.model == "net" and exp.model_cfg.get("app") not in APPS:
        raise ValueError(f"unknown app {exp.model_cfg.get('app')!r}")
    if exp.model not in ("phold", "net"):
        raise ValueError(f"unknown model {exp.model!r}")


def check_digest_params(params: EngineParams) -> None:
    """state_digest needs a telemetry ring: the per-window digest words are
    ring columns."""
    if params.state_digest and params.metrics_ring <= 0:
        raise ValueError(
            "state_digest=1 requires metrics_ring > 0 — the per-window "
            "digest words are ring columns (CLI --state-digest sets a ring "
            "automatically)")


def check_probe_params(params: EngineParams) -> None:
    """The probe ring reuses the telemetry ring's depth knob: watched flows
    need metrics_ring > 0."""
    if params.probes and params.metrics_ring <= 0:
        raise ValueError(
            "probes require metrics_ring > 0 — the [W, K, F] probe ring "
            "depth is the metrics_ring window count (CLI --watch sets a "
            "ring automatically)")


_QLEN_INF = 1 << 62


def qlen_ns_np(qlen_bytes, bw_bits) -> np.ndarray:
    """NIC queue bound in serialization-time ns (0 bytes = unbounded)."""
    q = np.asarray(qlen_bytes, np.int64)
    bw = np.asarray(bw_bits, np.int64)
    return np.where(q > 0, (q * 8 * SEC + bw - 1) // bw, _QLEN_INF)


def aqm_tables_np(exp) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RED per-host tables (min_ns, span_ns, pmax_thr), in numpy, once:
    thresholds as uplink backlog ns (the drop-tail bound's ceil, but 0
    bytes is 0 ns here), span clamped to ≥ 1 so the division is safe,
    pmax_thr 0 wherever AQM is off."""
    bw = np.asarray(exp.bw_up, np.int64)

    def to_ns(b):
        return (np.asarray(b, np.int64) * 8 * SEC + bw - 1) // bw

    on = np.asarray(exp.aqm_max_bytes) > 0
    min_ns = np.where(on, to_ns(exp.aqm_min_bytes), 0)
    span_ns = np.maximum(np.where(on, to_ns(exp.aqm_max_bytes) - min_ns, 1), 1)
    pmax_thr = np.where(on, rng.prob_threshold(exp.aqm_pmax), np.uint64(0))
    return (min_ns.astype(np.int64), span_ns.astype(np.int64),
            pmax_thr.astype(np.int64))


def fidelity_ctx_kwargs(exp, device) -> dict:
    """The Ctx fidelity tables and has_* flags of a CompiledExperiment,
    the fault plane's tables included (``fault/schedule.py``: host down/up
    intervals with the legacy stop_time merged in, link outages, loss
    ramps), put on ``device`` once."""
    from shadow1_tpu_torch.fault.schedule import (
        host_interval_tensors,
        link_tables,
        ramp_tables,
    )

    def t(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)

    aqm_min_ns, aqm_span_ns, aqm_pmax_thr = aqm_tables_np(exp)
    fault_down, fault_up = host_interval_tensors(exp)
    lf, rt = link_tables(exp), ramp_tables(exp)
    return dict(
        jitter_vv=t(exp.jitter_vv),
        fault_down=t(fault_down),
        fault_up=t(fault_up),
        link_fault=tuple(t(a) for a in lf) if lf is not None else None,
        loss_ramp=tuple(t(a) for a in rt) if rt is not None else None,
        cpu_cost=t(exp.cpu_ns_per_event),
        tx_qlen_ns=t(qlen_ns_np(exp.tx_qlen_bytes, exp.bw_up)),
        rx_qlen_ns=t(qlen_ns_np(exp.rx_qlen_bytes, exp.bw_dn)),
        aqm_min_ns=t(aqm_min_ns),
        aqm_span_ns=t(aqm_span_ns),
        aqm_pmax_thr=t(aqm_pmax_thr),
        has_jitter=bool(np.asarray(exp.jitter_vv).max() > 0),
        has_stop=bool(fault_down.min() < NO_STOP),
        has_restart=bool((fault_up < NO_STOP).any()),
        has_link_fault=lf is not None,
        has_loss_ramp=rt is not None,
        has_cpu=bool(np.asarray(exp.cpu_ns_per_event).max() > 0),
        has_tx_qlen=bool(np.asarray(exp.tx_qlen_bytes).max() > 0),
        has_rx_qlen=bool(np.asarray(exp.rx_qlen_bytes).max() > 0),
        has_aqm=bool(np.asarray(exp.aqm_max_bytes).max() > 0),
    )


def build_base_ctx(exp: CompiledExperiment, params: EngineParams,
                   device, window: int | None = None) -> Ctx:
    """The single-device Ctx for a CompiledExperiment: topology constants,
    integer loss thresholds (computed host-side once, as the reference
    does), the fidelity and fault tables and the per-experiment RNG key."""
    dev = torch.device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    from shadow1_tpu_torch.telemetry.probes import probe_index

    return Ctx(
        n_hosts=exp.n_hosts,
        n_total=exp.n_hosts,
        params=params,
        window=window if window is not None else exp.window,
        key=rng.base_key(exp.seed),
        lat_vv=t(exp.lat_vv, torch.int64),
        loss_thr_vv=t(rng.prob_threshold(np.asarray(exp.loss_vv, np.float32))
                      .astype(np.int64), torch.int64),
        host_vertex=t(exp.host_vertex, torch.int32),
        bw_up=t(exp.bw_up, torch.int64),
        bw_dn=t(exp.bw_dn, torch.int64),
        model_cfg=exp.model_cfg,
        hosts=torch.arange(exp.n_hosts, dtype=torch.int32, device=dev),
        device=dev,
        probe_index=(probe_index(params.probes, exp.n_hosts, dev)
                     if params.probes else None),
        **fidelity_ctx_kwargs(exp, dev),
    )


def push_local_event(st: SimState, ctx: Ctx, mask, time, kind,
                     p0=None, p1=None, p2=None, p3=None) -> SimState:
    """Push one local event per host where ``mask``, counting overflow."""
    from shadow1_tpu_torch.core.dense import payload
    from shadow1_tpu_torch.core.popk import push_local

    p = payload(ctx.n_hosts, p0, p1, p2, p3, device=ctx.device)
    k = torch.full((ctx.n_hosts,), kind, dtype=torch.int32, device=ctx.device)
    evbuf, over = push_local(st.evbuf, mask, time, k, p)
    m = st.metrics
    return st._replace(
        evbuf=evbuf,
        metrics=m._replace(ev_overflow=m.ev_overflow + lsum(ctx, over)),
    )


class FlatPackets(NamedTuple):
    """One window's routed packets, flattened slot-major over the [P, H]
    outbox. ``dst`` is a global host id; ``keep`` marks packets that
    survived the loss draw."""

    dst: torch.Tensor      # i32 [N] (a fleet: the destination's column)
    arrival: torch.Tensor  # i64 [N]
    tb: torch.Tensor       # i64 [N]
    kind: torch.Tensor     # i32 [N]
    p: torch.Tensor        # i32 [NP, N]
    keep: torch.Tensor     # bool [N]


@functools.lru_cache(maxsize=None)
def _kind_column(kinds: tuple, device: torch.device) -> torch.Tensor:
    """The handler kinds as an i32 [K, 1] column on ``device``, copied once."""
    return torch.tensor(kinds, dtype=torch.int32, device=device)[:, None]


def run_round(st: SimState, ctx: Ctx, handlers: dict, win_end, until=None,
              active=None) -> SimState:
    """One inner round: per-host pop-min, then the handler passes.

    Two fidelity gates apply between pop and dispatch, as in the
    reference: under churn an event of a host that is down at its time is
    discarded (``down_events``); under the virtual CPU an event runs at
    ``eff = max(time, cpu_busy)`` and charges ``cpu_busy = eff + cost``,
    or, where ``eff`` reaches the window's end, goes back into the buffer
    unexecuted at (eff, its own tie-break) through ``popk.push_back``,
    called every round (the reference's unconditional push).

    With several handler kinds, each pass runs only if some host popped its
    kind (the reference's ``lax.cond``) and counts its ``fires_*``; which
    kinds popped is known once the gates are done (a pass never changes
    the popped events), so one device read serves every kind. A single
    handler runs unconditionally, as in the reference.

    In a fleet, ``active`` is the i64 ``[E]`` mask of the lanes this round
    belongs to (their ``rounds`` count it) and ``until`` the pop bound,
    per column when some lane sits at its own ``max_rounds`` cap; a pass
    runs when some lane popped its kind and counts ``fires_*`` per lane.
    A lane that pops nothing is left as it was: every pass is masked by
    the popped events and reduces per lane."""
    evbuf, ev = pop_until(st.evbuf, win_end if until is None else until,
                          extract=ctx.params.pop_extract)
    st = st._replace(evbuf=evbuf)
    m = st.metrics
    if ctx.has_stop:
        from shadow1_tpu_torch.fault.plane import hosts_down_at

        supp = ev.mask & hosts_down_at(ctx.fault_down, ctx.fault_up, ev.time)
        m = m._replace(down_events=m.down_events + lsum(ctx, supp))
        ev = ev._replace(mask=ev.mask & ~supp,
                         kind=torch.where(supp, K_NONE, ev.kind))
    if ctx.has_cpu:
        eff = torch.maximum(ev.time, st.cpu_busy)
        defer = ev.mask & (eff >= win_end)
        run = ev.mask & ~defer
        evbuf, over = popk.push_back(st.evbuf, defer, eff, ev.tb, ev.kind,
                                     ev.p)
        st = st._replace(evbuf=evbuf, cpu_busy=torch.where(
            run, eff + ctx.cpu_cost, st.cpu_busy))
        m = m._replace(ev_overflow=m.ev_overflow + lsum(ctx, over))
        ev = ev._replace(mask=run, time=torch.where(run, eff, ev.time),
                         kind=torch.where(defer, K_NONE, ev.kind))
    pops = {
        f[0]: getattr(m, f[0]) + lsum(ctx, ev.mask & (ev.kind == k))
        for k, f in KIND_METRIC_FIELDS.items() if k in handlers
    }
    st = st._replace(metrics=m._replace(
        events=m.events + lsum(ctx, ev.mask),
        rounds=m.rounds + (1 if active is None else active),
        **pops,
    ))
    items = sorted(handlers.items())
    if len(items) == 1:
        return items[0][1](st, ev)
    kinds = _kind_column(tuple(k for k, _ in items), ev.kind.device)
    hit = (ev.kind[None, :] == kinds) & ev.mask[None, :]
    if not ctx.n_exp:
        popped = hit.any(dim=1).tolist()
        lane_hit = [int(x) for x in popped]
    else:
        lane_hit = lany(ctx, hit)                      # [K, E]
        popped = lane_hit.any(dim=1).tolist()
        lane_hit = lane_hit.to(torch.int64)
    for i, ((kind, fn), present) in enumerate(zip(items, popped)):
        if kind in KIND_METRIC_FIELDS:
            fires = KIND_METRIC_FIELDS[kind][1]
            m2 = st.metrics
            st = st._replace(metrics=m2._replace(
                **{fires: getattr(m2, fires) + lane_hit[i]}))
        if present:
            st = fn(st, ev)
    return st


def route_outbox(ctx: Ctx, ob: Outbox, links=None, win_start=None):
    """Route this window's outbox: latency gather, the fault plane's gates
    and the loss draws, in the reference's order. Edge jitter moves each
    arrival by a draw in [-J, +J]; a packet departing inside a link outage
    is dropped (``link_down_pkts``, never in ``pkts_lost``); otherwise the
    loss draw applies at the path's threshold, or an active loss ramp's —
    the same coin either way. Returns (flat_packets, n_sent, n_lost,
    n_linkdown), and with the link plane on (``links`` a LinkAccum,
    ``win_start`` the window start) the accumulator with every offered
    packet's edge contribution added, as a fifth element."""
    cap, h = ob.dst.shape
    dev = ob.dst.device
    mask = torch.arange(cap, device=dev)[:, None] < ob.cnt[None, :]
    src = ctx.hosts[None, :].expand(cap, h)

    def flat(x):
        return x.reshape(x.shape[:-2] + (cap * h,))

    fmask, fsrc, fdst = flat(mask), flat(src), flat(ob.dst)
    fdst_safe = torch.where(fmask, fdst, 0)
    # The i32 outbox planes widen once here, at window granularity.
    fdep = flat(ob.abs_depart())
    fctr = flat(ob.ctr).to(torch.int64)
    vs = ctx.host_vertex[fsrc.long()].long()
    vd = ctx.host_vertex[fdst_safe.long()].long()
    # A fleet: each packet's lane picks its key, thresholds and tables.
    flane = key = None
    if not ctx.n_exp:
        key = ctx.key
    else:
        flane = flat(ctx.lane.expand(cap, h))
        key = flat(ctx.key.expand(cap, h))
    arrival = fdep + ctx.lat_vv[vs, vd]
    if ctx.has_jitter:
        jit = ctx.jitter_vv[vs, vd]
        jbits = rng.bits(key, R_JITTER, fsrc, fctr)
        arrival = arrival + rng.randint(jbits, 2 * jit + 1).to(torch.int64) - jit
    linkdown = torch.zeros_like(fmask)
    if ctx.has_link_fault:
        from shadow1_tpu_torch.fault.plane import link_down_mask

        linkdown = fmask & link_down_mask(ctx.link_fault, vs, vd, fdep, flane)
    thr = (ctx.loss_thr_vv[vs, vd] if flane is None
           else ctx.loss_thr_vv[flane, vs, vd])
    if ctx.has_loss_ramp:
        from shadow1_tpu_torch.fault.plane import ramp_loss_thr

        thr = ramp_loss_thr(ctx.loss_ramp, vs, vd, fdep, thr, flane)
    bits = rng.bits(key, R_LOSS, fsrc, fctr)
    lost = fmask & ~linkdown & rng.uniform_lt(bits, thr)
    keep = fmask & ~lost & ~linkdown
    tb = packet_tb(fsrc.to(torch.int64), fctr)
    if flane is not None:
        # Models address lane-local ids; the scatter needs the column.
        fdst_safe = fdst_safe + (flane * (h // ctx.n_exp)).to(torch.int32)
    fp = FlatPackets(dst=fdst_safe, arrival=arrival, tb=tb, kind=flat(ob.kind),
                     p=flat(ob.p), keep=keep)
    out = (fp, lsum(ctx, fmask), lsum(ctx, lost), lsum(ctx, linkdown))
    if links is None:
        return out
    from shadow1_tpu_torch.consts import WIRE_OVERHEAD
    from shadow1_tpu_torch.telemetry.links import link_route_accum

    links = link_route_accum(
        links, vs, vd, fmask, lost, linkdown, queued=fdep - win_start,
        wire=fp.p[4].to(torch.int64) + WIRE_OVERHEAD, lane=flane)
    return out + (links,)


def deliver_flat(evbuf: EventBuf, ctx: Ctx, fp: FlatPackets):
    """Scatter the routed packets into this block's event buffers; under
    churn a packet that arrives while its destination is down is dropped
    here. Returns (evbuf, n_delivered, n_overflow, n_down). In a fleet
    ``fp.dst`` is already the destination's column (``route_outbox``) and
    ``hosts[0]`` is 0; the counts are per lane: a packet's lane is its
    source's, which is its destination's."""
    local = fp.dst - ctx.hosts[0]
    mine = fp.keep & (local >= 0) & (local < ctx.n_hosts)
    local = torch.where(mine, local, 0)
    n_down = torch.zeros((), dtype=torch.int64, device=fp.dst.device)
    if ctx.has_stop:
        from shadow1_tpu_torch.fault.plane import hosts_down_at_idx

        to_down = mine & hosts_down_at_idx(ctx.fault_down, ctx.fault_up,
                                           local, fp.arrival)
        n_down = lsum(ctx, to_down)
        mine = mine & ~to_down
    evbuf, n_over = deliver_batch(evbuf, local, fp.arrival, fp.tb, fp.kind,
                                  fp.p, mine, lanes=ctx.n_exp)
    return evbuf, lsum(ctx, mine) - n_over, n_over, n_down


def deliver_window(st: SimState, ctx: Ctx, exchange=None) -> SimState:
    """Window-end packet exchange: route, (the all_to_all under sharding),
    scatter; clears the outbox. ``exchange`` maps FlatPackets →
    (FlatPackets, n_dropped, fill_high_water) across the ranks
    (``shard/engine.py``); None on one device, where nothing more runs."""
    links = st.links
    if links is not None:
        fp, n_sent, n_lost, n_linkdown, links = route_outbox(
            ctx, st.outbox, links=links, win_start=st.win_start)
    else:
        fp, n_sent, n_lost, n_linkdown = route_outbox(ctx, st.outbox)
    # Read before the window-end clear.
    ob_fill = lmax(ctx, st.outbox.cnt)
    ob_hosts = lsum(ctx, st.outbox.cnt > 0)
    m = st.metrics
    if exchange is not None:
        with torch.profiler.record_function("phase:exchange"):
            fp, n_x2x, x2x_hw = exchange(fp)
        m = m._replace(x2x_overflow=m.x2x_overflow + n_x2x,
                       x2x_max_fill=torch.maximum(m.x2x_max_fill, x2x_hw))
    evbuf, n_deliv, n_over, n_down = deliver_flat(st.evbuf, ctx, fp)
    return st._replace(
        evbuf=evbuf,
        outbox=outbox_clear(st.outbox),
        links=links,
        metrics=m._replace(
            pkts_sent=m.pkts_sent + n_sent,
            pkts_delivered=m.pkts_delivered + n_deliv,
            pkts_lost=m.pkts_lost + n_lost,
            ev_overflow=m.ev_overflow + n_over,
            ob_max_fill=torch.maximum(m.ob_max_fill, ob_fill),
            down_pkts=m.down_pkts + n_down,
            link_down_pkts=m.link_down_pkts + n_linkdown,
            outbox_hosts=m.outbox_hosts + ob_hosts,
        ),
    )


def run_rounds(st: SimState, ctx: Ctx, handlers: dict, win_end):
    """The inner round loop to quiescence or the ``max_rounds`` cap.
    Returns (st, cap_hit); in a fleet ``cap_hit`` is an i64 ``[E]``."""
    if ctx.n_exp:
        return _run_rounds_lanes(st, ctx, handlers, win_end)
    r = 0
    while r < ctx.params.max_rounds and any_eligible(st.evbuf):
        st = run_round(st, ctx, handlers, win_end)
        r += 1
    return st, r >= ctx.params.max_rounds and any_eligible(st.evbuf)


def _run_rounds_lanes(st: SimState, ctx: Ctx, handlers: dict, win_end):
    """The fleet's round loop: a round runs while some lane is active —
    it has an eligible host and has run fewer rounds this window than its
    ``max_rounds``. One device read a round (each lane's eligible flag).
    A lane never becomes eligible again once it is not (it pops nothing,
    so nothing of it changes), so its rounds are a prefix of the loop's.
    Once a lane that is still eligible reaches its cap, the pop runs with
    a per-column bound that stops that lane's columns from popping."""
    n = ctx.n_exp
    caps = ctx.lane_max_rounds or (ctx.params.max_rounds,) * n
    done = [0] * n
    dev = st.evbuf.n_elig.device
    until = never = active = None
    while True:
        elig_t = lany(ctx, st.evbuf.n_elig > 0)
        elig = elig_t.tolist()
        act = [el and d < c for el, d, c in zip(elig, done, caps)]
        if not any(act):
            break
        if act == elig:
            until, active = None, elig_t.to(torch.int64)
        else:
            act_t = torch.tensor(act, device=dev)
            active = act_t.to(torch.int64)
            if never is None:
                never = st.evbuf.epoch + I32_PASTDUE
            until = torch.where(act_t.repeat_interleave(ctx.n_hosts // n),
                                win_end, never)
        st = run_round(st, ctx, handlers, win_end, until=until, active=active)
        done = [d + a for d, a in zip(done, act)]
    cap_hit = [int(el and d >= c) for el, d, c in zip(elig, done, caps)]
    return st, torch.tensor(cap_hit, dtype=torch.int64, device=dev)


class WindowFrame(NamedTuple):
    """The intra-window carry threaded through the ``window_phases``."""

    st: SimState
    m_entry: Metrics        # metrics at window entry (ring delta baseline)
    win_end: torch.Tensor   # i64 scalar
    cap_hit: bool = False
    dg_ob: Any = None       # i64 outbox digest word (digest runs only)
    l_entry: Any = None     # link accumulator at window entry (the sharded
                            # reduction's delta baseline)


def window_frame(st: SimState, ctx: Ctx) -> WindowFrame:
    return WindowFrame(st=st, m_entry=st.metrics,
                       win_end=st.win_start + ctx.window, l_entry=st.links)


def window_phases(ctx: Ctx, handlers: dict, make_handlers, pre_window=None,
                  exchange=None, telem_reduce=None, probe_reduce=None,
                  link_reduce=None):
    """The ordered (name, frame → frame) stage list of one window.
    ``handlers`` are ``make_handlers(ctx)``, the model's handler builder.
    ``pre_window(st, ctx, win_end)`` is the model's hook before the rounds
    (the net model's batched NIC arrivals). With ``compact_cap`` set below
    the host count, the rounds run through ``core/compact.py
    compact_window_rounds``, which builds handlers over the gathered ctx
    with ``make_handlers``.

    The sharded engine (``shard/engine.py``) passes the cross-rank hooks:
    ``exchange`` (the window's one all_to_all, ``deliver_window``),
    ``telem_reduce(counters, gauges)`` (a ring row: counter deltas and
    digest words summed, gauges maxed), ``probe_reduce(row)`` (the probe
    row summed: a rank samples zeros for a probe it does not own) and
    ``link_reduce(entry, cur)`` (the window's link deltas summed onto the
    entry baseline, the high-water column maxed). With every hook None no
    operation is added."""
    digest_on = bool(ctx.params.state_digest)

    def ph_prepare(fr: WindowFrame) -> WindowFrame:
        st, win_end = fr.st, fr.win_end
        if ctx.has_restart:
            # Hosts whose window-quantized up time is this window's start
            # get their model columns restored to the post-init capture
            # and their virtual-CPU clock zeroed, before the rounds. The
            # event buffer is left alone: stale events of the down
            # interval are discarded at pop.
            from shadow1_tpu_torch.fault.plane import (
                reset_host_columns,
                restart_mask,
            )

            rs = restart_mask(ctx.fault_up, st.win_start)
            mr = st.metrics
            st = st._replace(
                model=reset_host_columns(st.model, ctx.init_model, rs,
                                         ctx.n_hosts),
                cpu_busy=torch.where(rs, 0, st.cpu_busy),
                metrics=mr._replace(host_restarts=mr.host_restarts
                                    + lsum(ctx, rs)))
        n_act = n_el = None
        if pre_window is not None:
            # Work gauges BEFORE the hook rewrites event times: the raw
            # window-start pending set (events with time < win_end).
            live = (st.evbuf.kind != K_NONE) & (st.evbuf.abs_time() < win_end)
            n_act = lsum(ctx, live.any(dim=0))
            n_el = lsum(ctx, live)
            st = pre_window(st, ctx, win_end)
        # Advance the i32 pop-key epoch to this window's start and pin the
        # n_elig counters to win_end.
        st = st._replace(evbuf=rebase(st.evbuf, st.win_start, win_end))
        n_active = lsum(ctx, st.evbuf.n_elig > 0)
        if n_act is None:
            # No hook: the just-rebased counters are the window-start
            # pending set.
            n_act = n_active
            n_el = lsum(ctx, st.evbuf.n_elig)
        m0 = st.metrics
        st = st._replace(metrics=m0._replace(
            compact_max_fill=torch.maximum(m0.compact_max_fill, n_active),
            active_hosts=m0.active_hosts + n_act,
            elig_events=m0.elig_events + n_el,
        ))
        return fr._replace(st=st)

    def ph_rounds(fr: WindowFrame) -> WindowFrame:
        ccap = ctx.params.compact_cap
        if ccap and ccap < ctx.n_hosts:
            from shadow1_tpu_torch.core.compact import compact_window_rounds

            st, cap_hit = compact_window_rounds(
                fr.st, ctx, handlers, make_handlers, run_rounds, fr.win_end,
                ccap)
        else:
            st, cap_hit = run_rounds(fr.st, ctx, handlers, fr.win_end)
        return fr._replace(st=st, cap_hit=cap_hit)

    def ph_deliver(fr: WindowFrame) -> WindowFrame:
        st, dg_ob = fr.st, fr.dg_ob
        if digest_on and st.telem is not None:
            # The outbox still holds this window's sends; the delivery
            # below routes and clears it.
            from shadow1_tpu_torch.core.digest import digest_outbox

            dg_ob = digest_outbox(st.outbox, ctx.hosts, ctx.n_exp)
        return fr._replace(st=deliver_window(st, ctx, exchange), dg_ob=dg_ob)

    def ph_telem(fr: WindowFrame) -> WindowFrame:
        st = fr.st
        ev_fill = lmax(ctx, (st.evbuf.kind != K_NONE).sum(dim=0,
                                                            dtype=torch.int32))
        m = st.metrics
        cap_hit = (int(fr.cap_hit) if isinstance(fr.cap_hit, bool)
                   else fr.cap_hit)
        st = st._replace(
            win_start=fr.win_end,
            metrics=m._replace(
                windows=m.windows + 1,
                round_cap_hits=m.round_cap_hits + cap_hit,
                ev_max_fill=torch.maximum(m.ev_max_fill, ev_fill),
            ),
        )
        if st.telem is not None:
            from shadow1_tpu_torch.telemetry.ring import ring_record

            digests = None
            if digest_on:
                # The post-delivery window-boundary state (the outbox word
                # was taken before the delivery).
                from shadow1_tpu_torch.core.digest import state_digests

                digests = state_digests(st, ctx, fr.dg_ob)
            st = st._replace(telem=ring_record(st.telem, fr.m_entry,
                                               st.metrics, ev_fill, digests,
                                               telem_reduce=telem_reduce))
        if st.probes is not None:
            # The same post-delivery boundary state the digests hash;
            # ``fr.win_end`` anchors the NIC backlog columns and the
            # window-entry metrics pick the ring slot.
            from shadow1_tpu_torch.telemetry.probes import (
                probe_record,
                probe_sample,
            )

            row = probe_sample(st, ctx, fr.win_end)
            if probe_reduce is not None:
                row = probe_reduce(row)
            st = st._replace(probes=probe_record(st.probes, fr.m_entry, row))
        if st.links is not None and link_reduce is not None:
            st = st._replace(links=link_reduce(fr.l_entry, st.links))
        return fr._replace(st=st)

    return [("prepare", ph_prepare), ("rounds", ph_rounds),
            ("deliver", ph_deliver), ("telem", ph_telem)]


def window_step(st: SimState, ctx: Ctx, handlers: dict, make_handlers,
                pre_window=None, exchange=None, telem_reduce=None,
                probe_reduce=None, link_reduce=None) -> SimState:
    """One conservative window: the four phases in order, each in its
    ``record_function`` scope (the hooks: ``window_phases``)."""
    from shadow1_tpu_torch.telemetry.profiler import WINDOW_PHASES

    fr = window_frame(st, ctx)
    for name, fn in window_phases(ctx, handlers, make_handlers, pre_window,
                                  exchange, telem_reduce, probe_reduce,
                                  link_reduce):
        with torch.profiler.record_function(WINDOW_PHASES[name]):
            fr = fn(fr)
    return fr.st


def _model_module(name: str):
    if name == "phold":
        from shadow1_tpu_torch.core import phold

        return phold
    if name == "net":
        from shadow1_tpu_torch import net

        return net
    raise ValueError(f"unknown model {name!r}")


class Engine:
    """Batched engine for one CompiledExperiment, on one device.

    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU. ``EngineParams.pop_impl``
    and ``push_impl`` are parsed and ignored: the device picks the path
    (CUDA runs the hand-written kernels, the CPU their plain versions), and
    the Hopper kernels take any (C, H) that fits the card's memory, so the
    reference's VMEM-driven downgrade has no counterpart here.
    """

    def __init__(self, exp: CompiledExperiment,
                 params: EngineParams | None = None, device=None):
        exp.validate()
        self.exp = exp
        self.params = params or EngineParams()
        check_digest_params(self.params)
        check_probe_params(self.params)
        from shadow1_tpu_torch.telemetry.links import check_link_params

        check_link_params(self.params, np.asarray(exp.lat_vv).shape[0])
        check_supported(exp, self.params)
        self.device = resolve_device(device)
        self.window = exp.window
        self.n_windows = int(math.ceil(exp.end_time / self.window))
        self.ctx = build_base_ctx(exp, self.params, self.device,
                                  window=self.window)
        self._model = _model_module(exp.model)
        if self.ctx.has_restart:
            # The restart target: the model state exactly as init builds
            # it, a second copy on the device, kept only when some host
            # restarts.
            model0, _, _ = self._model.init(
                self.ctx, evbuf_init(exp.n_hosts, self.params.ev_cap,
                                     self.device))
            self.ctx = dataclasses.replace(self.ctx, init_model=model0)
        self._handlers = self._model.make_handlers(self.ctx)
        self._pre_window = getattr(self._model, "make_pre_window",
                                   lambda c: None)(self.ctx)

    def at_caps(self, params: EngineParams) -> "Engine":
        """This experiment's engine at ``params``, which may differ from
        this engine's in ``ev_cap`` and ``outbox_cap`` only. It shares the
        device tables (the ctx's and the restart capture, neither of which
        depends on a cap) instead of building them again: the recovery
        planes (``txn.OverflowGuard``, ``tune.CapController``) build their
        engines at grown and shrunk caps so, and hold one copy of them."""
        same = dataclasses.replace(params, ev_cap=self.params.ev_cap,
                                   outbox_cap=self.params.outbox_cap)
        if same != self.params:
            raise ValueError("Engine.at_caps: params may differ in ev_cap "
                             "and outbox_cap only")
        eng = copy.copy(self)
        eng.params = params
        eng.ctx = dataclasses.replace(self.ctx, params=params)
        eng._handlers = self._model.make_handlers(eng.ctx)
        eng._pre_window = getattr(self._model, "make_pre_window",
                                  lambda c: None)(eng.ctx)
        return eng

    def init_state(self) -> SimState:
        from shadow1_tpu_torch.telemetry.links import link_init
        from shadow1_tpu_torch.telemetry.probes import probe_init
        from shadow1_tpu_torch.telemetry.ring import ring_init

        dev, h, n_exp = self.device, self.ctx.n_hosts, self.ctx.n_exp
        evbuf = evbuf_init(h, self.params.ev_cap, dev)
        model, evbuf, seed_over = self._model.init(self.ctx, evbuf)
        metrics = _metrics_init(dev, n_exp)
        return SimState(
            win_start=torch.zeros((), dtype=torch.int64, device=dev),
            evbuf=evbuf,
            outbox=outbox_init(h, self.params.outbox_cap, dev),
            model=model,
            metrics=metrics._replace(ev_overflow=metrics.ev_overflow + seed_over),
            cpu_busy=torch.zeros(h, dtype=torch.int64, device=dev),
            telem=ring_init(self.params.metrics_ring, dev, n_exp),
            probes=probe_init(self.params.metrics_ring, self.params.probes,
                              dev, n_exp),
            links=link_init(self.params.link_telem,
                            np.asarray(self.exp.lat_vv).shape[0], dev, n_exp),
        )

    def run(self, st: SimState | None = None, n_windows: int | None = None,
            check_x2x: bool = True) -> SimState:
        """Run ``n_windows`` windows (default: to the experiment's end) from
        ``st`` (default: a fresh ``init_state``). On CUDA the kernels
        update the given state's event-buffer and outbox planes in place.
        ``check_x2x`` is the sharded engine's and means nothing here."""
        if st is None:
            st = self.init_state()
        n = n_windows if n_windows is not None else self.n_windows
        for _ in range(int(n)):
            st = window_step(st, self.ctx, self._handlers,
                             self._model.make_handlers, self._pre_window)
        return st

    def synchronize(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def metrics_dict(st: SimState) -> dict[str, int]:
        return {k: int(v) for k, v in st.metrics._asdict().items()}

    def model_summary(self, st: SimState) -> dict[str, Any]:
        return {k: v.cpu().numpy()
                for k, v in self._model.summary(st.model, self.ctx).items()}

    # The sharded engine's API (``shard/engine.py``) for a world of one
    # device: the recovery planes, observability and the CLI call it alike
    # for every engine.
    rank = 0

    def init_global_state(self) -> SimState:
        return self.init_state()

    def place_state(self, st: SimState) -> SimState:
        return st

    def gather_state(self, st: SimState) -> SimState:
        return st

    def global_summary(self, st: SimState) -> dict[str, Any]:
        return self.model_summary(st)

    def agree(self, flag: bool) -> bool:
        return bool(flag)

    def on_root(self, write):
        return write()

    def grow_x2x(self) -> bool:
        """No exchange bucket to grow: an overflow is never bucket-sized."""
        return False
