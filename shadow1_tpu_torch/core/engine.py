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
handler kinds popped, plus the model's own (``tcp/tcp.py``,
``apps/filexfer.py``).

Module and function names follow the reference so each counterpart is found
under the same name. Parts of the reference this slice does not run raise
``NotImplementedError`` when a config asks for them (``check_supported``).
"""

from __future__ import annotations

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
    R_LOSS,
    EngineParams,
    packet_tb,
)
from shadow1_tpu_torch.core.events import (
    EventBuf,
    any_eligible,
    deliver_batch,
    evbuf_fill,
    evbuf_init,
    rebase,
)
from shadow1_tpu_torch.core.outbox import (
    Outbox,
    outbox_clear,
    outbox_fill,
    outbox_init,
)
from shadow1_tpu_torch.core.popk import pop_until


class Metrics(NamedTuple):
    """Run counters, every one an i64 scalar tensor; the same fields in the
    same order as the reference's ``Metrics`` (see there for each one's
    meaning). Fields of parts this slice does not run stay 0."""

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


def _metrics_init(device) -> Metrics:
    return Metrics(*(torch.zeros((), dtype=torch.int64, device=device)
                     for _ in Metrics._fields))


class SimState(NamedTuple):
    win_start: torch.Tensor  # i64 scalar
    evbuf: EventBuf
    outbox: Outbox
    model: Any               # workload-model state (PholdState, NetState)
    metrics: Metrics
    cpu_busy: torch.Tensor   # i64 [H] virtual CPU free-at (0: no cpu model)
    # The telemetry ring (telemetry/ring.TelemetryRing), None when
    # metrics_ring is 0. The reference's probe ring and link accumulator:
    # refused, always None.
    telem: Any = None
    probes: Any = None
    links: Any = None


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Run constants handed to the model's handler builders. ``n_hosts`` is
    the host-axis size, ``hosts`` the global host ids (``arange`` on one
    device) and ``n_total`` the global host count."""

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
    # The reference's fidelity flags. ``check_supported`` refuses every
    # configuration that sets one, so they are all False here; the net
    # model reads them where the reference does.
    has_jitter: bool = False
    has_stop: bool = False
    has_restart: bool = False
    has_link_fault: bool = False
    has_loss_ramp: bool = False
    has_cpu: bool = False
    has_tx_qlen: bool = False
    has_rx_qlen: bool = False
    has_aqm: bool = False


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
    """Refuse, loudly, what this slice of the port does not run: each
    refusal names the ROADMAP item that will add it."""
    def no(what: str, item: str):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP: {item})")

    gates = "fault plane and fidelity gates"
    if exp.model == "net" and exp.model_cfg.get("app") != "filexfer":
        no(f"app {exp.model_cfg.get('app')!r}", "the other apps")
    if exp.model not in ("phold", "net"):
        raise ValueError(f"unknown model {exp.model!r}")
    queues = "NIC queue bounds and RED AQM"
    if np.asarray(exp.aqm_max_bytes).max() > 0:
        no("aqm_max_bytes (RED AQM, has_aqm)", queues)
    if np.asarray(exp.tx_qlen_bytes).max() > 0:
        no("tx_queue_bytes (has_tx_qlen)", queues)
    if np.asarray(exp.rx_qlen_bytes).max() > 0:
        no("rx_queue_bytes (has_rx_qlen)", queues)
    if exp.faults is not None:
        no("faults:", gates)
    if (np.asarray(exp.stop_time) < NO_STOP).any():
        no("host stop_time (has_stop)", gates)
    if np.asarray(exp.cpu_ns_per_event).max() > 0:
        no("cpu_per_event (has_cpu)", gates)
    if np.asarray(exp.jitter_vv).max() > 0:
        no("network.jitter (has_jitter)", gates)
    if params.compact_cap:
        no("compact_cap", "compaction")
    if params.probes or params.link_telem:
        no("probes / link_telem", "checkpoint and observability")
    if params.auto_caps or params.on_overflow != "drop":
        no("auto_caps / on_overflow other than 'drop'", "recovery planes")


def check_digest_params(params: EngineParams) -> None:
    """state_digest needs a telemetry ring: the per-window digest words are
    ring columns."""
    if params.state_digest and params.metrics_ring <= 0:
        raise ValueError(
            "state_digest=1 requires metrics_ring > 0 — the per-window "
            "digest words are ring columns (CLI --state-digest sets a ring "
            "automatically)")


def build_base_ctx(exp: CompiledExperiment, params: EngineParams,
                   device, window: int | None = None) -> Ctx:
    """The single-device Ctx for a CompiledExperiment: topology constants,
    integer loss thresholds (computed host-side once, as the reference
    does) and the per-experiment RNG key."""
    dev = torch.device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

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
        metrics=m._replace(ev_overflow=m.ev_overflow + over.sum(dtype=torch.int64)),
    )


class FlatPackets(NamedTuple):
    """One window's routed packets, flattened slot-major over the [P, H]
    outbox. ``dst`` is a global host id; ``keep`` marks packets that
    survived the loss draw."""

    dst: torch.Tensor      # i32 [N]
    arrival: torch.Tensor  # i64 [N]
    tb: torch.Tensor       # i64 [N]
    kind: torch.Tensor     # i32 [N]
    p: torch.Tensor        # i32 [NP, N]
    keep: torch.Tensor     # bool [N]


@functools.lru_cache(maxsize=None)
def _kind_column(kinds: tuple, device: torch.device) -> torch.Tensor:
    """The handler kinds as an i32 [K, 1] column on ``device``, copied once."""
    return torch.tensor(kinds, dtype=torch.int32, device=device)[:, None]


def run_round(st: SimState, ctx: Ctx, handlers: dict, win_end) -> SimState:
    """One inner round: per-host pop-min, then the handler passes.

    With several handler kinds, each pass runs only if some host popped its
    kind (the reference's ``lax.cond``) and counts its ``fires_*``; which
    kinds popped is known once the pop is done (a pass never changes the
    popped events), so one device read serves every kind. A single handler
    runs unconditionally, as in the reference."""
    evbuf, ev = pop_until(st.evbuf, win_end, extract=ctx.params.pop_extract)
    st = st._replace(evbuf=evbuf)
    m = st.metrics
    pops = {
        f[0]: getattr(m, f[0]) + (ev.mask & (ev.kind == k)).sum(dtype=torch.int64)
        for k, f in KIND_METRIC_FIELDS.items() if k in handlers
    }
    st = st._replace(metrics=m._replace(
        events=m.events + ev.mask.sum(dtype=torch.int64),
        rounds=m.rounds + 1,
        **pops,
    ))
    items = sorted(handlers.items())
    if len(items) == 1:
        return items[0][1](st, ev)
    kinds = _kind_column(tuple(k for k, _ in items), ev.kind.device)
    popped = ((ev.kind[None, :] == kinds) & ev.mask[None, :]).any(dim=1).tolist()
    for (kind, fn), present in zip(items, popped):
        if kind in KIND_METRIC_FIELDS:
            fires = KIND_METRIC_FIELDS[kind][1]
            m2 = st.metrics
            st = st._replace(metrics=m2._replace(
                **{fires: getattr(m2, fires) + int(present)}))
        if present:
            st = fn(st, ev)
    return st


def route_outbox(ctx: Ctx, ob: Outbox):
    """Route this window's outbox: latency gather and loss draws. Returns
    (flat_packets, n_sent, n_lost)."""
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
    arrival = fdep + ctx.lat_vv[vs, vd]
    thr = ctx.loss_thr_vv[vs, vd]
    bits = rng.bits(ctx.key, R_LOSS, fsrc, fctr)
    lost = fmask & rng.uniform_lt(bits, thr)
    keep = fmask & ~lost
    tb = packet_tb(fsrc.to(torch.int64), fctr)
    fp = FlatPackets(dst=fdst_safe, arrival=arrival, tb=tb, kind=flat(ob.kind),
                     p=flat(ob.p), keep=keep)
    return fp, fmask.sum(dtype=torch.int64), lost.sum(dtype=torch.int64)


def deliver_flat(evbuf: EventBuf, ctx: Ctx, fp: FlatPackets):
    """Scatter the routed packets into this block's event buffers. Returns
    (evbuf, n_delivered, n_overflow)."""
    local = fp.dst - ctx.hosts[0]
    mine = fp.keep & (local >= 0) & (local < ctx.n_hosts)
    local = torch.where(mine, local, 0)
    evbuf, n_over = deliver_batch(evbuf, local, fp.arrival, fp.tb, fp.kind,
                                  fp.p, mine)
    return evbuf, mine.sum(dtype=torch.int64) - n_over, n_over


def deliver_window(st: SimState, ctx: Ctx) -> SimState:
    """Window-end packet exchange: route, then scatter; clears the outbox."""
    fp, n_sent, n_lost = route_outbox(ctx, st.outbox)
    # Read before the window-end clear.
    ob_fill = outbox_fill(st.outbox)
    ob_hosts = (st.outbox.cnt > 0).sum(dtype=torch.int64)
    evbuf, n_deliv, n_over = deliver_flat(st.evbuf, ctx, fp)
    m = st.metrics
    return st._replace(
        evbuf=evbuf,
        outbox=outbox_clear(st.outbox),
        metrics=m._replace(
            pkts_sent=m.pkts_sent + n_sent,
            pkts_delivered=m.pkts_delivered + n_deliv,
            pkts_lost=m.pkts_lost + n_lost,
            ev_overflow=m.ev_overflow + n_over,
            ob_max_fill=torch.maximum(m.ob_max_fill, ob_fill),
            outbox_hosts=m.outbox_hosts + ob_hosts,
        ),
    )


def run_rounds(st: SimState, ctx: Ctx, handlers: dict, win_end):
    """The inner round loop to quiescence or the ``max_rounds`` cap.
    Returns (st, cap_hit)."""
    r = 0
    while r < ctx.params.max_rounds and any_eligible(st.evbuf):
        st = run_round(st, ctx, handlers, win_end)
        r += 1
    return st, r >= ctx.params.max_rounds and any_eligible(st.evbuf)


class WindowFrame(NamedTuple):
    """The intra-window carry threaded through the ``window_phases``."""

    st: SimState
    m_entry: Metrics        # metrics at window entry (ring delta baseline)
    win_end: torch.Tensor   # i64 scalar
    cap_hit: bool = False
    dg_ob: Any = None       # i64 outbox digest word (digest runs only)


def window_frame(st: SimState, ctx: Ctx) -> WindowFrame:
    return WindowFrame(st=st, m_entry=st.metrics,
                       win_end=st.win_start + ctx.window)


def window_phases(ctx: Ctx, handlers: dict, pre_window=None):
    """The ordered (name, frame → frame) stage list of one window.
    ``pre_window(st, ctx, win_end)`` is the model's hook before the rounds
    (the net model's batched NIC arrivals)."""
    digest_on = bool(ctx.params.state_digest)

    def ph_prepare(fr: WindowFrame) -> WindowFrame:
        st, win_end = fr.st, fr.win_end
        n_act = n_el = None
        if pre_window is not None:
            # Work gauges BEFORE the hook rewrites event times: the raw
            # window-start pending set (events with time < win_end).
            live = (st.evbuf.kind != K_NONE) & (st.evbuf.abs_time() < win_end)
            n_act = live.any(dim=0).sum(dtype=torch.int64)
            n_el = live.sum(dtype=torch.int64)
            st = pre_window(st, ctx, win_end)
        # Advance the i32 pop-key epoch to this window's start and pin the
        # n_elig counters to win_end.
        st = st._replace(evbuf=rebase(st.evbuf, st.win_start, win_end))
        n_active = (st.evbuf.n_elig > 0).sum(dtype=torch.int64)
        if n_act is None:
            # No hook: the just-rebased counters are the window-start
            # pending set.
            n_act = n_active
            n_el = st.evbuf.n_elig.sum(dtype=torch.int64)
        m0 = st.metrics
        st = st._replace(metrics=m0._replace(
            compact_max_fill=torch.maximum(m0.compact_max_fill, n_active),
            active_hosts=m0.active_hosts + n_act,
            elig_events=m0.elig_events + n_el,
        ))
        return fr._replace(st=st)

    def ph_rounds(fr: WindowFrame) -> WindowFrame:
        st, cap_hit = run_rounds(fr.st, ctx, handlers, fr.win_end)
        return fr._replace(st=st, cap_hit=cap_hit)

    def ph_deliver(fr: WindowFrame) -> WindowFrame:
        st, dg_ob = fr.st, fr.dg_ob
        if digest_on and st.telem is not None:
            # The outbox still holds this window's sends; the delivery
            # below routes and clears it.
            from shadow1_tpu_torch.core.digest import digest_outbox

            dg_ob = digest_outbox(st.outbox, ctx.hosts)
        return fr._replace(st=deliver_window(st, ctx), dg_ob=dg_ob)

    def ph_telem(fr: WindowFrame) -> WindowFrame:
        st = fr.st
        ev_fill = evbuf_fill(st.evbuf)
        m = st.metrics
        st = st._replace(
            win_start=fr.win_end,
            metrics=m._replace(
                windows=m.windows + 1,
                round_cap_hits=m.round_cap_hits + int(fr.cap_hit),
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
                                               st.metrics, ev_fill, digests))
        return fr._replace(st=st)

    return [("prepare", ph_prepare), ("rounds", ph_rounds),
            ("deliver", ph_deliver), ("telem", ph_telem)]


def window_step(st: SimState, ctx: Ctx, handlers: dict,
                pre_window=None) -> SimState:
    """One conservative window: the four phases in order."""
    fr = window_frame(st, ctx)
    for _name, fn in window_phases(ctx, handlers, pre_window):
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
        check_supported(exp, self.params)
        self.device = resolve_device(device)
        self.window = exp.window
        self.n_windows = int(math.ceil(exp.end_time / self.window))
        self.ctx = build_base_ctx(exp, self.params, self.device,
                                  window=self.window)
        self._model = _model_module(exp.model)
        self._handlers = self._model.make_handlers(self.ctx)
        self._pre_window = getattr(self._model, "make_pre_window",
                                   lambda c: None)(self.ctx)

    def init_state(self) -> SimState:
        from shadow1_tpu_torch.telemetry.ring import ring_init

        dev, h = self.device, self.exp.n_hosts
        evbuf = evbuf_init(h, self.params.ev_cap, dev)
        model, evbuf, seed_over = self._model.init(self.ctx, evbuf)
        metrics = _metrics_init(dev)
        return SimState(
            win_start=torch.zeros((), dtype=torch.int64, device=dev),
            evbuf=evbuf,
            outbox=outbox_init(h, self.params.outbox_cap, dev),
            model=model,
            metrics=metrics._replace(ev_overflow=metrics.ev_overflow + seed_over),
            cpu_busy=torch.zeros(h, dtype=torch.int64, device=dev),
            telem=ring_init(self.params.metrics_ring, dev),
        )

    def run(self, st: SimState | None = None,
            n_windows: int | None = None) -> SimState:
        """Run ``n_windows`` windows (default: to the experiment's end) from
        ``st`` (default: a fresh ``init_state``). On CUDA the kernels
        update the given state's event-buffer and outbox planes in place."""
        if st is None:
            st = self.init_state()
        n = n_windows if n_windows is not None else self.n_windows
        for _ in range(int(n)):
            st = window_step(st, self.ctx, self._handlers, self._pre_window)
        return st

    @staticmethod
    def metrics_dict(st: SimState) -> dict[str, int]:
        return {k: int(v) for k, v in st.metrics._asdict().items()}

    def model_summary(self, st: SimState) -> dict[str, Any]:
        return {k: v.cpu().numpy()
                for k, v in self._model.summary(st.model, self.ctx).items()}
