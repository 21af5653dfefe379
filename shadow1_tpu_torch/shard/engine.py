"""The sharded engine: the host axis split over the ranks of a
``torch.distributed`` world (port of ``shard/engine.py``).

Rank r of D holds the hosts ``r·H/D .. (r+1)·H/D − 1``: the columns of
every host-minor state leaf (the ``[.., H]`` layout rule), and a block
ctx whose per-host tables are those columns, whose ``hosts`` are their
global ids and whose ``n_total`` is H. Inside a window each rank runs its
block's rounds on its own — the conservative lookahead guarantees that no
host hears from another before the window ends — with the same kernels
and the same code as the solo engine (``core/engine.window_step``). At
the window's end each rank buckets its routed packets by destination
rank, and ONE ``all_to_all_single`` delivers every bucket to its owner,
which scatters the packets addressed to its hosts. That is the whole
communication schedule of the packets.

Determinism across world sizes: the bucket sort is stable in flat source
order and the received buckets are concatenated in source-rank order, so
every destination sees its packets in the single-device flatten order,
and every event and tie-break key is computed from global host ids. A
sharded run therefore equals the solo run in every field but ``rounds``
and ``round_cap_hits``, which each rank counts for its own round loop and
which are summed.

The hooks of ``window_step`` make the telemetry global at each window's
end: a ring row's counter deltas and digest words (per-rank partial sums
of globally keyed hashes) are summed over the ranks and its gauges maxed;
a probe row is summed (a rank samples zeros for a probe it does not own);
the link accumulator's per-window deltas are summed onto the entry
baseline and its high-water column maxed. The metrics are reduced once,
at the end of ``run``: the sum over ranks minus (D−1)× the entry
baseline, ``windows`` and ``x2x_max_fill`` as they are (the same on every
rank), the fill gauges maxed. Every rank calls the same collectives in
the same order in every window; the per-rank branches (the compaction
branch, the round loop, a handler kind that popped nowhere) hold none.

The exchange bucket (``x2x_cap``): auto-sized to twice the uniform
expectation, ``max(16, ceil(2·h_local·outbox_cap / D))``, and clamped to
``h_local·outbox_cap``, which always fits (one bucket cannot need more
than the rank's whole outbox). A bucket's drops are counted in
``x2x_overflow`` and its demanded fill in ``x2x_max_fill``. ``run`` is the
reference's safety net: an auto cap that overflowed reruns the same input
at the full cap (``RuntimeWarning``), an explicit cap that overflowed
raises; ``check_x2x=False`` hands the policy to ``txn.OverflowGuard``,
which grows the bucket through :meth:`ShardedEngine.grow_x2x`.

Collectives: under ``nccl`` they run on the ranks' own cards; under
``gloo`` on CPU ranks, or on ranks that share one card, where the send
buffer and the reduced vectors are copied through host memory around
each collective. ``shard/launch.py`` starts the ranks.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import warnings

import numpy as np
import torch

from shadow1_tpu_torch.config.compiled import CompiledExperiment
from shadow1_tpu_torch.consts import EngineParams
from shadow1_tpu_torch.core.compact import _CTX_HOST_FIELDS, _tree_map
from shadow1_tpu_torch.core.engine import (
    Engine,
    FlatPackets,
    Metrics,
    SimState,
    _model_module,
    build_base_ctx,
    check_digest_params,
    check_probe_params,
    check_supported,
    resolve_device,
    window_step,
)
from shadow1_tpu_torch.core.events import evbuf_init, tb_join, tb_split

# The state fields whose leaves carry the host axis last; the telemetry
# planes (ring, probe ring, link accumulator), the metrics and the window
# start are the same on every rank.
HOST_FIELDS = ("evbuf", "outbox", "model", "cpu_busy")
# Metrics kept as they are at the end-of-run reduction (the same on every
# rank), and those maxed over the ranks.
_KEEP = ("windows", "x2x_max_fill")
_MAXED = ("ev_max_fill", "ob_max_fill", "compact_max_fill")

# Exchanges run, counted like ``popk.LAUNCHES``; set to 0 to start a count.
EXCHANGES = {"all_to_all": 0}


def local_compact_cap(compact_cap: int, n_dev: int, h_local: int) -> int:
    """The per-rank bucket of ``compact_cap`` (sized against the global
    active set): ``ceil(compact_cap / D)`` rounded up to a tile of 128
    (8 below 128), clamped to the rank's columns. A rank whose active
    hosts overflow it runs full width that window, as on one device."""
    if not compact_cap:
        return 0
    cap = -(-compact_cap // n_dev)
    tile = 128 if cap >= 128 else 8
    return min(-(-cap // tile) * tile, h_local)


def _slice_hosts(tree, lo: int, h_local: int, n_hosts: int):
    """Every leaf whose last axis is the host axis (``n_hosts`` long),
    narrowed to the block [lo, lo + h_local); other leaves as they are."""
    def s(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                and x.shape[-1] == n_hosts:
            return x.narrow(-1, lo, h_local).contiguous()
        return x
    return _tree_map(s, tree)


class ShardedEngine:
    """One CompiledExperiment over the ranks of the default process group
    (or ``group``): each rank builds its own ``ShardedEngine`` and calls
    the same methods. The API mirrors the solo ``Engine``: ``init_state``
    → ``run`` → ``metrics_dict`` / ``model_summary``; ``place_state`` /
    ``gather_state`` move between the global state and a rank's columns.
    ``n_hosts`` must divide by the world size.

    ``device`` defaults to CUDA: under NCCL the rank's card
    (``cuda:LOCAL_RANK``), under gloo ``cuda:0`` (ranks that share a
    card); pass ``device="cpu"`` for gloo CPU ranks. ``model_summary`` and
    ``gather_state`` are collectives: every rank calls them."""

    def __init__(self, exp: CompiledExperiment,
                 params: EngineParams | None = None, device=None,
                 group=None):
        import torch.distributed as dist

        exp.validate()
        self.exp = exp
        self.params = params or EngineParams()
        check_digest_params(self.params)
        check_probe_params(self.params)
        from shadow1_tpu_torch.telemetry.links import check_link_params

        check_link_params(self.params, np.asarray(exp.lat_vv).shape[0])
        check_supported(exp, self.params)
        if not dist.is_initialized():
            raise RuntimeError(
                "ShardedEngine needs a torch.distributed process group: "
                "run under torchrun, or start the ranks with "
                "shadow1_tpu_torch.shard.launch")
        self.group = group
        self._waiters = None  # on_root's barrier group, made at first use
        self.local_metrics: Metrics | None = None  # the last run's, unreduced
        self.rank = dist.get_rank(group)
        self.n_dev = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        from shadow1_tpu_torch.shard.launch import check_backend, rank_device

        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            local = int(os.environ.get("LOCAL_RANK", self.rank))
            device = rank_device(self.backend, "cuda", local)
        self.device = device
        check_backend(self.backend, self.device, self.n_dev)
        if self.backend == "nccl" and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        # gloo on a card: the collectives' buffers go through host memory.
        self._via_host = (self.backend == "gloo"
                          and self.device.type == "cuda")
        if exp.n_hosts % self.n_dev:
            raise ValueError(f"n_hosts={exp.n_hosts} not divisible by "
                             f"{self.n_dev} ranks")
        self.h_local = exp.n_hosts // self.n_dev
        self.lo = self.rank * self.h_local
        self.window = exp.window
        self.n_windows = int(math.ceil(exp.end_time / self.window))
        self._model = _model_module(exp.model)
        # The global ctx: init and the model summaries run over it.
        self.global_ctx = build_base_ctx(exp, self.params, self.device,
                                         window=self.window)
        self._init_model = None
        if self.global_ctx.has_restart:
            # The fault plane's restart capture, this rank's columns of it.
            model0, _, _ = self._model.init(
                self.global_ctx, evbuf_init(exp.n_hosts, self.params.ev_cap,
                                            self.device))
            self._init_model = _slice_hosts(model0, self.lo, self.h_local,
                                            exp.n_hosts)
        self._bind()

    def _bind(self) -> None:
        """The block ctx, its handlers and the exchange caps, from
        ``self.params``."""
        from shadow1_tpu_torch.telemetry.probes import probe_index

        pr = self.params
        lo, h = self.lo, self.h_local
        local = dataclasses.replace(pr, compact_cap=local_compact_cap(
            pr.compact_cap, self.n_dev, h))
        gctx = self.global_ctx = dataclasses.replace(self.global_ctx,
                                                     params=pr)
        repl = {"n_hosts": h, "params": local,
                "init_model": self._init_model,
                "probe_index": (probe_index(pr.probes, h, self.device,
                                            base=lo)
                                if pr.probes else None)}
        for f in _CTX_HOST_FIELDS:
            v = getattr(gctx, f, None)
            if v is not None:
                repl[f] = v.narrow(-1, lo, h).contiguous()
        self.ctx = dataclasses.replace(gctx, **repl)
        self._handlers = self._model.make_handlers(self.ctx)
        self._pre_window = getattr(self._model, "make_pre_window",
                                   lambda c: None)(self.ctx)
        self._full_cap = h * pr.outbox_cap
        auto = max(16, -(-2 * self._full_cap // self.n_dev))
        self._x2x_cap = min(pr.x2x_cap or auto, self._full_cap)

    def at_caps(self, params: EngineParams) -> "ShardedEngine":
        """This experiment's engine at ``params`` (other ``ev_cap`` /
        ``outbox_cap`` only), sharing the global tables and the restart
        capture; the recovery planes build their engines so. A bucket
        grown to its full cap stays at the new full cap."""
        same = dataclasses.replace(params, ev_cap=self.params.ev_cap,
                                   outbox_cap=self.params.outbox_cap)
        if same != self.params:
            raise ValueError("ShardedEngine.at_caps: params may differ in "
                             "ev_cap and outbox_cap only")
        grown = self._x2x_cap >= self._full_cap
        eng = copy.copy(self)
        eng.params = params
        eng._bind()
        if grown:
            eng._x2x_cap = eng._full_cap
        return eng

    # -- collectives -------------------------------------------------------
    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self._via_host else t.clone()

    def _from_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._via_host else t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (a new tensor)."""
        import torch.distributed as dist

        x = self._to_wire(t)
        dist.all_reduce(x, dist.ReduceOp.SUM, group=self.group)
        return self._from_wire(x)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` maxed over the ranks (a new tensor)."""
        import torch.distributed as dist

        x = self._to_wire(t)
        dist.all_reduce(x, dist.ReduceOp.MAX, group=self.group)
        return self._from_wire(x)

    def agree(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on some rank (a
        host-side decision, such as a time-throttled snapshot, that every
        rank must take alike)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int64,
                         device=self.device)
        return bool(self.all_max(t).item())

    def on_root(self, write):
        """``write()`` (host-only work: a snapshot, a state file, records)
        on rank 0 while the other ranks wait for it at a barrier of a gloo
        group of their own, whose timeout (``launch.WRITE_TIMEOUT_S``)
        covers a large state on a slow disk; the process group's short
        timeout stays for the collectives. Rank 0 gets ``write()``'s
        value, the others None. Every rank calls it."""
        import datetime

        import torch.distributed as dist

        from shadow1_tpu_torch.shard.launch import WRITE_TIMEOUT_S

        out = write() if self.rank == 0 else None
        if self.n_dev > 1:
            if self._waiters is None:
                ranks = (None if self.group is None
                         else dist.get_process_group_ranks(self.group))
                self._waiters = dist.new_group(
                    ranks, backend="gloo",
                    timeout=datetime.timedelta(seconds=WRITE_TIMEOUT_S))
            dist.barrier(group=self._waiters)
        return out

    def _all_gather_hosts(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' [.., h_local] blocks concatenated on the host axis."""
        import torch.distributed as dist

        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        x = self._to_wire(wire)
        parts = [torch.empty_like(x) for _ in range(self.n_dev)]
        dist.all_gather(parts, x, group=self.group)
        out = self._from_wire(torch.cat(parts, dim=-1))
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def _exchange(self, x2x_cap: int):
        """The window's one all_to_all, for ``deliver_window``."""
        import torch.distributed as dist

        d, h, dev = self.n_dev, self.h_local, self.device
        iota_d = torch.arange(d + 1, device=dev)
        iota_k = torch.arange(x2x_cap, device=dev)

        def exchange(fp: FlatPackets):
            n = fp.dst.shape[0]
            dshard = torch.where(fp.keep, fp.dst.long() // h, d)
            dshard_s, order = torch.sort(dshard, stable=True)
            seg = torch.searchsorted(dshard_s, iota_d)
            pos = seg[:-1, None] + iota_k[None, :]
            valid = pos < seg[1:, None]                        # [D, K]
            src = order[torch.clamp(pos, max=n - 1)]           # [D, K]
            dropped = (fp.keep.sum(dtype=torch.int64)
                       - valid.sum(dtype=torch.int64))
            # The busiest outbound bucket's demanded fill (it exceeds the
            # cap exactly when packets drop), maxed over the ranks.
            local_fill = (seg[1:] - seg[:-1]).max().reshape(1)
            a_hi, a_lo = tb_split(fp.arrival)
            t_hi, t_lo = tb_split(fp.tb)
            stacked = torch.cat([
                torch.stack([fp.dst.to(torch.int32), a_lo, a_hi, t_lo, t_hi,
                             fp.kind.to(torch.int32)], dim=1),
                fp.p.T.to(torch.int32)], dim=1)                # [N, 6+NP]
            send = torch.where(valid[:, :, None], stacked[src], 0)
            send = torch.cat([send, valid[:, :, None].to(torch.int32)],
                             dim=2).contiguous()               # [D, K, 7+NP]
            x = self._to_wire(send)
            recv = torch.empty_like(x)
            dist.all_to_all_single(recv, x, group=self.group)
            EXCHANGES["all_to_all"] += 1
            r = self._from_wire(recv).reshape(d * x2x_cap, send.shape[2])
            fill_hw = self.all_max(local_fill)[0]
            keep = r[:, -1] != 0
            out = FlatPackets(
                dst=torch.where(keep, r[:, 0], 0),
                arrival=tb_join(r[:, 2], r[:, 1]),
                tb=tb_join(r[:, 4], r[:, 3]),
                kind=r[:, 5].contiguous(),
                p=r[:, 6:-1].T.contiguous(),
                keep=keep)
            return out, dropped, fill_hw

        return exchange

    def _telem_reduce(self, counters, gauges):
        return self.all_sum(counters), self.all_max(gauges)

    def _probe_reduce(self, row):
        return self.all_sum(row)

    def _link_reduce(self, entry, cur):
        from shadow1_tpu_torch.telemetry.links import LINK_MAX_COL

        d = cur.buf[..., :LINK_MAX_COL] - entry.buf[..., :LINK_MAX_COL]
        ctr = entry.buf[..., :LINK_MAX_COL] + self.all_sum(d)
        mx = self.all_max(cur.buf[..., LINK_MAX_COL])
        return cur._replace(buf=torch.cat([ctr, mx[..., None]], dim=-1))

    def _reduce_metrics(self, m: Metrics, m0: Metrics) -> Metrics:
        """The run's metrics made global: the sum over ranks minus the
        entry baseline each rank carried, ``windows`` and ``x2x_max_fill``
        as they are, the fill gauges maxed."""
        f = Metrics._fields
        tot = (self.all_sum(torch.stack(list(m)))
               - (self.n_dev - 1) * torch.stack(list(m0)))
        mx = self.all_max(torch.stack([getattr(m, k) for k in _MAXED]))
        out = {k: tot[i] for i, k in enumerate(f)}
        out.update({k: getattr(m, k) for k in _KEEP})
        out.update({k: mx[i] for i, k in enumerate(_MAXED)})
        return Metrics(**out)

    # -- state -------------------------------------------------------------
    def init_global_state(self) -> SimState:
        """The whole run's initial state (every host), built over the
        global ctx as the solo engine builds it: the template a snapshot
        loads into before :meth:`place_state`."""
        import types

        return Engine.init_state(types.SimpleNamespace(
            ctx=self.global_ctx, params=self.params, exp=self.exp,
            device=self.device, _model=self._model))

    def init_state(self) -> SimState:
        """This rank's columns of the initial state."""
        return self.place_state(self.init_global_state())

    def place_state(self, st: SimState) -> SimState:
        """A global state (every host, any device or numpy-converted) →
        this rank's: the host-minor leaves of the evbuf, outbox, model and
        CPU clock sliced to the rank's columns, the telemetry planes, the
        metrics and the window start whole."""
        n = self.exp.n_hosts
        repl = {f: _slice_hosts(getattr(st, f), self.lo, self.h_local, n)
                for f in HOST_FIELDS}
        st = st._replace(**repl)
        return _tree_map(lambda x: x.to(self.device)
                         if isinstance(x, torch.Tensor) else x, st)

    def gather_state(self, st: SimState) -> SimState:
        """The global state from every rank's columns (a collective: every
        rank calls it and gets the whole state) — what the JAX package's
        ``np.asarray`` of a sharded state gives."""
        h = self.h_local

        def g(x):
            if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                    and x.shape[-1] == h:
                return self._all_gather_hosts(x)
            return x

        return st._replace(**{f: _tree_map(g, getattr(st, f))
                              for f in HOST_FIELDS})

    # -- running -----------------------------------------------------------
    def _run(self, st: SimState, n: int, x2x_cap: int) -> SimState:
        """``n`` windows from ``st`` (its only reference, rebound as the
        windows go), then the metrics made global; this rank's own, before
        the reduction, stay in ``local_metrics`` (its ``rounds`` are the
        rank's round loop)."""
        exchange = self._exchange(x2x_cap)
        m0 = st.metrics
        for _ in range(int(n)):
            st = window_step(st, self.ctx, self._handlers,
                             self._model.make_handlers, self._pre_window,
                             exchange=exchange,
                             telem_reduce=self._telem_reduce,
                             probe_reduce=self._probe_reduce,
                             link_reduce=self._link_reduce)
        self.local_metrics = st.metrics
        return st._replace(metrics=self._reduce_metrics(st.metrics, m0))

    def run(self, st: SimState | None = None, n_windows: int | None = None,
            check_x2x: bool = True) -> SimState:
        """Run ``n_windows`` windows (default: to the end) from ``st``
        (default: ``init_state()``). The safety net of the exchange bucket
        is the reference's (module docstring); a rerun starts from a clone
        of the input taken before the run, because on CUDA the kernels
        update the planes of the state they are given."""
        from shadow1_tpu_torch.convert import clone_state

        if st is None:
            st = self.init_state()
        n = n_windows if n_windows is not None else self.n_windows
        base = int(st.metrics.x2x_overflow)
        may_retry = (check_x2x and not base and not self.params.x2x_cap
                     and self._x2x_cap < self._full_cap)
        keep = clone_state(st) if may_retry else None
        # Handed over, not kept: the windows free the input as they go.
        held = [st]
        st = None
        out = self._run(held.pop(), n, self._x2x_cap)
        if not check_x2x:
            # A supervising OverflowGuard owns the response.
            return out
        drops = int(out.metrics.x2x_overflow) - base
        if drops and may_retry:
            warnings.warn(
                f"x2x bucket overflow ({drops} pkts) at auto cap "
                f"{self._x2x_cap}; retrying at worst-case cap "
                f"{self._full_cap} — set EngineParams.x2x_cap to pin the "
                f"exchange size", RuntimeWarning, stacklevel=2)
            self._x2x_cap = self._full_cap
            out = None
            held.append(keep)
            keep = None
            out = self._run(held.pop(), n, self._x2x_cap)
        total = int(out.metrics.x2x_overflow)
        if total:
            raise RuntimeError(
                f"{total} packets dropped by full all_to_all buckets "
                f"(x2x_cap too small for this traffic pattern) — results "
                f"diverge from the single-device engine; raise "
                f"EngineParams.x2x_cap or pass check_x2x=False")
        return out

    def grow_x2x(self) -> bool:
        """Escalate the exchange bucket to its guaranteed-fit cap (the
        overflow-retry hook, ``txn.OverflowGuard._grow``). False when it
        is there already: the overflow is then not bucket-sized."""
        if self._x2x_cap >= self._full_cap:
            return False
        self._x2x_cap = self._full_cap
        return True

    def synchronize(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    metrics_dict = staticmethod(Engine.metrics_dict)

    def global_summary(self, gst: SimState) -> dict:
        """The model summary of a gathered (global) state."""
        return {k: v.cpu().numpy() for k, v in
                self._model.summary(gst.model, self.global_ctx).items()}

    def model_summary(self, st: SimState) -> dict:
        """The model summary of the whole run (a collective)."""
        return self.global_summary(self.gather_state(st))
