"""Active-host compaction: sparse windows run on a narrow bucket (port of
``core/compact.py``).

A window's active-host set is closed under round execution — handlers
only push events to their own host, and packets wait for the window-end
exchange — so a host with no eligible event at window start stays
event-free all window. Gathering the active columns into a ``cap``-wide
bucket, running the same round loop there and scattering back is the
identity on every inactive host and the same computation on every active
one: pops, handler order, RNG draws (keyed by the GLOBAL host id,
``ctx.hosts``) and metric sums are bit-equal to the full-width run.
Windows whose active count exceeds the bucket run full width, so
``compact_cap`` is purely a speed choice.

Padding lanes (bucket wider than the active count) clone host H − 1 but
are forced event-free, so they never pop and masked handlers never write
them; clone lanes are left out of the scatter-back (``pos`` maps each
host to its FIRST lane).

The gather makes fresh contiguous tensors (``index_select``), which the
CUDA kernels update in place; the scatter-back reads those updated copies
on active hosts only. The reference's ``lax.cond(n_active <= cap, ...)``
is one device→host read per window. ``WINDOWS`` counts the windows that
took each branch.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow1_tpu_torch.consts import K_NONE
from shadow1_tpu_torch.core.events import I32_FREE
from shadow1_tpu_torch.telemetry.profiler import read

# Ctx fields indexed by LOCAL host lane (everything else — vertex tables,
# host_vertex (global-id-indexed), scalars, static flags — stays as is).
_CTX_HOST_FIELDS = (
    "hosts", "bw_up", "bw_dn", "fault_down", "fault_up", "cpu_cost",
    "tx_qlen_ns", "rx_qlen_ns", "aqm_min_ns", "aqm_span_ns", "aqm_pmax_thr",
)

# Windows run by each branch of ``compact_window_rounds``; set to 0 to
# start a count.
WINDOWS = {"compact": 0, "full": 0}


def active_mask(evbuf, win_end) -> torch.Tensor:
    """bool [H]: host has ≥ 1 eligible event this window (= will pop).
    Reads the per-host eligible counters, current after the window-start
    rebase."""
    del win_end  # pinned at rebase time (evbuf.u32)
    return evbuf.n_elig > 0


def compact_perm(active: torch.Tensor, cap: int):
    """Bucket permutation for the active set.

    Returns (idx [cap], pos [H], lane_pad [cap]):
    * ``idx`` — host id in each bucket lane (padding lanes clone H − 1),
    * ``pos`` — bucket lane of each host (valid where ``active``; for a
      cloned host it is the FIRST — real — lane),
    * ``lane_pad`` — True on padding lanes (no real host).
    """
    h = active.shape[0]
    iota = torch.arange(h, dtype=torch.int32, device=active.device)
    key_s = torch.sort(torch.where(active, iota, h)).values
    pos = torch.searchsorted(key_s, iota).to(torch.int32)  # first occurrence
    idx = key_s[:cap]
    lane_pad = idx >= h
    return torch.clamp(idx, max=h - 1), pos, lane_pad


def _tree_map(fn, *trees):
    """Map ``fn`` over the tensor leaves of tuples, NamedTuples, dicts and
    None (the engine's state trees), keeping the structure of the first."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, tuple):
        out = (_tree_map(fn, *xs) for xs in zip(*trees))
        return type(t0)(*out) if hasattr(t0, "_fields") else tuple(out)
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _is_host(x, h: int) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[-1] == h


def _gather_tree(tree, idx, h: int):
    """Gather the host (last) axis of every [*, H] leaf down to the bucket,
    into fresh contiguous tensors; every other leaf passes as it is."""
    idx = idx.long()
    return _tree_map(
        lambda x: x.index_select(-1, idx) if _is_host(x, h) else x, tree)


def _scatter_tree(full, comp, pos, active, h: int):
    """Inverse of ``_gather_tree``: active hosts read their bucket lane,
    inactive hosts keep the full-width value; leaves without a host axis
    take the round loop's value. ``pos`` past the bucket (inactive hosts)
    is clipped before the gather; ``active`` masks those lanes out."""
    lanes = {}

    def s(xf, xc):
        if not _is_host(xf, h):
            return xc
        w = xc.shape[-1]
        if w not in lanes:
            lanes[w] = torch.clamp(pos, max=w - 1).long()
        return torch.where(active, xc.index_select(-1, lanes[w]), xf)

    return _tree_map(s, full, comp)


def compact_ctx(ctx, idx, cap: int):
    """The bucket-width view of a Ctx: per-host tables gathered,
    n_hosts = cap (``n_total`` stays the global count)."""
    repl = {"n_hosts": cap}
    for f in _CTX_HOST_FIELDS:
        v = getattr(ctx, f, None)
        if v is not None:
            repl[f] = v.index_select(-1, idx.long())
    return dataclasses.replace(ctx, **repl)


def compact_window_rounds(st, ctx, handlers, make_handlers, run_rounds,
                          win_end, cap: int):
    """Run one window's inner rounds, compacted when the active set fits.

    ``run_rounds(st, ctx, handlers, win_end) -> (st, cap_hit)`` is the
    engine's round loop, reused as it is at bucket width; ``handlers`` is
    the full-width handler dict (the other branch) and
    ``make_handlers(ctx)`` rebuilds the handlers over the gathered ctx."""
    h = ctx.n_hosts
    active = active_mask(st.evbuf, win_end)
    if read("compact", int, active.sum()) > cap:
        WINDOWS["full"] += 1
        return run_rounds(st, ctx, handlers, win_end)
    WINDOWS["compact"] += 1
    idx, pos, lane_pad = compact_perm(active, cap)
    ctx_c = compact_ctx(ctx, idx, cap)
    handlers_c = make_handlers(ctx_c)
    host_state = (st.evbuf, st.outbox, st.model, st.cpu_busy)
    evbuf_c, outbox_c, model_c, busy_c = _gather_tree(host_state, idx, h)
    # Padding/clone lanes must never pop: force them event-free (a clone
    # lane with a live n_elig copy would spin the round loop).
    evbuf_c = evbuf_c._replace(
        kind=torch.where(lane_pad[None, :], K_NONE, evbuf_c.kind),
        t32=torch.where(lane_pad[None, :], I32_FREE, evbuf_c.t32),
        n_elig=torch.where(lane_pad, 0, evbuf_c.n_elig),
    )
    st_c = st._replace(evbuf=evbuf_c, outbox=outbox_c, model=model_c,
                       cpu_busy=busy_c)
    st_c, cap_hit = run_rounds(st_c, ctx_c, handlers_c, win_end)
    comp = (st_c.evbuf, st_c.outbox, st_c.model, st_c.cpu_busy)
    evbuf_f, outbox_f, model_f, busy_f = _scatter_tree(host_state, comp, pos,
                                                       active, h)
    return st_c._replace(evbuf=evbuf_f, outbox=outbox_f, model=model_f,
                         cpu_busy=busy_f), cap_hit
