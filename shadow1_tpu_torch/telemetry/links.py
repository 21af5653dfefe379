"""On-device link-telemetry accumulator — per-edge counters of the topology
(port of ``telemetry/links.py``).

A ``[V, V, F]`` i64 tensor (``registry.LINK_FIELDS`` columns, keyed
(src_vertex, dst_vertex)) rides in ``SimState.links``. ``route_outbox``
adds every routed packet's contribution at the window-end route phase (one
``index_add`` and one ``scatter_reduce(amax)`` on the flattened tensor, no
host read), and the NIC tx sites add drop-tail drops onto their egress
edge as they happen (``link_nic_drops``). At chunk boundaries ``drain_links`` reads the
tensor back as CUMULATIVE per-edge ``link`` records — running totals, a
pure function of the state, so a resumed run's stream continues a
straight run's exactly. Integer adds and maxima do not depend on the
order the device applies them in, so the records equal the JAX engine's
bit for bit.

The plane defaults off: ``link_init`` returns None, the state has no such
leaf and no operation runs. The accumulator is never digested, so turning
it on leaves every digest word as it was. Updates are out of place (the
state stays a value, as the rest of the engine's state is on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch.consts import SEC
from shadow1_tpu_torch.telemetry.registry import (
    LINK_FIELDS,
    LINK_MAX_COL,
    REC_LINK,
    REC_LINK_GAP,
)

# Dense [V, V, F] memory bound: the plane targets PoP-level topologies,
# not per-host meshes. 1024 vertices is 56 MB of i64 accumulator.
MAX_DENSE_VERTICES = 1024
_NIC_COL = LINK_FIELDS.index("nic_backlog_drops")


class LinkAccum(NamedTuple):
    """The device-resident accumulator: running totals per directed edge."""

    buf: torch.Tensor  # i64 [V, V, len(LINK_FIELDS)]


def check_link_params(params, n_vertices: int) -> None:
    """Config-time guards for the link plane (engine constructor)."""
    if not getattr(params, "link_telem", 0):
        return
    if int(params.link_telem) != 1:
        raise ValueError(
            f"link_telem={params.link_telem}: only the dense [V, V] "
            f"accumulator (link_telem=1) is implemented; top-K edge "
            f"tracking is reserved for a follow-up")
    if n_vertices > MAX_DENSE_VERTICES:
        raise ValueError(
            f"link_telem: {n_vertices} vertices exceeds the dense "
            f"accumulator bound ({MAX_DENSE_VERTICES}); the [V, V] tensor "
            f"would not fit the observability budget")


def link_init(link_telem: int, n_vertices: int, device) -> LinkAccum | None:
    """A zeroed [V, V, F] accumulator, or None when the plane is off."""
    if not link_telem:
        return None
    return LinkAccum(buf=torch.zeros(
        (int(n_vertices), int(n_vertices), len(LINK_FIELDS)),
        dtype=torch.int64, device=device))


def link_route_accum(links: LinkAccum, vs, vd, fmask, lost, linkdown,
                     queued, wire) -> LinkAccum:
    """Add one window's routed packets onto their edges.

    ``vs`` / ``vd`` are the endpoint vertices of the flat outbox slots,
    ``fmask`` the occupied slots (the offered population), ``lost`` /
    ``linkdown`` the drop masks (subsets of fmask), ``queued`` the
    per-packet NIC queueing ns and ``wire`` the wire bytes. Empty slots
    land on edge (0, 0) with all-zero contributions."""
    buf = links.buf
    v = buf.shape[0]
    ek = torch.where(fmask, vs.long() * v + vd.long(), 0)
    one = fmask.to(torch.int64)
    q = torch.where(fmask, queued, 0).to(torch.int64)
    adds = torch.stack([
        one,                                      # pkts
        torch.where(fmask, wire, 0).to(torch.int64),
        lost.to(torch.int64),
        linkdown.to(torch.int64),
        torch.zeros_like(one),                    # nic drops: tx sites
        q,
    ], dim=-1)                                    # [N, LINK_MAX_COL]
    f = len(LINK_FIELDS)
    cols = torch.arange(LINK_MAX_COL, device=buf.device)
    flat = buf.reshape(-1).index_add(
        0, (ek[:, None] * f + cols).reshape(-1), adds.reshape(-1))
    # Every entry is ≥ 0, so an empty slot's max(old, 0) on edge 0 is a
    # no-op.
    flat = flat.scatter_reduce(0, ek * f + LINK_MAX_COL, q, reduce="amax")
    return links._replace(buf=flat.reshape(buf.shape))


def link_nic_drops(links: LinkAccum | None, ctx, drops, dst
                   ) -> LinkAccum | None:
    """Add NIC uplink drop-tail drops onto their egress edge.

    ``drops`` is the per-host drop count (bool mask or counts, [H] hosts of
    ``ctx``, a compaction bucket's included: ``ctx.hosts`` holds their
    global ids), ``dst`` the per-host global destination host (garbage
    where drops == 0). Nothing runs when the plane is off. RED early drops
    are not backlog and stay off the edge tensor (the ``nic_tx_drops``
    metric sites)."""
    if links is None:
        return None
    buf = links.buf
    v = buf.shape[0]
    n = drops.to(torch.int64)
    hit = n > 0
    vs = ctx.host_vertex[ctx.hosts.long()]
    vd = ctx.host_vertex[torch.where(hit, dst, 0).long()]
    ek = torch.where(hit, vs.long() * v + vd.long(), 0)
    flat = buf.reshape(-1).index_add(0, ek * len(LINK_FIELDS) + _NIC_COL,
                                     torch.where(hit, n, 0))
    return links._replace(buf=flat.reshape(buf.shape))


def drain_links(st, window_ns: int, start: int = 0) -> list[dict]:
    """Cumulative per-edge snapshots at the current window boundary (one
    device→host copy; chunk boundaries only): one ``link`` record per edge
    with any nonzero column, in (src, dst) order. The ``start`` cursor (the
    last drained boundary) keeps a resume from re-emitting; a state behind
    the cursor emits one ``link_gap`` rebase marker instead."""
    links = getattr(st, "links", None)
    if links is None:
        return []
    done = int(st.metrics.windows)
    if done < start:
        return [{
            "type": REC_LINK_GAP,
            "window": done,
            "expected_window": start,
        }]
    if done <= start:
        return []
    buf = links.buf.cpu().numpy()
    t = round(done * window_ns / SEC, 9)
    recs: list[dict] = []
    for s, d in zip(*buf.any(axis=-1).nonzero()):
        rec = {
            "type": REC_LINK,
            "window": done - 1,
            "sim_time_s": t,
            "src_vertex": int(s),
            "dst_vertex": int(d),
        }
        rec.update({f: int(x) for f, x in zip(LINK_FIELDS, buf[s, d])})
        recs.append(rec)
    return recs
