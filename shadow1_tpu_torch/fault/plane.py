"""The fault plane on the device (port of ``fault/plane.py``).

Every function here is elementwise PyTorch over the dense tables that
``fault/schedule.py`` builds: the down predicates cost K (intervals per
host) compares, the link and ramp gates L or R compares over the window's
flat packet axis. Thresholds are the u64 Bernoulli thresholds of
``rng.prob_threshold``, at most 2**32, held as int64.

In a fleet the host tables are folded onto the host axis like the state
([K, E·H], each lane padded to the fleet's K with ``[NO_STOP, NO_STOP)``
intervals) and the link and ramp tables carry a leading lane axis ([E, L],
padded with ``t0 == t1`` entries no time falls in); the packet gates then
take each packet's ``lane`` and read its lane's row.
"""

from __future__ import annotations

import torch


def hosts_down_at(down, up, t) -> torch.Tensor:
    """bool down-mask for times ``t`` of shape [..., H] (hosts on the last
    axis), against the [K, H] interval tensors."""
    k, h = down.shape
    shape = (k,) + (1,) * (t.dim() - 1) + (h,)
    tt = t[None]
    return ((tt >= down.reshape(shape)) & (tt < up.reshape(shape))).any(dim=0)


def hosts_down_at_idx(down, up, idx, t) -> torch.Tensor:
    """Per-packet down-mask: ``idx`` [N] host indices, ``t`` [N] times."""
    i = idx.long()
    tt = t[None, :]
    return ((tt >= down[:, i]) & (tt < up[:, i])).any(dim=0)


def _by_lane(table, lane):
    """[L] → [L, 1] for every packet, or [E, L] → [L, N] by packet lane."""
    return table[:, None] if lane is None else table.T[:, lane]


def link_down_mask(link_fault, vs, vd, dep, lane=None) -> torch.Tensor:
    """bool [N]: the packet's (src vertex, dst vertex, departure) falls in
    an outage window of the (src, dst, t0, t1) table (its lane's row of
    the [E, L] table when ``lane`` [N] is given)."""
    src, dst, t0, t1 = (_by_lane(a, lane) for a in link_fault)
    m = ((vs[None, :] == src) & (vd[None, :] == dst)
         & (dep[None, :] >= t0) & (dep[None, :] < t1))
    return m.any(dim=0)


def ramp_loss_thr(loss_ramp, vs, vd, dep, thr, lane=None) -> torch.Tensor:
    """The timed loss ramps: where a packet's path and departure match an
    entry, its Bernoulli threshold is replaced; entries apply in order, so
    a later one wins. R is a few config lines, unrolled (with ``lane``,
    each packet reads entry i of its lane's row of the [E, R] table)."""
    src, dst, t0, t1, rthr = loss_ramp
    for i in range(src.shape[-1]):
        s, d, a, b, r = (x[..., i] if lane is None else x[:, i][lane]
                         for x in (src, dst, t0, t1, rthr))
        m = (vs == s) & (vd == d) & (dep >= a) & (dep < b)
        thr = torch.where(m, r, thr)
    return thr


def restart_mask(up, win_start) -> torch.Tensor:
    """bool [H]: hosts whose window-quantized up time is this window's
    start; their restart reset applies before this window's rounds."""
    return (up == win_start).any(dim=0)


def reset_host_columns(tree, init_tree, mask, n_hosts: int):
    """Restore the masked hosts' columns of every per-host leaf (host axis
    last, the state layout rule) to the post-init capture ``init_tree``;
    leaves of other shapes pass through."""
    from shadow1_tpu_torch.core.compact import _tree_map

    def r(cur, ini):
        if (isinstance(cur, torch.Tensor) and cur.dim() >= 1
                and cur.shape[-1] == n_hosts):
            m = mask.reshape((1,) * (cur.dim() - 1) + (n_hosts,))
            return torch.where(m, ini.to(cur.dtype), cur)
        return cur

    return _tree_map(r, tree, init_tree)
