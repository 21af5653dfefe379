"""Lane folding: a fleet's experiments side by side on the host axis.

A fleet state (``fleet/engine.py``) keeps the solo layout with E·H host
columns: column ``e·H + h`` is host h of lane e, so every per-host plane is
``[..., E·H]`` and the kernels run unchanged at that width. What has no
host axis in a solo run (every ``Metrics`` counter and gauge, the digest
words, the ring rows) has one entry per lane in a fleet. These helpers are
the only place that splits the host axis into lanes: each takes the
``Ctx`` (``n_exp`` lanes of ``n_hosts // n_exp`` hosts) and, in a solo run
(``n_exp == 0``: no lane axis), computes exactly what the solo code
computed, a scalar (a ctx without ``n_exp``, such as a test's stand-in,
reads as solo). A fleet of one lane keeps its lane axis.
A lane-segment reduction is one device operation whatever E is.
"""

from __future__ import annotations

import torch


def lane_view(ctx, x: torch.Tensor) -> torch.Tensor:
    """``x`` (host axis last, all other axes flattened in front) as
    ``[N, E, H]``."""
    return x.reshape(-1, ctx.n_exp, ctx.n_hosts // ctx.n_exp)


def lsum(ctx, x: torch.Tensor) -> torch.Tensor:
    """i64 sum of ``x`` (host axis last) per lane: a scalar solo, ``[E]``
    in a fleet."""
    if not getattr(ctx, "n_exp", 0):
        return x.sum(dtype=torch.int64)
    return lane_view(ctx, x).sum(dim=(0, 2), dtype=torch.int64)


def lmax(ctx, x: torch.Tensor) -> torch.Tensor:
    """i64 maximum of ``x`` (host axis last) per lane: a scalar solo,
    ``[E]`` in a fleet."""
    if not getattr(ctx, "n_exp", 0):
        return x.amax().to(torch.int64)
    return lane_view(ctx, x).amax(dim=(0, 2)).to(torch.int64)


def lany(ctx, x: torch.Tensor) -> torch.Tensor:
    """bool ``[..., E]``: any True per lane over the host axis of a
    ``[..., E·H]`` mask."""
    lead = x.shape[:-1]
    return x.reshape(lead + (ctx.n_exp, ctx.n_hosts // ctx.n_exp)).any(-1)

