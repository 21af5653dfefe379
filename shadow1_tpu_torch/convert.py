"""Carry engine state between the JAX package and the port.

A simulator has no weights; what carries across is the state of a run.
Both packages keep the same ``SimState`` tree — the same NamedTuples, field
names, leaf shapes and dtypes — so a state converts leaf by leaf:

* ``state_from_numpy(tree, device)`` takes a reference ``SimState`` whose
  leaves are numpy arrays (``jax.tree.map(np.asarray, st)`` on the JAX
  side) and returns the port's ``SimState`` on ``device``;
* ``state_to_numpy(st)`` returns the port's ``SimState`` with numpy leaves
  of the same dtypes, to compare with or hand back to the reference;
* ``sharded_from_numpy`` / ``sharded_to_numpy`` do the same for a rank of
  the sharded engine (``shard/engine.py``): the global tree in, the rank's
  columns placed; the rank's columns gathered, the global tree out.

The tree is read by field name (NamedTuples) and key (the net model's
TCP and app dicts), so this module needs nothing of the JAX package. A
state carries PHOLD's or the net model's state (NIC rows, the TCP dict of
``[S, H]`` and ``[Q, S, H]`` planes, the app's dict — filexfer, tgen,
dgram or Tor, whose ``[ct_cap, H]`` circuit tables ride as leaves too)
and the telemetry planes (the ring, the flow-probe ring and the link
accumulator).

A fleet state (``fleet/engine.py``) folds its E lanes onto the host axis
(``[C, E·H]``); the reference's fleet state carries them on a leading axis
(``[E, C, H]``, metrics ``[E]``, ring ``[E, W, F]``, and the window start
and pop epoch once per lane; the ring, the probe ring and the link
accumulator are ``[E, ...]`` in both). ``fleet_to_saved`` and
``fleet_from_saved``
map one layout onto the other, so a fleet snapshot is the reference's and
loads in either package.

Checkpoints (``ckpt.py``) store the leaves in the order
``jax.tree_util.tree_flatten`` gives the reference's tree:
``flatten_like_jax`` lists them so (NamedTuple fields in declaration
order, dict keys SORTED, ``None`` dropped — the port's dicts keep their
insertion order, which is not the same), and ``unflatten_like_jax`` puts
such a list back into a port state.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from shadow1_tpu_torch.core.engine import Metrics, SimState
from shadow1_tpu_torch.core.events import EventBuf
from shadow1_tpu_torch.core.outbox import Outbox
from shadow1_tpu_torch.core.phold import PholdState
from shadow1_tpu_torch.net import NetState
from shadow1_tpu_torch.net.nic import NicState
from shadow1_tpu_torch.telemetry.links import LinkAccum
from shadow1_tpu_torch.telemetry.probes import ProbeRing
from shadow1_tpu_torch.telemetry.ring import TelemetryRing

# Port NamedTuple for each reference NamedTuple, by class name.
_TYPES = {c.__name__: c for c in (SimState, EventBuf, Outbox, Metrics,
                                  PholdState, NetState, NicState,
                                  TelemetryRing, ProbeRing, LinkAccum)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _convert(node: Any, leaf) -> Any:
    if node is None:
        return None
    if _is_namedtuple(node):
        name = type(node).__name__
        if name not in _TYPES:
            raise NotImplementedError(f"state node {name!r} has no port "
                                      "counterpart in this slice")
        cls = _TYPES[name]
        if cls._fields != node._fields:
            raise ValueError(f"{name}: fields {node._fields} do not match "
                             f"the port's {cls._fields}")
        return cls(*(_convert(getattr(node, f), leaf) for f in cls._fields))
    if isinstance(node, dict):
        return {k: _convert(v, leaf) for k, v in node.items()}
    return leaf(node)


def state_from_numpy(tree, device) -> SimState:
    """A reference SimState with numpy leaves → the port's SimState on
    ``device``, leaf for leaf with the same dtypes."""
    dev = torch.device(device)
    return _convert(tree, lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(dev))


def state_to_numpy(st: SimState) -> SimState:
    """The port's SimState → the same tree with numpy leaves."""
    return _convert(st, lambda t: t.detach().cpu().numpy())


def sharded_from_numpy(engine, tree):
    """A reference global SimState with numpy leaves → this rank's columns
    of it, on the sharded engine's device (``ShardedEngine.place_state``;
    the JAX package's ``np.asarray`` of a sharded state is such a tree)."""
    return engine.place_state(state_from_numpy(tree, "cpu"))


def sharded_to_numpy(engine, st) -> SimState:
    """A rank's state → the global state with numpy leaves (a collective:
    every rank calls it, ``ShardedEngine.gather_state``)."""
    return state_to_numpy(engine.gather_state(st))


def _walk(node, out: list) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], out)
    elif isinstance(node, (tuple, list)):
        for x in node:
            _walk(x, out)
    else:
        out.append(node)


def flatten_like_jax(st) -> list:
    """The tensor leaves of a port state in the order
    ``jax.tree_util.tree_flatten`` gives the reference's state: NamedTuple
    fields in declaration order, dict keys sorted, ``None`` dropped. The
    leaves are the state's own tensors, not copies."""
    out: list = []
    _walk(st, out)
    return out


def clone_state(st):
    """A device copy of every leaf (``Tensor.clone``): a state the kernels
    may update in place (on CUDA they write the event-buffer and outbox
    planes of the state they are given) is kept by cloning it."""
    return unflatten_like_jax(st, [x.clone() for x in flatten_like_jax(st)])


def unflatten_like_jax(template, leaves):
    """``template`` (a port state) with its leaves replaced, in
    ``flatten_like_jax`` order, by ``leaves`` (numpy arrays or tensors),
    each put on its template leaf's device. Dicts keep the template's key
    order."""
    it = iter(leaves)

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            new = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(rebuild(x) for x in node))
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(x) for x in node)
        x = next(it)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, copy=True))
        return x.to(node.device)

    out = rebuild(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _host_width(st) -> int:
    return st.evbuf.kind.shape[-1]


def fleet_to_saved(st: SimState, n_exp: int) -> SimState:
    """A port fleet state → the reference's fleet layout (views of the
    same tensors): every host-axis leaf ``[..., E·H]`` → ``[E, ..., H]``;
    the window start, the pop epoch and bound and any other leaf the
    lanes share → repeated ``[E, ...]``; metrics and ring rows (already
    ``[E]`` and ``[E, W, F]``) as they are."""
    width = _host_width(st)

    def host(x):
        return x.reshape(x.shape[:-1] + (n_exp, width // n_exp)).movedim(-2, 0)

    def shared(x):
        return x.expand((n_exp,) + tuple(x.shape))

    def any_leaf(x):
        return host(x) if x.dim() and x.shape[-1] == width else shared(x)

    from shadow1_tpu_torch.core.compact import _tree_map

    return st._replace(
        win_start=shared(st.win_start),
        evbuf=_tree_map(any_leaf, st.evbuf),
        outbox=_tree_map(host, st.outbox),
        model=_tree_map(any_leaf, st.model),
        cpu_busy=host(st.cpu_busy),
    )


def fleet_from_saved(tree, template: SimState, n_exp: int) -> SimState:
    """Inverse of ``fleet_to_saved``: a reference-layout fleet state
    (tensors, structured like ``template``, a port fleet state) → the
    port's layout, every leaf a fresh contiguous tensor (the kernels need
    contiguous planes). A shared leaf takes lane 0's value; the lanes of a
    fleet run their windows in step, so every lane holds the same."""
    width = _host_width(template)

    def back(x, t):
        if t.dim() and t.shape[-1] == width:
            x = x.movedim(0, -2)
            return x.reshape(x.shape[:-2] + (-1,)).contiguous()
        return x[0].contiguous()

    def same(x, t):
        return x.contiguous()

    from shadow1_tpu_torch.core.compact import _tree_map

    return tree._replace(
        win_start=back(tree.win_start, template.win_start),
        evbuf=_tree_map(back, tree.evbuf, template.evbuf),
        outbox=_tree_map(back, tree.outbox, template.outbox),
        model=_tree_map(back, tree.model, template.model),
        cpu_busy=back(tree.cpu_busy, template.cpu_busy),
        metrics=_tree_map(same, tree.metrics, template.metrics),
        telem=_tree_map(same, tree.telem, template.telem),
        probes=_tree_map(same, tree.probes, template.probes),
        links=_tree_map(same, tree.links, template.links),
    )
