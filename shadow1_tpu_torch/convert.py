"""Carry engine state between the JAX package and the port.

A simulator has no weights; what carries across is the state of a run.
Both packages keep the same ``SimState`` tree — the same NamedTuples, field
names, leaf shapes and dtypes — so a state converts leaf by leaf:

* ``state_from_numpy(tree, device)`` takes a reference ``SimState`` whose
  leaves are numpy arrays (``jax.tree.map(np.asarray, st)`` on the JAX
  side) and returns the port's ``SimState`` on ``device``;
* ``state_to_numpy(st)`` returns the port's ``SimState`` with numpy leaves
  of the same dtypes, to compare with or hand back to the reference.

The tree is read by field name (NamedTuples) and key (the net model's
TCP and app dicts), so this module needs nothing of the JAX package. A
state carries PHOLD's or the net model's state (NIC rows, the TCP dict of
``[S, H]`` and ``[Q, S, H]`` planes, the app's dict — filexfer, tgen,
dgram or Tor, whose ``[ct_cap, H]`` circuit tables ride as leaves too)
and the telemetry ring; states that carry the probe ring or the link
accumulator are refused: the port does not run them.
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
from shadow1_tpu_torch.telemetry.ring import TelemetryRing

# Port NamedTuple for each reference NamedTuple, by class name.
_TYPES = {c.__name__: c for c in (SimState, EventBuf, Outbox, Metrics,
                                  PholdState, NetState, NicState,
                                  TelemetryRing)}


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
    for f in ("probes", "links"):
        if getattr(tree, f, None) is not None:
            raise NotImplementedError(
                f"SimState.{f} is not ported yet (ROADMAP: checkpoint and "
                "observability)")
    dev = torch.device(device)
    return _convert(tree, lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(dev))


def state_to_numpy(st: SimState) -> SimState:
    """The port's SimState → the same tree with numpy leaves."""
    return _convert(st, lambda t: t.detach().cpu().numpy())
