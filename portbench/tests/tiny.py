"""Tiny cells for the CPU tests: the benchmark's own configurations with
fewer hosts, run through the whole harness (set-up, window, traced passes,
reference) on the CPU with the kernels' plain versions, from a scratch
checkout layout that holds their files.

``fault`` plants a fault in the program for the whole run, so a test can
see ``correct`` come out false:

* ``unchanged``: ``Engine.run`` returns the state it was given;
* ``half``: the hosts of the second half of the columns never pop (in a
  fleet, half of the lanes), half of the batch left out;
* ``altered``: the first packet a window delivers arrives 1 ns late.
"""

from __future__ import annotations

import contextlib
import copy
import json
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_configs() -> dict:
    tor = json.loads((ROOT / "portbench/configs/tor10k.json").read_text())
    counts = {"guard": 12, "middle": 20, "exit": 8, "dirauth": 2,
              "client": 120}
    for g in tor["experiment"]["hosts"]:
        g["count"] = counts[g["name"]]
    phold = json.loads((ROOT / "portbench/configs/phold.json").read_text())
    phold["experiment"]["hosts"][0]["count"] = 384
    return {"tor.tiny": tor, "phold.tiny": phold}


CELLS = {
    "tor.tiny": {"config": "tor.tiny", "traffic": "seeds2", "lanes": 2,
                 "start_window": 8, "span_windows": 4},
    "phold.tiny": {"config": "phold.tiny", "traffic": "lp384", "lanes": 1,
                   "start_window": 4, "span_windows": 8},
}


def manifest() -> dict:
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = copy.deepcopy(real)
    m["configs"] = [{"name": n, "source": "https://example.org/tiny",
                     "file": f"portbench/configs/{n}.json", "reduced": [],
                     "why": "a tiny copy for the CPU tests"}
                    for n in tiny_configs()]
    m["workloads"] = [{"name": n, "config": c["config"],
                       "traffic": c["traffic"], "chips": 1, "why": "tiny"}
                      for n, c in CELLS.items()]
    for group in ("end_to_end", "per_layer"):
        for e in m[group]:
            e.pop("workloads", None)
    return m


def layout(root: Path) -> Path:
    """Write the tiny cells' files under ``root`` as a checkout holds
    them."""
    (root / "portbench/configs").mkdir(parents=True, exist_ok=True)
    (root / "portbench/workloads").mkdir(parents=True, exist_ok=True)
    for n, c in tiny_configs().items():
        (root / f"portbench/configs/{n}.json").write_text(json.dumps(c))
    for n, c in CELLS.items():
        (root / f"portbench/workloads/{n}.json").write_text(json.dumps(c))
    return root


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted, restored on exit."""
    import torch

    from shadow1_tpu_torch.core import engine as E

    saved = (E.Engine.run, E.pop_until, E.deliver_batch)
    if fault == "unchanged":
        def run(self, st=None, n_windows=None, check_x2x=True):
            return self.init_state() if st is None else st
        E.Engine.run = run
    elif fault == "half":
        real_pop = E.pop_until

        def pop(buf, until, *a, **k):
            cols = buf.kind.shape[-1]
            keep = torch.arange(cols, device=buf.kind.device) < cols // 2
            never = buf.epoch - (1 << 40)
            if isinstance(until, torch.Tensor) and until.dim() == 1:
                bound = torch.where(keep, until, never)
            else:
                bound = torch.where(keep, torch.as_tensor(until), never)
            return real_pop(buf, bound, *a, **k)
        E.pop_until = pop
    elif fault == "altered":
        real_deliver = E.deliver_batch

        def deliver(buf, dst, time, tb, kind, p, mask, lanes=0):
            time = time.clone()
            first = torch.nonzero(mask)[:1, 0]
            time[first] += 1
            return real_deliver(buf, dst, time, tb, kind, p, mask, lanes)
        E.deliver_batch = deliver
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        E.Engine.run, E.pop_until, E.deliver_batch = saved


def run_tiny(name: str, seed: int, trace: bool = False,
             fault: str | None = None, seconds: float = 0.05) -> dict:
    """One run of a tiny cell on the CPU: the result line's object."""
    from portbench.harness import run_cell

    with tempfile.TemporaryDirectory() as d:
        root = layout(Path(d))
        with planted(fault):
            return run_cell(name, seed, seconds, trace, "cpu",
                            manifest=manifest(), root=root,
                            log=lambda s: None)
