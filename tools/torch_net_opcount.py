"""Count what one round of the port's net slice dispatches, on the CPU.

    python tools/torch_net_opcount.py [--groups 2] [--warmup 7] [--windows 3]
        [--planes]

Runs the ``filexfer16k`` layout (``tiled_filexfer_experiment``) at
``--groups`` groups of 8 hosts on the CPU, and over ``--windows`` windows
after ``--warmup`` counts, per round: the PyTorch ops dispatched (views
left out; on the CPU the kernels' plain versions run, so pop, push and
the outbox append count as their plain ops, not as one launch each) and
the device→host reads (``bool(tensor)`` and ``.tolist()``, by calling
function). With ``--planes`` the run also carries the observability
planes: a telemetry ring, four flow probes in the first group (the
server's host view and socket 1, clients 1 and 2) and the link
accumulator. A CPU count, not a device measurement: it says how many eager
ops and synchronising reads the round loop issues, which the card's host
pays for. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VIEWS = {"aten.unsqueeze.default", "aten.expand.default", "aten.view.default",
         "aten.squeeze.dim", "aten.select.int", "aten.slice.Tensor",
         "aten.alias.default", "aten.detach.default",
         "aten._local_scalar_dense.default"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=7)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--planes", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    sys.path.insert(0, str(ROOT))
    from shadow1_tpu_torch.config.compiled import tiled_filexfer_experiment
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core.engine import Engine

    torch.set_num_threads(1)
    exp = tiled_filexfer_experiment(
        args.groups, seed=42,
        end_time=(args.warmup + args.windows) * 40_000_000)
    planes = (dict(metrics_ring=args.warmup + args.windows, link_telem=1,
                   probes=((0, -1), (0, 1), (1, 0), (2, 0)))
              if args.planes else {})
    eng = Engine(exp, EngineParams(ev_cap=512, **planes), device="cpu")
    st = eng.run(n_windows=args.warmup)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    reads = Counter()
    real_bool, real_tolist = torch.Tensor.__bool__, torch.Tensor.tolist

    def counted(fn):
        def wrap(self):
            reads[traceback.extract_stack(limit=2)[0].name] += 1
            return fn(self)
        return wrap

    r0 = Engine.metrics_dict(st)["rounds"]
    torch.Tensor.__bool__ = counted(real_bool)
    torch.Tensor.tolist = counted(real_tolist)
    try:
        with Count() as c:
            st = eng.run(st, n_windows=args.windows)
    finally:
        torch.Tensor.__bool__, torch.Tensor.tolist = real_bool, real_tolist
    rounds = Engine.metrics_dict(st)["rounds"] - r0
    ops = sum(n for k, n in c.ops.items() if k not in VIEWS)
    print(json.dumps({
        "device": "cpu", "hosts": exp.n_hosts, "windows": args.windows,
        "planes": args.planes,
        "rounds": rounds, "ops_per_round": ops / rounds,
        "reads_per_round": sum(reads.values()) / rounds,
        "reads_by_caller": dict(reads),
        "top_ops": c.ops.most_common(15),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
