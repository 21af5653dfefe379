"""Count what one round of the port's net slice dispatches, on the CPU.

    python tools/torch_net_opcount.py [--groups 2] [--warmup 7] [--windows 3]
        [--planes]

Runs the ``filexfer16k`` layout (``tiled_filexfer_experiment``) at
``--groups`` groups of 8 hosts on the CPU, and over ``--windows`` windows
after ``--warmup`` counts, per round, what ``opcensus.count_call`` counts
(the census's one rule): the aten ops dispatched (views and the scalar
read left out; on the CPU the kernels' plain versions run, so pop, push
and the outbox append count as their plain ops) and the device→host
reads, with the ops grouped by ``file.function``. With ``--planes`` the
run also carries the observability planes: a telemetry ring, four flow
probes in the first group (the server's host view and socket 1, clients 1
and 2) and the link accumulator. A CPU count, not a device measurement:
it says how many eager ops and synchronising reads the round loop dispatches,
which the card's host pays for. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=7)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--planes", action="store_true")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, str(ROOT))
    from shadow1_tpu_torch.config.compiled import tiled_filexfer_experiment
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.tools.opcensus import count_call

    torch.set_num_threads(1)
    exp = tiled_filexfer_experiment(
        args.groups, seed=42,
        end_time=(args.warmup + args.windows) * 40_000_000)
    planes = (dict(metrics_ring=args.warmup + args.windows, link_telem=1,
                   probes=((0, -1), (0, 1), (1, 0), (2, 0)))
              if args.planes else {})
    eng = Engine(exp, EngineParams(ev_cap=512, **planes), device="cpu")
    st = eng.run(n_windows=args.warmup)
    r0 = Engine.metrics_dict(st)["rounds"]
    st, c = count_call(lambda s: eng.run(s, n_windows=args.windows), st,
                       sources=True)
    rounds = Engine.metrics_dict(st)["rounds"] - r0
    print(json.dumps({
        "device": "cpu", "hosts": exp.n_hosts, "windows": args.windows,
        "planes": args.planes, "rounds": rounds,
        "ops_per_round": c.ops / rounds, "reads_per_round": c.reads / rounds,
        "top_sources": c.by_src.most_common(15),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
