"""The control of a cell: its configuration's reference with one guarantee
broken (``configs/<config>.json``: ``control``), put in the program's
place and held to the reference exactly as a run holds the program. It has
to come out as not correct. The benchmark's runs never run it; run it on
the card at the cell's own size:

    python3 portbench/control.py --workload phold.lp1m --seeds 5 6 7

Each seed prints the numbers compared, from the cell's lanes (seed, seed +
1, ...) over windows 0 to the pass's end; the last line is JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import (  # noqa: E402
    ROOT,
    compare_outputs,
    load_cell,
    load_json,
    reference_module,
)


def control_readings(cell: dict, seed: int, device) -> dict:
    """The compared numbers of the control against the reference."""
    cfg = cell["cfg"]
    ref = reference_module(cfg["reference"])
    seeds = [seed + i for i in range(int(cell["lanes"]))]
    n = int(cell["start_window"]) + int(cell["span_windows"])
    want = ref.expected(cfg["experiment"], seeds, n, device=device)
    got = ref.expected(cfg["experiment"], seeds, n, device=device,
                       control=cfg["control"])
    return compare_outputs(got, want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = load_cell(args.workload, load_json(ROOT / "BENCHMARK.json"))
    out = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        out[seed] = control_readings(cell, seed, args.device)
        print(f"control {cell['cfg']['control']} seed {seed}: {out[seed]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"workload": args.workload,
                      "control": cell["cfg"]["control"], "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
