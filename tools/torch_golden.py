"""Write the golden results the PyTorch port is held to on the card.

Runs each PHOLD slice configuration below through the JAX package's
``Engine`` (on the CPU) and writes one JSON file per configuration into
``shadow1_tpu_torch/golden/``: the configuration itself, every ``Metrics``
field, the total hop count and a SHA-256 of the per-host hop counts.
``chip_smoke.py`` builds the same experiments in the port, runs them on the
H100 and compares — the machine with the card has no JAX, so the reference
travels as these files.

    JAX_PLATFORMS=cpu python tools/torch_golden.py [NAME ...]

This script imports JAX; it lives outside ``shadow1_tpu_torch/`` because the
port never does.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "shadow1_tpu_torch" / "golden"

MS = 1_000_000

# name -> experiment spec. ``bench`` is bench.py's PHOLD workload (65,536
# hosts, 16 initial events per host, ev_cap 48, outbox_cap 24, 2 ms mean
# delay, 1 ms windows, max_rounds 128) cut to 20 windows; ``lossy`` is a
# 4,096-host PHOLD with 5 % path loss, so the loss draws of route_outbox
# decide part of the result.
CONFIGS = {
    "bench": dict(n_hosts=65536, seed=1234, latency_ns=1 * MS, loss=0.0,
                  mean_delay_ns=2.0 * MS, init_events=16, ev_cap=48,
                  outbox_cap=24, max_rounds=128, windows=20),
    "lossy": dict(n_hosts=4096, seed=7, latency_ns=1 * MS, loss=0.05,
                  mean_delay_ns=2.0 * MS, init_events=8, ev_cap=32,
                  outbox_cap=16, max_rounds=128, windows=20),
}


def hops_sha256(hops) -> str:
    """SHA-256 of the per-host hop counts as little-endian int64."""
    import numpy as np

    return hashlib.sha256(np.asarray(hops, "<i8").tobytes()).hexdigest()


def run_reference(spec: dict) -> tuple[dict, float]:
    import numpy as np

    import shadow1_tpu  # noqa: F401  (enables x64)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from shadow1_tpu.config.compiled import single_vertex_experiment
    from shadow1_tpu.consts import EngineParams
    from shadow1_tpu.core.engine import Engine

    exp = single_vertex_experiment(
        n_hosts=spec["n_hosts"], seed=spec["seed"],
        end_time=spec["windows"] * spec["latency_ns"],
        latency_ns=spec["latency_ns"], loss=spec["loss"], model="phold",
        model_cfg={"mean_delay_ns": spec["mean_delay_ns"],
                   "init_events": spec["init_events"]})
    params = EngineParams(ev_cap=spec["ev_cap"], outbox_cap=spec["outbox_cap"],
                          max_rounds=spec["max_rounds"])
    eng = Engine(exp, params)
    t0 = time.perf_counter()
    st = eng.run(n_windows=spec["windows"])
    metrics = Engine.metrics_dict(st)
    hops = np.asarray(eng.model_summary(st)["hops"])
    rec = {"config": spec, "metrics": metrics,
           "total_hops": int(hops.sum()), "hops_sha256": hops_sha256(hops),
           "reference": "shadow1_tpu Engine on the CPU"}
    return rec, time.perf_counter() - t0


def main(argv: list[str]) -> int:
    names = argv or list(CONFIGS)
    GOLDEN.mkdir(parents=True, exist_ok=True)
    for name in names:
        rec, seconds = run_reference(CONFIGS[name])
        path = GOLDEN / f"phold_{name}.json"
        path.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
        print(f"{path.relative_to(ROOT)}: {rec['metrics']['events']} events "
              f"in {seconds:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    raise SystemExit(main(sys.argv[1:]))
