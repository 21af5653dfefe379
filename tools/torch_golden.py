"""Write the golden results the PyTorch port is held to on the card.

Runs each slice configuration below through the JAX package's ``Engine``
(on the CPU) and writes one JSON file per configuration into
``shadow1_tpu_torch/golden/``:

* PHOLD (``phold_<name>.json``): the configuration itself, every
  ``Metrics`` field, the total hop count and a SHA-256 of the per-host hop
  counts;
* the net model (``net_<name>.json``): the experiment's arrays, or the
  ``tiled_filexfer_experiment`` call that makes them, with a SHA-256 of
  those arrays; every
  ``Metrics`` field; the scalar summary; a SHA-256 of each per-host summary
  array; and the per-window state-digest words (a run with
  ``state_digest=1``), 5 per window in ``core/digest.py``'s subsystem
  order. The run must be overflow-free.

``chip_smoke.py`` builds the same experiments in the port, runs them on the
H100 and compares — the machine with the card has no JAX, so the reference
travels as these files.

    JAX_PLATFORMS=cpu python tools/torch_golden.py [NAME ...]

Names: ``bench``, ``lossy`` (PHOLD), ``filexfer16k``, ``rung1`` (net).
``filexfer16k`` (16,384 hosts) takes about 20 minutes on 8 CPU cores.

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


# name -> net experiment spec. ``filexfer16k`` is the host layout of
# configs/churn_filexfer.yaml (its faults: left out) tiled 2,048 times,
# built by the port's ``tiled_filexfer_experiment`` and cut to 20 windows
# (0.8 s of simulated time); ``rung1`` is configs/rung1_filexfer.yaml whole
# (500 windows), carried as its compiled arrays.
NET_CONFIGS = {
    "filexfer16k": dict(build=dict(n_groups=2048, seed=42,
                                   end_time=20 * 40 * MS),
                        params=dict(ev_cap=512), windows=20),
    "rung1": dict(yaml="configs/rung1_filexfer.yaml", windows=500),
}
# Per-host summary arrays hashed into a net golden.
NET_ARRAYS = ("rx_bytes", "flows_done", "done_time", "nic_tx_bytes",
              "nic_rx_bytes")


def array_sha256(a) -> str:
    """SHA-256 of an integer array as little-endian int64."""
    import numpy as np

    return hashlib.sha256(np.asarray(a, "<i8").tobytes()).hexdigest()


def run_net_reference(spec: dict) -> tuple[dict, float]:
    import dataclasses
    import resource

    import numpy as np

    import shadow1_tpu  # noqa: F401  (enables x64)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from shadow1_tpu.config import compiled as cj
    from shadow1_tpu.config.experiment import load_experiment
    from shadow1_tpu.consts import EngineParams
    from shadow1_tpu.core.engine import Engine
    from shadow1_tpu.telemetry.ring import drain_ring

    from shadow1_tpu_torch.config import compiled as ct

    windows = spec["windows"]
    if "build" in spec:
        exp_t = ct.tiled_filexfer_experiment(**spec["build"])
        exp = cj.CompiledExperiment(**{
            f.name: getattr(exp_t, f.name)
            for f in dataclasses.fields(cj.CompiledExperiment)})
        params = EngineParams(**spec["params"])
        rec = {"build": {"tiled_filexfer_experiment": spec["build"]},
               "params": spec["params"]}
    else:
        exp, params, _ = load_experiment(str(ROOT / spec["yaml"]))
        rec = {"experiment": ct.experiment_arrays(exp),
               "params": {f.name: getattr(params, f.name)
                          for f in dataclasses.fields(params)
                          if getattr(params, f.name) != f.default}}
    rec["windows"] = windows
    rec["experiment_sha256"] = hashlib.sha256(json.dumps(
        ct.experiment_arrays(exp), sort_keys=True).encode()).hexdigest()
    params = dataclasses.replace(params, metrics_ring=windows, state_digest=1)
    eng = Engine(exp, params)
    t0 = time.perf_counter()
    st = eng.run(n_windows=windows)
    metrics = Engine.metrics_dict(st)
    seconds = time.perf_counter() - t0
    for k in ("ev_overflow", "ob_overflow", "round_cap_hits"):
        assert metrics[k] == 0, f"golden run overflowed: {k} = {metrics[k]}"
    summ = eng.model_summary(st)
    rows = drain_ring(st, eng.window)
    assert len(rows) == windows and all(r["type"] == "ring" for r in rows)
    rec.update(
        metrics=metrics,
        summary={"total_rx_bytes": int(summ["total_rx_bytes"]),
                 "total_flows_done": int(summ["total_flows_done"]),
                 "nic_tx_bytes": int(np.asarray(summ["nic_tx_bytes"]).sum()),
                 "nic_rx_bytes": int(np.asarray(summ["nic_rx_bytes"]).sum())},
        sha256={k: array_sha256(summ[k]) for k in NET_ARRAYS},
        digest_fields=["dg_evbuf", "dg_outbox", "dg_tcp", "dg_nic", "dg_rng"],
        digests=[[r[f] for f in ("dg_evbuf", "dg_outbox", "dg_tcp", "dg_nic",
                                 "dg_rng")] for r in rows],
        reference="shadow1_tpu Engine on the CPU",
        reference_seconds=round(seconds, 1),
        reference_max_rss_mb=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss // 1024,
    )
    return rec, seconds


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    names = argv or list(CONFIGS) + list(NET_CONFIGS)
    GOLDEN.mkdir(parents=True, exist_ok=True)
    for name in names:
        if name in NET_CONFIGS:
            rec, seconds = run_net_reference(NET_CONFIGS[name])
            path = GOLDEN / f"net_{name}.json"
            path.write_text(json.dumps(rec, sort_keys=True) + "\n")
            print(f"{path.relative_to(ROOT)}: {rec['metrics']['events']} "
                  f"events in {seconds:.1f} s", file=sys.stderr)
            continue
        rec, seconds = run_reference(CONFIGS[name])
        path = GOLDEN / f"phold_{name}.json"
        path.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
        print(f"{path.relative_to(ROOT)}: {rec['metrics']['events']} events "
              f"in {seconds:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    raise SystemExit(main(sys.argv[1:]))
