"""Write the golden results the PyTorch port is held to on the card.

Runs each slice configuration below through the JAX package's ``Engine``
(on the CPU) and writes one JSON file per configuration into
``shadow1_tpu_torch/golden/``:

* PHOLD (``phold_<name>.json``): the configuration itself, every
  ``Metrics`` field, the total hop count and a SHA-256 of the per-host hop
  counts;
* the net model (``net_<name>.json``): the experiment's arrays, or the
  ``config/compiled.py`` builder call that makes them, with a SHA-256 of
  those arrays; every ``Metrics`` field; the summary (each entry summed
  over hosts); a SHA-256 of each per-host summary array; and the
  per-window state-digest words (a run with ``state_digest=1``), 5 per
  window in ``core/digest.py``'s subsystem order. The run must be
  overflow-free.

* the observability planes (``net_<name>_obs.json``, ``OBS_CONFIGS``): a
  net golden's experiment with flow probes and the link accumulator on,
  drained at the chunk boundaries the spec lists; the SHA-256 and count of
  the ``flow`` records and of the ``link`` records (each record as
  ``json.dumps(rec, sort_keys=True)``, one per line), and the final link
  snapshot's column totals;
* the fleet (``fleet_<name>.json``, ``FLEET_CONFIGS``): the JAX package's
  ``FleetEngine`` over a sweep built in code by ``config/compiled.py``;
  per lane its label, every ``Metrics`` field, the SHA-256 of each
  per-host summary array and the per-window digest words;
* a snapshot (``ckpt_<name>.npz``, ``CKPT_CONFIGS``): the JAX package's
  ``ckpt.save_state`` of a YAML config's state at a window, with the
  telemetry ring and the digest words on;
* the sharded engine (``shard<D>_<name>.json``, ``SHARD_CONFIGS``): a net
  golden's experiment through the JAX package's ``ShardedEngine`` over D
  CPU devices, recorded as a net golden is (``rounds`` and
  ``round_cap_hits`` are the per-shard sums; every other field equals the
  solo golden's);
* the oracle's tools (``oracle_tools.json``): the JAX package's
  ``pcapdump`` (the SHA-256 and size of each ``.pcap``), ``activeprobe``,
  ``depthprobe`` and ``occprobe`` (their JSON rows, ``config`` left out)
  and ``fleetprobe`` (its verdicts)
  on the JSON mirrors ``chip_smoke.oracle_configs`` writes, with the
  arguments ``chip_smoke.py`` phase 18 gives the port's tools (occprobe
  on dense_tgen50k's 50,000 hosts takes a few minutes).

``chip_smoke.py`` builds the same experiments in the port, runs them on the
H100 and compares — the machine with the card has no JAX, so the reference
travels as these files.

    JAX_PLATFORMS=cpu python tools/torch_golden.py [NAME ...]

Names: ``bench``, ``lossy`` (PHOLD), ``filexfer16k``, ``rung1``,
``tgen50k``, ``rung2``, ``tor10k``, ``dgram4k``, ``bitcoin5k``, ``churn8``,
``fidelity16k`` (net), ``shard2_filexfer16k`` (the sharded engine over 2
devices), ``fidelity16k_obs`` (the planes; ~8 minutes),
``ckpt_churn8_w75`` (the snapshot; seconds), ``fleet_sweep_phold`` (the
fleet; seconds) and ``oracle_tools``. ``filexfer16k``
(16,384 hosts) takes about 35 minutes on 8 CPU cores; each golden records
its own wall time and peak memory.

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


# name -> net experiment spec: ``build`` names a builder of the port's
# ``config/compiled.py`` and its arguments (the experiment is made in code:
# the card has neither YAML nor GraphML), ``yaml`` a config carried as its
# compiled arrays; ``params`` are the EngineParams fields the config sets.
#
# * ``filexfer16k``: the host layout of configs/churn_filexfer.yaml (its
#   faults: left out) tiled 2,048 times, cut to 20 windows (0.8 s);
# * ``rung1``: configs/rung1_filexfer.yaml whole (500 windows);
# * ``tgen50k``: configs/dense_tgen50k.yaml at its full width (50,000
#   hosts), cut to 20 windows (0.2 s);
# * ``rung2``: configs/rung2_tgen100.yaml, cut to 150 windows (3 s); the
#   card also runs it with ``compact_cap`` 48 (``compact_caps``), against
#   the same golden;
# * ``tor10k``: configs/rung4_tor10k.yaml at its full width (10,000 hosts,
#   compact_cap 1280), cut to 40 windows (1.2 s), a depth at which clients
#   have received cells;
# * ``dgram4k``: a 4,096-host dgram ring (20 datagrams of 1,200 B every
#   2 ms to the next host, 10 ms paths with 1 % loss), 20 windows;
# * ``bitcoin5k``: configs/rung5_bitcoin5k.yaml at its full width (5,000
#   hosts), cut to 60 windows (3 s): the first transaction is created in
#   window 40, and the flood of the first ones must show;
# * ``churn8``: configs/churn_filexfer.yaml whole, its faults: included
#   (150 windows);
# * ``fidelity16k``: filexfer16k's layout with every fidelity gate on
#   (``fidelity_filexfer_experiment``: NIC queue bounds, RED AQM, the
#   virtual CPU, jitter and the fault plane), 11 windows of 39 ms (the
#   1 ms jitter shortens the window; the last restart is at 390 ms).
#
# ``at_least`` gives a least value for summary entries (summed over hosts)
# or metrics at the end: a golden too short to reach the path it is meant
# to check, a gate that must fire or a flood that must spread fails.
NET_CONFIGS = {
    "filexfer16k": dict(build={"tiled_filexfer_experiment": dict(
                            n_groups=2048, seed=42, end_time=20 * 40 * MS)},
                        params=dict(ev_cap=512), windows=20),
    "rung1": dict(yaml="configs/rung1_filexfer.yaml", windows=500),
    "tgen50k": dict(build={"tgen_experiment": dict(
                        n_hosts=50_000, seed=71, end_time=20 * 10 * MS,
                        latency_ns=10 * MS, bw_bits=20_000_000,
                        streams=1_000_000, mean_bytes=30e6,
                        mean_think_ns=50.0 * MS, start_time=10 * MS,
                        fixed_size=True)},
                    params=dict(ev_cap=96, outbox_cap=32, sockets_per_host=8,
                                msgq_cap=4, max_rounds=512, rcvbuf=16384),
                    windows=20),
    "rung2": dict(build={"tgen_experiment": dict(
                      n_hosts=100, seed=22, end_time=150 * 20 * MS,
                      latency_ns=20 * MS, bw_bits=10_000_000, streams=5,
                      mean_bytes=100000.0, mean_think_ns=500.0 * MS,
                      start_time=1 * MS)},
                  params=dict(ev_cap=512, sockets_per_host=32),
                  windows=150, compact_caps=[0, 48]),
    "tor10k": dict(build={"tor_experiment": dict(
                       n_guard=300, n_middle=500, n_exit=200, n_dirauth=10,
                       n_client=8990, seed=44, end_time=40 * 30 * MS,
                       latency_ns=30 * MS, relay_bw=200_000_000,
                       client_bw=20_000_000, n_circuits=2, n_streams=3,
                       mean_stream_cells=40.0, mean_think_ns=5000.0 * MS,
                       start_time=200 * MS, client_interval=2 * MS,
                       ct_cap=1024)},
                   params=dict(ev_cap=256, sockets_per_host=128, msgq_cap=64,
                               max_rounds=1024, compact_cap=1280),
                   windows=40, at_least={"total_cells_rx": 1}),
    "bitcoin5k": dict(build={"bitcoin_experiment": dict(
                          n_hosts=5000, seed=55, end_time=60_000 * MS,
                          latency_ns=50 * MS, bw_bits=50_000_000, k=8,
                          n_tx=200, tx_start=2000 * MS, tx_interval=250 * MS)},
                      params=dict(ev_cap=96, sockets_per_host=32, msgq_cap=64,
                                  max_rounds=1024),
                      windows=60,
                      at_least={"total_tx_rx": 1, "total_seen": 5}),
    "churn8": dict(yaml="configs/churn_filexfer.yaml", windows=150,
                   at_least={"host_restarts": 3, "link_down_pkts": 1}),
    "fidelity16k": dict(build={"fidelity_filexfer_experiment": dict(
                            n_groups=2048, seed=42, end_time=400 * MS)},
                        params=dict(ev_cap=512), windows=11,
                        at_least={"nic_tx_drops": 1, "nic_rx_drops": 1,
                                  "nic_aqm_drops": 1, "down_pkts": 1,
                                  "link_down_pkts": 1,
                                  "host_restarts": 3 * 2048,
                                  "fires_pkt": 1}),
    "dgram4k": dict(build={"dgram_ring_experiment": dict(
                        n_hosts=4096, seed=5, end_time=20 * 10 * MS,
                        latency_ns=10 * MS, loss=0.01, payload=1200,
                        interval=2 * MS, count=20, start_time=1 * MS)},
                    params={}, windows=20, at_least={"total_rx": 1}),
}


# name -> observability spec: ``base`` is the net golden whose experiment
# and params it takes; ``probes`` the watched (host, sock) pairs; the run
# drains at the end of each chunk of ``chunks`` windows. ``at_least`` gives
# a least value for the final link snapshot's column totals.
#
# * ``fidelity16k_obs``: fidelity16k with 8 probes (the first tile's server
#   as a host and its first accepted connection, clients with flows —
#   hosts 2 and 3 go down and restart, and clients' uplinks drop — one
#   client in the middle tile and the last host as a host) and the link
#   accumulator, in chunks of 3 windows (the card resumes at window 6).
OBS_CONFIGS = {
    "fidelity16k_obs": dict(
        base="fidelity16k",
        probes=[[0, -1], [0, 1], [1, 0], [2, 0], [3, 0], [7, 0],
                [8193, 0], [16383, -1]],
        chunks=[3, 3, 3, 2],
        at_least={"loss_drops": 1, "link_down_drops": 1,
                  "nic_backlog_drops": 1}),
}

# name -> snapshot spec: ``yaml`` the config, ``window`` where the JAX run
# stops and saves; the run has a ``ring_windows`` telemetry ring and the
# digest words on.
#
# * ``ckpt_churn8_w75``: configs/churn_filexfer.yaml (the churn8 golden's)
#   at window 75 of 150, between the restarts and the link outage.
CKPT_CONFIGS = {
    "ckpt_churn8_w75": dict(yaml="configs/churn_filexfer.yaml", window=75,
                            ring_windows=150),
}


def records_sha256(recs) -> str:
    """SHA-256 of JSONL records, each as ``json.dumps(rec, sort_keys=True)``
    on its own line (the form ``chip_smoke.py`` hashes)."""
    return hashlib.sha256("".join(
        json.dumps(r, sort_keys=True) + "\n" for r in recs).encode()
    ).hexdigest()


def jax_experiment_from_builder(build: dict):
    """A port ``config/compiled.py`` builder call, as the JAX package's
    CompiledExperiment (the fault schedule as its own)."""
    import dataclasses

    from shadow1_tpu.config import compiled as cj

    from shadow1_tpu_torch.config import compiled as ct

    (builder, kwargs), = build.items()
    exp_t = getattr(ct, builder)(**kwargs)
    exp = cj.CompiledExperiment(**{
        f.name: getattr(exp_t, f.name)
        for f in dataclasses.fields(cj.CompiledExperiment)})
    # The reference memoizes caches into model_cfg; keep the port's dict
    # as built.
    exp.model_cfg = dict(exp.model_cfg)
    if exp_t.faults is not None:
        from shadow1_tpu.fault.schedule import FaultSchedule

        exp.faults = FaultSchedule(**dataclasses.asdict(exp_t.faults))
    return exp


def run_obs_reference(spec: dict) -> tuple[dict, float]:
    import resource

    import shadow1_tpu  # noqa: F401  (enables x64)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from shadow1_tpu.consts import EngineParams
    from shadow1_tpu.core.engine import Engine
    from shadow1_tpu.telemetry.links import drain_links
    from shadow1_tpu.telemetry.probes import drain_probes
    from shadow1_tpu.telemetry.registry import LINK_FIELDS

    base = NET_CONFIGS[spec["base"]]
    exp = jax_experiment_from_builder(base["build"])
    windows = sum(spec["chunks"])
    assert windows == base["windows"], (windows, base["windows"])
    probes = tuple(tuple(p) for p in spec["probes"])
    params = EngineParams(**base["params"], metrics_ring=windows,
                          state_digest=1, probes=probes, link_telem=1)
    eng = Engine(exp, params)
    t0 = time.perf_counter()
    st, done, flows, links = eng.init_state(), 0, [], []
    for n in spec["chunks"]:
        st = eng.run(st, n_windows=n)
        flows += drain_probes(st, eng.window, probes, start=done)
        links += drain_links(st, eng.window, start=done)
        done += n
    seconds = time.perf_counter() - t0
    metrics = Engine.metrics_dict(st)
    for k in ("ev_overflow", "ob_overflow", "round_cap_hits"):
        assert metrics[k] == 0, f"golden run overflowed: {k} = {metrics[k]}"
    last = [r for r in links if r["window"] == windows - 1]
    totals = {f: sum(r[f] for r in last) for f in LINK_FIELDS}
    low = {k: (totals[k], n) for k, n in spec["at_least"].items()
           if totals[k] < n}
    assert not low, f"golden run: (value, least) {low}"
    assert all(r["type"] == "flow" for r in flows)
    assert len(flows) == windows * len(probes)
    rec = {
        "base": spec["base"], "probes": spec["probes"],
        "chunks": spec["chunks"], "windows": windows,
        "flow_count": len(flows), "flow_sha256": records_sha256(flows),
        "link_count": len(links), "link_sha256": records_sha256(links),
        "link_totals": totals, "at_least": spec["at_least"],
        "reference": "shadow1_tpu Engine on the CPU",
        "reference_seconds": round(seconds, 1),
        "reference_max_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss // 1024,
    }
    return rec, seconds


def write_ckpt_reference(spec: dict, path: Path) -> float:
    import dataclasses

    import shadow1_tpu  # noqa: F401  (enables x64)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from shadow1_tpu.ckpt import save_state
    from shadow1_tpu.config.experiment import load_experiment
    from shadow1_tpu.core.engine import Engine

    exp, params, _ = load_experiment(str(ROOT / spec["yaml"]))
    params = dataclasses.replace(params, metrics_ring=spec["ring_windows"],
                                 state_digest=1)
    t0 = time.perf_counter()
    st = Engine(exp, params).run(n_windows=spec["window"])
    save_state(st, str(path))
    return time.perf_counter() - t0


# name -> (config/compiled.py builder, windows): the fleet goldens.
FLEET_CONFIGS = {
    "fleet_sweep_phold": ("sweep_phold_experiments", 20),
}


def run_fleet_reference(builder: str, windows: int) -> tuple[dict, float]:
    import dataclasses

    import numpy as np

    import shadow1_tpu  # noqa: F401  (enables x64)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from shadow1_tpu.config import compiled as cj
    from shadow1_tpu.consts import EngineParams
    from shadow1_tpu.fault.schedule import FaultSchedule
    from shadow1_tpu.fleet.engine import FleetEngine

    from shadow1_tpu_torch.config import compiled as ct

    exps_t, params_t, max_rounds, labels = getattr(ct, builder)()
    exps = []
    for e in exps_t:
        exp = cj.CompiledExperiment(**{
            f.name: getattr(e, f.name)
            for f in dataclasses.fields(cj.CompiledExperiment)})
        exp.model_cfg = dict(exp.model_cfg)
        if e.faults is not None:
            exp.faults = FaultSchedule(**dataclasses.asdict(e.faults))
        exps.append(exp)
    params = EngineParams(**dataclasses.asdict(params_t))
    params = dataclasses.replace(params, metrics_ring=windows, state_digest=1)
    eng = FleetEngine(exps, params, max_rounds)
    t0 = time.perf_counter()
    st = eng.run(n_windows=windows)
    per = FleetEngine.metrics_per_exp(st)
    seconds = time.perf_counter() - t0
    rows = eng.drain_rings(st)
    fields = ["dg_evbuf", "dg_outbox", "dg_tcp", "dg_nic", "dg_rng"]
    lanes = []
    for e, label in enumerate(labels):
        summ = {k: np.asarray(v) for k, v in eng.model_summary(st, e).items()}
        mine = [r for r in rows if r["exp"] == e and r["type"] == "ring"]
        assert len(mine) == windows
        lanes.append(dict(
            label=label, metrics=per[e],
            sha256={k: array_sha256(v) for k, v in summ.items() if v.ndim},
            digests=[[r[f] for f in fields] for r in mine]))
    return dict(builder=builder, windows=windows, max_rounds=max_rounds,
                digest_fields=fields, lanes=lanes,
                reference="shadow1_tpu FleetEngine on the CPU",
                reference_seconds=round(seconds, 1)), seconds


def array_sha256(a) -> str:
    """SHA-256 of an integer array as little-endian int64."""
    import numpy as np

    return hashlib.sha256(np.asarray(a, "<i8").tobytes()).hexdigest()


# name -> (NET_CONFIGS entry, device count): the JAX ShardedEngine over
# that many CPU devices (the script asks XLA for them before JAX loads).
SHARD_CONFIGS = {
    "shard2_filexfer16k": ("filexfer16k", 2),
}


def run_net_reference(spec: dict, n_dev: int = 0) -> tuple[dict, float]:
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
        (builder, kwargs), = spec["build"].items()
        exp_t = getattr(ct, builder)(**kwargs)
        exp = cj.CompiledExperiment(**{
            f.name: getattr(exp_t, f.name)
            for f in dataclasses.fields(cj.CompiledExperiment)})
        # The reference memoizes caches into model_cfg; keep the port's
        # dict as built.
        exp.model_cfg = dict(exp.model_cfg)
        if exp_t.faults is not None:
            from shadow1_tpu.fault.schedule import FaultSchedule

            exp.faults = FaultSchedule(**dataclasses.asdict(exp_t.faults))
        params = EngineParams(**spec["params"])
        rec = {"build": spec["build"], "params": spec["params"]}
        if "compact_caps" in spec:
            rec["compact_caps"] = spec["compact_caps"]
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
    if n_dev:
        from shadow1_tpu.shard.engine import ShardedEngine

        assert len(jax.devices()) >= n_dev, jax.devices()
        eng = ShardedEngine(exp, params, devices=jax.devices()[:n_dev])
        rec["n_dev"] = n_dev
    else:
        eng = Engine(exp, params)
    t0 = time.perf_counter()
    st = eng.run(n_windows=windows)
    summ = {k: np.asarray(v) for k, v in eng.model_summary(st).items()}
    metrics = Engine.metrics_dict(st)
    seconds = time.perf_counter() - t0
    for k in ("ev_overflow", "ob_overflow", "round_cap_hits"):
        assert metrics[k] == 0, f"golden run overflowed: {k} = {metrics[k]}"
    got = {**metrics, **{k: int(v.sum()) for k, v in summ.items()}}
    low = {k: (got[k], n) for k, n in spec.get("at_least", {}).items()
           if got[k] < n}
    assert not low, f"golden run: (value, least) {low}"
    rows = drain_ring(st, eng.window)
    assert len(rows) == windows and all(r["type"] == "ring" for r in rows)
    rec.update(
        metrics=metrics,
        summary={k: int(v.sum()) for k, v in summ.items()},
        sha256={k: array_sha256(v) for k, v in summ.items() if v.ndim},
        digest_fields=["dg_evbuf", "dg_outbox", "dg_tcp", "dg_nic", "dg_rng"],
        digests=[[r[f] for f in ("dg_evbuf", "dg_outbox", "dg_tcp", "dg_nic",
                                 "dg_rng")] for r in rows],
        reference=(f"shadow1_tpu ShardedEngine over {n_dev} CPU devices"
                   if n_dev else "shadow1_tpu Engine on the CPU"),
        reference_seconds=round(seconds, 1),
        reference_max_rss_mb=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss // 1024,
    )
    return rec, seconds


def run_tools_reference() -> tuple[dict, float]:
    """The JAX package's oracle tools on phase 18's JSON mirrors, each a
    subprocess on the CPU, with phase 18's arguments."""
    import subprocess
    import tempfile

    import chip_smoke as cs

    t0 = time.perf_counter()
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}

    def tool(name, *args, check=True):
        r = subprocess.run(
            [sys.executable, "-m", f"shadow1_tpu.tools.{name}", *args],
            cwd=ROOT, env=env, capture_output=True, text=True, check=check)
        return r.stdout.strip().splitlines()[-1]

    def row(name, *args):
        rec = json.loads(tool(name, *args))
        del rec["config"]
        return {"args": list(args[1:]), "row": rec}

    with tempfile.TemporaryDirectory() as tmp:
        paths = cs.oracle_configs(Path(tmp))
        pcap = {}
        for case, args in cs.PCAP_RUNS.items():
            out = Path(tmp) / f"{case}.pcap"
            tool("pcapdump", paths["rung1"], str(out), *args)
            data = out.read_bytes()
            pcap[case] = {"args": list(args), "bytes": len(data),
                          "sha256": hashlib.sha256(data).hexdigest()}
        win = ("--windows", str(cs.ORACLE_PROBE_WINDOWS))
        fleet = {case: {"args": list(args), "verdict": json.loads(tool(
                     "fleetprobe", paths[cfg], *args, "--json-only",
                     check=False))}
                 for case, (cfg, args, _) in cs.FLEETPROBE_RUNS.items()}
        rec = {"pcap": pcap, "fleetprobe": fleet,
               "activeprobe": row("activeprobe", paths["tor10k"], *win),
               "depthprobe": row("depthprobe", paths["tor10k"], *win),
               "occprobe": row("occprobe", paths["dense_tgen50k"],
                               *cs.OCC_ARGS)}
    return rec, time.perf_counter() - t0


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    names = argv or (list(CONFIGS) + list(NET_CONFIGS) + list(OBS_CONFIGS)
                     + list(CKPT_CONFIGS) + list(FLEET_CONFIGS)
                     + list(SHARD_CONFIGS) + ["oracle_tools"])
    n_dev = max((SHARD_CONFIGS[n][1] for n in names if n in SHARD_CONFIGS),
                default=0)
    if n_dev:
        # Before JAX loads: the CPU platform with n_dev devices.
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n_dev}")
    GOLDEN.mkdir(parents=True, exist_ok=True)
    for name in names:
        if name == "oracle_tools":
            rec, seconds = run_tools_reference()
            path = GOLDEN / "oracle_tools.json"
            path.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
            print(f"{path.relative_to(ROOT)} in {seconds:.1f} s",
                  file=sys.stderr)
            continue
        if name in FLEET_CONFIGS:
            rec, seconds = run_fleet_reference(*FLEET_CONFIGS[name])
            path = GOLDEN / f"{name}.json"
            path.write_text(json.dumps(rec, sort_keys=True) + "\n")
            print(f"{path.relative_to(ROOT)}: {len(rec['lanes'])} lanes in "
                  f"{seconds:.1f} s", file=sys.stderr)
            continue
        if name in OBS_CONFIGS:
            rec, seconds = run_obs_reference(OBS_CONFIGS[name])
            path = GOLDEN / f"net_{name}.json"
            path.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
            print(f"{path.relative_to(ROOT)}: {rec['flow_count']} flow and "
                  f"{rec['link_count']} link records in {seconds:.1f} s",
                  file=sys.stderr)
            continue
        if name in CKPT_CONFIGS:
            path = GOLDEN / f"{name}.npz"
            seconds = write_ckpt_reference(CKPT_CONFIGS[name], path)
            print(f"{path.relative_to(ROOT)}: {path.stat().st_size} bytes in "
                  f"{seconds:.1f} s", file=sys.stderr)
            continue
        if name in SHARD_CONFIGS:
            net, d = SHARD_CONFIGS[name]
            rec, seconds = run_net_reference(NET_CONFIGS[net], n_dev=d)
            path = GOLDEN / f"{name}.json"
            path.write_text(json.dumps(rec, sort_keys=True) + "\n")
            print(f"{path.relative_to(ROOT)}: {rec['metrics']['events']} "
                  f"events in {seconds:.1f} s", file=sys.stderr)
            continue
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
