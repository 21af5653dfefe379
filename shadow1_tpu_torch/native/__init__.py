"""Native thread-per-core comparator: build + run harness.

Builds ``phold_comparator.cpp`` and ``net_comparator.cpp`` with the system
g++ on first use (cached under ``build/native_torch/`` at the repo root)
and runs them on the same experiment parameters the port's engines
consume. The Q32 log2 table is dumped from the port's ``rng._LOG_TBL_NP``
so the C++ fixed-point exponential is bit-identical to both engines (no
libm rounding drift can enter).

This is the honest baseline BASELINE.json names ("thread-per-core CPU
scheduler", reference scheduler-policy-host-steal.c): an optimized
multi-core C++ DES, not the interpreted oracle.
tests/test_torch_native.py asserts counter equality against the oracle,
which is what entitles a benchmark to divide by its wall clock.

Every file is written under a temporary name and moved into place with
``os.replace``, so two processes building at once never see a torn
binary or table.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_REPO = _DIR.parent.parent
_BUILD = _REPO / "build" / "native_torch"
_BIN = _BUILD / "phold_comparator"
_NET_BIN = _BUILD / "net_comparator"
_TABLE = _BUILD / "log2_q32.tbl"
_RNG_SRC = _DIR.parent / "rng.py"


class NativeUnavailable(RuntimeError):
    pass


def _tmp(path: pathlib.Path) -> pathlib.Path:
    """A name of this process's and thread's own beside ``path``."""
    import threading

    return path.with_name(
        f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")


def _dump_table() -> None:
    from shadow1_tpu_torch import rng

    tbl = np.asarray(rng._LOG_TBL_NP, np.uint64)
    assert tbl.shape == (2**rng._LOG_BITS + 1,)
    tmp = _tmp(_TABLE)
    with open(tmp, "wb") as f:
        f.write(tbl.tobytes())
        f.write(np.uint64(rng._LN2_Q32).tobytes())
    os.replace(tmp, _TABLE)


def _ensure(binary: pathlib.Path, src: pathlib.Path,
            force: bool) -> pathlib.Path:
    """Build ``src`` into ``binary`` unless it is newer than the source;
    re-dump the table when ``rng.py`` is newer than it (a stale table
    would make the comparator silently differ from the engines)."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    if (force or not _TABLE.exists()
            or _TABLE.stat().st_mtime < _RNG_SRC.stat().st_mtime):
        _dump_table()
    if (not force and binary.exists()
            and binary.stat().st_mtime >= src.stat().st_mtime):
        return binary
    tmp = _tmp(binary)
    cmd = ["g++", "-O2", "-std=c++17", "-pthread", "-o", str(tmp), str(src)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        raise NativeUnavailable(f"g++ unavailable: {e!r}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"g++ failed: {out.stderr[-800:]}")
    os.replace(tmp, binary)
    return binary


def ensure_built(force: bool = False) -> pathlib.Path:
    return _ensure(_BIN, _DIR / "phold_comparator.cpp", force)


def ensure_net_built(force: bool = False) -> pathlib.Path:
    return _ensure(_NET_BIN, _DIR / "net_comparator.cpp", force)


def run_phold(
    n_hosts: int,
    seed: int,
    n_windows: int,
    window_ns: int,
    mean_delay_ns: float,
    init_events: int,
    ev_cap: int,
    outbox_cap: int,
    n_threads: int | None = None,
    timeout_s: float = 900.0,
) -> dict:
    """Run the comparator; returns its counters + wall_s + events_per_sec."""
    binary = ensure_built()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    cmd = [
        str(binary), str(_TABLE), str(n_hosts), str(seed), str(n_windows),
        str(window_ns), str(int(round(mean_delay_ns))), str(init_events),
        str(ev_cap), str(outbox_cap), str(n_threads),
    ]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
    if out.returncode != 0:
        raise NativeUnavailable(
            f"comparator rc={out.returncode}: {out.stderr[-500:]}"
        )
    return json.loads(out.stdout.strip().splitlines()[-1])


_NET_MAGIC = 0x53484457434D5032


def dump_net_config(exp, params, n_windows: int, path: str) -> None:
    """Serialize a net-model CompiledExperiment for the C++ comparator.

    Refuses configs using fidelity knobs the comparator does not mirror
    (stop/cpu/qlen/aqm) — silent divergence would be worse than no
    baseline. The layout matches read_config in net_comparator.cpp."""
    from shadow1_tpu_torch import rng

    for knob, name in (
        (np.asarray(exp.stop_time).min() < (1 << 62), "host stop times"),
        (getattr(exp, "faults", None) is not None, "fault schedule"),
        (np.asarray(exp.cpu_ns_per_event).max() > 0, "virtual CPU"),
        (np.asarray(exp.tx_qlen_bytes).max() > 0, "tx queue bound"),
        (np.asarray(exp.rx_qlen_bytes).max() > 0, "rx queue bound"),
        (np.asarray(exp.aqm_max_bytes).max() > 0, "RED AQM"),
    ):
        if knob:
            raise NativeUnavailable(
                f"net comparator does not model {name}; config refused"
            )
    assert exp.model == "net"
    cfg = exp.model_cfg
    app = cfg["app"]
    h = exp.n_hosts
    pr = params
    lat = np.asarray(exp.lat_vv, np.int64)
    V = lat.shape[0]
    jit = np.asarray(exp.jitter_vv, np.int64)
    loss_thr = rng.prob_threshold(np.asarray(exp.loss_vv))
    z = np.zeros(0, np.int64)
    u0 = np.zeros(0, np.uint64)

    def rounded_mean(x):
        return np.round(np.asarray(x, np.float64)).astype(np.uint64)

    a = {i: z for i in range(5)}
    m0 = m1 = u0
    s = [0, 0, 0, 0, 0]
    tids = [z, z, z, z]
    tcum = [z, z, z]
    peers = z
    if app == "filexfer":
        app_id = 1
        a = {0: cfg["role"], 1: cfg["server"], 2: cfg["flow_bytes"],
             3: cfg["start_time"], 4: cfg["flow_count"]}
    elif app == "tgen":
        app_id = 2
        mb = np.asarray(cfg["mean_bytes"], np.float64)
        a = {0: cfg["active"], 1: cfg["streams"], 2: z, 3: cfg["start_time"],
             4: np.maximum(mb.astype(np.int64), 1)}
        m0, m1 = rounded_mean(mb), rounded_mean(cfg["mean_think_ns"])
        s[0] = 1 if cfg.get("fixed_size") else 0
    elif app == "tor":
        from shadow1_tpu_torch.apps.tor import _build_tables

        app_id = 3
        t = _build_tables(cfg)
        a = {0: cfg["role"], 1: cfg["n_circuits"], 2: cfg["n_streams"],
             3: cfg["start_time"], 4: z}
        m0 = rounded_mean(cfg["mean_stream_cells"])
        m1 = rounded_mean(cfg["mean_think_ns"])
        s[0] = int(cfg.get("consensus_bytes", 2048))
        s[1] = int(cfg.get("cells_max", 120))
        s[2] = int(cfg.get("ct_cap", 64))
        tids = [t["guard_ids"], t["exit_ids"], t["relay_ids"], t["dir_ids"]]
        tcum = [t["guard_cum"], t["exit_cum"], t["relay_cum"]]
    elif app == "bitcoin":
        app_id = 4
        p2 = np.asarray(cfg["peers"], np.int64)
        a = {0: cfg["tx_origin"], 1: cfg["tx_time"], 2: z, 3: z, 4: z}
        s[0] = int(cfg.get("tx_size", 400))
        s[1] = int(cfg.get("inv_size", 36))
        s[2] = int(cfg.get("connect_time", 0))
        s[3] = p2.shape[1]
        s[4] = len(np.asarray(cfg["tx_origin"]))
        peers = p2.reshape(-1)
    else:
        raise NativeUnavailable(f"net comparator: unknown app {app!r}")

    def w_i64(f, x):
        f.write(np.asarray(x, np.int64).tobytes())

    def w_vec(f, x, dt=np.int64):
        arr = np.asarray(x, dt)
        w_i64(f, arr.size)
        f.write(arr.tobytes())

    with open(path, "wb") as f:
        f.write(np.uint64(_NET_MAGIC).tobytes())
        for v in (h, exp.seed, exp.window, n_windows, pr.ev_cap,
                  pr.outbox_cap, pr.sockets_per_host, pr.msgq_cap,
                  pr.send_burst, pr.mss, pr.init_cwnd_mss, pr.sndbuf,
                  pr.rcvbuf, pr.rto_min, pr.rto_max, pr.rto_init,
                  pr.dupack_thresh, V, int(jit.max() > 0), app_id):
            w_i64(f, v)
        w_vec(f, lat.reshape(-1))
        w_vec(f, jit.reshape(-1))
        w_vec(f, loss_thr.reshape(-1), np.uint64)
        w_vec(f, exp.host_vertex)
        w_vec(f, exp.bw_up)
        w_vec(f, exp.bw_dn)
        for i in range(5):
            w_vec(f, a[i])
        w_vec(f, m0, np.uint64)
        w_vec(f, m1, np.uint64)
        for v in s:
            w_i64(f, v)
        w_vec(f, tids[0]); w_vec(f, tcum[0])
        w_vec(f, tids[1]); w_vec(f, tcum[1])
        w_vec(f, tids[2]); w_vec(f, tcum[2])
        w_vec(f, tids[3])
        w_vec(f, peers)


def run_net(exp, params, n_windows: int, n_threads: int | None = None,
            timeout_s: float = 3600.0) -> dict:
    """Run the net comparator on a CompiledExperiment; returns counters +
    wall_s + events_per_sec (bit-identical counters to both engines)."""
    import tempfile

    binary = ensure_net_built()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    with tempfile.NamedTemporaryFile(suffix=".blob", delete=False) as tf:
        blob = tf.name
    try:
        dump_net_config(exp, params, n_windows, blob)
        cmd = [str(binary), str(_TABLE), blob, str(n_threads)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=timeout_s)
        except subprocess.TimeoutExpired as e:
            raise NativeUnavailable(
                f"net comparator exceeded {timeout_s:.0f}s"
            ) from e
        if out.returncode != 0:
            raise NativeUnavailable(
                f"net comparator rc={out.returncode}: {out.stderr[-500:]}"
            )
        try:
            return json.loads(out.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError) as e:
            raise NativeUnavailable(
                f"net comparator produced no result line: {e!r}"
            ) from e
    finally:
        os.unlink(blob)

