"""Device-fault bisection probes (port of ``tools/faultprobe.py``).

    python -m shadow1_tpu_torch.tools.faultprobe [probe ...] [--device DEV]
        [--tor-config PATH]

When a run dies on the card (a CUDA error, a sticky fault, a hang the
supervisor's watchdog killed), these probes isolate the device code the
round path runs, each in a few seconds. Every probe runs on CUDA unless
``--device cpu`` is given; with no card and no ``--device cpu`` the probe
exits non-zero (``core/engine.py resolve_device``), and it refuses any
other device: a CPU "ok" tells nothing about a device fault. The first
JSON line names the device the probes ran on.

* ``sort0``   — the arrival batching's ordering: the two stable
                ``torch.sort`` passes along axis 0 (tie-break, then time;
                ``net/__init__.py make_pre_window``), checked to order
                (time, tie-break) lexicographically;
* ``scan0``   — the arrival batching's clock recurrence in its
                ``torch.cummax`` max-plus closed form, checked against the
                sequential recurrence;
* ``pop``     — ``push_local`` then ``pop_until`` on a [C, H] event
                buffer: the push and pop kernels on CUDA;
* ``phold``   — 20 + 40 engine windows at [1000, 256] (prints ms per
                round): all three kernels;
* ``tor N``   — N windows of the rung-3 Tor config (default 50); the card
                has no YAML parser, so pass ``--tor-config`` a JSON mirror
                of ``configs/rung3_tor1k.yaml`` there.

The reference's ``sort0`` and ``scan0`` probe XLA's 3-key ``lax.sort`` and
``associative_scan``, which the port does not use; the port keeps the
names and probes its own counterparts of them, at the same [256, 1000]
shape. Each probe's line carries the kernel launches it made
(``popk.LAUNCHES``). Run probes in order; the first to fail identifies the
culprit. After a sticky CUDA fault, run again from a fresh process.
"""

from __future__ import annotations

import json
import sys
import time

H, C = 1000, 256
TOR_CONFIG = "configs/rung3_tor1k.yaml"


def parse_probes(args: list[str]) -> list[tuple[str, int]]:
    """Positional probe list; ``tor`` may be followed by a window count."""
    todo: list[tuple[str, int]] = []
    i = 0
    while i < len(args):
        name, n = args[i], 0
        if name == "tor" and i + 1 < len(args) and args[i + 1].isdigit():
            n = int(args[i + 1])
            i += 1
        todo.append((name, n))
        i += 1
    return todo


def pop_inputs(device):
    """The ``pop`` probe's inputs: an empty [C, H] event buffer and one
    event per host (time 0, kind 1, zero payload)."""
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core.events import evbuf_init

    buf = evbuf_init(H, C, device)
    mask = torch.ones(H, dtype=torch.bool, device=device)
    t = torch.zeros(H, dtype=torch.int64, device=device)
    kind = torch.full((H,), 1, dtype=torch.int32, device=device)
    p = torch.zeros((NP, H), dtype=torch.int32, device=device)
    until = torch.tensor(10, dtype=torch.int64, device=device)
    return buf, mask, t, kind, p, until


def pop_probe(device):
    """``push_local`` then ``pop_until`` through the kernels' wrappers
    (``core/popk.py``): returns (buffer, popped event)."""
    from shadow1_tpu_torch.core.popk import pop_until, push_local

    buf, mask, t, kind, p, until = pop_inputs(device)
    buf, _ = push_local(buf, mask, t, kind, p)
    return pop_until(buf, until)


def _sort0(dev, g) -> dict:
    import torch

    t = torch.as_tensor(g.integers(0, 1 << 40, (C, H)), device=dev)
    tb = torch.as_tensor(g.integers(0, 1 << 40, (C, H)), device=dev)
    perm = torch.sort(tb, dim=0, stable=True).indices
    perm = perm.gather(0, torch.sort(t.gather(0, perm), dim=0,
                                     stable=True).indices)
    ts, tbs = t.gather(0, perm), tb.gather(0, perm)
    ordered = (ts[1:] > ts[:-1]) | ((ts[1:] == ts[:-1]) & (tbs[1:] >= tbs[:-1]))
    if not bool(ordered.all()):
        raise AssertionError("sort0: (time, tie-break) not in order")
    return {}


def _scan0(dev, g) -> dict:
    import numpy as np
    import torch

    t = np.sort(g.integers(0, 1 << 30, (C, H)), axis=0)
    ser = g.integers(1, 1 << 20, (C, H))
    free0 = g.integers(0, 1 << 30, H)
    tt, st = torch.as_tensor(t, device=dev), torch.as_tensor(ser, device=dev)
    p_pre = torch.cumsum(st, dim=0)
    free = p_pre + torch.maximum(torch.as_tensor(free0, device=dev)[None, :],
                                 torch.cummax(tt + st - p_pre, dim=0).values)
    ref, prev = np.empty_like(t), free0
    for j in range(C):
        prev = ref[j] = np.maximum(prev, t[j]) + ser[j]
    if not np.array_equal(free.cpu().numpy(), ref):
        raise AssertionError("scan0: the cummax form differs from the "
                             "sequential recurrence")
    return {}


def _pop(dev, g) -> dict:
    from shadow1_tpu_torch.consts import K_NONE

    buf, ev = pop_probe(dev)
    if not bool((ev.kind == 1).all()) or bool((buf.kind != K_NONE).any()):
        raise AssertionError("pop: the pushed event did not come back out")
    return {}


def _phold(dev, g) -> dict:
    from shadow1_tpu_torch.config.compiled import single_vertex_experiment
    from shadow1_tpu_torch.consts import MS, EngineParams
    from shadow1_tpu_torch.core.engine import Engine

    exp = single_vertex_experiment(
        n_hosts=H, seed=77, end_time=10**12, latency_ns=30 * MS,
        model="phold",
        model_cfg={"mean_delay_ns": float(60 * MS), "init_events": 4})
    eng = Engine(exp, EngineParams(ev_cap=C), device=dev)
    st = eng.run(eng.init_state(), n_windows=20)
    eng.synchronize()
    r0 = int(st.metrics.rounds)
    t1 = time.perf_counter()
    st = eng.run(st, n_windows=40)
    eng.synchronize()
    wall = time.perf_counter() - t1
    r = int(st.metrics.rounds) - r0
    return {"ms_per_round": round(1000 * wall / max(r, 1), 3), "rounds": r,
            "events": int(st.metrics.events)}


def _tor(dev, n: int, config: str) -> dict:
    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.core.engine import Engine

    exp, params, _ = load_experiment(config)
    eng = Engine(exp, params, device=dev)
    st = eng.run(eng.init_state(), n_windows=n)
    eng.synchronize()
    return {"windows": n, "events": int(st.metrics.events)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.faultprobe")
    ap.add_argument("probes", nargs="*",
                    help="sort0, scan0, pop, phold, tor [N] (default: "
                         "sort0 scan0 pop phold)")
    ap.add_argument("--device", default=None,
                    help="CUDA device (default: cuda, which must be "
                         "present) or cpu")
    ap.add_argument("--tor-config", default=TOR_CONFIG,
                    help="the tor probe's config (YAML or JSON)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}), flush=True)
        return 1
    if dev.type not in ("cuda", "cpu") or (
            dev.type == "cpu" and args.device != "cpu"):
        print(json.dumps({"error": f"device {str(dev)!r}: the probes run "
                                   "on CUDA, or on the CPU with --device "
                                   "cpu"}), flush=True)
        return 1
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(json.dumps({"backend": dev.type, "device": str(dev),
                      "name": name}), flush=True)
    if dev.type == "cuda":
        from shadow1_tpu_torch.core import _build

        _build.library()
    g = np.random.default_rng(0)
    probes = {"sort0": _sort0, "scan0": _scan0, "pop": _pop,
              "phold": _phold}
    for probe, probe_n in parse_probes(args.probes
                                       or ["sort0", "scan0", "pop", "phold"]):
        if probe != "tor" and probe not in probes:
            print(json.dumps({"error": f"unknown probe {probe!r}"}))
            return 2
        for k in popk.LAUNCHES:
            popk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        try:
            out = (_tor(dev, probe_n or 50, args.tor_config)
                   if probe == "tor" else probes[probe](dev, g))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except Exception as e:  # noqa: BLE001 — the verdict names it
            print(json.dumps({"probe": probe, "ok": False,
                              "error": f"{type(e).__name__}: {e}"[:2000]}),
                  flush=True)
            return 1
        print(json.dumps({
            "probe": probe, "ok": True, **out,
            "launches": dict(popk.LAUNCHES),
            "wall_s": round(time.perf_counter() - t0, 2),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
