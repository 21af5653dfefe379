"""Op census of the window loop — a tool AND a gate (port of
``tools/opcensus.py``).

    python -m shadow1_tpu_torch.tools.opcensus           # gate vs the baseline
    python -m shadow1_tpu_torch.tools.opcensus --update  # this backend's entry
    python -m shadow1_tpu_torch.tools.opcensus smoke --sources --device cpu
    python -m shadow1_tpu_torch.tools.opcensus CONFIG --fusion  # the card

The performance attribution plane's static half (the wall-clock half is
``tools/phaseprobe.py``). A net round on the card is host-bound: it
dispatches about a thousand eager device operations at 13-26 µs of host time
each, plus a dozen synchronising device→host reads (``PERF.md`` §5). The
count of operations and reads per phase is therefore what the round's
cost follows, and the earliest warning a change can give: a handler
rewrite that doubles a pass's op count shows up here before any
benchmark moves.

* **op census** — every window phase (``core/engine.window_phases``:
  ``prepare`` / ``rounds`` / ``deliver`` / ``telem``) is counted over
  window ``WARMUP`` (8) of the config (the windows before it run
  uncounted), stage by stage; every handler pass (``h_<kind>``), the
  pop (``pop``) and the whole round (``round``) are counted over one call
  each on the frame of that window's first round. The unit is the aten
  operation one call dispatches (a ``TorchDispatchMode``; views and the
  scalar read left out), plus one per launch of a hand-written kernel:
  the kernels are called through ``ctypes`` (``core/popk.py``), which the
  dispatcher never sees, so each launch (``popk.LAUNCHES``) counts as one
  op. Beside it, the **reads**: device→host reads (``bool(tensor)``,
  ``.item()``, ``.tolist()``, ``int``/``float``/``index`` of a tensor).
  The result is ``{"ops": {...}, "reads": {...}}`` per config; the run is
  deterministic, so two runs give equal counts.
* **source table** (``--sources``) — ops grouped by the deepest frame
  inside ``shadow1_tpu_torch`` (``file.function``; kernel launches as
  ``popk.<name>_kernel``).
* **launch census** (``--fusion``, the card only) — the counterpart of
  XLA's fusion count: the CUDA kernels (and memory copies) each window
  phase launches over window ``WARMUP``, each phase in a
  ``torch.profiler`` capture of its own, beside the ``popk.LAUNCHES``
  delta of each phase. A phase is captured again (up to 3 times) when
  its counts of the three hand-written kernels fall short of those
  deltas (CUPTI drops records now and then).
* **drift gate** — without flags, measured counts compare against the
  committed baseline: any phase whose ops or reads drift more than
  ``tolerance`` (default 10 %) either way fails (exit 1), as does a
  phase that vanished or appeared. Intentional change? Override once
  with ``SHADOW1_OPCENSUS_ACCEPT="why"`` and re-baseline with
  ``--update``.
* ``--inject N`` — self-test hook: N extra ops after every round of the
  ``rounds`` phase (a round-body change; the reference adds N once to
  its traced rounds program, which runs every round), so a check can
  assert the gate actually trips and names ``rounds`` alone.

The baseline is the port's own, ``opcensus_baseline.json`` beside this
module, with one entry per config per backend (``cpu``, ``cuda``): on the
CPU the kernels run their plain versions, so the op counts differ by
backend (the reads do not). ``--update`` writes this backend's entries
and keeps the others. The repository's ``OPCENSUS.json`` (the JAX
package's jaxpr counts) is never read or written. Runs on CUDA unless
``--device`` names another device; configs are YAML or JSON (the card
has no YAML parser; the default set uses JSON mirrors).

Always prints one JSON line on stdout. Exit 0 (ok, updated, accepted, no
baseline), 1 (drift), 2 (``--fusion`` off the card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
BASELINE = os.path.join(_HERE, "opcensus_baseline.json")
TOLERANCE = 0.10
ACCEPT_ENV = "SHADOW1_OPCENSUS_ACCEPT"
# The window counted: the windows before it run uncounted, so the census
# sees a warm state (phaseprobe's default warm-up).
WARMUP = 8
UNITS = ("ops", "reads")
KERNELS = ("pop", "push", "obox")

# The gated config set: the benchgate dense-phold shape plus the rung-1
# net/TCP config (its JSON mirror) — tiny to build, but between them they
# run every handler pass, the NIC arrival batch and the TCP flush machine.
DEFAULT_CONFIGS = ("smoke",
                   "shadow1_tpu_torch/tools/benchgate_configs/"
                   "rung1_filexfer.json")
# Tensor methods that read the device from the host.
READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__")


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _source_label(frame) -> str:
    """``file.function`` of the deepest frame inside the package, from
    ``frame`` outward."""
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(_PKG + os.sep):
            base = os.path.basename(path)
            if base.endswith(".py"):
                base = base[:-3]
            if base == "__init__":
                base = os.path.basename(os.path.dirname(path))
            return f"{base}.{frame.f_code.co_name}"
        frame = frame.f_back
    return "(no source)"


class Count:
    """What one call dispatched: ``ops`` (aten ops, views and the scalar
    read left out, plus one per kernel launch), ``reads`` (device→host
    reads), ``launches`` per kernel, and with ``sources`` the ops by
    ``file.function``."""

    def __init__(self):
        self.ops = 0
        self.reads = 0
        self.launches = dict.fromkeys(KERNELS, 0)
        self.by_src: Counter = Counter()


def count_call(fn, *args, sources: bool = False):
    """(result, Count) of ``fn(*args)``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from shadow1_tpu_torch.core import popk

    scalar = torch.ops.aten._local_scalar_dense.default
    c = Count()

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (getattr(func, "is_view", False) or func is scalar):
                c.ops += 1
                if sources:
                    c.by_src[_source_label(sys._getframe(1))] += 1
            return func(*args, **(kwargs or {}))

    real = {name: getattr(torch.Tensor, name) for name in READS}
    own = {name: name in vars(torch.Tensor) for name in READS}

    def counted(method):
        def read(self, *a, **k):
            c.reads += 1
            return method(self, *a, **k)
        return read

    before = dict(popk.LAUNCHES)
    for name, method in real.items():
        setattr(torch.Tensor, name, counted(method))
    try:
        with Mode():
            out = fn(*args)
    finally:
        for name, method in real.items():
            if own[name]:
                setattr(torch.Tensor, name, method)
            else:
                delattr(torch.Tensor, name)
    for k in KERNELS:
        n = popk.LAUNCHES[k] - before[k]
        c.launches[k] = n
        c.ops += n
        if sources and n:
            c.by_src[f"popk.{k}_kernel"] += n
    return out, c


def _inject_ops(fn, n: int):
    """``fn`` (the rounds phase) with ``n`` extra adds after every round it
    runs (drift-gate self-test: what a round-body change adds). The
    engine's round loop looks ``run_round`` up in ``core/engine.py`` at
    each call; the wrapper stands there for the duration of the phase."""
    if not n:
        return fn
    from shadow1_tpu_torch.core import engine

    def wrapped(fr):
        inner = engine.run_round

        def run_round(*a, **k):
            st = inner(*a, **k)
            x = st.win_start
            for _ in range(n):
                x = x + 0
            return st._replace(win_start=x)

        engine.run_round = run_round
        try:
            return fn(fr)
        finally:
            engine.run_round = inner

    return wrapped


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def census(eng, warmup: int = WARMUP, sources: bool = False,
           fusion: bool = False, inject: int = 0) -> dict:
    """The per-config census dict: ``ops`` and ``reads`` per phase and
    handler pass (the gated numbers), ``launches`` per phase, the counted
    window (``window``: its index, rounds and events), optional
    ``sources`` per pass and, with ``fusion``, ``fusions`` per window
    phase (``count_fusions``)."""
    from shadow1_tpu_torch.consts import KIND_NAMES
    from shadow1_tpu_torch.convert import clone_state
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import run_round, window_frame
    from shadow1_tpu_torch.tools.phaseprobe import clone_tree, engine_phases

    ctx, handlers = eng.ctx, eng._handlers
    st = eng.run(eng.init_state(), n_windows=warmup)
    eng.synchronize()
    st_fusion = clone_state(st) if fusion else None
    m0 = {k: int(getattr(st.metrics, k)) for k in ("rounds", "events")}
    fr = window_frame(st, ctx)
    ops: dict[str, int] = {}
    reads: dict[str, int] = {}
    launches: dict[str, dict] = {}
    srcs: dict[str, dict] = {}
    round_in = None

    def keep(name, c):
        ops[name], reads[name] = c.ops, c.reads
        launches[name] = c.launches
        if sources:
            srcs[name] = dict(c.by_src.most_common())

    for name, fn in engine_phases(eng):
        if name == "rounds":
            round_in = clone_tree(fr)
            fn = _inject_ops(fn, inject)
        fr, c = count_call(fn, fr, sources=sources)
        keep(name, c)
    window = {"index": warmup,
              **{k: int(getattr(fr.st.metrics, k)) - m0[k] for k in m0}}

    # One call each on the frame of the counted window's first round, each
    # on a fresh clone (the kernels write their planes in place).
    st_r, win_end = round_in.st, round_in.win_end
    extract = ctx.params.pop_extract
    (buf, ev), c = count_call(popk.pop_until, clone_tree(st_r.evbuf), win_end,
                              extract, sources=sources)
    keep("pop", c)
    st_popped = st_r._replace(evbuf=buf)
    for kind, hfn in sorted(handlers.items()):
        _, c = count_call(hfn, clone_tree(st_popped), ev, sources=sources)
        keep(f"h_{KIND_NAMES.get(kind, kind)}", c)
    _, c = count_call(run_round, clone_tree(st_r), ctx, handlers, win_end,
                      sources=sources)
    keep("round", c)
    out: dict = {"ops": ops, "reads": reads, "launches": launches,
                 "window": window}
    if sources:
        out["sources"] = srcs
    if fusion:
        out["fusions"] = count_fusions(eng, st_fusion)
    return out


def device_records(events) -> dict:
    """Counts of a profiler capture's device records (``events``: the raw
    kineto events, each with ``name()`` and ``device_type()``): every CUDA
    kernel (``kernels``), memory copies and sets (``copies``: a
    device→host read is one), and the three hand-written kernels by
    name."""
    from torch.autograd.profiler import _filter_name

    out = {"kernels": 0, "copies": 0, **dict.fromkeys(KERNELS, 0)}
    for e in events:
        name = e.name()
        if not str(e.device_type()).endswith("CUDA") or _filter_name(name):
            continue
        if name.startswith(("Memcpy", "Memset")):
            out["copies"] += 1
            continue
        out["kernels"] += 1
        for k in KERNELS:
            if f"{k}_kernel" in name:
                out[k] += 1
    return out


def count_fusions(eng, st, attempts: int = 3) -> dict:
    """The CUDA kernels each window phase launches over one window from
    ``st`` (a clone is run). Each phase runs on a clone of its input frame
    inside a ``torch.profiler`` capture of its own (CUDA activity, padded
    with idle on each side, ending in a device synchronise), whose raw
    device records are counted (``device_records``) beside the phase's
    ``popk.LAUNCHES`` delta. A phase whose capture holds fewer launches of
    the three kernels than the delta is captured again from its frame, up
    to ``attempts`` times (CUPTI drops records now and then). Returns
    {"phases": {phase: device_records}, "launches": {phase: {kernel: n}},
    "attempts": {phase: n}, "seconds": {phase: wall}, "complete"}:
    ``complete`` when every phase's
    counts of the three kernels equal its deltas. The card only."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from shadow1_tpu_torch.convert import clone_state
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import window_frame
    from shadow1_tpu_torch.telemetry.profiler import WINDOW_PHASES
    from shadow1_tpu_torch.tools.phaseprobe import clone_tree, engine_phases

    if eng.device.type != "cuda":
        raise ValueError("count_fusions reads CUDA kernels from "
                         "torch.profiler captures: the card only")
    fr = window_frame(clone_state(st), eng.ctx)
    out = {"phases": {}, "launches": {}, "attempts": {}, "seconds": {},
           "complete": True}
    for name, fn in engine_phases(eng):
        t0 = time.perf_counter()
        for attempt in range(1, attempts + 1):
            fr_in = clone_tree(fr)
            eng.synchronize()
            before = dict(popk.LAUNCHES)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(0.01)
                with torch.profiler.record_function(WINDOW_PHASES[name]):
                    fr_out = fn(fr_in)
                eng.synchronize()
                time.sleep(0.01)
            delta = {k: popk.LAUNCHES[k] - before[k] for k in KERNELS}
            got = device_records(prof.profiler.kineto_results.events())
            if all(got[k] == delta[k] for k in KERNELS):
                break
        out["phases"][name], out["launches"][name] = got, delta
        out["attempts"][name] = attempt
        out["seconds"][name] = time.perf_counter() - t0
        out["complete"] &= all(got[k] == delta[k] for k in KERNELS)
        fr = fr_out
    return out


def config_label(label: str) -> str:
    """A config's baseline key: its file name less the extension."""
    for ext in (".yaml", ".yml", ".json"):
        if label.endswith(ext):
            return label[:-len(ext)]
    return label


def run_census(config: str, device=None, sources=False, fusion=False,
               inject=0):
    """(label, census dict) for "smoke" or a YAML/JSON config path."""
    from shadow1_tpu_torch.tools.phaseprobe import build_engine

    eng, label = build_engine(config, device=device)
    return config_label(label), census(
        eng, sources=sources, fusion=fusion, inject=inject)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def gate_config(measured: dict, base: dict, tol: float) -> list[str]:
    """Failure strings (empty = pass) comparing one config's measured
    ``ops`` and ``reads`` against the baseline's (each unit the baseline
    holds). Both directions are enforced: a phase that grew, shrank,
    appeared or vanished without a baseline update is drift — shrinkage is
    great news, but the baseline must say so."""
    fails = []
    for unit in UNITS:
        if unit not in base:
            continue
        b = base[unit]
        m = measured.get(unit, {})
        for phase, ref in b.items():
            if phase not in m:
                fails.append(f"phase {phase!r} vanished (baseline {ref} "
                             f"{unit})")
                continue
            if ref and abs(m[phase] - ref) / ref > tol:
                pct = 100 * (m[phase] - ref) / ref
                fails.append(f"phase {phase!r}: {m[phase]} {unit} vs "
                             f"baseline {ref} ({pct:+.1f}% > "
                             f"±{tol * 100:.0f}%)")
        for phase in m:
            if phase not in b:
                fails.append(f"new phase {phase!r} ({m[phase]} {unit}) not "
                             f"in baseline")
    return fails


def _print_sources(label: str, c: dict, md: bool) -> None:
    for pname, by in c.get("sources", {}).items():
        print(f"== {label} {pname}: {c['ops'][pname]} ops ==",
              file=sys.stderr)
        if md:
            print("| source | ops |\n|---|---|", file=sys.stderr)
            for s, n in by.items():
                print(f"| {s} | {n} |", file=sys.stderr)
        else:
            for s, n in by.items():
                print(f"  {s}: {n}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.opcensus")
    ap.add_argument("configs", nargs="*", default=list(DEFAULT_CONFIGS),
                    help='YAML/JSON config paths and/or "smoke" (default: '
                         "the gated set)")
    ap.add_argument("--update", action="store_true",
                    help="write the measured census as the committed "
                         "baseline for THIS backend (opcensus_baseline.json;"
                         " other backends' entries are kept)")
    ap.add_argument("--baseline", default=BASELINE,
                    help="the baseline file (default: the committed one)")
    ap.add_argument("--sources", action="store_true",
                    help="per-pass source breakdown (file.function)")
    ap.add_argument("--fusion", action="store_true",
                    help="also count the CUDA kernels each window phase "
                         "launches, from a torch.profiler trace (the card "
                         "only)")
    ap.add_argument("--inject", type=int, default=0, metavar="N",
                    help="add N extra ops after every round of the rounds "
                         "phase (drift-gate self-test)")
    ap.add_argument("--md", action="store_true",
                    help="print source tables as markdown")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu to run on the "
                         "CPU)")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.core.engine import resolve_device

    dev = resolve_device(args.device)
    backend = dev.type
    if args.fusion and backend != "cuda":
        print(json.dumps({"error": "--fusion counts CUDA kernel launches "
                                   "from a torch.profiler trace: the card "
                                   "only", "backend": backend}))
        return 2
    measured: dict[str, dict] = {}
    for cfg in args.configs:
        label, c = run_census(cfg, device=dev, sources=args.sources,
                              fusion=args.fusion, inject=args.inject)
        measured[label] = c
        if args.sources:
            _print_sources(label, c, args.md)

    try:
        with open(args.baseline) as f:
            base = json.load(f)
    except OSError:
        base = {}
    if args.update:
        configs = base.get("configs", {})
        for label, c in measured.items():
            entry = {k: c[k] for k in (*UNITS, "window")}
            if "fusions" in c:
                entry["fusions"] = {k: c["fusions"][k]
                                    for k in ("phases", "launches")}
            configs.setdefault(label, {})[backend] = entry
        out = {
            "tolerance": base.get("tolerance", TOLERANCE),
            "configs": configs,
            "note": "opcensus baseline of the port, per config per backend "
                    "— the gate fails when any phase's dispatched ops or "
                    "device->host reads drift beyond tolerance; override "
                    f"once with {ACCEPT_ENV}, then re-baseline with "
                    "--update (merges: other backends kept)",
        }
        with open(args.baseline, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")
        print(json.dumps({"census": measured, "gate": "updated",
                          "backend": backend, "baseline": args.baseline}))
        return 0
    if not base.get("configs"):
        print(json.dumps({"census": measured, "gate": "no_baseline",
                          "backend": backend,
                          "hint": "commit one with --update"}))
        return 0
    tol = float(base.get("tolerance", TOLERANCE))
    fails: dict[str, list] = {}
    for label, c in measured.items():
        bcfg = base["configs"].get(label, {}).get(backend)
        if bcfg is None:
            continue  # un-gated config or backend (explicit census run)
        f = gate_config(c, bcfg, tol)
        if f:
            fails[label] = f
    verdict = {"census": measured, "tolerance": tol, "backend": backend}
    if fails:
        accept = os.environ.get(ACCEPT_ENV)
        for label, msgs in fails.items():
            for msg in msgs:
                print(f"[opcensus] {label}: {msg}", file=sys.stderr,
                      flush=True)
        if accept:
            print(f"[opcensus] DRIFT ACCEPTED ({accept}) — commit the new "
                  f"baseline: python -m shadow1_tpu_torch.tools.opcensus "
                  f"--update", file=sys.stderr, flush=True)
            print(json.dumps({**verdict, "gate": "accepted",
                              "reason": accept, "fails": fails}))
            return 0
        print(f"[opcensus] OP-COUNT DRIFT: the window loop's dispatched "
              f"ops or reads changed beyond ±{tol * 100:.0f}%. If "
              f"intentional, override once: {ACCEPT_ENV}='why' — then "
              f"re-baseline with --update.", file=sys.stderr, flush=True)
        print(json.dumps({**verdict, "gate": "failed", "fails": fails}))
        return 1
    print(json.dumps({**verdict, "gate": "ok"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
