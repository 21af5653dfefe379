"""paritytrace — first-divergence bisection between two engine
configurations (port of ``tools/paritytrace.py``).

The determinism contract says that two executions of one experiment —
the numpy oracle and the batched engine, sharded and single-device,
resumed and straight — give bit-identical results. When it breaks, the
end-of-run checks report one mismatched counter after many windows. This
tool runs the two configurations in lockstep chunks with the state
digest on (``EngineParams.state_digest``, ``core/digest.py``), compares
the per-window per-subsystem digest words as they stream out, and stops
at the FIRST divergent (window, subsystem). It then reruns both sides to
that window's boundary and dumps a per-host / per-slot JSONL diff of the
diverging state planes.

    python -m shadow1_tpu_torch.tools.paritytrace CONFIG A B [options]

Side specs (A / B):

    cpu                the numpy oracle (``cpu_engine/``)
    tpu                the single-device batched engine
    sharded[:D]        the sharded engine over D ranks (default 1), started
                       through ``shard/launch.py``
    +pallas            accepted and a no-op: the tensor's device picks the
                       hand kernel (CUDA) or its plain version (CPU), as
                       ``pop_impl`` is ignored
    +resume            a checkpoint save/load at every chunk boundary

Examples:

    paritytrace cfg.yaml tpu cpu                 # engine vs oracle
    paritytrace cfg.yaml tpu sharded:2           # sharding determinism
    paritytrace cfg.yaml tpu tpu+resume          # snapshot fidelity

The batched sides run on CUDA unless ``--device cpu``. A ``sharded:D``
side's ranks use NCCL on the card (one card per rank) and gloo on the
CPU.

``--inject W[:SUBSYS[:SIDE]]`` corrupts one side's state at the window-W
chunk boundary (default subsystem ``rng``: bump host 0's tie-break
counter; also ``evbuf``/``nic``/``tcp``) — the self-test that the
bisector localizes a one-window corruption to exactly (W, SUBSYS).

Exit codes: 0 = digest streams identical, 3 = divergence found (reported),
2 = usage error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

from shadow1_tpu_torch.core.digest import DIGEST_FIELDS, SUBSYSTEMS


def _pad_p(p, np_cols):
    return tuple(int(p[i]) if i < len(p) else 0 for i in range(np_cols))


# ---------------------------------------------------------------------------
# Sides
# ---------------------------------------------------------------------------

class Side:
    """One configuration under lockstep execution. ``run_to(w)`` advances to
    window w (exclusive); ``digest(w)`` returns that window's digest row;
    ``views()`` returns comparable per-subsystem state views for the dump."""

    spec: str

    def run_to(self, w: int) -> None:
        raise NotImplementedError

    def digest(self, w: int) -> dict:
        raise NotImplementedError

    def views(self) -> dict:
        raise NotImplementedError

    def inject(self, subsys: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class OracleSide(Side):
    def __init__(self, exp, params, spec="cpu"):
        from shadow1_tpu_torch.cpu_engine import CpuEngine

        self.spec = spec
        self.params = dataclasses.replace(params, state_digest=1)
        self.eng = CpuEngine(exp, self.params)
        self.done = 0

    def run_to(self, w):
        if w > self.done:
            self.eng.run(n_windows=w)
            self.done = w

    def digest(self, w):
        # digest_rows are appended in window order, one per window.
        return self.eng.digest_rows[w]

    def views(self):
        from shadow1_tpu_torch.consts import NP, TCP_FREE
        from shadow1_tpu_torch.tcp.tcp import (
            _FIELDS_BOOL as TCP_FIELDS_BOOL,
            _FIELDS_I32 as TCP_FIELDS_I32,
            _FIELDS_I64 as TCP_FIELDS_I64,
        )

        eng = self.eng
        ev = {}
        for time, tb, _g, host, kind, p in eng.heap:
            ev[(int(host), int(time), int(tb))] = (int(kind), _pad_p(p, NP))
        rng = {
            "self_ctr": eng.self_ctr.tolist(),
            "pkt_ctr": eng.pkt_ctr.tolist(),
            "cpu_busy": eng.cpu_busy.tolist(),
        }
        nic = tcp = None
        model = eng.model
        if hasattr(model, "socks"):
            nic = {
                "tx_free": model.tx_free.tolist(),
                "rx_free": model.rx_free.tolist(),
                "tx_bytes": model.tx_bytes.tolist(),
                "rx_bytes": model.rx_bytes.tolist(),
                "aqm_ctr": model.aqm_ctr.tolist(),
            }
            tcp = {}
            for h, socks in enumerate(model.socks):
                for s, k in enumerate(socks):
                    if k.st == TCP_FREE:
                        continue
                    d = {f: int(getattr(k, f)) & 0xFFFFFFFF
                         for f in TCP_FIELDS_I32}
                    d.update({f: int(getattr(k, f)) for f in TCP_FIELDS_I64})
                    d.update({f: bool(getattr(k, f)) for f in TCP_FIELDS_BOOL})
                    d["mq"] = sorted(
                        (int(e) & 0xFFFFFFFF, int(m) & 0xFFFFFFFF)
                        for e, m in k.mq
                    )
                    tcp[(h, s)] = d
        elif hasattr(model, "hops"):
            rng["hops"] = model.hops.tolist()
            rng["ctr"] = model.ctr.tolist()
        return {"evbuf": ev, "rng": rng, "nic": nic, "tcp": tcp}

    def inject(self, subsys):
        from shadow1_tpu_torch.core.digest import event_word

        eng = self.eng
        if subsys == "rng":
            eng.self_ctr[0] += 1
        elif subsys == "nic":
            eng.model.tx_bytes[0] += 1
        elif subsys == "tcp":
            for socks in eng.model.socks:
                for k in socks:
                    if k.st:
                        k.ts_seq += 1
                        return
            raise RuntimeError("no live socket to corrupt")
        elif subsys == "evbuf":
            if not eng.heap:
                raise RuntimeError("no pending event to corrupt")
            # Corrupt the latest-time pending event's first payload column
            # (and repair the maintained digest so only the CONTENT changes,
            # exactly like a bit-flip in device memory would).
            i = max(range(len(eng.heap)), key=lambda j: eng.heap[j][:2])
            time, tb, g, host, kind, p = eng.heap[i]
            p = ((int(p[0]) if p else 0) + 1,) + tuple(p[1:])
            eng.heap[i] = (time, tb, g, host, kind, p)
            if eng.digest_on:
                w = event_word(host, time, tb, kind, p)
                eng._ev_dg += w - eng._ev_word[g]
                eng._ev_word[g] = w
        else:
            raise ValueError(subsys)


def _parse_batch_spec(spec: str):
    """(kind, ranks, resume) of a batched side's spec."""
    kind, _, mods = spec.partition("+")
    mods = set(mods.split("+")) if mods else set()
    resume = "resume" in mods
    mods.discard("resume")
    # The tensor's device picks the kernel path; +pallas names no choice.
    mods.discard("pallas")
    if mods:
        raise ValueError(f"unknown side modifiers {sorted(mods)!r}")
    name, _, ndev = kind.partition(":")
    if name not in ("tpu", "sharded"):
        raise ValueError(f"unknown side kind {kind!r}")
    if name == "tpu" and ndev:
        raise ValueError("the tpu side runs on one device")
    return name, int(ndev or 1), resume


def _ring_digests(st, window, start):
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    return {r["window"]: r for r in drain_ring(st, window, start=start)
            if r["type"] == "ring"}


def _roundtrip_path(tmp):
    if tmp is None:
        fd, tmp = tempfile.mkstemp(suffix=".npz", prefix="paritytrace_")
        os.close(fd)
    return tmp


class BatchSide(Side):
    """The solo batched engine, in this process."""

    def __init__(self, exp, params, spec, chunk, device):
        from shadow1_tpu_torch.core.engine import Engine

        self.spec = spec
        _, _, self.resume = _parse_batch_spec(spec)
        # The ring is the digest transport: depth == lockstep chunk so every
        # window drains before it can be overwritten.
        self.params = dataclasses.replace(params, state_digest=1,
                                          metrics_ring=chunk)
        self.eng = Engine(exp, self.params, device=device)
        self.chunk = chunk
        self.st = None
        self.done = 0
        self.rows: dict[int, dict] = {}
        self._tmp = None

    def run_to(self, w):
        if self.st is None:
            self.st = self.eng.init_state()
        while self.done < w:
            step = min(self.chunk, w - self.done)
            self.st = self.eng.run(self.st, n_windows=step)
            self.rows.update(_ring_digests(self.st, self.eng.window,
                                           self.done))
            self.done += step
            if self.resume:
                self._roundtrip()

    def _roundtrip(self):
        from shadow1_tpu_torch import ckpt

        self._tmp = _roundtrip_path(self._tmp)
        ckpt.save_state(self.st, self._tmp)
        self.st = ckpt.load_state(self.eng.init_state(), self._tmp)

    def digest(self, w):
        return self.rows[w]

    def host_state(self):
        from shadow1_tpu_torch.convert import state_to_numpy

        if self.st is None:  # e.g. --inject 0: corrupt the initial state
            self.st = self.eng.init_state()
        return state_to_numpy(self.st)

    def place(self, tree):
        from shadow1_tpu_torch.convert import state_from_numpy

        self.st = state_from_numpy(tree, self.eng.device)

    def views(self):
        return _views(self.host_state())

    def inject(self, subsys):
        self.place(_inject(self.host_state(), subsys))

    def close(self):
        if self._tmp is not None and os.path.exists(self._tmp):
            os.remove(self._tmp)


# -- the sharded side: D ranks, each keeping its engine in launch.SLOTS -----

def _rk_init(rank, world, exp, params, device):
    from shadow1_tpu_torch.shard.engine import ShardedEngine
    from shadow1_tpu_torch.shard.launch import SLOTS

    eng = ShardedEngine(exp, params, device=device)
    SLOTS["paritytrace"] = {"eng": eng, "st": eng.init_state()}
    return True


def _rk_run(rank, world, step, start, ckpt_path):
    from shadow1_tpu_torch.shard.launch import SLOTS

    s = SLOTS["paritytrace"]
    eng = s["eng"]
    s["st"] = eng.run(s["st"], n_windows=step)
    rows = _ring_digests(s["st"], eng.window, start)
    if ckpt_path:
        # The snapshot is the gathered global state, written by rank 0;
        # every rank loads it back and takes its columns.
        import torch.distributed as dist

        from shadow1_tpu_torch import ckpt

        snap = eng.gather_state(s["st"])
        if rank == 0:
            ckpt.save_state(snap, ckpt_path)
        snap = s["st"] = None
        dist.barrier()
        s["st"] = eng.place_state(ckpt.load_state(eng.init_global_state(),
                                                  ckpt_path))
    return rows


def _rk_gather(rank, world):
    from shadow1_tpu_torch.convert import sharded_to_numpy
    from shadow1_tpu_torch.shard.launch import SLOTS

    s = SLOTS["paritytrace"]
    return sharded_to_numpy(s["eng"], s["st"])


def _rk_place(rank, world, tree):
    from shadow1_tpu_torch.convert import sharded_from_numpy
    from shadow1_tpu_torch.shard.launch import SLOTS

    s = SLOTS["paritytrace"]
    s["st"] = sharded_from_numpy(s["eng"], tree)
    return True


class ShardedSide(BatchSide):
    """The sharded engine over D ranks (``shard/launch.RankGroup``)."""

    def __init__(self, exp, params, spec, chunk, device):
        from shadow1_tpu_torch.core.engine import resolve_device
        from shadow1_tpu_torch.shard.launch import RankGroup

        self.spec = spec
        _, n_dev, self.resume = _parse_batch_spec(spec)
        self.params = dataclasses.replace(params, state_digest=1,
                                          metrics_ring=chunk)
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        self.window = exp.window
        self.chunk = chunk
        self.done = 0
        self.rows: dict[int, dict] = {}
        self._tmp = None
        self.group = RankGroup(n_dev, backend, str(dev),
                               threads=1 if dev.type == "cpu" else 0)
        # Under NCCL each rank's engine takes its own card.
        self.group.call(_rk_init, exp, self.params,
                        None if backend == "nccl" else str(dev))

    def run_to(self, w):
        while self.done < w:
            step = min(self.chunk, w - self.done)
            if self.resume:
                self._tmp = _roundtrip_path(self._tmp)
            self.rows.update(self.group.call(
                _rk_run, step, self.done, self._tmp if self.resume else None))
            self.done += step

    def host_state(self):
        return self.group.call(_rk_gather)

    def place(self, tree):
        self.group.call(_rk_place, tree)

    def close(self):
        self.group.close()
        super().close()


def _views(st) -> dict:
    """Comparable per-subsystem views of a numpy-leaved state."""
    from shadow1_tpu_torch.consts import K_NONE, NP, TCP_FREE
    from shadow1_tpu_torch.core.digest import (
        model_host_vectors,
        model_vector_names,
    )
    from shadow1_tpu_torch.tcp.tcp import (
        _FIELDS_BOOL as TCP_FIELDS_BOOL,
        _FIELDS_I32 as TCP_FIELDS_I32,
        _FIELDS_I64 as TCP_FIELDS_I64,
    )

    def join(hi, lo):
        return ((np.asarray(hi).astype(np.int64) << 32)
                | (np.asarray(lo).astype(np.int64) + (1 << 31)))

    buf = st.evbuf
    time = join(buf.time_hi, buf.time_lo)
    tb = join(buf.tb_hi, buf.tb_lo)
    ev = {}
    for c, hh in zip(*np.nonzero(buf.kind != K_NONE)):
        ev[(int(hh), int(time[c, hh]), int(tb[c, hh]))] = (
            int(buf.kind[c, hh]),
            tuple(int(buf.p[i, c, hh]) for i in range(NP)),
        )
    rng = {
        "self_ctr": buf.self_ctr.tolist(),
        "pkt_ctr": st.outbox.pkt_ctr.tolist(),
        "cpu_busy": st.cpu_busy.tolist(),
    }
    for name, vec in zip(model_vector_names(st.model),
                         model_host_vectors(st.model)):
        rng[name] = np.asarray(vec).tolist()
    nic = tcp = None
    mf = getattr(st.model, "_fields", ())
    if "nic" in mf and "tcp" in mf:
        n = st.model.nic
        nic = {
            "tx_free": n.tx_free.tolist(),
            "rx_free": n.rx_free.tolist(),
            "tx_bytes": n.tx_bytes.tolist(),
            "rx_bytes": n.rx_bytes.tolist(),
            "aqm_ctr": n.aqm_ctr.tolist(),
        }
        t = st.model.tcp
        tcp = {}
        for s, hh in zip(*np.nonzero(np.asarray(t["st"]) != TCP_FREE)):
            d = {f: int(np.asarray(t[f])[s, hh]) & 0xFFFFFFFF
                 for f in TCP_FIELDS_I32}
            for f in TCP_FIELDS_I64:
                d[f] = int(join(t[f + "_hi"], t[f + "_lo"])[s, hh])
            d.update({f: bool(np.asarray(t[f])[s, hh])
                      for f in TCP_FIELDS_BOOL})
            mqv = np.asarray(t["mq_valid"])[:, s, hh]
            d["mq"] = sorted(
                (int(np.asarray(t["mq_end"])[q, s, hh]) & 0xFFFFFFFF,
                 int(np.asarray(t["mq_meta"])[q, s, hh]) & 0xFFFFFFFF)
                for q in np.nonzero(mqv)[0]
            )
            tcp[(int(hh), int(s))] = d
    return {"evbuf": ev, "rng": rng, "nic": nic, "tcp": tcp}


def _inject(st, subsys):
    """A numpy-leaved state with one subsystem corrupted."""
    from shadow1_tpu_torch.consts import K_NONE, TCP_FREE

    if subsys == "rng":
        v = st.evbuf.self_ctr.copy()
        v[0] += 1
        return st._replace(evbuf=st.evbuf._replace(self_ctr=v))
    if subsys == "evbuf":
        occ = np.nonzero(st.evbuf.kind != K_NONE)
        if not len(occ[0]):
            raise RuntimeError("no pending event to corrupt")
        p = st.evbuf.p.copy()
        p[0, occ[0][0], occ[1][0]] += 1
        return st._replace(evbuf=st.evbuf._replace(p=p))
    if subsys == "nic":
        v = st.model.nic.tx_bytes.copy()
        v[0] += 1
        return st._replace(model=st.model._replace(
            nic=st.model.nic._replace(tx_bytes=v)))
    if subsys == "tcp":
        t = dict(st.model.tcp)
        live = np.nonzero(np.asarray(t["st"]) != TCP_FREE)
        if not len(live[0]):
            raise RuntimeError("no live socket to corrupt")
        v = t["ts_seq"].copy()
        v[live[0][0], live[1][0]] += 1
        t["ts_seq"] = v
        return st._replace(model=st.model._replace(tcp=t))
    raise ValueError(subsys)


def make_side(spec: str, exp, params, chunk: int, device=None) -> Side:
    if spec.partition("+")[0] == "cpu":
        if "+" in spec:
            raise ValueError("the cpu oracle takes no modifiers")
        return OracleSide(exp, params, spec)
    name, _, _ = _parse_batch_spec(spec)
    if name == "sharded":
        return ShardedSide(exp, params, spec, chunk, device)
    return BatchSide(exp, params, spec, chunk, device)


# ---------------------------------------------------------------------------
# Lockstep bisection
# ---------------------------------------------------------------------------

def bisect(a: Side, b: Side, n_windows: int, chunk: int,
           inject=None, log=lambda *a: None):
    """Run both sides in lockstep chunks; return (window, [subsystems]) of
    the first digest divergence, or None. ``inject`` is (window, subsys,
    side) applied at that window's chunk boundary."""
    done = 0
    injected = False
    while done < n_windows:
        if inject and not injected and done == inject[0]:
            side = a if inject[2] == "a" else b
            side.inject(inject[1])
            injected = True
            log(f"injected {inject[1]} corruption into side "
                f"{inject[2]} ({side.spec}) at window {done}")
        target = min(done + chunk, n_windows)
        if inject and not injected:
            target = min(target, inject[0])
        a.run_to(target)
        b.run_to(target)
        for w in range(done, target):
            da, db = a.digest(w), b.digest(w)
            diff = [s for s, f in zip(SUBSYSTEMS, DIGEST_FIELDS)
                    if int(da[f]) != int(db[f])]
            if diff:
                return w, diff
        log(f"windows [{done}, {target}) identical")
        done = target
    return None


# ---------------------------------------------------------------------------
# Divergence dump (the per-host / per-slot localization)
# ---------------------------------------------------------------------------

def _diff_keyed(sub, va, vb, emit, max_records):
    """Diff two {key: value} views; emit a_only / b_only / changed rows."""
    n = 0
    for key in sorted(set(va) | set(vb)):
        ka = va.get(key)
        kb = vb.get(key)
        if ka == kb:
            continue
        if n >= max_records:  # a further REAL difference exists beyond the cap
            emit({"type": "plane_diff_truncated", "subsystem": sub})
            return n
        rec = {"type": "plane_diff", "subsystem": sub,
               "key": list(key) if isinstance(key, tuple) else key}
        if ka is None:
            rec["side"] = "b_only"
            rec["b"] = kb
        elif kb is None:
            rec["side"] = "a_only"
            rec["a"] = ka
        else:
            rec["side"] = "changed"
            if isinstance(ka, dict):
                rec["fields"] = {
                    f: {"a": ka[f], "b": kb[f]}
                    for f in ka if ka.get(f) != kb.get(f)
                }
            else:
                rec["a"], rec["b"] = ka, kb
        emit(rec)
        n += 1
    return n


def _diff_vectors(sub, va, vb, emit, max_records):
    """Diff two {name: [per-host values]} views; one row per differing host."""
    n = 0
    for name in sorted(set(va) | set(vb)):
        xa = va.get(name, [])
        xb = vb.get(name, [])
        for h in range(max(len(xa), len(xb))):
            ea = xa[h] if h < len(xa) else None
            eb = xb[h] if h < len(xb) else None
            if ea != eb:
                if n >= max_records:  # a further real difference beyond cap
                    emit({"type": "plane_diff_truncated", "subsystem": sub})
                    return n
                emit({"type": "plane_diff", "subsystem": sub, "field": name,
                      "host": h, "a": ea, "b": eb})
                n += 1
    return n


def dump_divergence(a: Side, b: Side, window: int, subsystems, emit,
                    max_records: int = 200) -> int:
    """Re-derive both sides' state at the end of ``window`` (the caller ran
    them there) and emit the structured diff of each diverging plane."""
    va, vb = a.views(), b.views()
    total = 0
    for sub in subsystems:
        if sub == "outbox":
            # The outbox is cleared by the window-end delivery, so its
            # contents cannot be read back from a window-boundary state;
            # the scattered packets ARE next window's evbuf entries.
            emit({"type": "plane_note", "subsystem": "outbox",
                  "note": "outbox sends are consumed at the window-end "
                          "exchange; diffing the evbuf (delivered packets) "
                          "and rng (pkt_ctr) planes instead"})
            total += _diff_keyed("evbuf", va["evbuf"], vb["evbuf"], emit,
                                 max_records)
            total += _diff_vectors("rng", va["rng"], vb["rng"], emit,
                                   max_records)
        elif sub == "evbuf":
            total += _diff_keyed("evbuf", va["evbuf"], vb["evbuf"], emit,
                                 max_records)
        elif sub == "tcp":
            total += _diff_keyed("tcp", va["tcp"] or {}, vb["tcp"] or {},
                                 emit, max_records)
        elif sub == "nic":
            total += _diff_vectors("nic", va["nic"] or {}, vb["nic"] or {},
                                   emit, max_records)
        elif sub == "rng":
            total += _diff_vectors("rng", va["rng"], vb["rng"], emit,
                                   max_records)
    return total


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_inject(s: str | None):
    if s is None:
        return None
    parts = s.split(":")
    w = int(parts[0])
    subsys = parts[1] if len(parts) > 1 else "rng"
    side = parts[2] if len(parts) > 2 else "b"
    if subsys not in SUBSYSTEMS or subsys == "outbox":
        raise SystemExit(f"--inject subsystem must be one of "
                         f"{[s for s in SUBSYSTEMS if s != 'outbox']}")
    if side not in ("a", "b"):
        raise SystemExit("--inject side must be a or b")
    return (w, subsys, side)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="shadow1_tpu_torch.tools.paritytrace",
        description="lockstep digest comparison + first-divergence bisection",
    )
    ap.add_argument("config", help="YAML or JSON experiment file")
    ap.add_argument("side_a", help="cpu | tpu | sharded[:D] (+resume; "
                                   "+pallas is accepted and changes nothing: "
                                   "the device picks the kernel path)")
    ap.add_argument("side_b", help="same grammar as side A")
    ap.add_argument("--windows", type=int, default=None,
                    help="compare this many windows (default: the full run)")
    ap.add_argument("--chunk", type=int, default=64,
                    help="lockstep chunk in windows (= digest ring depth)")
    ap.add_argument("--inject", default=None, metavar="W[:SUBSYS[:SIDE]]",
                    help="corrupt one side at window W (self-test; default "
                         "subsystem rng, default side b)")
    ap.add_argument("--dump", default=None, metavar="PATH",
                    help="write the divergence plane diff as JSONL here "
                         "(default: stderr)")
    ap.add_argument("--max-diff", type=int, default=200,
                    help="cap on emitted plane-diff records")
    ap.add_argument("--no-localize", action="store_true",
                    help="report the first divergent (window, subsystem) "
                         "only; skip the re-run and plane dump")
    ap.add_argument("--device", default=None,
                    help="the batched sides' device (default: cuda)")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.config.experiment import load_experiment

    for spec in (args.side_a, args.side_b):
        try:
            if spec.partition("+")[0] != "cpu":
                _parse_batch_spec(spec)
            elif "+" in spec:
                raise ValueError("the cpu oracle takes no modifiers")
        except ValueError as e:
            ap.error(str(e))
    exp, params, _scheduler = load_experiment(args.config)
    n_windows = args.windows or int(-(-exp.end_time // exp.window))
    chunk = max(1, min(args.chunk, n_windows))
    inject = _parse_inject(args.inject)
    if inject and inject[0] >= n_windows:
        raise SystemExit("--inject window is past the compared range")

    def log(msg):
        print(f"[paritytrace] {msg}", file=sys.stderr, flush=True)

    def side(spec):
        return make_side(spec, exp, params, chunk, args.device)

    log(f"A = {args.side_a}, B = {args.side_b}, {n_windows} windows, "
        f"chunk {chunk}")
    sides = [side(args.side_a)]
    try:
        sides.append(side(args.side_b))
        hit = bisect(sides[0], sides[1], n_windows, chunk, inject=inject,
                     log=log)
    finally:
        for s in sides:
            s.close()

    result = {
        "type": "paritytrace",
        "config": args.config,
        "sides": [args.side_a, args.side_b],
        "windows_compared": n_windows if hit is None else hit[0] + 1,
        "first_divergence": None,
        "injected": list(inject) if inject else None,
    }
    if hit is None:
        log(f"digest streams identical over {n_windows} windows")
        print(json.dumps(result))
        return 0

    window, subsystems = hit
    result["first_divergence"] = {"window": window, "subsystems": subsystems}
    log(f"FIRST DIVERGENCE at window {window}: {', '.join(subsystems)}")

    if not args.no_localize:
        # Re-run both sides fresh to the divergent window's boundary (the
        # runs are deterministic, so the states reproduce exactly) and dump
        # the diverging plane(s) element by element.
        log(f"re-running both sides to window {window} for the plane dump")
        sides = []
        try:
            for spec, tag in ((args.side_a, "a"), (args.side_b, "b")):
                s2 = side(spec)
                sides.append(s2)
                if inject and inject[2] == tag:
                    s2.run_to(inject[0])
                    s2.inject(inject[1])
                s2.run_to(window + 1)
            out = open(args.dump, "w") if args.dump else sys.stderr

            def emit(rec):
                print(json.dumps(rec), file=out, flush=True)

            emit(result)
            n = dump_divergence(sides[0], sides[1], window, subsystems, emit,
                                max_records=args.max_diff)
        finally:
            for s in sides:
                s.close()
        if args.dump:
            out.close()
            log(f"wrote {n} plane-diff records to {args.dump}")
        result["diff_records"] = n
    print(json.dumps(result))
    return 3


if __name__ == "__main__":
    sys.exit(main())
