"""Fault schedule — config parsing and the engine-neutral compiled tables
(the port's copy of ``fault/schedule.py``, which is free of JAX; the
imports point at the port's own ``config`` and ``rng``).

One compilation path feeds every engine: the YAML ``faults:`` section
parses into a :class:`FaultSchedule` (raw nanosecond times, host/vertex
ids resolved), which rides ``CompiledExperiment.faults``; the three table
builders below turn it into the dense numpy arrays the engine puts on its
device once, so every engine agrees about when a host is down.

Plain numpy; the device twins live in ``fault/plane.py``.

Semantics (docs/SEMANTICS.md §"Fault plane"):

* **host churn** — a host is *down* during each ``[down, up)`` interval.
  Down times are exact event-time predicates; up times are quantized UP to
  the next conservative-window boundary, because the restart reset (state
  re-initialization) is applied at window starts. The legacy per-group
  ``stop_time`` knob compiles into the same tables as a final
  ``[stop_time, never)`` interval.
* **link outage** — packets whose NIC departure time falls inside a
  ``[from, until)`` window on a listed (src_vertex, dst_vertex) path are
  dropped deterministically (counted ``link_down_pkts``), before the loss
  draw. No quantization: the predicate is a pure function of the packet.
* **loss ramp** — during ``[from, until)`` the path's Bernoulli loss
  threshold is replaced by the ramp's (entries apply in file order, later
  entries win). The per-packet coin is drawn from the same
  ``(R_LOSS, src, pkt_ctr)`` stream either way, so toggling a ramp cannot
  shift any other draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.oracle.compiled import NO_STOP


@dataclasses.dataclass
class FaultSchedule:
    """Raw (unquantized) fault entries; all times int64 ns, ids resolved.

    Host entries are flat (host_id, down, up) triples — multiple entries
    per host express repeated down/up cycles. ``up == NO_STOP`` means the
    host never restarts (a permanent kill, like the legacy stop_time).
    Link/ramp entries are vertex-pair keyed, already expanded to directed
    pairs (the parser duplicates bidirectional entries)."""

    host_id: np.ndarray = None    # i32 [E]
    host_down: np.ndarray = None  # i64 [E]
    host_up: np.ndarray = None    # i64 [E] (NO_STOP = never)
    link_src: np.ndarray = None   # i32 [L] vertex ids
    link_dst: np.ndarray = None   # i32 [L]
    link_t0: np.ndarray = None    # i64 [L]
    link_t1: np.ndarray = None    # i64 [L]
    ramp_src: np.ndarray = None   # i32 [R]
    ramp_dst: np.ndarray = None   # i32 [R]
    ramp_t0: np.ndarray = None    # i64 [R]
    ramp_t1: np.ndarray = None    # i64 [R]
    ramp_loss: np.ndarray = None  # f64 [R] loss probability during the ramp

    def __post_init__(self):
        for f, dt in (("host_id", np.int32), ("host_down", np.int64),
                      ("host_up", np.int64), ("link_src", np.int32),
                      ("link_dst", np.int32), ("link_t0", np.int64),
                      ("link_t1", np.int64), ("ramp_src", np.int32),
                      ("ramp_dst", np.int32), ("ramp_t0", np.int64),
                      ("ramp_t1", np.int64), ("ramp_loss", np.float64)):
            v = getattr(self, f)
            setattr(self, f, np.asarray(v if v is not None else [], dt))

    def validate(self, n_hosts: int, n_vertices: int) -> None:
        assert len(self.host_id) == len(self.host_down) == len(self.host_up)
        if len(self.host_id):
            assert self.host_id.min() >= 0 and self.host_id.max() < n_hosts
            assert (self.host_down > 0).all(), \
                "host down time must be > 0 (hosts cannot start dead)"
            assert (self.host_up > self.host_down).all()
        for src, dst, t0, t1 in ((self.link_src, self.link_dst,
                                  self.link_t0, self.link_t1),
                                 (self.ramp_src, self.ramp_dst,
                                  self.ramp_t0, self.ramp_t1)):
            assert len(src) == len(dst) == len(t0) == len(t1)
            if len(src):
                assert src.min() >= 0 and src.max() < n_vertices
                assert dst.min() >= 0 and dst.max() < n_vertices
                assert (t1 > t0).all() and (t0 >= 0).all()
        if len(self.ramp_loss):
            assert ((self.ramp_loss >= 0) & (self.ramp_loss <= 1)).all()

    @property
    def empty(self) -> bool:
        return not (len(self.host_id) or len(self.link_src)
                    or len(self.ramp_src))


# ---------------------------------------------------------------------------
# Engine-facing table builders (the ONE compilation both engines share)
# ---------------------------------------------------------------------------

def host_interval_tensors(exp) -> tuple[np.ndarray, np.ndarray]:
    """``(down, up)`` i64 ``[K, H]`` host down-interval tensors.

    Merges the legacy ``exp.stop_time`` (one ``[stop, never)`` interval)
    with ``exp.faults`` host entries; quantizes finite up times UP to the
    next window boundary (restart resets apply at window starts); pads to
    the max interval count K with ``[NO_STOP, NO_STOP)`` — an empty
    interval no time can satisfy. Intervals per host must not overlap
    AFTER quantization (validated here, loudly). ``down(h, t)`` is then
    ``any_k(down[k,h] <= t < up[k,h])`` on every engine."""
    h, w = exp.n_hosts, exp.window
    per_host: list[list[tuple[int, int]]] = [[] for _ in range(h)]
    st = np.asarray(exp.stop_time, np.int64)
    for i in range(h):
        if st[i] < NO_STOP:
            per_host[i].append((int(st[i]), NO_STOP))
    fs = getattr(exp, "faults", None)
    if fs is not None:
        for hid, d, u in zip(fs.host_id, fs.host_down, fs.host_up):
            uq = NO_STOP if u >= NO_STOP else int(-(-int(u) // w) * w)
            per_host[int(hid)].append((int(d), uq))
    k = max(max((len(v) for v in per_host), default=0), 1)
    down = np.full((k, h), NO_STOP, np.int64)
    up = np.full((k, h), NO_STOP, np.int64)
    for i, iv in enumerate(per_host):
        iv.sort()
        prev_up = 0
        for j, (d, u) in enumerate(iv):
            if d < prev_up:
                raise ValueError(
                    f"faults: host {i} down intervals overlap after "
                    f"window-quantizing up times (down={d} < previous "
                    f"up={prev_up}; window={w} ns) — space the cycles at "
                    f"least one window apart"
                )
            prev_up = u
            down[j, i] = d
            up[j, i] = u
    return down, up


def link_tables(exp) -> tuple[np.ndarray, ...] | None:
    """``(src, dst, t0, t1)`` link-outage arrays, or None when none are
    configured (the engine then runs no outage op)."""
    fs = getattr(exp, "faults", None)
    if fs is None or not len(fs.link_src):
        return None
    return fs.link_src, fs.link_dst, fs.link_t0, fs.link_t1


def ramp_tables(exp) -> tuple[np.ndarray, ...] | None:
    """``(src, dst, t0, t1, thr)`` loss-ramp arrays (thr = the u64
    Bernoulli threshold via rng.prob_threshold — the identical integer both
    engines compare the shared coin bits against), or None."""
    fs = getattr(exp, "faults", None)
    if fs is None or not len(fs.ramp_src):
        return None
    from portbench.reference.oracle.rng import prob_threshold

    return (fs.ramp_src, fs.ramp_dst, fs.ramp_t0, fs.ramp_t1,
            prob_threshold(fs.ramp_loss))


def hosts_down_at_np(down: np.ndarray, up: np.ndarray, host: int,
                     t: int) -> bool:
    """Oracle-side down predicate (python ints; K is small)."""
    return bool(((t >= down[:, host]) & (t < up[:, host])).any())


# ---------------------------------------------------------------------------
# YAML ``faults:`` section → FaultSchedule
# ---------------------------------------------------------------------------

def parse_faults(doc: dict | None, groups, vertex_names) -> FaultSchedule | None:
    """Parse the config's ``faults:`` section.

    Schema (durations accept the usual "<num> <unit>" strings):

        faults:
          hosts:                       # repeated entries = repeated cycles
            - group: client            # host group name, or host: <id>,
              down_at: 2 s             #   or hosts: [ids]
              up_at: 3 s               # omit = never restarts (a kill)
          links:
            - src_vertex: pop_west     # vertex name (graphml id) or int
              dst_vertex: pop_east
              down_at: 4 s
              up_at: 4.5 s
              bidirectional: true      # default true; expands both ways
          loss:
            - src_vertex: pop_west
              dst_vertex: pop_east
              from: 1 s
              until: 2 s
              loss: 0.3                # replaces the path loss prob
              bidirectional: true

    ``groups`` is the expanded HostGroup list (for group-name resolution),
    ``vertex_names`` the topology's vertex-id list."""
    if not doc:
        return None
    from portbench.reference.oracle.experiment import parse_time_ns

    by_name = {g.name: g for g in groups}
    vidx = {str(n): i for i, n in enumerate(vertex_names)}

    def vertex(v):
        return int(v) if isinstance(v, int) else vidx[str(v)]

    hid, hdown, hup = [], [], []
    for e in doc.get("hosts", []):
        extra = set(e) - {"group", "host", "hosts", "down_at", "up_at"}
        assert not extra, f"unknown faults.hosts keys: {extra}"
        if "group" in e:
            ids = by_name[e["group"]].ids
        elif "hosts" in e:
            ids = [int(x) for x in e["hosts"]]
        else:
            ids = [int(e["host"])]
        down = parse_time_ns(e["down_at"])
        up = parse_time_ns(e["up_at"]) if "up_at" in e else NO_STOP
        for i in ids:
            hid.append(i)
            hdown.append(down)
            hup.append(up)

    def pairs(entries, t0_key, t1_key, known):
        src, dst, t0, t1, extras = [], [], [], [], []
        for e in entries:
            extra = set(e) - known
            assert not extra, f"unknown faults keys: {extra}"
            vs, vd = vertex(e["src_vertex"]), vertex(e["dst_vertex"])
            a, b = parse_time_ns(e[t0_key]), parse_time_ns(e[t1_key])
            dirs = [(vs, vd)]
            if e.get("bidirectional", True) and vs != vd:
                dirs.append((vd, vs))
            for s, d in dirs:
                src.append(s)
                dst.append(d)
                t0.append(a)
                t1.append(b)
                extras.append(e)
        return src, dst, t0, t1, extras

    base = {"src_vertex", "dst_vertex", "bidirectional"}
    lsrc, ldst, lt0, lt1, _ = pairs(doc.get("links", []), "down_at", "up_at",
                                    base | {"down_at", "up_at"})
    rsrc, rdst, rt0, rt1, rents = pairs(doc.get("loss", []), "from", "until",
                                        base | {"from", "until", "loss"})
    rloss = [float(e["loss"]) for e in rents]

    fs = FaultSchedule(
        host_id=hid, host_down=hdown, host_up=hup,
        link_src=lsrc, link_dst=ldst, link_t0=lt0, link_t1=lt1,
        ramp_src=rsrc, ramp_dst=rdst, ramp_t0=rt0, ramp_t1=rt1,
        ramp_loss=rloss,
    )
    return None if fs.empty else fs
