"""Experiment documents → CompiledExperiment — a frozen numpy copy.

The schema and validation of the program's configuration compiler, so one
document (a parsed JSON config) compiles to the same ``CompiledExperiment``
and ``EngineParams`` here as in the program:

    general:  {seed: 1, stop_time: 60 s}
    engine:   {scheduler: tpu, ev_cap: 256, ...}   # any EngineParams field
    network:  {single_vertex: {latency: 10 ms, loss: 0.01}} | {graphml: f}
    hosts:    [{name: h, count: 8, vertex: 0, bandwidth_up: 100 Mbit}, ...]
    app:      {model: phold, params: {mean_delay_ns: ..., init_events: ...}}

The ``app:`` section compiles to per-host arrays as in the reference:
each schema parameter takes its ``defaults:`` value, then each host group's
``groups:`` value — a scalar, a list (one per host) or a stagger
``{start, interval}`` — and ``"@name"`` names the first host of a group.

The ``faults:`` section compiles to a ``FaultSchedule``
(``fault/schedule.py``), and bitcoin's ``graph:`` / ``tx:`` generator specs
to its ``peers``, ``tx_origin`` and ``tx_time`` arrays
(``_gen_bitcoin_cfg``). The top-level ``probes:`` watchlist resolves to
``EngineParams.probes`` (``resolve_watchlist``; a typo raises
``WatchlistError``). The ``params:`` scalars (``fixed_size`` for tgen,
``ct_cap``, ``cells_max`` and ``consensus_bytes`` for Tor, ``tx_size`` and
``inv_size`` for bitcoin) pass through into ``model_cfg`` as written.
``sweep:`` runs the base experiment, as a solo run of the reference does;
``fleet/expand.py`` expands it into the fleet's experiments.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from portbench.reference.oracle.compiled import NO_STOP, CompiledExperiment
from portbench.reference.oracle.dns import Dns
from portbench.reference.oracle.topology import compile_paths, load_graphml
from portbench.reference.oracle.consts import MS, NS, SEC, US, EngineParams

_TIME_UNITS = {"ns": NS, "us": US, "ms": MS, "s": SEC, "sec": SEC}
_BW_UNITS = {"bit": 1, "kbit": 10**3, "mbit": 10**6, "gbit": 10**9}


def parse_time_ns(v) -> int:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v)
    s = str(v).strip().lower()
    parts = s.split()
    if len(parts) == 2 and parts[1] in _TIME_UNITS:
        return int(float(parts[0]) * _TIME_UNITS[parts[1]])
    for unit in ("ns", "us", "ms", "sec", "s"):
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * _TIME_UNITS[unit])
    return int(float(s))


def parse_bw_bits(v) -> int:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v)
    s = str(v).strip().lower().replace("/s", "")
    parts = s.split()
    if len(parts) == 2 and parts[1] in _BW_UNITS:
        return int(float(parts[0]) * _BW_UNITS[parts[1]])
    for unit in ("kbit", "mbit", "gbit", "bit"):
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * _BW_UNITS[unit])
    return int(float(s))


# Per-host app parameter schemas: name -> (dtype, default, parser), as in
# the reference. A parser of parse_time_ns lets YAML say "100 ms".
_APP_PARAMS: dict[str, dict[str, tuple]] = {
    "filexfer": {
        "role": (np.int64, 2, None),
        "server": (np.int64, 0, None),
        "flow_bytes": (np.int64, 0, None),
        "start_time": (np.int64, 0, parse_time_ns),
        "flow_count": (np.int64, 0, None),
    },
    "dgram": {
        "dst": (np.int64, 0, None),
        "payload": (np.int64, 0, None),
        "interval": (np.int64, 0, parse_time_ns),
        "count": (np.int64, 0, None),
        "start_time": (np.int64, 0, parse_time_ns),
    },
    "tgen": {
        "active": (np.int64, 0, None),
        "streams": (np.int64, 0, None),
        "mean_bytes": (np.float64, 0.0, None),
        "mean_think_ns": (np.float64, 0.0, parse_time_ns),
        "start_time": (np.int64, 0, parse_time_ns),
    },
    "tor": {
        "role": (np.int64, 3, None),
        "relay_weight": (np.int64, 0, None),
        "is_guard": (bool, False, None),
        "is_exit": (bool, False, None),
        "n_circuits": (np.int64, 0, None),
        "n_streams": (np.int64, 0, None),
        "mean_stream_cells": (np.float64, 0.0, None),
        "mean_think_ns": (np.float64, 0.0, parse_time_ns),
        "start_time": (np.int64, 0, parse_time_ns),
    },
    "bitcoin": {},  # graph-structured config passes through `params`
    "phold": {},
}


def _per_host_array(name, dtype, default, parser, groups, defaults,
                    group_cfg, h):
    arr = np.full(h, default, dtype)
    conv = parser or (lambda x: x)
    if name in defaults:
        arr[:] = _group_values(name, defaults[name], conv, h, np.arange(h))
    for g in groups:
        block = group_cfg.get(g.name, {})
        if name in block:
            arr[g.ids] = _group_values(name, block[name], conv, g.count,
                                       np.arange(g.count))
    return arr


def _group_values(name, val, conv, count, idx):
    """One app-param value spec → per-host values for a group of ``count``:
    a scalar (broadcast), a list (one per host) or a stagger dict
    ``{start: X, interval: Y}`` → ``start + i·interval``."""
    if isinstance(val, dict):
        extra = set(val) - {"start", "interval"}
        assert not extra, f"unknown stagger keys for {name}: {extra}"
        return conv(val.get("start", 0)) + idx * conv(val.get("interval", 0))
    if isinstance(val, list):
        assert len(val) == count, (name, count)
        return [conv(x) for x in val]
    return conv(val)


def _gen_bitcoin_cfg(model_cfg: dict, h: int, seed: int) -> None:
    """Expand bitcoin's generator specs into arrays, in place.

    ``graph: {kind: ring_chord, k: K}`` → a symmetric K-regular peer graph
    (ring ±1 plus power-of-4 chords); ``tx: {count, start, interval}`` →
    staggered transactions at origins drawn from
    ``RandomState(seed ^ 0xB17C01)``. Explicit ``peers`` / ``tx_origin`` /
    ``tx_time`` arrays may be given instead."""
    if "peers" not in model_cfg:
        gspec = model_cfg.pop("graph", {})
        k = int(gspec.get("k", 8))
        assert k % 2 == 0 and k >= 2
        chords = [1]
        while len(chords) < k // 2:
            chords.append(chords[-1] * 4)
        peers = np.zeros((h, k), np.int32)
        for ci, c in enumerate(chords):
            peers[:, 2 * ci] = (np.arange(h) - c) % h
            peers[:, 2 * ci + 1] = (np.arange(h) + c) % h
        model_cfg["peers"] = peers
    if "tx_origin" not in model_cfg:
        tspec = model_cfg.pop("tx", {})
        count = int(tspec.get("count", 50))
        start = parse_time_ns(tspec.get("start", "1 s"))
        interval = parse_time_ns(tspec.get("interval", "200 ms"))
        rs = np.random.RandomState(seed ^ 0xB17C01)
        model_cfg["tx_origin"] = rs.randint(0, h, count).astype(np.int64)
        model_cfg["tx_time"] = (start + np.arange(count) * interval).astype(np.int64)


@dataclasses.dataclass
class HostGroup:
    name: str
    count: int
    start: int          # first global host id
    vertex_spec: Any
    bw_up: int
    bw_dn: int
    stop_time: int      # ns the host halts (churn); NO_STOP = never
    cpu_ns_per_event: int
    tx_qlen_bytes: int  # NIC uplink queue bound (0 = unbounded)
    rx_qlen_bytes: int
    aqm_min_bytes: int  # RED uplink AQM thresholds (aqm_max_bytes 0 = off)
    aqm_max_bytes: int
    aqm_pmax: float

    @property
    def ids(self) -> np.ndarray:
        return np.arange(self.start, self.start + self.count)


def _reject_unknown(section: str, have, allowed) -> None:
    """A typo like ``ev_capp:`` must fail at load instead of silently
    running the experiment on defaults."""
    unknown = set(have) - set(allowed)
    assert not unknown, (
        f"unknown {section} keys: {sorted(map(str, unknown))} "
        f"(allowed: {sorted(allowed)})"
    )


_HOST_KEYS = ("name", "count", "vertex", "bandwidth_up", "bandwidth_down",
              "stop_time", "cpu_per_event", "tx_queue_bytes",
              "rx_queue_bytes", "aqm_min_bytes", "aqm_max_bytes", "aqm_pmax")


def _expand_hosts(spec: list[dict]) -> list[HostGroup]:
    groups, start = [], 0
    for g in spec:
        _reject_unknown(f"hosts[{g.get('name', start)}]", g, _HOST_KEYS)
        count = int(g.get("count", 1))
        groups.append(HostGroup(
            name=g["name"],
            count=count,
            start=start,
            vertex_spec=g.get("vertex", 0),
            bw_up=parse_bw_bits(g.get("bandwidth_up", "1 Gbit")),
            bw_dn=parse_bw_bits(g.get("bandwidth_down", "1 Gbit")),
            stop_time=(
                parse_time_ns(g["stop_time"]) if "stop_time" in g else NO_STOP
            ),
            cpu_ns_per_event=(
                parse_time_ns(g["cpu_per_event"]) if "cpu_per_event" in g else 0
            ),
            tx_qlen_bytes=int(g.get("tx_queue_bytes", 0)),
            rx_qlen_bytes=int(g.get("rx_queue_bytes", 0)),
            aqm_min_bytes=int(g.get("aqm_min_bytes", 0)),
            aqm_max_bytes=int(g.get("aqm_max_bytes", 0)),
            aqm_pmax=float(g.get("aqm_pmax", 0.1)),
        ))
        start += count
    return groups


def _vertex_assignment(groups, vertex_names, n_hosts) -> np.ndarray:
    n_v = max(len(vertex_names), 1)
    name_idx = {str(n): i for i, n in enumerate(vertex_names)}
    hv = np.zeros(n_hosts, np.int32)
    for g in groups:
        if g.vertex_spec == "spread":
            hv[g.start:g.start + g.count] = np.arange(g.count) % n_v
        elif isinstance(g.vertex_spec, int):
            hv[g.start:g.start + g.count] = g.vertex_spec
        else:
            hv[g.start:g.start + g.count] = name_idx[str(g.vertex_spec)]
    assert hv.max(initial=0) < n_v, "host attached to missing vertex"
    return hv


class WatchlistError(ValueError):
    """A probe watchlist entry (``probes:`` section / ``--watch``) failed to
    resolve: unknown host or group name, bad index, or out-of-range socket.
    Raised at config time; the CLI turns it into its config error."""


def _resolve_probe_host(spec, dns) -> int:
    """One watchlist host spec → global host id.

    Accepted forms: an int host id; ``"name"`` / ``"@name"`` (any hostname
    or group name the Dns registry knows — bare group name = its first
    host); ``"name[i]"`` (the group's i-th host, via the registry's
    ``name-i`` convention)."""
    txt = str(spec).strip()
    if isinstance(spec, int) or txt.lstrip("-").isdigit():
        hid = int(txt)
        if not 0 <= hid < len(dns):
            raise WatchlistError(
                f"probe host id {hid} out of range (hosts 0..{len(dns) - 1})")
        return hid
    name = txt[1:] if txt.startswith("@") else txt
    if name.endswith("]") and "[" in name:
        base, _, idx_s = name[:-1].partition("[")
        try:
            idx = int(idx_s)
        except ValueError:
            raise WatchlistError(
                f"probe target {txt!r}: index {idx_s!r} is not an integer"
            ) from None
        name = base if (idx == 0 and f"{base}-0" not in dns._by_name) \
            else f"{base}-{idx}"
    try:
        return dns.resolve(name)
    except KeyError:
        import difflib

        close = difflib.get_close_matches(name, dns._by_name, n=3)
        hint = f" — did you mean {', '.join(map(repr, close))}?" if close \
            else ""
        raise WatchlistError(
            f"unknown probe target {txt!r}: no host or group by that "
            f"name{hint}") from None


def resolve_watchlist(entries, dns, sockets_per_host: int) -> tuple:
    """Watchlist specs → the EngineParams.probes tuple of (host, sock) ints.

    ``entries`` come from the ``probes:`` config section (a list of
    ``"host[:sock]"`` strings, int ids, or ``{host:, sock:}`` dicts) or
    repeated ``--watch`` flags. sock defaults to −1 (the host-only
    NIC/event view). Duplicates collapse, the first occurrence keeps its
    place. Every failure raises WatchlistError."""
    if isinstance(entries, (str, int, dict)):
        entries = [entries]
    if not isinstance(entries, (list, tuple)):
        raise WatchlistError(
            f"probes: must be a list of host[:sock] targets, "
            f"got {type(entries).__name__}")
    probes: list[tuple[int, int]] = []
    for e in entries:
        if isinstance(e, dict):
            unknown = set(e) - {"host", "sock"}
            if unknown:
                raise WatchlistError(
                    f"unknown probe entry keys {sorted(map(str, unknown))} "
                    f"(allowed: host, sock)")
            if "host" not in e:
                raise WatchlistError(f"probe entry {e!r} is missing 'host'")
            spec, sock_s = e["host"], e.get("sock", -1)
        else:
            txt = str(e)
            spec, sep, tail = txt.rpartition(":")
            if not sep:
                spec, sock_s = txt, -1
            else:
                sock_s = tail
        host = _resolve_probe_host(spec, dns)
        try:
            sock = int(sock_s)
        except (TypeError, ValueError):
            raise WatchlistError(
                f"probe target {e!r}: socket {sock_s!r} is not an integer"
            ) from None
        if not -1 <= sock < sockets_per_host:
            raise WatchlistError(
                f"probe target {e!r}: socket {sock} out of range "
                f"(-1 = host view, else 0..{sockets_per_host - 1})")
        pr = (host, sock)
        if pr not in probes:
            probes.append(pr)
    return tuple(probes)


def resolve_edges(entries, vertex_names) -> tuple:
    """``"VS:VD"`` edge specs → tuple of (src_vertex, dst_vertex) int pairs.

    Each half is a topology vertex name (GraphML node id) or a numeric
    vertex id — the same namespace link records report. Used by the
    pcapdump ``--edge`` filter. Duplicates collapse, first occurrence wins
    the order. Every failure raises WatchlistError with a typo-grade
    message (the CLI maps it onto ap.error → EXIT_CONFIG, like the probe
    watchlist)."""
    names = [str(n) for n in (vertex_names or [])]
    idx = {n: i for i, n in enumerate(names)}
    n_v = len(names)

    def one(txt, whole):
        txt = txt.strip()
        if txt.lstrip("-").isdigit():
            v = int(txt)
            if not (0 <= v < n_v if n_v else v >= 0):
                raise WatchlistError(
                    f"edge {whole!r}: vertex id {v} out of range "
                    f"(vertices 0..{n_v - 1})")
            return v
        if txt in idx:
            return idx[txt]
        import difflib

        close = difflib.get_close_matches(txt, names, n=3)
        hint = f" — did you mean {', '.join(map(repr, close))}?" \
            if close else ""
        raise WatchlistError(
            f"edge {whole!r}: unknown vertex {txt!r}{hint}")

    edges: list[tuple[int, int]] = []
    for e in entries:
        txt = str(e)
        src, sep, dst = txt.partition(":")
        if not sep or not src.strip() or not dst.strip():
            raise WatchlistError(
                f"edge {txt!r}: expected SRC_VERTEX:DST_VERTEX")
        pr = (one(src, txt), one(dst, txt))
        if pr not in edges:
            edges.append(pr)
    return tuple(edges)


def build_experiment(doc: dict, base_dir: str = ".") -> tuple[CompiledExperiment, EngineParams, str]:
    """Experiment document → (CompiledExperiment, EngineParams, scheduler)."""
    import os

    _reject_unknown("top-level config", doc,
                    ("general", "engine", "network", "hosts", "app",
                     "faults", "sweep", "probes"))
    gen = doc.get("general", {})
    _reject_unknown("general:", gen, ("seed", "stop_time"))
    seed = int(gen.get("seed", 1))
    end_time = parse_time_ns(gen.get("stop_time", "10 s"))

    # -- engine ------------------------------------------------------------
    eng = dict(doc.get("engine", {}))
    scheduler = eng.pop("scheduler", "tpu")
    fields = {f.name: f for f in dataclasses.fields(EngineParams)}
    unknown = set(eng) - set(fields)
    assert not unknown, f"unknown engine params: {unknown}"
    assert "probes" not in eng, (
        "engine.probes is not settable — use the top-level 'probes:' section"
    )
    params = EngineParams(**{
        k: str(v) if fields[k].type in (str, "str") else int(v)
        for k, v in eng.items()
    })

    # -- network -----------------------------------------------------------
    net = doc.get("network", {})
    _reject_unknown("network:", net, ("graphml", "single_vertex", "jitter"))
    if "single_vertex" in net:
        _reject_unknown("network.single_vertex:", net["single_vertex"],
                        ("latency", "loss"))
    if "graphml" in net:
        path = net["graphml"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        names, lat_e, loss_e, directed = load_graphml(path)
        lat_vv, loss_vv = compile_paths(lat_e, loss_e, directed=directed)
    else:
        sv = net.get("single_vertex", {})
        names = ["v0"]
        lat_vv = np.full((1, 1), parse_time_ns(sv.get("latency", "10 ms")), np.int64)
        loss_vv = np.full((1, 1), float(sv.get("loss", 0.0)), np.float32)
    jitter = net.get("jitter")
    jitter_vv = (
        np.full_like(lat_vv, parse_time_ns(jitter)) if jitter is not None else None
    )

    # -- hosts -------------------------------------------------------------
    groups = _expand_hosts(doc.get("hosts", [{"name": "host", "count": 1}]))
    h = sum(g.count for g in groups)
    host_vertex = _vertex_assignment(groups, names, h)
    per_host = {k: np.zeros(h, np.int64) for k in (
        "bw_up", "bw_dn", "stop_time", "cpu_ns_per_event", "tx_qlen_bytes",
        "rx_qlen_bytes", "aqm_min_bytes", "aqm_max_bytes")}
    aqm_pmax = np.zeros(h, np.float64)
    for g in groups:
        for k, arr in per_host.items():
            arr[g.ids] = getattr(g, k)
        aqm_pmax[g.ids] = g.aqm_pmax if g.aqm_max_bytes else 0.0

    # -- app ---------------------------------------------------------------
    appsec = doc.get("app", {"model": "phold"})
    _reject_unknown("app:", appsec, ("model", "params", "defaults", "groups"))
    app = appsec["model"]
    schema = _APP_PARAMS.get(app)
    assert schema is not None, f"unknown app model {app!r}"
    dns = Dns.from_groups(groups, host_vertex)

    # Group-name references: "@name" → first host id of that group (the
    # registry's bare group name).
    def resolve(tree):
        if isinstance(tree, str) and tree.startswith("@"):
            return dns.resolve(tree[1:])
        if isinstance(tree, dict):
            return {k: resolve(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [resolve(v) for v in tree]
        return tree

    defaults = resolve(appsec.get("defaults", {}))
    group_cfg = resolve(appsec.get("groups", {}))
    model_cfg: dict[str, Any] = resolve(dict(appsec.get("params", {})))
    if schema:
        allowed = set(schema)
        assert set(defaults) <= allowed, \
            f"unknown app.defaults params: {set(defaults) - allowed}"
        host_names = {g.name for g in groups}
        assert set(group_cfg) <= host_names, \
            f"unknown app.groups host groups: {set(group_cfg) - host_names}"
        for gname, block in group_cfg.items():
            assert set(block) <= allowed, \
                f"unknown params in app.groups.{gname}: {set(block) - allowed}"
    for pname, (dtype, default, parser) in schema.items():
        model_cfg[pname] = _per_host_array(
            pname, dtype, default, parser, groups, defaults, group_cfg, h)
    from portbench.reference.oracle.schedule import parse_faults

    faults = parse_faults(doc.get("faults"), groups, names)
    if app == "bitcoin":
        _gen_bitcoin_cfg(model_cfg, h, seed)
    if app == "phold":
        model_cfg.setdefault("mean_delay_ns", float(10 * MS))
        model = "phold"
    else:
        model_cfg["app"] = app
        model = "net"

    exp = CompiledExperiment(
        n_hosts=h,
        seed=seed,
        end_time=end_time,
        lat_vv=lat_vv,
        loss_vv=loss_vv,
        host_vertex=host_vertex,
        model=model,
        model_cfg=model_cfg,
        jitter_vv=jitter_vv,
        aqm_pmax=aqm_pmax,
        faults=faults,
        dns=dns,
        vertex_names=[str(n) for n in names],
        **per_host,
    )
    exp.validate()
    # -- probes ------------------------------------------------------------
    # Flow-probe watchlist, resolved through the host name registry into
    # static (host, sock) pairs (telemetry/probes.py samples them).
    watch = doc.get("probes")
    if watch is not None:
        params = dataclasses.replace(
            params,
            probes=resolve_watchlist(watch, exp.dns, params.sockets_per_host))
    return exp, params, scheduler
