"""YAML experiment files → CompiledExperiment — the port's numpy copy.

The schema and validation of the JAX package's
``shadow1_tpu/config/experiment.py`` for what this slice runs, so one YAML
file compiles to the same ``CompiledExperiment`` and ``EngineParams`` in
both packages:

    general:  {seed: 1, stop_time: 60 s}
    engine:   {scheduler: tpu, ev_cap: 256, ...}   # any EngineParams field
    network:  {single_vertex: {latency: 10 ms, loss: 0.01}} | {graphml: f}
    hosts:    [{name: h, count: 8, vertex: 0, bandwidth_up: 100 Mbit}, ...]
    app:      {model: phold, params: {mean_delay_ns: ..., init_events: ...}}

The ``app:`` section compiles to per-host arrays as in the reference:
each schema parameter takes its ``defaults:`` value, then each host group's
``groups:`` value — a scalar, a list (one per host) or a stagger
``{start, interval}`` — and ``"@name"`` names the first host of a group.

Sections this slice of the port does not run fail loudly with a
``NotImplementedError`` naming the ROADMAP item that adds them: ``faults:``
(fault plane and fidelity gates), ``probes:`` (checkpoint and
observability) and the apps ``dgram``, ``tgen``, ``tor`` and ``bitcoin``
(the other apps). ``sweep:`` runs the base experiment, as a solo run of the
reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from shadow1_tpu_torch.config.compiled import NO_STOP, CompiledExperiment
from shadow1_tpu_torch.config.dns import Dns
from shadow1_tpu_torch.config.topology import compile_paths, load_graphml
from shadow1_tpu_torch.consts import MS, NS, SEC, US, EngineParams

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
    "phold": {},
}
_OTHER_APPS = ("dgram", "tgen", "tor", "bitcoin")


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


def build_experiment(doc: dict, base_dir: str = ".") -> tuple[CompiledExperiment, EngineParams, str]:
    """YAML document → (CompiledExperiment, EngineParams, scheduler)."""
    import os

    _reject_unknown("top-level config", doc,
                    ("general", "engine", "network", "hosts", "app",
                     "faults", "sweep", "probes"))
    if doc.get("faults") is not None:
        raise NotImplementedError(
            "faults: is not ported yet (ROADMAP: fault plane and fidelity "
            "gates)")
    if doc.get("probes") is not None:
        raise NotImplementedError(
            "probes: is not ported yet (ROADMAP: checkpoint and "
            "observability)")
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
    if app in _OTHER_APPS:
        raise NotImplementedError(
            f"app model {app!r} is not ported yet (ROADMAP: the other apps)")
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
        dns=dns,
        vertex_names=[str(n) for n in names],
        **per_host,
    )
    exp.validate()
    return exp, params, scheduler


def load_experiment(path: str):
    """Load a YAML experiment file → (CompiledExperiment, EngineParams,
    scheduler). ``yaml`` is imported here, not at module import: the
    machine with the card has no ``pyyaml``, and code that builds its
    experiments in Python must not need it."""
    import os

    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    return build_experiment(doc, base_dir=os.path.dirname(os.path.abspath(path)))
