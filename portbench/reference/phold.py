"""Plain PyTorch PHOLD: what a pass of the ``phold`` configuration must
produce, written from the semantics alone (``docs/SEMANTICS.md``).

Every host keeps up to ``ev_cap`` pending events, each a (time, tie-break)
pair. Time advances in conservative windows of the path latency. In each
window, rounds run while some host holds an event due before the window's
end (at most ``max_rounds``): every such host takes its earliest event by
(time, tie-break), draws a delay (exponential, mean ``mean_delay_ns``) and
a destination (uniform over the hosts) from its counter ``ctr``, and
schedules the next hop at time + delay: on itself when the draw names it
(tie-break: its own push counter), else through its outbox (at most
``outbox_cap`` a window; tie-break: ``2**62 + src·2**32 + the sender's
packet counter``). At the window's end every outbox packet arrives at its
destination one latency later (the loss draw decides first), into the
destination's free slots in (destination, slot, source) order. The draws
are the counter-based integer hash of (seed, purpose, host, counter) and
the Q32 fixed-point exponential.

The state here is plain tensors: times and tie-breaks ``[C, H]`` (empty
slots hold ``FREE``), the outbox as ``[P, H]`` rows, the counters ``[H]``.
Every window gives the telemetry row the engine records (counter deltas,
work gauges, fill gauges, the five digest words) and the run gives the
final counters and the per-host hop counts. Imports nothing of the
program: the constants, the hash, the exponential and the digest words
are written out here.
"""

from __future__ import annotations

import torch

from portbench.reference import words as W
from portbench.reference.timeparse import parse_time_ns

FREE = (1 << 63) - 1
TB_PACKET_BASE = 1 << 62
K_PHOLD = 1
NP = 10
R_PHOLD_DELAY = 1
R_PHOLD_DST = 2
R_LOSS = 3

# The engine's Metrics fields, in order; those PHOLD never moves stay 0.
METRIC_FIELDS = (
    "events", "rounds", "windows", "pkts_sent", "pkts_delivered",
    "pkts_lost", "ev_overflow", "ob_overflow", "round_cap_hits",
    "tcp_fast_rtx", "tcp_rto", "tcp_ooo_drops", "x2x_overflow",
    "x2x_max_fill", "ev_max_fill", "ob_max_fill", "compact_max_fill",
    "down_events", "down_pkts", "nic_tx_drops", "nic_rx_drops",
    "nic_aqm_drops", "pops_pkt", "pops_deliver", "pops_timer", "pops_txr",
    "pops_app", "fires_pkt", "fires_deliver", "fires_timer", "fires_txr",
    "fires_app", "link_down_pkts", "host_restarts", "active_hosts",
    "elig_events", "outbox_hosts")
RING_DELTAS = (
    "events", "rounds", "pkts_sent", "pkts_delivered", "pkts_lost",
    "ev_overflow", "ob_overflow", "x2x_overflow", "down_events", "down_pkts",
    "link_down_pkts", "host_restarts", "active_hosts", "elig_events",
    "outbox_hosts")


def spec(doc: dict) -> dict:
    """The sizes a run needs, read from the experiment document."""
    eng, app = doc.get("engine", {}), doc["app"]
    sv = doc["network"]["single_vertex"]
    return {
        "hosts": sum(int(g.get("count", 1)) for g in doc["hosts"]),
        "ev_cap": int(eng["ev_cap"]), "outbox_cap": int(eng["outbox_cap"]),
        "max_rounds": int(eng["max_rounds"]),
        "latency": parse_time_ns(sv["latency"]),
        "loss": float(sv.get("loss", 0.0)),
        "mean": float(app["params"]["mean_delay_ns"]),
        "init_events": int(app["params"].get("init_events", 1)),
    }


def delay_exact(bits: torch.Tensor, mean: float) -> torch.Tensor:
    return W.exponential_ns(bits, mean)


def delay_float32(bits: torch.Tensor, mean: float) -> torch.Tensor:
    """The control's delay: the same draw through float32 ``log1p``."""
    u = bits.to(torch.float32) * (2.0 ** -32)
    d = torch.round(-torch.log1p(-u) * torch.tensor(mean, dtype=torch.float32))
    return torch.clamp(d.to(torch.int64), min=1)


class Phold:
    """One experiment's state and its windows."""

    def __init__(self, sp: dict, seed: int, device, control: str | None = None):
        self.sp, self.dev = sp, torch.device(device)
        self.key = W.base_key(seed)
        self.delay = delay_float32 if control == "delay_float32" else delay_exact
        h, c, p = sp["hosts"], sp["ev_cap"], sp["outbox_cap"]
        self.h, self.c, self.p = h, c, p
        i64 = dict(dtype=torch.int64, device=self.dev)
        self.hosts = torch.arange(h, **i64)
        self.time = torch.full((c, h), FREE, **i64)
        self.tb = torch.zeros((c, h), **i64)
        n0 = min(sp["init_events"], c)
        self.time[:n0] = 0
        self.tb[:n0] = torch.arange(n0, **i64)[:, None]
        self.self_ctr = torch.full((h,), n0, **i64)
        self.pkt_ctr = torch.zeros(h, **i64)
        self.ctr = torch.zeros(h, **i64)
        self.hops = torch.zeros(h, **i64)
        self.ob_dst = torch.zeros((p, h), **i64)
        self.ob_dep = torch.zeros((p, h), **i64)
        self.ob_ctr = torch.zeros((p, h), **i64)
        self.ob_cnt = torch.zeros(h, **i64)
        self.m = dict.fromkeys(METRIC_FIELDS, 0)
        self.m["ev_overflow"] = max(sp["init_events"] - c, 0) * h
        self.rows: list[dict] = []
        self.thr = int(round(sp["loss"] * 2.0 ** 32))

    # -- one window ----------------------------------------------------------
    def window(self, w: int) -> None:
        win_end = (w + 1) * self.sp["latency"]
        m0 = dict(self.m)
        due = (self.time < win_end).sum(dim=0)
        n_act = int((due > 0).sum())
        self.m["compact_max_fill"] = max(self.m["compact_max_fill"], n_act)
        self.m["active_hosts"] += n_act
        self.m["elig_events"] += int(due.sum())
        r = 0
        while r < self.sp["max_rounds"] and bool((self.time < win_end).any()):
            self.round(win_end)
            r += 1
        if r >= self.sp["max_rounds"] and bool((self.time < win_end).any()):
            self.m["round_cap_hits"] += 1
        dg_ob = self.digest_outbox()
        self.deliver()
        fill = int((self.time != FREE).sum(dim=0).max())
        self.m["ev_max_fill"] = max(self.m["ev_max_fill"], fill)
        self.m["windows"] += 1
        row = {"window": w}
        row.update({f: self.m[f] - m0[f] for f in RING_DELTAS})
        row.update(evbuf_fill=fill, ev_max_fill=self.m["ev_max_fill"],
                   ob_max_fill=self.m["ob_max_fill"],
                   compact_max_fill=self.m["compact_max_fill"],
                   x2x_max_fill=0, dg_evbuf=self.digest_evbuf(),
                   dg_outbox=dg_ob, dg_tcp=0, dg_nic=0,
                   dg_rng=self.digest_rng())
        self.rows.append(row)

    def round(self, win_end: int) -> None:
        due = self.time < win_end
        tmin = torch.where(due, self.time, FREE).amin(dim=0)
        cand = due & (self.time == tmin)
        tbmin = torch.where(cand, self.tb, FREE).amin(dim=0)
        sel = cand & (self.tb == tbmin)
        hit = sel.any(dim=0)
        self.time = torch.where(sel, FREE, self.time)
        delay = self.delay(W.bits(self.key, R_PHOLD_DELAY, self.hosts,
                                  self.ctr), self.sp["mean"])
        dst = W.randint(W.bits(self.key, R_PHOLD_DST, self.hosts, self.ctr),
                        self.h)
        t_next = tmin + delay
        local = hit & (dst == self.hosts)
        free = self.time == FREE
        has_free = free.any(dim=0)
        slot = torch.argmax(free.to(torch.int8), dim=0)
        ok = local & has_free
        put = ok[None, :] & (torch.arange(self.c, device=self.dev)[:, None]
                             == slot[None, :])
        self.time = torch.where(put, t_next, self.time)
        self.tb = torch.where(put, self.self_ctr, self.tb)
        self.self_ctr = self.self_ctr + ok
        remote = hit & ~local
        sent = remote & (self.ob_cnt < self.p)
        at = sent[None, :] & (torch.arange(self.p, device=self.dev)[:, None]
                              == self.ob_cnt[None, :])
        self.ob_dst = torch.where(at, dst, self.ob_dst)
        self.ob_dep = torch.where(at, t_next, self.ob_dep)
        self.ob_ctr = torch.where(at, self.pkt_ctr, self.ob_ctr)
        self.ob_cnt = self.ob_cnt + sent
        self.pkt_ctr = self.pkt_ctr + sent
        self.ctr = self.ctr + hit
        self.hops = self.hops + hit
        self.m["events"] += int(hit.sum())
        self.m["rounds"] += 1
        self.m["ev_overflow"] += int((local & ~has_free).sum())
        self.m["ob_overflow"] += int((remote & ~sent).sum())

    def deliver(self) -> None:
        """Route and scatter the window's outbox, then clear it."""
        p, h = self.p, self.h
        valid = (torch.arange(p, device=self.dev)[:, None]
                 < self.ob_cnt[None, :]).reshape(-1)
        src = self.hosts.expand(p, h).reshape(-1)[valid]
        dst = self.ob_dst.reshape(-1)[valid]
        dep = self.ob_dep.reshape(-1)[valid]
        ctr = self.ob_ctr.reshape(-1)[valid]
        order = torch.arange(p * h, device=self.dev)[valid]
        n = int(valid.sum())
        self.m["pkts_sent"] += n
        self.m["ob_max_fill"] = max(self.m["ob_max_fill"],
                                    int(self.ob_cnt.max()))
        self.m["outbox_hosts"] += int((self.ob_cnt > 0).sum())
        lost = W.bits(self.key, R_LOSS, src, ctr) < self.thr
        self.m["pkts_lost"] += int(lost.sum())
        keep = ~lost
        src, dst, dep, ctr, order = (x[keep] for x in (src, dst, dep, ctr,
                                                       order))
        arrival = dep + self.sp["latency"]
        tb = TB_PACKET_BASE + (src << 32) + (ctr & 0xFFFFFFFF)
        # Rebuild each host's slots: its pending events, then the arrivals
        # in (destination, outbox slot, source) order, up to ev_cap.
        occ = self.time != FREE
        c_idx, h_idx = torch.nonzero(occ, as_tuple=True)
        host = torch.cat([h_idx, dst])
        tim = torch.cat([self.time[c_idx, h_idx], arrival])
        tbs = torch.cat([self.tb[c_idx, h_idx], tb])
        rank_in = torch.cat([c_idx, self.c + order])
        key = host * (self.c + p * h) + rank_in
        key, perm = torch.sort(key)
        host, tim, tbs = host[perm], tim[perm], tbs[perm]
        first = torch.searchsorted(host, torch.arange(h, device=self.dev))
        rank = torch.arange(host.numel(), device=self.dev) - first[host]
        fits = rank < self.c
        self.m["ev_overflow"] += int((~fits).sum())
        self.m["pkts_delivered"] += int(keep.sum()) - int((~fits).sum())
        self.time = torch.full_like(self.time, FREE)
        self.tb = torch.zeros_like(self.tb)
        self.time[rank[fits], host[fits]] = tim[fits]
        self.tb[rank[fits], host[fits]] = tbs[fits]
        self.ob_cnt = torch.zeros_like(self.ob_cnt)

    # -- digest words --------------------------------------------------------
    def digest_evbuf(self) -> int:
        occ = self.time != FREE
        zeros = [torch.zeros((), dtype=torch.int64, device=self.dev)] * NP
        words = W.words(W.SEED_EVBUF, [self.hosts[None, :], self.time, self.tb,
                                       torch.tensor(K_PHOLD, device=self.dev)]
                        + zeros)
        return int(torch.where(occ, words, 0).sum())

    def digest_outbox(self) -> int:
        mask = (torch.arange(self.p, device=self.dev)[:, None]
                < self.ob_cnt[None, :])
        zeros = [torch.zeros((), dtype=torch.int64, device=self.dev)] * NP
        words = W.words(W.SEED_OUTBOX, [self.hosts[None, :], self.ob_dst,
                                        self.ob_dep, self.ob_ctr & 0xFFFFFFFF,
                                        torch.tensor(K_PHOLD, device=self.dev)]
                        + zeros)
        return int(torch.where(mask, words, 0).sum())

    def digest_rng(self) -> int:
        zero = torch.zeros_like(self.ctr)
        return int(W.words(W.SEED_RNG, [self.hosts, self.self_ctr,
                                        self.pkt_ctr, zero, self.hops,
                                        self.ctr]).sum())


def expected(doc: dict, seeds: list[int], n_windows: int, device,
             control: str | None = None) -> list[dict]:
    """Per seed: the final counters, the telemetry rows of windows
    0..n_windows-1 and the model summary."""
    sp = spec(doc)
    out = []
    for seed in seeds:
        ph = Phold(sp, seed, device, control)
        for w in range(n_windows):
            ph.window(w)
        hops = ph.hops.cpu().numpy()
        out.append({"metrics": dict(ph.m), "ring": ph.rows,
                    "summary": {"hops": hops, "total_hops": hops.sum()}})
        del ph
    return out
