"""Per-window order-independent state digests (port of ``core/digest.py``).

One integer word per engine subsystem per conservative window, carried as
telemetry-ring columns (``telemetry/ring.py``): any two runs of the same
configuration — the JAX engine and the port, CPU and CUDA — must carry the
same stream, and the first (window, subsystem) that differs names where a
run went wrong.

Each semantic element (an occupied event slot, a buffered packet, a live
socket, a host's NIC or counter row) hashes to one u32 word: a polynomial
fold ``z = z * K + v`` of its semantic fields onto a per-subsystem seed,
then the splitmix finalizer twice and the top 32 bits. A subsystem's word
is the i64 sum of its element words (order-independent).

The reference folds in uint64. Here the same bit patterns live in int64
tensors: ``+`` and ``*`` wrap mod 2**64 alike, and the right shifts are
logical (``rng._srl``). i32 and bool fields enter as their low 32 bits
(``_u``), i64 fields as their bit pattern.
"""

from __future__ import annotations

import torch

from shadow1_tpu_torch.consts import NP, TCP_FREE
from shadow1_tpu_torch.core.events import tb_join
from shadow1_tpu_torch.rng import _i64, _mix, _srl

# The five digested subsystems, in canonical (ring-column) order.
SUBSYSTEMS = ("evbuf", "outbox", "tcp", "nic", "rng")

_K = _i64(0x2545F4914F6CDD1D)
SEED_EVBUF = _i64(0xA0761D6478BD642F)
SEED_OUTBOX = _i64(0xE7037ED1A0B428DB)
SEED_TCP = _i64(0x8EBC6AF09C88C6E3)
SEED_MQ = _i64(0x589965CC75374CC3)
SEED_NIC = _i64(0x1D8E4E27C47D124F)
SEED_RNG = _i64(0xEB44ACCAB455D165)

# The TCP plane's field order is the canonical fold order (tcp/tcp.py).
from shadow1_tpu_torch.tcp.tcp import (  # noqa: E402
    _FIELDS_BOOL as TCP_FIELDS_BOOL,
    _FIELDS_I32 as TCP_FIELDS_I32,
    _FIELDS_I64 as TCP_FIELDS_I64,
)


def _u(v: torch.Tensor) -> torch.Tensor:
    """Field → fold input: i32 and bool as their low 32 bits, i64 as is."""
    if v.dtype == torch.int64:
        return v
    return v.to(torch.int64) & 0xFFFFFFFF


def _words(seed: int, fields) -> torch.Tensor:
    """Element hash words (int64 in [0, 2**32)): fold ``fields``
    (broadcastable tensors) in order onto ``seed``, then finalize."""
    z = _i64(seed * _K) + _u(fields[0])
    for v in fields[1:]:
        z = z * _K + _u(v)
    return _srl(_mix(_mix(z)), 32)


def _masked_sum(words: torch.Tensor, mask) -> torch.Tensor:
    """i64 sum of the selected words (exact: each < 2**32)."""
    if mask is None:
        return words.sum()
    return torch.where(mask, words, 0).sum()


def digest_evbuf(buf, hosts) -> torch.Tensor:
    """Occupied event slots keyed by (host, time, tb, kind, payload)."""
    fields = [hosts[None, :], buf.abs_time(), tb_join(buf.tb_hi, buf.tb_lo),
              buf.kind] + [buf.p[i] for i in range(NP)]
    return _masked_sum(_words(SEED_EVBUF, fields), buf.kind != 0)


def digest_outbox(ob, hosts) -> torch.Tensor:
    """This window's buffered sends keyed by (src, dst, depart, ctr, kind,
    payload); taken before the window-end delivery clears the outbox."""
    cap = ob.dst.shape[0]
    mask = torch.arange(cap, device=ob.cnt.device)[:, None] < ob.cnt[None, :]
    fields = [hosts[None, :], ob.dst, ob.abs_depart(), ob.ctr,
              ob.kind] + [ob.p[i] for i in range(NP)]
    return _masked_sum(_words(SEED_OUTBOX, fields), mask)


def digest_tcp(tcp: dict, hosts) -> torch.Tensor:
    """Live sockets (st != TCP_FREE): every field in canonical order, plus
    the socket's valid message-boundary FIFO entries."""
    s = tcp["st"].shape[0]
    live = tcp["st"] != TCP_FREE
    socks = torch.arange(s, dtype=torch.int32, device=hosts.device)[:, None]
    fields = [hosts[None, :], socks]
    fields += [tcp[f] for f in TCP_FIELDS_I32]
    fields += [tb_join(tcp[f + "_hi"], tcp[f + "_lo"]) for f in TCP_FIELDS_I64]
    fields += [tcp[f] for f in TCP_FIELDS_BOOL]
    total = _masked_sum(_words(SEED_TCP, fields), live)
    mq = [hosts[None, None, :], socks[None], tcp["mq_end"], tcp["mq_meta"]]
    return total + _masked_sum(_words(SEED_MQ, mq),
                               tcp["mq_valid"] & live[None])


def digest_nic(nic, hosts) -> torch.Tensor:
    """Per-host NIC clocks and counters."""
    return _masked_sum(_words(SEED_NIC, [hosts, nic.tx_free, nic.rx_free,
                                         nic.tx_bytes, nic.rx_bytes,
                                         nic.aqm_ctr]), None)


def digest_rng(hosts, vectors) -> torch.Tensor:
    """Per-host deterministic counters: self_ctr, pkt_ctr, the virtual-CPU
    clocks and the model's draw counters (``model_host_vectors``)."""
    return _masked_sum(_words(SEED_RNG, [hosts] + list(vectors)), None)


def model_host_vectors(model) -> list:
    """The model-level [H] counters folded into the rng word: PHOLD's
    (hops, ctr); the net model has none (its NIC and TCP planes carry
    their own words, and app state is outside the digest)."""
    f = getattr(model, "_fields", ())
    if "hops" in f and "ctr" in f:
        return [model.hops, model.ctr]
    return []


def state_digests(st, ctx, dg_outbox) -> torch.Tensor:
    """The window's digest words, i64 [5] in SUBSYSTEMS order.
    ``dg_outbox`` was taken before the delivery; the rest digests the
    post-delivery window-boundary state."""
    hosts = ctx.hosts
    model = st.model
    mf = getattr(model, "_fields", ())
    zero = torch.zeros((), dtype=torch.int64, device=hosts.device)
    if "nic" in mf and "tcp" in mf:
        dg_tcp, dg_nic = digest_tcp(model.tcp, hosts), digest_nic(model.nic, hosts)
    else:
        dg_tcp = dg_nic = zero
    vectors = [st.evbuf.self_ctr, st.outbox.pkt_ctr, st.cpu_busy]
    vectors += model_host_vectors(model)
    return torch.stack([digest_evbuf(st.evbuf, hosts), dg_outbox, dg_tcp,
                        dg_nic, digest_rng(hosts, vectors)])
