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
is the i64 sum of its element words (order-independent). In a fleet
(``n_exp`` lanes folded onto the host axis, ``core/lanes.py``) each word is
summed per lane, so lane e carries the words of a solo run of its
experiment.

The reference folds in uint64. Here the same bit patterns live in int64
tensors: ``+`` and ``*`` wrap mod 2**64 alike, and the right shifts are
logical (``rng._srl``). i32 and bool fields enter as their low 32 bits
(``_u``), i64 fields as their bit pattern.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from shadow1_tpu_torch.consts import NP, TCP_FREE
from shadow1_tpu_torch.core.events import tb_join
from shadow1_tpu_torch.rng import _i64, _mix, _mix_np, _srl

# The five digested subsystems, in canonical (ring-column) order.
SUBSYSTEMS = ("evbuf", "outbox", "tcp", "nic", "rng")
DIGEST_FIELDS = tuple(f"dg_{s}" for s in SUBSYSTEMS)

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


def _masked_sum(words: torch.Tensor, mask, n_exp: int = 0) -> torch.Tensor:
    """i64 sum of the selected words (exact: each < 2**32); per lane,
    ``[n_exp]``, when the host axis folds ``n_exp`` lanes (0: solo)."""
    if mask is not None:
        words = torch.where(mask, words, 0)
    if not n_exp:
        return words.sum()
    return words.reshape(-1, n_exp, words.shape[-1] // n_exp).sum(dim=(0, 2))


def digest_evbuf(buf, hosts, n_exp: int = 0) -> torch.Tensor:
    """Occupied event slots keyed by (host, time, tb, kind, payload)."""
    fields = [hosts[None, :], buf.abs_time(), tb_join(buf.tb_hi, buf.tb_lo),
              buf.kind] + [buf.p[i] for i in range(NP)]
    return _masked_sum(_words(SEED_EVBUF, fields), buf.kind != 0, n_exp)


def digest_outbox(ob, hosts, n_exp: int = 0) -> torch.Tensor:
    """This window's buffered sends keyed by (src, dst, depart, ctr, kind,
    payload); taken before the window-end delivery clears the outbox."""
    cap = ob.dst.shape[0]
    mask = torch.arange(cap, device=ob.cnt.device)[:, None] < ob.cnt[None, :]
    fields = [hosts[None, :], ob.dst, ob.abs_depart(), ob.ctr,
              ob.kind] + [ob.p[i] for i in range(NP)]
    return _masked_sum(_words(SEED_OUTBOX, fields), mask, n_exp)


def digest_tcp(tcp: dict, hosts, n_exp: int = 0) -> torch.Tensor:
    """Live sockets (st != TCP_FREE): every field in canonical order, plus
    the socket's valid message-boundary FIFO entries."""
    s = tcp["st"].shape[0]
    live = tcp["st"] != TCP_FREE
    socks = torch.arange(s, dtype=torch.int32, device=hosts.device)[:, None]
    fields = [hosts[None, :], socks]
    fields += [tcp[f] for f in TCP_FIELDS_I32]
    fields += [tb_join(tcp[f + "_hi"], tcp[f + "_lo"]) for f in TCP_FIELDS_I64]
    fields += [tcp[f] for f in TCP_FIELDS_BOOL]
    total = _masked_sum(_words(SEED_TCP, fields), live, n_exp)
    mq = [hosts[None, None, :], socks[None], tcp["mq_end"], tcp["mq_meta"]]
    return total + _masked_sum(_words(SEED_MQ, mq),
                               tcp["mq_valid"] & live[None], n_exp)


def digest_nic(nic, hosts, n_exp: int = 0) -> torch.Tensor:
    """Per-host NIC clocks and counters."""
    return _masked_sum(_words(SEED_NIC, [hosts, nic.tx_free, nic.rx_free,
                                         nic.tx_bytes, nic.rx_bytes,
                                         nic.aqm_ctr]), None, n_exp)


def digest_rng(hosts, vectors, n_exp: int = 0) -> torch.Tensor:
    """Per-host deterministic counters: self_ctr, pkt_ctr, the virtual-CPU
    clocks and the model's draw counters (``model_host_vectors``)."""
    return _masked_sum(_words(SEED_RNG, [hosts] + list(vectors)), None, n_exp)


def model_host_vectors(model) -> list:
    """The model-level [H] counters folded into the rng word: PHOLD's
    (hops, ctr); the net model has none (its NIC and TCP planes carry
    their own words, and app state is outside the digest)."""
    f = getattr(model, "_fields", ())
    if "hops" in f and "ctr" in f:
        return [model.hops, model.ctr]
    return []


def model_vector_names(model) -> list[str]:
    """Labels of ``model_host_vectors``' vectors, in the same order
    (paritytrace's plane dumps)."""
    f = getattr(model, "_fields", ())
    if "hops" in f and "ctr" in f:
        return ["hops", "ctr"]
    return []


def state_digests(st, ctx, dg_outbox) -> torch.Tensor:
    """The window's digest words, i64 [5] in SUBSYSTEMS order ([E, 5] in a
    fleet). ``dg_outbox`` was taken before the delivery; the rest digests
    the post-delivery window-boundary state."""
    hosts, n = ctx.hosts, getattr(ctx, "n_exp", 0)
    model = st.model
    mf = getattr(model, "_fields", ())
    zero = torch.zeros((n,) if n else (), dtype=torch.int64,
                       device=hosts.device)
    if "nic" in mf and "tcp" in mf:
        dg_tcp = digest_tcp(model.tcp, hosts, n)
        dg_nic = digest_nic(model.nic, hosts, n)
    else:
        dg_tcp = dg_nic = zero
    vectors = [st.evbuf.self_ctr, st.outbox.pkt_ctr, st.cpu_busy]
    vectors += model_host_vectors(model)
    return torch.stack([digest_evbuf(st.evbuf, hosts, n), dg_outbox, dg_tcp,
                        dg_nic, digest_rng(hosts, vectors, n)], dim=-1)


# ---------------------------------------------------------------------------
# Host-side twins for the numpy oracle (``cpu_engine/``): plain Python ints
# for its per-event and per-socket paths, numpy uint64 for its [H] planes.
# Same element words as the torch versions above.
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_K_U = _K & _M64


def _mix_int(z: int) -> int:
    z ^= z >> 30
    z = (z * 0xBF58476D1CE4E5B9) & _M64
    z ^= z >> 27
    z = (z * 0x94D049BB133111EB) & _M64
    z ^= z >> 31
    return z


def word_int(seed: int, fields) -> int:
    """One element's word from Python ints. i32-semantics fields come
    masked with ``& 0xFFFFFFFF``; i64 fields may be any int (folded mod
    2**64, the u64 reinterpretation)."""
    z = seed & _M64
    for v in fields:
        z = (z * _K_U + (int(v) & _M64)) & _M64
    return _mix_int(_mix_int(z)) >> 32


def event_word(host: int, time: int, tb: int, kind: int, p: tuple) -> int:
    """An event's word, as ``digest_evbuf`` hashes its slot; ``p`` is the
    (possibly short) payload tuple, missing columns zero."""
    fields = [host, time, tb, kind]
    fields += [int(p[i]) & _M32 if i < len(p) else 0 for i in range(NP)]
    return word_int(SEED_EVBUF, fields)


def packet_word(src: int, dst: int, depart: int, ctr: int, kind: int,
                p: tuple) -> int:
    """A send's word, as ``digest_outbox`` hashes its slot (``ctr`` is the
    sender's lifetime packet counter; the outbox plane keeps its low 32
    bits)."""
    fields = [src, dst, depart, ctr & _M32, kind]
    fields += [int(p[i]) & _M32 if i < len(p) else 0 for i in range(NP)]
    return word_int(SEED_OUTBOX, fields)


def sock_word(host: int, sock: int, k) -> int:
    """A live socket's words, as ``digest_tcp`` hashes it: ``k`` is the
    oracle's ``CpuSock``, its fields in the canonical tcp-plane order, then
    its message-boundary FIFO entries."""
    fields = [host, sock]
    fields += [getattr(k, f) & _M32 for f in TCP_FIELDS_I32]
    fields += [getattr(k, f) for f in TCP_FIELDS_I64]
    fields += [1 if getattr(k, f) else 0 for f in TCP_FIELDS_BOOL]
    total = word_int(SEED_TCP, fields)
    for end, meta in k.mq:
        total += word_int(SEED_MQ, [host, sock, end & _M32, meta & _M32])
    return total


def digest_socks_np(live) -> int:
    """The sum of ``sock_word`` over ``live``, a list of (host, sock,
    CpuSock) triples, as one numpy fold over all of them (the oracle's
    tcp word at a window boundary; every field fits int64)."""
    if not live:
        return 0
    get = operator.attrgetter(*TCP_FIELDS_I32, *TCP_FIELDS_I64,
                              *TCP_FIELDS_BOOL)
    cols = np.array([(h, s, *get(k)) for h, s, k in live], np.int64).T
    n32 = 2 + len(TCP_FIELDS_I32)
    cols[2:n32] &= _M32
    total = int(_words_np(SEED_TCP, list(cols)).astype(np.int64).sum())
    mq = [(h, s, end & _M32, meta & _M32)
          for h, s, k in live for end, meta in k.mq]
    if mq:
        total += int(_words_np(SEED_MQ, list(np.array(mq, np.int64).T))
                     .astype(np.int64).sum())
    return total


def _words_np(seed: int, fields) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = np.uint64(seed & _M64)
        for v in fields:
            v = np.asarray(v)
            if v.dtype == np.int32 or v.dtype == np.bool_:
                v = v.astype(np.uint32)
            z = z * np.uint64(_K_U) + v.astype(np.uint64)
        return (_mix_np(_mix_np(z)) >> np.uint64(32)).astype(np.uint32)


def digest_nic_np(tx_free, rx_free, tx_bytes, rx_bytes, aqm_ctr) -> int:
    """``digest_nic`` over the oracle's [H] NIC arrays."""
    h = np.arange(len(tx_free), dtype=np.int64)
    w = _words_np(SEED_NIC, [h, tx_free, rx_free, tx_bytes, rx_bytes,
                             aqm_ctr])
    return int(w.astype(np.int64).sum())


def digest_rng_np(vectors) -> int:
    """``digest_rng`` over the oracle's [H] counter arrays."""
    h = np.arange(len(vectors[0]), dtype=np.int64)
    w = _words_np(SEED_RNG, [h] + list(vectors))
    return int(w.astype(np.int64).sum())
