"""The counter-based draws and the digest words, in plain PyTorch int64.

A draw is a pure function of (seed, purpose, host, counter): a
splitmix64-style hash of ``key + purpose·P1 + host·P2 + counter·P3``,
mixed twice, top 32 bits. The exponential maps those bits through a Q32
fixed-point ``−ln(1 − u)`` (a 4,097-entry log2 table, linear
interpolation on 24 bits) and scales by the rounded mean. A digest word
folds an element's fields ``z = z·K + v`` onto a per-subsystem seed and
hashes the same way. The u64 arithmetic lives in int64 tensors: ``+`` and
``*`` wrap alike, and every right shift is logical (``srl``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

M64 = (1 << 64) - 1


def i64(u: int) -> int:
    u &= M64
    return u - (1 << 64) if u >> 63 else u


C1 = i64(0xBF58476D1CE4E5B9)
C2 = i64(0x94D049BB133111EB)
P1 = 0x9E3779B97F4A7C15
P2 = i64(0xC2B2AE3D27D4EB4F)
P3 = i64(0x165667B19E3779F9)
K = i64(0x2545F4914F6CDD1D)
SEED_EVBUF = i64(0xA0761D6478BD642F)
SEED_OUTBOX = i64(0xE7037ED1A0B428DB)
SEED_RNG = i64(0xEB44ACCAB455D165)


def srl(z: torch.Tensor, s: int) -> torch.Tensor:
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix(z: torch.Tensor) -> torch.Tensor:
    z = z ^ srl(z, 30)
    z = z * C1
    z = z ^ srl(z, 27)
    z = z * C2
    return z ^ srl(z, 31)


def base_key(seed: int) -> int:
    return i64(int(seed) * 0x9E3779B97F4A7C15 + 0x94D049BB133111EB)


def bits(key: int, purpose: int, host, ctr) -> torch.Tensor:
    """u32 draws in [0, 2**32) as int64."""
    z = (host.to(torch.int64) * P2 + ctr.to(torch.int64) * P3
         + i64(int(key) + int(purpose) * P1))
    return srl(mix(mix(z)), 32)


def randint(b: torch.Tensor, n: int) -> torch.Tensor:
    """[0, n) by 64-bit multiply and shift."""
    return srl(b * n, 32)


LOG_BITS = 12
LOG_TABLE = np.round(np.log2(1.0 + np.arange(2 ** LOG_BITS + 1)
                             / 2 ** LOG_BITS) * 2.0 ** 32).astype(np.int64)
LN2_Q27 = int(round(np.log(2.0) * 2 ** 32)) >> 5


@functools.cache
def _table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(LOG_TABLE, device=device)


def exponential_ns(b: torch.Tensor, mean: float) -> torch.Tensor:
    """Exponential int64 ns with the given mean, at least 1."""
    x = (1 << 32) - b
    _, e = torch.frexp(x.to(torch.float64))
    k = e.to(torch.int64) - 1
    m = torch.bitwise_left_shift(x, 63 - k)
    frac = m & ((1 << 63) - 1)
    idx = frac >> (63 - LOG_BITS)
    rem = (frac >> (63 - LOG_BITS - 24)) & ((1 << 24) - 1)
    tbl = _table(b.device)
    lo, hi = tbl[idx], tbl[idx + 1]
    log2_x = (k << 32) + lo + (((hi - lo) * rem) >> 24)
    e_q32 = srl(((32 << 32) - log2_x) * LN2_Q27, 27)
    mean_i = min(int(np.round(np.float64(mean))), 1 << 38)
    d = mean_i * (e_q32 >> 32) + ((mean_i * ((e_q32 & 0xFFFFFFFF) >> 7)) >> 25)
    return torch.clamp(d, min=1)


def words(seed: int, fields) -> torch.Tensor:
    """Element words: fold the (broadcasting, non-negative int64) fields
    onto ``seed``, then hash."""
    z = i64(seed * K) + fields[0]
    for v in fields[1:]:
        z = z * K + v
    return srl(mix(mix(z)), 32)
