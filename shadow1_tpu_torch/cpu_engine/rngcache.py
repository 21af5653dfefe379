"""Block-cached counter RNG draws for the CPU oracle.

The oracle consumes draws one at a time. Draws are pure functions of
(purpose, host, counter); since the shared RNG (shadow1_tpu_torch.rng) is pure
integer arithmetic, the oracle evaluates its exact NumPy twins — zero
device dispatch, bit-identical values by construction (guarded by
tests/test_torch_oracle_rng.py). Blocks of
consecutive counters are still cached to amortize the vectorized hash.
"""

from __future__ import annotations

import numpy as np

from shadow1_tpu_torch import rng

_BLOCK = 256


class DrawCache:
    def __init__(self, seed: int):
        self.key = rng.base_key_np(seed)
        self._bits: dict[tuple, np.ndarray] = {}
        self._xf: dict[tuple, np.ndarray] = {}  # transformed-value blocks

    def _bits_block(self, purpose: int, host: int, blk: int) -> np.ndarray:
        k = (purpose, host, blk)
        got = self._bits.get(k)
        if got is None:
            ctrs = np.arange(blk * _BLOCK, (blk + 1) * _BLOCK, dtype=np.int64)
            got = rng.bits_np(self.key, purpose, np.int64(host), ctrs)
            self._bits[k] = got
        return got

    def bits(self, purpose: int, host: int, ctr: int) -> np.uint32:
        return self._bits_block(purpose, host, ctr // _BLOCK)[ctr % _BLOCK]

    def _xf_block(self, tag, purpose, host, ctr, fn) -> np.ndarray:
        """Whole-block transform (one vectorized call per block)."""
        blk = ctr // _BLOCK
        k = (tag, purpose, host, blk)
        got = self._xf.get(k)
        if got is None:
            got = fn(self._bits_block(purpose, host, blk))
            self._xf[k] = got
        return got

    def exponential_ns(self, purpose: int, host: int, ctr: int, mean_ns: float) -> int:
        blk = self._xf_block(
            ("e", mean_ns), purpose, host, ctr,
            lambda b: rng.exponential_ns_np(b, mean_ns),
        )
        return int(blk[ctr % _BLOCK])

    def randint(self, purpose: int, host: int, ctr: int, n: int) -> int:
        blk = self._xf_block(("r", n), purpose, host, ctr, lambda b: rng.randint_np(b, n))
        return int(blk[ctr % _BLOCK])
