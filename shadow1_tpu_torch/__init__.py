"""shadow1_tpu_torch — the PyTorch/CUDA port of the shadow1_tpu simulator.

A second package beside ``shadow1_tpu`` (the JAX package, which stays the
reference): the same conservative-window batched discrete-event engine,
written as PyTorch tensor code, with the JAX package's Pallas kernels
(``shadow1_tpu/core/popk.py``) rewritten by hand in CUDA C++ for Hopper
(``csrc/popk.cu``, built with ``nvcc`` for ``sm_90a`` at first use).

Module names follow the JAX package, so each part's counterpart is found
under the same path. The port imports ``torch`` and never ``jax``, and
nothing of ``shadow1_tpu``: the jax-free pieces it needs (``consts``,
``config/``, ``tune/ladder.py``, the error classes of ``txn.py``) are its
own copies.

Determinism is the contract: every op is integer arithmetic (the RNG is
counter-based, ``rng.py``), so the port reproduces the JAX engine's metrics
and state bit for bit (``tests/test_torch_*.py``).

Entry points (``core.engine.Engine``, ``fleet.engine.FleetEngine``,
``python -m shadow1_tpu_torch``, with ``--fleet`` for a ``sweep:``) run
on the CUDA device unless the caller asks for ``device="cpu"``; with no
card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
