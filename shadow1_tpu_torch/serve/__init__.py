"""Simulation-as-a-service — the persistent multi-tenant engine daemon
(port of ``serve/``).

The batch CLI builds its engine, its device tables and (on a first run)
the CUDA kernels on every invocation. This package turns the engine into
a long-lived server on one card, so repeat-shape traffic reuses a built
engine:

* ``python -m shadow1_tpu_torch serve --spool DIR`` — the daemon
  (:mod:`serve.daemon`): accepts YAML or JSON experiment configs over a
  filesystem spool + Unix-socket JSON-line protocol, admits them against
  the device memory budget (:mod:`shadow1_tpu_torch.mem` pre-flight,
  priced off the card BEFORE any engine is built), packs
  shape-compatible jobs into fleet lanes (:mod:`shadow1_tpu_torch.fleet`),
  and streams per-job telemetry into the spool. It runs on CUDA unless
  given ``--device cpu``; with no card it raises;
* ``python -m shadow1_tpu_torch submit CONFIG --spool DIR`` — the client
  (:mod:`serve.client`): submits, streams status, awaits the result, and
  exits the solo CLI's taxonomy codes (EXIT_CONFIG / EXIT_MEMORY for
  rejections, EXIT_CAPACITY for a quarantined lane);
* the **hot engine cache** (:mod:`serve.cache`): built fleet engines
  keyed by (shape class, caps, engine knobs, lane count, device) — a
  repeat-shape batch REBINDS its per-job variants into the cached engine
  (``FleetEngine.rebind``) and builds none.

The serving contract (docs/SEMANTICS.md §"Serving contract"): a job run
through the daemon produces a digest stream and parity counters
bit-identical to the same config run through the solo CLI — lanes cannot
interact, so cohabitation is observable only in wall time.
``shadow1_tpu_torch/tools/serveprobe.py`` proves it end to end per
invocation.
"""

from shadow1_tpu_torch.serve.protocol import Spool, new_job_id  # noqa: F401
