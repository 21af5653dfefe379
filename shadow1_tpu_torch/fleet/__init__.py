"""Fleet mode — batched experiment sweeps as one device program (port of
``shadow1_tpu/fleet/``).

``expand``  — ``sweep:`` section expansion and fleet-contract validation
              (FleetPlan, FleetConfigError), a copy of the reference's.
``engine``  — FleetEngine: E experiment variants folded onto the host
              axis, run through the solo window loop and its kernels.
``run``     — the chunked fleet runner and its recovery plane.

Contracts: docs/SEMANTICS.md "Fleet contract" and "Fleet recovery
contract".
"""

from shadow1_tpu_torch.fleet.expand import (  # noqa: F401
    FleetConfigError,
    FleetPlan,
    expand_sweep,
    expand_sweep_docs,
    load_sweep,
)
