"""Deterministic fault plane — simulated host churn and link failure (port
of ``fault/``): a ``faults:`` config section compiles to dense tables
(``schedule.py``, numpy) that the engine applies on its device
(``plane.py``). Semantics: docs/SEMANTICS.md §"Fault plane".
"""

from shadow1_tpu_torch.fault.schedule import (  # noqa: F401
    FaultSchedule,
    host_interval_tensors,
    link_tables,
    parse_faults,
    ramp_tables,
)
