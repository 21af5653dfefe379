"""Occupancy-driven capacity tuning (port of ``tune/``).

* ``ladder``  — the geometric cap ladder every tuned cap is quantized to;
* ``resize``  — bit-exact migration of the event-buffer/outbox planes to a
  new capacity, on the state's device;
* ``autocap`` — the between-chunk controller behind ``--auto-caps``.
"""

from shadow1_tpu_torch.tune.autocap import CapController, CapPolicy
from shadow1_tpu_torch.tune.ladder import (
    cap_ladder,
    next_step,
    quantize_cap,
    recommend_cap,
)
from shadow1_tpu_torch.tune.resize import (
    resize_evbuf,
    resize_outbox,
    resize_state,
)

__all__ = [
    "CapController",
    "CapPolicy",
    "cap_ladder",
    "next_step",
    "quantize_cap",
    "recommend_cap",
    "resize_evbuf",
    "resize_outbox",
    "resize_state",
]
