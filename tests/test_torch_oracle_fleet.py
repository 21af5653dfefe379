"""The port's ``fleetprobe`` against the JAX package's, on the CPU.

A small sweep (three 8-host PHOLD lanes, one of them lossy) with
``--sides tpu,cpu``: the port's ``FleetEngine`` against its solo
``Engine`` and its numpy oracle, lane by lane; and the same sweep
under-capped (``ev_cap`` 8) with ``--retry``: the retried fleet against
the straight fleet at the grown caps and the oracle at those caps. The
port's verdicts must equal the reference's field for field (the verdict
holds no wall time), and both must be ok. Bit-exact (digest words).
"""

from __future__ import annotations

import pytest

from tests.test_torch_oracle_tools import _last_json, _main

SWEEP = """
general: {{seed: 5, stop_time: 40 ms}}
engine: {{scheduler: tpu, ev_cap: {cap}}}
network: {{single_vertex: {{latency: 1 ms}}}}
hosts:
  - {{name: h, count: 8}}
app:
  model: phold
  params: {{mean_delay_ns: 2000000.0, init_events: 6}}
sweep:
  seeds: [5, 6, 7]
  vary:
    - {{}}
    - {{network: {{single_vertex: {{loss: 0.2}}}}}}
    - {{}}
"""


@pytest.mark.parametrize("mode", ["sides", "retry"])
def test_fleetprobe_verdict_matches_jax(tmp_path, mode):
    from shadow1_tpu.tools import fleetprobe as fj
    from shadow1_tpu_torch.tools import fleetprobe as ft

    cfg = tmp_path / "sweep.yaml"
    cfg.write_text(SWEEP.format(cap=8 if mode == "retry" else 64))
    argv = [str(cfg), "--sides", "tpu,cpu", "--windows", "20", "--json-only"]
    if mode == "retry":
        argv += ["--retry", "--chunk", "5"]
    rc, out, _ = _main(ft, argv + ["--device", "cpu"])
    rc_j, out_j, _ = _main(fj, argv)
    assert rc == rc_j == 0
    v = _last_json(out)
    assert v == _last_json(out_j) and v["ok"] is True
    if mode == "retry":
        assert v["chunk_retries"] > 0
    else:
        assert v["streams_compared"] == {"tpu": 3, "cpu": 3}
