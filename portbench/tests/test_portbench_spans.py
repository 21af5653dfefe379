"""The span pass (``spans.py``): the four per-layer metrics that read the
program's own tracer, through the whole harness on the CPU at test size;
its idle attribution on made-up intervals; and nothing read from a
program without the tracer.

Run: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import pytest

from portbench.tests.tiny import run_tiny

SEED = 2**31 + 91
NEW = ("round_ms.pop", "round_ms.handlers", "read_wait_ms_per_round",
       "read_idle_pct")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["phold.tiny", "tor.tiny"])
def test_traced_run_reads_the_span_metrics(cell, capsys):
    out = run_tiny(cell, SEED, trace=True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in NEW:
        assert got.get(name) is not None, name
    assert got["round_ms.pop"] > 0 and got["round_ms.handlers"] > 0
    assert 0 <= got["read_idle_pct"] <= 100


class _Tracer:
    """A stand-in for the program's tracer: its Chrome trace's spans."""

    base_ns = 1_000_000

    def __init__(self, spans):
        self.spans = spans

    def chrome_trace(self):
        return {"traceEvents": [
            {"name": n, "ph": "X", "ts": (s - self.base_ns) / 1e3,
             "dur": (e - s) / 1e3} for s, e, n in self.spans]}


def test_idle_goes_to_the_innermost_open_span():
    from portbench import spans

    b = _Tracer.base_ns
    tracer = _Tracer([(b, b + 1000, "portbench:spans"),
                      (b + 100, b + 900, "phase:rounds"),
                      (b + 200, b + 400, "round:pop"),
                      (b + 500, b + 600, "read:continue")])
    sp = spans.Spans(tracer)
    assert sp.sweep([b + 50, b + 250, b + 450, b + 550, b + 950,
                     b + 2000]) == [
        "portbench:spans", "round:pop", "phase:rounds", "read:continue",
        "portbench:spans", None]
    busy = [(b + 0, b + 210), (b + 300, b + 520), (b + 510, b + 700),
            (b + 900, b + 1000)]
    idle = spans.idle_by_span(sp, busy, b, b + 1000)
    assert idle == {"round:pop": [90, 1], "phase:rounds": [200, 1]}


def test_nothing_is_read_from_a_program_without_the_tracer(monkeypatch):
    from portbench import spans
    from portbench.harness import load_reader
    from shadow1_tpu_torch.telemetry import profiler

    monkeypatch.delattr(profiler, "active")

    class Cell:
        eng, span = object(), 1

    records = {"rounds": 10, "walls": [1.0]}
    cell = Cell()  # noqa: F841 - found through this frame, as in run_cell
    assert spans.of(records) is None
    for name in NEW:
        assert load_reader(name)(records) is None


class _Record:
    """A profiler record as a release without ``activity_type`` gives it."""

    def __init__(self, name, dev, corr, t0, t1=None):
        self.n, self.dev, self.corr = name, dev, corr
        self.t0, self.t1 = t0, t1 if t1 is not None else t0 + 1

    def name(self):
        return self.n

    def device_type(self):
        return self.dev

    def correlation_id(self):
        return self.corr

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1


def test_launches_and_copies_are_matched_to_their_issuing_span():
    from portbench import spans

    b = _Tracer.base_ns
    sp = spans.Spans(_Tracer([(b, b + 1000, "phase:rounds"),
                              (b + 100, b + 200, "round:pop"),
                              (b + 300, b + 400, "read:continue")]))
    events = [_Record("cudaLaunchKernel", "DeviceType.CPU", 1, b + 150),
              _Record("cudaMemcpyAsync", "DeviceType.CPU", 2, b + 350),
              _Record("cudaLaunchKernel", "DeviceType.CPU", 3, b + 500),
              _Record("pop_kernel", "DeviceType.CUDA", 1, b + 160, b + 170),
              _Record("Memcpy DtoH (Device -> Pageable)", "DeviceType.CUDA",
                      2, b + 360, b + 370),
              _Record("pop_kernel", "DeviceType.CUDA", 3, b + 510, b + 520),
              _Record("pop_kernel", "DeviceType.CUDA", 9, b + 600, b + 610)]
    assert spans.issued_inside(events, sp) == {
        "pop": {"records": 3, "matched": 2, "inside": 1},
        "d2h": {"records": 1, "matched": 1, "inside": 1}}
