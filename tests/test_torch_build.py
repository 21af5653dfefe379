"""The CUDA source's C entry points against the ctypes rows that bind them,
and the wrappers' argument handling, on the CPU (no ``nvcc``, no card).

``core/_build.py`` declares each entry point's argument types for ctypes
(``_SIGNATURES``). A stale row would pass a pointer as a 32-bit int or
shift every argument after a changed one, so these tests parse the
``extern "C"`` block of ``csrc/popk.cu`` and hold each declaration to its
row: the same count, ``c_void_p`` for every pointer and for the stream,
``c_int`` for every int.
"""

import ctypes
import re

import pytest
import torch

from shadow1_tpu_torch.core import _build, popk


def _entry_points() -> dict:
    src = _build.SOURCE.read_text()
    block = src[src.index('extern "C" {'):]
    return {m.group(1): [p.strip() for p in m.group(2).split(",") if p.strip()]
            for m in re.finditer(r"^int\s+(\w+)\s*\(([^)]*)\)\s*\{", block, re.M)}


def _ctype(param: str):
    if "*" in param or param.startswith("cudaStream_t "):
        return ctypes.c_void_p
    if re.fullmatch(r"(const\s+)?int\s+\w+", param):
        return ctypes.c_int
    raise AssertionError(f"no ctypes type for parameter {param!r}")


def test_every_entry_point_has_a_row():
    assert set(_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_source(name):
    params = _entry_points()[name]
    assert [_ctype(p) for p in params] == _build._SIGNATURES[name], params
    if params:  # a kernel's entry point launches on the caller's stream
        assert params[-1].startswith("cudaStream_t ")


def test_arg_passes_a_matching_tensor_through():
    x = torch.zeros(5, dtype=torch.int64)
    assert popk._arg(x, torch.int64, (5,), x.device) is x


@pytest.mark.parametrize("x,dtype,shape", [
    (3, torch.int64, ()),                                  # Python int
    (torch.tensor([True, False, True]), torch.int32, (3,)),  # dtype
    (torch.tensor(7, dtype=torch.int32), torch.int32, (4,)),  # broadcast
    (torch.arange(12, dtype=torch.int32).reshape(3, 4).T, torch.int32, (4, 3)),
])
def test_arg_converts_only_what_differs(x, dtype, shape):
    y = popk._arg(x, dtype, shape, torch.device("cpu"))
    assert y.dtype == dtype and tuple(y.shape) == shape and y.is_contiguous()
    assert torch.equal(y, torch.as_tensor(x).to(dtype).expand(shape))


@pytest.mark.parametrize("x,step", [
    (torch.tensor(7), 0),                                   # 0-d: one value
    (torch.arange(5, dtype=torch.int32), 1),                # a matching row
    (torch.tensor([True, False, True, True, False]), 1),    # a row to convert
])
def test_row_reads_a_0d_value_with_step_0(x, step):
    y, s = popk._row(x, torch.int32, 5, torch.device("cpu"))
    assert s == step and y.dtype == torch.int32 and y.dim() == step
    assert torch.equal(y.expand(5), x.to(torch.int32).expand(5))
    if x.dtype == torch.int32:
        assert y is x  # no device operation for a row that matches


@pytest.mark.parametrize("bad,what", [
    (torch.zeros((2, 3), dtype=torch.int64), "int64"),
    (torch.zeros((3, 2), dtype=torch.int32), "shape"),
    (torch.zeros((3, 2), dtype=torch.int32).T, "contiguous=False"),
])
def test_check_raises_with_the_argument_named(bad, what):
    good = torch.zeros((2, 3), dtype=torch.int32)
    cpu = torch.device("cpu")
    popk._check("k", cpu, (("a", good, torch.int32, (2, 3)),))
    with pytest.raises(ValueError, match=rf"k: b .*{what}"):
        popk._check("k", cpu, (("a", good, torch.int32, (2, 3)),
                               ("b", bad, torch.int32, (2, 3))))


def test_launch_counts_only_accepted_launches():
    seen = []

    def entry(*args):
        seen.append(args)
        return len(seen) - 1  # 0 the first time, a cudaError after

    t = torch.zeros(4, dtype=torch.int32)
    n = popk.LAUNCHES["pop"]
    popk._launch("pop", entry, t, None, 7)
    assert seen[0] == (t.data_ptr(), None, 7)
    assert popk.LAUNCHES["pop"] == n + 1
    with pytest.raises(RuntimeError, match="cudaError 1"):
        popk._launch("pop", entry, t, None, 7)
    assert popk.LAUNCHES["pop"] == n + 1
