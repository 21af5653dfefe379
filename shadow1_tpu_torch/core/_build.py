"""Build and load the hand-written CUDA kernels (``csrc/popk.cu``).

``nvcc`` compiles the source for Hopper (``sm_90a``) into a shared library
with a plain C interface, ``build/shadow1_tpu_torch/libpopk.so`` under the
checkout, at first use; ``ctypes`` loads it. A stamp file beside the
library holds the source's hash, so an edited source rebuilds and an
unchanged one loads in milliseconds. Nothing here runs at import: the CPU
tests import every module of the port on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from shadow1_tpu_torch.consts import NP

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "popk.cu"
BUILD_DIR = _PKG.parent / "build" / "shadow1_tpu_torch"
LIBRARY = BUILD_DIR / "libpopk.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/popk.cu's entry points: every pointer and the stream
# are c_void_p (ctypes would pass a bare Python int as a 32-bit int).
_SIGNATURES = {
    "popk_pop": [_P] * 14 + [_I, _I, _P],
    "popk_push": [_P] * 18 + [_I, _I, _I, _P],
    "popk_obox": [_P] * 16 + [_I] * 5 + [_P],
    "popk_np": [],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of shadow1_tpu_torch are built at first use")
    return found


def build() -> dict:
    """Compile ``csrc/popk.cu`` unless the library is current. Returns
    {"seconds", "built", "log"}; ``log`` is nvcc's register/spill report
    (``-Xptxas -v``) when it compiled."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()
    stamp = LIBRARY.with_suffix(".so.sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return {"seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libpopk.{os.getpid()}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    stamp.write_text(digest)
    return {"seconds": time.perf_counter() - t0, "built": True,
            "log": proc.stderr}


def load(path: Path) -> ctypes.CDLL:
    """A library built from ``csrc/popk.cu`` (or a variant of it with the
    same entry points), with each entry point's C signature bound."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if lib.popk_np() != NP:
        raise RuntimeError(f"{path} was built for NP={lib.popk_np()} "
                           f"payload words, consts.NP is {NP}")
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once a process)."""
    build()
    return load(LIBRARY)
