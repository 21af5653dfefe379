"""Where the pop kernel's time goes, phase by phase, on a CUDA card.

    python tools/torch_pop_phases.py [--reps 5]

Builds a copy of ``shadow1_tpu_torch/csrc/popk.cu`` with ``%globaltimer``
stamps added to the pop kernel (nothing in the package changes): for each
warp, at its start, when its t32 loads have all arrived, when its passes
over the candidate slots are done, and when its outputs are issued. It runs
that kernel, with the L2 cache evicted first, on the arguments the bench
PHOLD hands ``pop_until`` at the rounds ``chip_smoke.py`` keeps (three rounds
in the middle of a window) and on a random bench-shape buffer, and prints
one JSON line: per case, the hosts that pop, the share of warps with a
candidate slot, the median over warps of each phase's length (ns, the
stream measured from the kernel's first warp start) and the kernel's span.
The stamps add a few instructions per warp, so the span runs a little
above the profiler's kernel time. Bench shape only (H a multiple of 32).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _stamp(i: int, flag: str = "0") -> str:
    return ("  __syncwarp();\n  if (threadIdx.x % 32 == 0) ts_[(h / 32) * 4 + "
            f"{i}] = gtimer() | ((unsigned long long)({flag}) << 63);\n")


# (anchor in pop_kernel, text added after it); each anchor must occur once.
PATCHES = [
    ("  if (h >= H) return;\n", _stamp(0)),
    ("    for (int k = 0; k < kPopBatch; ++k) rem |= (uint64_t)(t[k] < u) << k;\n",
     "    if (c0 == 0) {\n      const bool any_ = __any_sync(0xffffffffu, rem != 0);\n"
     + _stamp(1, "any_") + "    }\n"),
    ("  // bt < u exactly when some slot was eligible (mask = min_t < u32).\n",
     _stamp(2)),
    ("    kind[s] = kNone;\n  }\n", _stamp(3)),
]
ENTRY = r'''
extern "C" int pop_phases(const int64_t* until, const int64_t* epoch,
    int32_t* t32, const int32_t* tb_hi, const int32_t* tb_lo, int32_t* kind,
    const int32_t* p, const int32_t* n_elig, uint8_t* mask_out,
    int64_t* time_out, int64_t* tb_out, int32_t* kind_out, int32_t* p_out,
    int32_t* n_elig_out, int C, int H, unsigned long long* ts_,
    cudaStream_t stream) {
  pop_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(until,
      epoch, t32, tb_hi, tb_lo, kind, p, n_elig, mask_out, time_out, tb_out,
      kind_out, p_out, n_elig_out, C, H, ts_);
  return (int)cudaGetLastError();
}
'''


def instrumented_source(src: str) -> str:
    """popk.cu up to its C entry points, with the pop kernel stamped."""
    head = src[:src.index('extern "C" {')]
    start = head.index("pop_kernel(")
    pop_end = head.index("__global__", start)
    pop = head[start:pop_end]
    for anchor, add in PATCHES:
        if pop.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in pop_kernel: {anchor!r}")
        pop = pop.replace(anchor, anchor + add)
    pop = pop.replace("int C, int H) {", "int C, int H, unsigned long long* ts_) {", 1)
    timer = ("__device__ __forceinline__ unsigned long long gtimer() {\n"
             "  unsigned long long t;\n"
             '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
             "  return t;\n}\n\n")
    head = head[:start] + pop + head[pop_end:]
    ns = head.index("namespace {\n") + len("namespace {\n")
    return head[:ns] + timer + head[ns:] + ENTRY


def phases(lib, buf, until, flush, reps: int) -> dict:
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP

    cap, h = buf.kind.shape
    if h % 32:
        raise SystemExit("bench shape only: H must be a multiple of 32")
    nw = h // 32
    dev = buf.kind.device
    ts = torch.zeros(nw * 4, dtype=torch.int64, device=dev)
    outs = [torch.empty(h, dtype=torch.bool, device=dev),
            torch.empty(h, dtype=torch.int64, device=dev),
            torch.empty(h, dtype=torch.int64, device=dev),
            torch.empty(h, dtype=torch.int32, device=dev),
            torch.empty((NP, h), dtype=torch.int32, device=dev),
            torch.empty(h, dtype=torch.int32, device=dev)]
    rows = []
    low = np.uint64((1 << 63) - 1)
    for _ in range(reps):
        work = type(buf)(*(x.clone() for x in buf))
        flush.max()
        torch.cuda.synchronize()
        err = lib.pop_phases(
            until.data_ptr(), work.epoch.data_ptr(), work.t32.data_ptr(),
            work.tb_hi.data_ptr(), work.tb_lo.data_ptr(), work.kind.data_ptr(),
            work.p.data_ptr(), work.n_elig.data_ptr(),
            *(o.data_ptr() for o in outs), cap, h, ts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise SystemExit(f"launch failed: cudaError {err}")
        a = ts.view(nw, 4).cpu().numpy().view(np.uint64)
        t = (a & low).astype(np.int64)
        t = t - t[:, 0].min()
        rows.append({
            "span_ns": int(t[:, 3].max()),
            "stream_ns": float(np.median(t[:, 1])),
            "passes_ns": float(np.median(t[:, 2] - t[:, 1])),
            "writes_ns": float(np.median(t[:, 3] - t[:, 2])),
            "warps_with_candidates": float((a[:, 1] >> np.uint64(63)).mean()),
        })
    out = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    out["pops"] = int(outs[0].sum())
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from shadow1_tpu_torch.core import _build

    build = _build.BUILD_DIR / "phases"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "popk_phases.cu"
    src.write_text(instrumented_source(_build.SOURCE.read_text()))
    lib_path = build / "libpopk_phases.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        print(proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    lib.pop_phases.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 2
    lib.pop_phases.restype = ctypes.c_int

    dev = torch.device("cuda")
    with cs.PathCapture() as cap:
        cs.run_golden("bench", dev)
    g = np.random.default_rng(20261016)
    cases = {f"path round {r}": args_ for r, args_ in
             zip(cs.PATH_ROUNDS, cap.cases["pop"])}
    cases["random"] = (cs.random_evbuf(g, dev),
                       torch.tensor(10**9 + 1000, device=dev))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rec = {"card": cs.card_line(), "window": cs.PATH_WINDOW,
           "cases": {name: phases(lib, buf, until, flush, args.reps)
                     for name, (buf, until) in cases.items()}}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
