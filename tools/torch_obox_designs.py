"""The outbox-append kernel's designs, timed side by side on a CUDA card.

    python tools/torch_obox_designs.py [--order kept,vote,one round trip,...]

``csrc/popk.cu``'s obox kernel ("kept") loads mask, cnt and pkt_ctr, writes
the [H] results, and only a host whose packet lands loads its value words:
two device-memory round trips, and only the landing hosts' sectors of the
value rows move. The alternatives are built here from copies of the
source in which only the obox kernel's body differs (nothing in the
package changes): "one round trip" issues every load, value words
included, before it tests anything (volatile loads: ptxas sinks ordinary
ones behind the test), so it waits on one round trip but moves every
host's value words; "vote" loads the value words of every lane of a warp
in which any lane's packet lands. For each design, in the order given (the
default runs each twice, mirrored, so that a drift of the card shows), it
measures:

* random: ``chip_smoke.py``'s obox check on its random bench-shape outbox
  (the edge cases bit-equal first; device time per launch, wrapper call);
* in path: on the arguments the bench PHOLD hands ``outbox_append`` at the
  rounds ``chip_smoke.py`` keeps, bit-equal to the plain version, with the
  L2 cache evicted before each launch;
* in situ: ``tools/torch_phold_profile.py`` over the bench run — the obox
  kernel's device time per launch, device ops per round, idle share.

Prints one JSON line with the byte and sector counts of the same data and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# The bodies of the alternative designs' obox_kernel (same signature).
ONE_TRIP_BODY = r"""
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const bool m = mask[h] != 0;
  const int32_t c = cnt[h];
  const int64_t pc = pkt_ctr[h];
  const int32_t dv = *(const volatile int32_t*)(dst_v + (int64_t)h * dst_step);
  const int32_t kv = *(const volatile int32_t*)(kind_v + (int64_t)h * kind_step);
  const int64_t t = *(const volatile int64_t*)(depart + (int64_t)h * depart_step);
  int32_t pv[kNP];
#pragma unroll
  for (int w = 0; w < kNP; ++w) {
    pv[w] = *(const volatile int32_t*)(p_v + (int64_t)w * H + h);
  }
  const bool ok = m && c < P;
  ok_out[h] = ok;
  cnt_out[h] = c + (int32_t)ok;
  pkt_ctr_out[h] = wrap_add(pc, (int64_t)ok);
  if (!ok || c < 0) return;
  const int64_t s = (int64_t)c * H + h;
  const int64_t plane = (int64_t)P * H;
  dst[s] = dv;
  kind[s] = kv;
  dhi[s] = split_hi(t);
  dlo[s] = split_lo(t);
  ctr[s] = (int32_t)(uint32_t)(uint64_t)pc;
#pragma unroll
  for (int w = 0; w < kNP; ++w) p[w * plane + s] = pv[w];
"""

VOTE_BODY = r"""
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = h < H;
  const bool m = in && mask[h] != 0;
  const int32_t c = in ? cnt[h] : 0;
  const int64_t pc = in ? pkt_ctr[h] : 0;
  const bool ok = m && c < P;
  if (in) {
    ok_out[h] = ok;
    cnt_out[h] = c + (int32_t)ok;
    pkt_ctr_out[h] = wrap_add(pc, (int64_t)ok);
  }
  const bool lands = ok && c >= 0;
  // Every lane of a block exists (kBlock is a multiple of 32).
  if (!__any_sync(0xffffffffu, lands)) return;
  int32_t dv = 0, kv = 0, pv[kNP];
  int64_t t = 0;
  if (in) {
    dv = dst_v[(int64_t)h * dst_step];
    kv = kind_v[(int64_t)h * kind_step];
    t = depart[(int64_t)h * depart_step];
  }
#pragma unroll
  for (int w = 0; w < kNP; ++w) pv[w] = in ? p_v[(int64_t)w * H + h] : 0;
  if (!lands) return;
  const int64_t s = (int64_t)c * H + h;
  const int64_t plane = (int64_t)P * H;
  dst[s] = dv;
  kind[s] = kv;
  dhi[s] = split_hi(t);
  dlo[s] = split_lo(t);
  ctr[s] = (int32_t)(uint32_t)(uint64_t)pc;
#pragma unroll
  for (int w = 0; w < kNP; ++w) p[w * plane + s] = pv[w];
"""

# Each alternative: its body and its file stem.
VARIANTS = {"one round trip": (ONE_TRIP_BODY, "one_trip"),
            "vote": (VOTE_BODY, "vote")}


def _body(src: str) -> tuple[int, int]:
    """Where the obox kernel's body starts and ends in ``src``."""
    start = src.index("obox_kernel(const uint8_t*")
    open_ = src.index(") {\n", start) + len(") {\n")
    return open_, src.index("\n}\n", open_) + 1


def variant_source(src: str, design: str) -> str:
    """``src`` with the obox kernel's body replaced by ``design``'s."""
    a, b = _body(src)
    return src[:a] + VARIANTS[design][0].lstrip("\n") + src[b:]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order",
                    default="kept,one round trip,vote,vote,one round trip,kept")
    args = ap.parse_args()
    order = args.order.split(",")

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import numpy as np

    import chip_smoke as cs
    import torch_phold_profile
    from shadow1_tpu_torch.core import _build

    if set(order) - {"kept", *VARIANTS}:
        raise SystemExit(f"--order: designs are kept, {', '.join(VARIANTS)}")
    build = _build.BUILD_DIR / "designs"
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, stem) in VARIANTS.items():  # one nvcc each, all at once
        src = build / f"popk_{stem}.cu"
        src.write_text(variant_source(_build.SOURCE.read_text(), name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(build / f"libpopk_{stem}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {"kept": _build.library()}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            print(err, file=sys.stderr)
            return 1
        libs[name] = _build.load(build / f"libpopk_{VARIANTS[name][1]}.so")

    dev = torch.device("cuda")
    with cs.PathCapture() as cap:
        cs.run_golden("bench", dev)
    cases = cap.cases["obox"]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    g = np.random.default_rng(20261016)
    ob, rows = cs.random_outbox(g, dev), cs._obox_rows(g, dev)
    rec = {"card": cs.card_line(), "order": order,
           "random_bytes": cs.obox_bytes(ob, *rows[:4]),
           "random_sector_bytes": cs.obox_sector_bytes(ob, *rows[:4]),
           "path_case_bytes": [cs.obox_bytes(*a[:5]) for a in cases],
           "path_case_sector_bytes": [cs.obox_sector_bytes(*a[:5])
                                      for a in cases],
           "runs": []}
    library = _build.library
    # This tool times; chip_smoke.py checks that a call is one device op.
    cs.one_device_op = lambda *a, **k: None
    try:
        for design in order:
            _build.library = lambda lib=libs[design]: lib
            r = cs.check_obox(np.random.default_rng(20261016), dev)
            path = cs.check_path("obox", cases, dev, flush)
            situ = torch_phold_profile.profile(65536, 10)
            rec["runs"].append({
                "design": design, "random_us": r["ms"] * 1e3,
                "wrapper_us": r["wrapper_ms"] * 1e3,
                "path_us": path["path_ms"] * 1e3,
                "path_case_us": [x * 1e3 for x in path["path_case_ms"]],
                "path_wrapper_us": path["path_wrapper_ms"] * 1e3,
                "in_situ_us": situ["kernel_us"]["obox"],
                "device_kernels_per_round": situ["device_kernels_per_round"],
                "device_idle_share": situ["device_idle_share"],
                "events_per_s": situ["events_per_s"]})
    finally:
        _build.library = library
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
