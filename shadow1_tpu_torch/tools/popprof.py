"""Profile the pop primitive — its cap ablation, kernel and plain version
(port of ``tools/popprof.py``).

    python -m shadow1_tpu_torch.tools.popprof [--iters N] [--hosts H]
        [--cap C] [--sass] [--device DEV]

Times the pop as an eager carried loop (``roundprobe.pop_step``: one pop a
iteration, the popped times fed back into ``self_ctr``, one device
synchronise at the end) at two slot counts, ``--cap`` C and C // 4, on a
full seeded buffer (``roundprobe.seeded_buf``), once through the CUDA
kernel (``popk.pop_until``) and once through its plain PyTorch version
(``events.pop_until_plain``) on the same device: the slot axis's cost for
each, and how far the hand-written kernel sits from the op-by-op version.
Each row also says whether the two loops' final buffers are bit equal.

The reference's other axes are absent: its i32 / i64 key ablation and
its host-major control time layouts of the XLA pop, while the port's one
pop is the kernel on the i32 split key, slot-major (``csrc/popk.cu``).
``--sass`` (the reference's ``--hlo``) prints ``cuobjdump -sass`` of the
pop kernel from the built library instead of timing: what ``ptxas`` made
of it.

Runs on CUDA unless ``--device`` names another device; on the CPU both
rows run the plain version. One JSON line per row, after a header line
with the backend, the shapes and, on CUDA, the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

ITERS = 5000
HOSTS = 1000
CAP = 256


def pop_loop(n_hosts: int, cap: int, iters: int, device, plain: bool,
             seed: int = 7):
    """(µs per iteration, final buffer) of roundprobe's pop loop at ``cap``
    slots, every slot live."""
    from shadow1_tpu_torch.tools import roundprobe as rp

    step, buf = rp.probe_setup("pop", n_hosts, cap, device, rp.Prims(plain),
                               seed)
    return rp.carried_loop(step, buf, iters, device)


def grid(n_hosts: int = HOSTS, cap: int = CAP, iters: int = ITERS,
         device=None) -> list[dict]:
    """The ablation rows: at C and C // 4, the kernel's and the plain
    version's µs per iteration, and whether their final buffers are bit
    equal."""
    from shadow1_tpu_torch.core.engine import resolve_device
    from shadow1_tpu_torch.tools.roundprobe import carries_equal

    device = resolve_device(device)
    rows = []
    for c in (cap, cap // 4):
        us, buf = pop_loop(n_hosts, c, iters, device, plain=False)
        plain_us, ref = pop_loop(n_hosts, c, iters, device, plain=True)
        rows.append({"probe": f"pop_c{c}", "cap": c,
                     "us_per_iter": round(us, 1),
                     "plain_us_per_iter": round(plain_us, 1),
                     "bit_equal": carries_equal(buf, ref)})
    return rows


def pop_sass() -> str:
    """``cuobjdump -sass`` of the pop kernel in the built library."""
    from shadow1_tpu_torch.core import _build

    _build.library()
    nvcc = _build._nvcc()
    cuobjdump = nvcc[:-len("nvcc")] + "cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(_build.LIBRARY)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    parts = text.split("\t\tFunction : ")
    return "".join("\t\tFunction : " + p for p in parts[1:]
                   if "pop_kernel" in p.split("\n", 1)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.popprof")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--hosts", type=int, default=HOSTS)
    ap.add_argument("--cap", type=int, default=CAP)
    ap.add_argument("--sass", action="store_true",
                    help="print cuobjdump -sass of the pop kernel (the card's "
                         "toolkit)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu to run on the "
                         "CPU)")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.core.engine import resolve_device
    from shadow1_tpu_torch.tools.perfprobe import card_line

    dev = resolve_device(args.device)
    if args.sass:
        print(pop_sass()[:20000])
        return 0
    card = card_line(dev)
    print(json.dumps({"backend": dev.type, "hosts": args.hosts,
                      "cap": args.cap, "iters": args.iters,
                      **({"card": card} if card else {})}), flush=True)
    for row in grid(args.hosts, args.cap, args.iters, dev):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
