"""Time K1 and K2 of one source tree at the flagship shapes, for an A/B.

    python zigma_tpu_torch/tools/scan_times.py TREE [TREE ...]   # one CUDA card

Each TREE is the root of a checkout (this repository, or an unpacked
``git archive`` of another commit).  For each, in turn and in its own
process, the script builds that tree's kernels and times, by CUDA events
(median over 5 groups of 20 launches for K1, 10 for K2):

- K1, ``selective_scan_fwd_cuda`` at (16, 1024, 1536, 16) bf16 with the
  fused gate and no chunk starts, as the sampling path calls it;
- K2, ``selective_scan_bwd_cuda`` at the same shape, fused, from K1's chunk
  starts and without a final-state cotangent, as the training path calls
  it;

on inputs drawn from a fixed seed.  Only the wrappers' common interface is
used, so any tree since the kernels' redesign can be timed.  Run the trees
in turns on one card (``A B B A``) and compare within the call.  Prints the
card's name and power limit, one line a tree and one JSON line of all the
results.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

SHAPE = (16, 1024, 1536, 16)


def _time_tree(tree: str) -> dict:
    """Runs in a child process whose ``sys.path`` starts at ``tree``."""
    import torch
    import zigma_tpu_torch
    from zigma_tpu_torch.ops import _build
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_fwd_cuda)

    pkg = os.path.dirname(os.path.abspath(zigma_tpu_torch.__file__))
    if pkg != os.path.join(tree, "zigma_tpu_torch"):
        raise RuntimeError(f"imported {pkg}, not the package of {tree}")
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, L, D, N = SHAPE
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf = torch.bfloat16
    u, delta = r(B, L, D).to(bf), (0.5 * r(B, L, D)).to(bf)
    A, Bm, Cm = -torch.exp(0.5 * r(D, N)), r(B, L, N).to(bf), r(B, L, N).to(bf)
    bias, Dskip, z, gy = 0.1 * r(D), r(D), r(B, L, D).to(bf), r(B, L, D).to(bf)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    with torch.no_grad():
        k1 = ms(lambda: selective_scan_fwd_cuda(
            u, delta, A, Bm, Cm, bias, Dskip, z, return_carries=False), 20)
        _, carries, _ = selective_scan_fwd_cuda(u, delta, A, Bm, Cm, bias,
                                                Dskip, z)
        k2 = ms(lambda: selective_scan_bwd_cuda(
            u, delta, bias, A, Bm, Cm, carries, gy, None, Dskip, z), 10)
    return {"tree": tree, "k1_ms": k1, "k2_ms": k2}


def main(trees) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    results = []
    for tree in trees:
        root = os.path.abspath(tree)
        code = (f"import sys, json; sys.path.insert(0, {root!r}); "
                f"sys.path.insert(1, {os.path.dirname(os.path.abspath(__file__))!r}); "
                f"import scan_times; "
                f"print(json.dumps(scan_times._time_tree({root!r})))")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=900, cwd=root)
        if out.returncode != 0:
            raise RuntimeError(f"{tree}: rc {out.returncode}\n{out.stderr}")
        res = dict(json.loads(out.stdout.strip().splitlines()[-1]), tree=tree)
        results.append(res)
        print(f"{tree}: K1 {res['k1_ms']:.4f} ms, K2 {res['k2_ms']:.4f} ms at "
              f"{SHAPE} bf16 fused", flush=True)
    print(smi)
    print(json.dumps({"shape": SHAPE, "card": smi, "runs": results}))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
