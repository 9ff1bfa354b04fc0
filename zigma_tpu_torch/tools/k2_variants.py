"""Time variants of the selective-scan backward kernel (K2) side by side.

    python -m zigma_tpu_torch.tools.k2_variants [NAME ...]   # from the repo root; one CUDA card

Each variant is ``csrc/selective_scan_bwd.cu`` with some of its
``constexpr`` settings replaced (``VARIANTS``; "shipped" is the source as
it is).  All are built at once, one ``nvcc`` each, into
``zigma_tpu_torch/build/k2_variants/``, checked against
``selective_scan_bwd_ref`` on every output by ``chip_smoke.check_bwd_case``
(the flagship shape in bf16 with the fused gate, and two ragged shapes),
and timed at the flagship shape (16, 1024, 1536, 16) bf16 fused, as the
training path calls it, by ``chip_smoke.cuda_ms`` in turns (each variant,
then each again in reverse order); the time is the median over the turns.
Prints each variant's registers, spill bytes, resident blocks an SM,
channels a block, steps a tile and shared bytes, the card's name and power
limit, and one JSON line of the results.

For the variants in ``PHASES`` an instrumented copy is built too: the
kernel's ``ZT_PHASE`` marks read ``clock64`` in each block's first thread
and add the interval since the previous mark to the block's shared counter
of the phase; the block stores its counters at its end (one slot a block,
no atomics).  One launch at the flagship shape gives each phase's share of
the summed block time (``PHASE_NAMES``).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

from zigma_tpu_torch.ops import _build, scan_cuda

# name -> {constexpr name: value}
VARIANTS = {
    "shipped": {},
    "2x8-lanes": {"kNPT": "8"},
    "256-threads": {"kThreads": "256", "kRegBlocks": "2",
                    "kSmemBudget": "113 * 1024"},
    "64-threads": {"kThreads": "64", "kRegBlocks": "8",
                   "kSmemBudget": "37 * 1024"},
    "tile-8": {"kMaxTile": "8"},
    "tile-32": {"kSmemBudget": "113 * 1024"},
}
PHASES = ("shipped",)
PHASE_NAMES = ("wait for the tile", "pre-pass", "barrier after it",
               "next copy issued", "forward pass", "reverse walk",
               "barrier before epilogue", "epilogue")
_INSTRUMENT = """#define ZT_MAX_BLOCKS 65536
__device__ unsigned long long zt_phase_cycles[ZT_MAX_BLOCKS][8];
#define ZT_PHASE_START __shared__ long long zt_acc[8]; long long zt_t0 = clock64(); \\
  if (threadIdx.x == 0) for (int zt_i = 0; zt_i < 8; ++zt_i) zt_acc[zt_i] = 0;
#define ZT_PHASE(i) if (threadIdx.x == 0) { const long long zt_now = clock64(); \\
  zt_acc[i] += zt_now - zt_t0; zt_t0 = zt_now; }
#define ZT_PHASE_END if (threadIdx.x == 0) for (int zt_i = 0; zt_i < 8; ++zt_i) \\
  zt_phase_cycles[blockIdx.y * gridDim.x + blockIdx.x][zt_i] = zt_acc[zt_i];
"""
_READ = """
extern "C" int zt_phase_read(unsigned long long* out, int clear) {
  static unsigned long long host[ZT_MAX_BLOCKS][8];
  int e = (int)cudaMemcpyFromSymbol(host, zt_phase_cycles, sizeof(host));
  if (e) return e;
  for (int i = 0; i < 8; ++i) {
    out[i] = 0;
    for (int b = 0; b < ZT_MAX_BLOCKS; ++b) out[i] += host[b][i];
  }
  if (clear) { memset(host, 0, sizeof(host)); e = (int)cudaMemcpyToSymbol(zt_phase_cycles, host, sizeof(host)); }
  return e;
}
"""
OUT = os.path.join(_build.BUILD_DIR, "k2_variants")
CHECKS = (("flagship bf16 fused", None, torch.bfloat16, True),
          ("L=300 D=100 N=17 fp32 fused", dict(batch=2, L=300, D=100, N=17),
           torch.float32, True),
          ("L=129 D=70 N=1 bf16 unfused", dict(batch=2, L=129, D=70, N=1),
           torch.bfloat16, False))


def variant_source(settings: dict, phases: bool = False) -> str:
    with open(os.path.join(_build.CSRC, "selective_scan_bwd.cu")) as f:
        src = f.read()
    for name, value in settings.items():
        src, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};",
                         src)
        if n != 1:
            raise ValueError(f"{name}: {n} definitions in the source")
    if phases:
        src = _INSTRUMENT + src + _READ
    return src


def build(names) -> dict:
    """One nvcc per variant (and per instrumented copy, "<name>+phases"),
    all started together; name -> loaded library."""
    procs = {}
    for name in names:
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for h in _build._sources_of("selective_scan_bwd.cu")[1:]:
            shutil.copy(os.path.join(_build.CSRC, h), d)
        src = os.path.join(d, "selective_scan_bwd.cu")
        base, _, tag = name.partition("+")
        with open(src, "w") as f:
            f.write(variant_source(VARIANTS[base], phases=tag == "phases"))
        lib = os.path.join(d, "libk2.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def bind(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.zt_selective_scan_bwd
    fn.argtypes = [vp] * 19 + [i32] * 4 + [i64] * 5 + [i32, vp]
    fn.restype = i32
    cpb = lib.zt_selective_scan_bwd_channels_per_block
    cpb.argtypes, cpb.restype = [i32], i32
    return fn, cpb


def info_of(lib, N, L) -> dict:
    """The variant's launch info for d_state N, length L, bf16."""
    fn = lib.zt_selective_scan_bwd_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = ("registers", "spill_bytes", "blocks_per_sm", "threads",
            "channels_per_block", "steps_per_tile", "shared_bytes")
    info = (ctypes.c_int * len(keys))()
    err = fn(N, L, 1, ctypes.addressof(info))
    if err:
        raise RuntimeError(f"launch info: CUDA error {err}")
    return dict(zip(keys, info))


def main(argv=None):
    import chip_smoke  # the repo root is on sys.path under ``python -m``
    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not torch.cuda.is_available():
        sys.exit("k2_variants needs a CUDA card")
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    libs = build(names + [f"{n}+phases" for n in PHASES if n in names])
    fs = chip_smoke.FLAGSHIP
    saved = scan_cuda._bwd_kernel()
    results, main_args = {}, None
    try:
        for name in names:
            scan_cuda._bwd = bind(libs[name])
            gen = torch.Generator(device="cuda").manual_seed(0)
            for case, shape, dtype, fused in CHECKS:
                d, carries, _ = chip_smoke.check_bwd_case(
                    f"{name}: {case}", gen, **(shape or fs), dtype=dtype,
                    fused=fused)
                if main_args is None:  # the training path's call: no g_last
                    main_args = (d["u"], d["delta"], d["bias"], d["A"], d["B"],
                                 d["C"], carries, d["gy"], None, d["Dskip"],
                                 d["z"])
            results[name] = dict(info_of(libs[name], fs["N"], fs["L"]),
                                 times=[])
            print(f"{name:16s} {results[name]}", flush=True)
        call = lambda: scan_cuda.selective_scan_bwd_cuda(*main_args)
        with torch.no_grad():
            for order in (names, names[::-1]):
                for name in order:
                    scan_cuda._bwd = bind(libs[name])
                    results[name]["times"].append(
                        chip_smoke.cuda_ms(call, reps=10, groups=3))
            for name in (n for n in PHASES if n in names):
                lib = libs[f"{name}+phases"]
                scan_cuda._bwd = bind(lib)
                read = lib.zt_phase_read
                read.argtypes = [ctypes.c_void_p, ctypes.c_int]
                read.restype = ctypes.c_int
                cycles = (ctypes.c_ulonglong * 8)()
                for _ in range(2):  # clear after a warm-up, then read one launch
                    call()
                    torch.cuda.synchronize()
                    if read(ctypes.addressof(cycles), 1):
                        raise RuntimeError("reading the phase counters failed")
                r = results[name]
                r["instrumented_ms"] = chip_smoke.cuda_ms(call, reps=10, groups=3)
                total = sum(cycles[:len(PHASE_NAMES)])
                r["phase_shares"] = {k: cycles[i] / total
                                     for i, k in enumerate(PHASE_NAMES)}
                print(f"{name} phases (instrumented copy "
                      f"{r['instrumented_ms']:.4f} ms; share of the summed "
                      f"block time of one launch): " + "; ".join(
                          f"{k} {100 * v:.1f}%"
                          for k, v in r["phase_shares"].items()), flush=True)
    finally:
        scan_cuda._bwd = saved
    for name in names:
        ts = results[name].pop("times")
        results[name]["ms"] = statistics.median(ts)
        results[name]["ms_turns"] = ts
        print(f"{name:16s} {results[name]['ms']:.4f} ms (turns "
              f"{', '.join(f'{t:.4f}' for t in ts)}) at "
              f"{tuple(fs.values())} bf16 fused", flush=True)
    print(json.dumps({"card": smi, "k2_variants": results}))
    return results


if __name__ == "__main__":
    main()
