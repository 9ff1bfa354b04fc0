"""Smoke run of the PyTorch port (``zigma_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one CUDA card

Phases, each of which fails loudly (non-zero exit, no result line):

1. device  -- the card's name and power limit (nvidia-smi);
2. build   -- every CUDA kernel from ``zigma_tpu_torch/csrc`` with nvcc;
3. kernel  -- the selective-scan forward kernel (K1) against its plain
              PyTorch version on the card, on all three outputs, at the
              flagship shape (fp32 and bf16, fused gate and not, with a
              seed state), at a ragged L and at d_state 64 and 256; its time
              at the main path's shape beside the plain version's and the
              bound;
4. main    -- the serving path through its entry point: the flagship
              ``zigzag8_b1_pe2`` (bf16, random weights from a seed, saved as
              a reference-format ``.pt``) sampled by ``cli.sample.main``,
              2 batches of 16 by 50-step Euler; K1 must launch exactly
              2 x 49 x 24 times and the plain scan never; then one flagship
              forward through the kernel against the same forward through
              the plain scan;
5. profile -- the top CUDA ops of one flagship forward (torch.profiler).

The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``; the nvidia-smi line comes just before.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# special-function unit (exp, log, ...) results per clock per SM, compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput)
SFU_OPS_PER_CLK_PER_SM = 16

# tolerance of the kernel against the plain version, per element:
# |got - ref| <= ulp * |ref| + TOL_FP32 * max |ref|.  The fp32 values differ
# only in summation order and exp/log1p ulps (the TOL_FP32 floor); a bf16
# output rounds the same fp32 value on both sides, so it may land one bf16
# ulp away, at most 2^-7 of |ref| (ulp = BF16_ULP; 0 for fp32 outputs)
TOL_FP32 = 1e-4
BF16_ULP = 2.0 ** -7
# one bf16 flagship forward, kernel vs plain scan: 24 layers of bf16
# rounding that can flip at different places
TOL_FORWARD = 5e-2

FLAGSHIP = dict(batch=16, L=1024, D=1536, N=16)
STEPS, DEPTH, N_BATCHES, BATCH = 50, 24, 2, 16


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query="name,power.limit"):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase(name):
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, reps, groups=5):
    """Median over ``groups`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def scan_inputs(gen, batch, L, D, N, dtype, big_dt=False):
    import torch
    dev = "cuda"
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    delta = 0.5 * r(batch, L, D)
    if big_dt:  # some channels past softplus's linear cut-off at 20
        delta[:, :, ::97] += 25.0
    return dict(u=r(batch, L, D).to(dtype), delta=delta.to(dtype),
                A=-torch.exp(0.5 * r(D, N)), B=r(batch, L, N).to(dtype),
                C=r(batch, L, N).to(dtype), bias=0.1 * r(D), Dskip=r(D),
                z=r(batch, L, D).to(dtype), x0=r(batch, N, D))


def rel_err(a, b):
    err = (a.float() - b.float()).abs().max().item()
    return err, err / max(b.float().abs().max().item(), 1e-30)


def excess(got, ref, ulp):
    """max over elements of |got - ref| - ulp * |ref|, over max |ref|"""
    g, r = got.float(), ref.float()
    worst = ((g - r).abs() - ulp * r.abs()).max().item()
    return worst / max(r.abs().max().item(), 1e-30)


def check_kernel_case(name, gen, batch, L, D, N, dtype, fused, with_x0,
                      big_dt=False):
    import torch
    from zigma_tpu_torch.ops.scan_cuda import selective_scan_fwd_cuda
    from zigma_tpu_torch.ops.selective_scan import selective_scan_ref
    d = scan_inputs(gen, batch, L, D, N, dtype, big_dt)
    Dk, zk = (d["Dskip"], d["z"]) if fused else (None, None)
    x0 = d["x0"] if with_x0 else None
    with torch.inference_mode():
        got = selective_scan_fwd_cuda(d["u"], d["delta"], d["A"], d["B"],
                                      d["C"], d["bias"], Dk, zk, x0)
        torch.cuda.synchronize()
        ref = selective_scan_ref(d["u"], d["delta"], d["A"], d["B"], d["C"],
                                 Dk, zk, d["bias"], True, x0)
        torch.cuda.synchronize()
    ulp_y = BF16_ULP if dtype == torch.bfloat16 else 0.0
    errs = {}
    for what, g, r, ulp in (("y", got[0], ref[0], ulp_y),
                            ("carries", got[1], ref[1], 0.0),
                            ("x_last", got[2], ref[2], 0.0)):
        if g.shape != r.shape or g.dtype != r.dtype:
            fail(f"{name}: {what} {tuple(g.shape)} {g.dtype} vs "
                 f"{tuple(r.shape)} {r.dtype}")
        err, _ = rel_err(g, r)
        over = excess(g, r, ulp)
        if not (over <= TOL_FP32):
            fail(f"{name}: {what} max abs err {err}; beyond {ulp:g} x |ref| "
                 f"by {over:.3e} of max |ref| > {TOL_FP32}")
        errs[what] = err
    print(f"{name:34s} y {errs['y']:.3e}  carries {errs['carries']:.3e}  "
          f"x_last {errs['x_last']:.3e}  ok", flush=True)
    return d, errs


def kernel_phase(gen):
    """K1 against the plain version; times at the main path's shape."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import selective_scan_fwd_cuda
    from zigma_tpu_torch.ops.selective_scan import selective_scan_ref
    f, bf = torch.float32, torch.bfloat16
    fs = FLAGSHIP
    cases = [
        ("flagship fp32 fused", fs, f, True, False),
        ("flagship fp32 unfused x0", fs, f, False, True),
        ("flagship bf16 fused (main path)", fs, bf, True, False),
        ("flagship bf16 unfused x0", fs, bf, False, True),
        ("ragged L=1000 bf16 fused x0 dt>20",
         dict(batch=2, L=1000, D=1536, N=16), bf, True, True),
        ("N=64 fp32 fused", dict(batch=2, L=1000, D=256, N=64), f, True, False),
        ("N=256 fp32 unfused x0", dict(batch=2, L=300, D=256, N=256), f,
         False, True),
    ]
    main_inputs, main_err = None, None
    for name, shp, dtype, fused, with_x0 in cases:
        d, errs = check_kernel_case(name, gen, **shp, dtype=dtype, fused=fused,
                                    with_x0=with_x0, big_dt="dt>20" in name)
        if "main path" in name:
            main_inputs, main_err = d, errs["y"]

    d = main_inputs
    B_, L, D, N = fs["batch"], fs["L"], fs["D"], fs["N"]
    args = (d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"],
            d["Dskip"], d["z"])
    with torch.inference_mode():
        ms = cuda_ms(lambda: selective_scan_fwd_cuda(
            *args, return_carries=False), reps=20)
        plain_ms = cuda_ms(lambda: selective_scan_ref(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["Dskip"], d["z"],
            d["bias"], True), reps=1, groups=3)
    # least time for the same work: each input read once, each output
    # written once (y in bf16, x_last in fp32; no carries on the main path)
    item = d["u"].element_size()
    n_bytes = (4 * B_ * L * D * item        # u, delta, z in; y out
               + 2 * B_ * L * N * item      # B, C
               + D * N * 4 + 2 * D * 4      # A, bias, D
               + B_ * N * D * 4)            # x_last
    # operations, each type over its own peak: fp32 FMAs (the JAX kernel's
    # cost estimate) and transcendentals on the special-function units (one
    # exp per state; softplus's exp and log1p, the gate's exp per channel)
    flops = 9 * B_ * L * D * N
    transc = B_ * L * D * N + 3 * B_ * L * D
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    fma_ms = flops / FP32_FLOPS_PER_S * 1e3
    sfu_ms = transc / (SFU_OPS_PER_CLK_PER_SM * n_sms * clk_mhz * 1e6) * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"),
                             (max(fma_ms, sfu_ms), "operations"))
    print(f"K1 at {tuple(fs.values())} bf16 fused: {ms:.4f} ms; plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} "
          f"GFLOP fp32 -> {fma_ms:.4f} ms; {transc / 1e6:.0f} M "
          f"transcendentals on {n_sms} SMs x {SFU_OPS_PER_CLK_PER_SM}/clk at "
          f"{clk_mhz:.0f} MHz -> {sfu_ms:.4f} ms)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=main_err)


def main_path_phase(gen):
    """The serving entry point at the flagship config; counts K1 launches."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.models import zigma_flops
    from zigma_tpu_torch.ops import scan_cuda
    from zigma_tpu_torch.ops.selective_scan import selective_scan_ref
    from zigma_tpu_torch.utils.inference import cast_for_inference

    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 ["model=zigzag8_b1_pe2"])
    model = sample_cli.build_model(cfg, device="cuda", generator=gen)
    with torch.no_grad():  # off the DiT zero-init, so every gate is open
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    n_params = sum(v.numel() for v in sd.values())
    print(f"flagship: depth {model.depth}, embed {model.embed_dim}, "
          f"{n_params / 1e6:.1f} M params, dtype {model.dtype}", flush=True)
    del model

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "flagship.pt")
        torch.save({"ema": sd}, ckpt)
        scan_cuda.selective_scan_fwd_cuda.launches = 0
        selective_scan_ref.calls = 0
        t0 = time.perf_counter()
        res = sample_cli.main([
            f"ckpt={ckpt}", "model=zigzag8_b1_pe2", "sample_mode=ODE",
            "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}",
            f"offline_sample_local_bs={BATCH}",
            f"num_fid_samples={N_BATCHES * BATCH}", f"sample_dir={tmp}"])
        wall = time.perf_counter() - t0
        launches = scan_cuda.selective_scan_fwd_cuda.launches
        plain_calls = selective_scan_ref.calls
        pngs = [f for f in os.listdir(res["out_dir"]) if f.endswith(".png")]
    want = N_BATCHES * (STEPS - 1) * DEPTH
    print(f"sample CLI: {len(pngs)} PNGs in {wall:.2f} s; batches "
          f"{[round(s, 4) for s in res['batch_seconds']]} s; K1 launches "
          f"{launches} (expected {want}); plain scan calls {plain_calls}",
          flush=True)
    if launches != want:
        fail(f"K1 launched {launches} times on the main path, expected {want}")
    if plain_calls != 0:
        fail(f"the plain scan ran {plain_calls} times on the main path")
    if len(pngs) != N_BATCHES * BATCH:
        fail(f"{len(pngs)} PNGs written, expected {N_BATCHES * BATCH}")
    if res["n_nonfinite"]:
        fail(f"{res['n_nonfinite']} non-finite sample values")
    steady = res["batch_seconds"][1:]
    img_s = BATCH / statistics.median(steady)
    print(f"flagship 50-step Euler, batch {BATCH}: {img_s:.3f} images/s "
          f"(steady batches; first batch {res['batch_seconds'][0]:.3f} s)",
          flush=True)

    # one flagship forward through the kernel vs through the plain scan
    model = sample_cli.build_model(cfg, device="cuda")
    model.load_state_dict(sd)
    cast_for_inference(model, model.dtype)
    x = torch.randn(BATCH, 4, 32, 32, generator=gen, device="cuda")
    t = torch.rand(BATCH, generator=gen, device="cuda")
    with torch.inference_mode():
        out_k = model(x, t)
        fwd_ms = cuda_ms(lambda: model(x, t), reps=3, groups=3)
        for blk in model.blocks:
            blk.mixer.scan_backend = "ref"
        out_r = model(x, t)
        for blk in model.blocks:
            blk.mixer.scan_backend = "auto"
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out_k).all()):
        fail("flagship forward through the kernel is not finite")
    err, rel = rel_err(out_k, out_r)
    print(f"flagship forward {tuple(out_k.shape)} {out_k.dtype}: kernel vs "
          f"plain scan max abs err {err:.4e} ({rel:.3e} of max |ref|, "
          f"tolerance {TOL_FORWARD})", flush=True)
    flops = zigma_flops(BATCH, 32 * 32, model.embed_dim, model.depth)
    rate = flops / (fwd_ms * 1e-3)
    print(f"forward {fwd_ms:.3f} ms: {flops / 1e9:.1f} GFLOP (zigma_flops) at "
          f"{rate / 1e12:.1f} TFLOP/s, {100 * rate / BF16_FLOPS_PER_S:.2f}% "
          f"of the bf16 peak", flush=True)
    if not rel <= TOL_FORWARD:
        fail("flagship forward: kernel and plain scan disagree")
    return model, x, t, dict(images_per_s=img_s, forward_ms=fwd_ms,
                             launches=launches)


def profile_phase(model, x, t):
    """Device time of one flagship forward, by kernel and by kind."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(x, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x, t)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: the CPU ops that launched them carry the
    # same device time again
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows)
    if total <= 0:
        fail("the profiler saw no device time")
    rows.sort(key=lambda e: -e.self_device_time_total)
    print(f"one flagship forward: device busy {total / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * total / wall_us:.1f}%)")
    kinds = {}
    for e in rows:
        k = e.key.lower()
        kind = ("K1 selective scan" if "selective_scan" in k else
                "GEMM" if any(s in k for s in ("gemm", "nvjet", "cutlass",
                                               "sm90_xmma")) else
                "gather (scan-path permutation)" if "index" in k else
                "reduction (norms)" if "reduce" in k else
                "convolution (patch embed)" if "conv" in k else
                "elementwise / copy")
        kinds[kind] = kinds.get(kind, 0) + e.self_device_time_total
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"{us / 1e3:15.3f} {100 * us / total:6.1f}%  {kind}")
    print(f"{'self device ms':>15} {'share':>7} {'calls':>6}  kernel")
    for e in rows[:10]:
        print(f"{e.self_device_time_total / 1e3:15.3f} "
              f"{100 * e.self_device_time_total / total:6.1f}% {e.count:6d}  "
              f"{e.key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, REPO)
    try:
        import zigma_tpu_torch
    except ImportError as e:
        fail(f"the port package is not beside this script ({e})")
    if os.path.dirname(os.path.abspath(zigma_tpu_torch.__file__)) != \
            os.path.join(REPO, "zigma_tpu_torch"):
        fail(f"zigma_tpu_torch imported from {zigma_tpu_torch.__file__}, "
             f"not from this checkout")
    from zigma_tpu_torch.device import resolve_device
    from zigma_tpu_torch.ops import _build

    phase("device")
    smi = nvidia_smi()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    resolve_device("cuda")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{count} device(s)", flush=True)

    phase("build")
    t0 = time.perf_counter()
    report = _build.build_all()
    for src, r in report.items():
        print(f"{src}: {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())
    print(f"build {time.perf_counter() - t0:.2f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase("kernel")
    k1 = kernel_phase(gen)
    phase("main path")
    model, x, t, e2e = main_path_phase(gen)
    phase("profile")
    profile_phase(model, x, t)

    kernels = [dict(
        name="selective_scan_fwd", route="cuda",
        source="zigma_tpu_torch/csrc/selective_scan_fwd.cu",
        replaces="zigma_tpu/ops/scan_pallas.py:55",
        launches=e2e["launches"], max_abs_err=k1["max_abs_err"], ms=k1["ms"],
        plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=None)]
    print(f"\nflagship images/s {e2e['images_per_s']:.4f}, forward "
          f"{e2e['forward_ms']:.3f} ms")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
