"""Smoke run of the PyTorch port (``zigma_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; one CUDA card

Phases, each of which fails loudly (non-zero exit, no result line):

1. device     -- the card's name and power limit (nvidia-smi);
2. build      -- every CUDA kernel from ``zigma_tpu_torch/csrc`` with nvcc
                 (one process per source, all started together);
3. kernel     -- the selective-scan forward kernel (K1) against its plain
                 PyTorch version on the card, on all three outputs, at the
                 flagship shape (fp32 and bf16, fused gate and not, with a
                 seed state, short and long memory), at a ragged L, at
                 d_state 64 and 256 and at the tiling's edges (L 1 and 129,
                 D not a multiple of a block's channels, d_state 1 and 17);
                 K1 and the plain fp32 version against a float64 truth at
                 the flagship shape, short and long memory; K1's time as the
                 sampling path calls it (no chunk starts) and as training
                 does, beside the plain version's and the bound; its
                 registers and resident blocks an SM;
4. kernel bwd -- the backward kernel (K2) against its plain version on every
                 gradient, over the same cases and its own tiling's edges
                 (with a final-state cotangent; z, B and C strided as the
                 model passes them), two launches bit-equal; K2 and the
                 plain fp32 version against a float64 adjoint at the
                 flagship shape, short and long memory, three draws each;
                 K2's time at the training path's shape beside the plain
                 version's and the bound; its registers and resident blocks
                 an SM;
5. video kernels -- K1 and K2 at the video ZigMa's scan shapes, (1024, 16,
                 1536, 16) for a temporal layer and (64, 256, 1536, 16) for
                 a spatial one at batch 4, fp32 and bf16, fused, z, B and C
                 strided as the model passes them, against their plain
                 versions (K2 bit-equal over two launches); their bf16 times
                 at the shapes the video paths give them beside the bound;
6. sample     -- the serving path through its entry point: the flagship
                 ``zigzag8_b1_pe2`` (bf16, random weights from a seed, saved
                 as a reference-format ``.pt``) sampled by
                 ``cli.sample.main``, 2 batches of 16 by 50-step Euler; K1
                 must launch exactly 2 x 49 x 24 times and the plain scan
                 never; then one flagship forward through the kernel against
                 the same forward through the plain scan;
7. train      -- the training path through its entry point:
                 ``cli.train.main`` with ``model=zigzag8_b1_pe2
                 data=synthetic data.batch_size=16`` (bf16, remat,
                 drop-path 0.1, AdamW + clip + EMA), 8 steps; every loss
                 finite, K1 exactly 48 and K2 exactly 24 launches a step,
                 the plain scan and plain backward never; the checkpoint's
                 EMA loads with strict=True into a fresh flagship model
                 through ``cli.sample.load_state_dict``;
8. grad check -- a flagship-width ZigMa (embed 768, 1024 tokens, zigzagN8)
                 at depth 2, fp32, batch 2, weights perturbed so every
                 adaLN gate is open: loss and gradients through K1/K2
                 against the same through the plain versions;
9. dopri5     -- the flagship sampled by ``cli.sample`` at the repo's
                 default ``ode`` config (dopri5, 250 save points, atol 1e-6,
                 rtol 1e-3), batch 4: model calls, accepted and rejected
                 steps; K1 exactly 24 launches a model call;
10. SDE       -- the default ``sde`` config (Euler, 250 steps, sigma
                 diffusion, Mean last step 0.04), batch 16: K1 exactly
                 24 x 250 launches (one model call a drift evaluation);
11. likelihood -- ``likelihood=true`` by Euler, 10 steps, batch 4: K1
                 48 x 9 and K2 24 x 9 launches (forward, remat recompute and
                 the vector-Jacobian product of each drift evaluation);
                 logp finite;
12. video train -- ``cli.train`` on the video ZigMa ``3d_zigzag8sst_b2``
                 (16 frames, 101 classes, label drop 0.1), synthetic data,
                 batch 4, 8 steps: K1 48 and K2 24 launches a step; the
                 checkpoint loads into the sampler's model (strict);
13. video sample -- ``cli.sample`` from that checkpoint (perturbed so the
                 gates are open) with classifier-free guidance 4, 50-step
                 Euler, 2 batches of 4: K1 24 x 49 launches a batch, a
                 ``.npy`` a batch and a ``.gif`` a video;
14. video grad check -- a flagship-width depth-3 (s, s, t) fp32 video model:
                 gradients through K1/K2 against the plain versions';
15. repairs   -- the CUDA scan without delta_bias, with A a non-contiguous
                 view and A and D in bf16 (K1 without a gradient, K1 and K2
                 under autograd), and at 65537 sequences, past the grid's
                 65535 (K1, and K2 bit-equal), against the plain versions;
16. 1024^2 kernels -- K1 at (1, 4096, 1536, 16) and (1, 16384, 1536, 16)
                 against the plain version, its time beside the bound and
                 the blocks it launches;
17. text train -- ``cli.train`` on the flagship with synthetic 77 x 768
                 caption features (cross-attention in every block), batch
                 16, 8 steps: K1 48 and K2 24 launches a step; strict load;
18. text sample -- the text model guided (cfg 4) against null features with
                 random caption features, 50-step Euler, 2 batches of 16: K1
                 24 x 49 launches a batch;
19. text grad check -- a flagship-width depth-2 fp32 text model with use_pe
                 3: gradients through K1/K2 against the plain versions';
20. ssm2 train / sample -- ``zigzag8_b1_pe2_ssm2`` (Mamba-2 / SSD mixers)
                 through ``cli.train`` (batch 16, 8 steps) and ``cli.sample``
                 (2 batches of 16): no K1, K2 or plain-scan call;
21. SSD truth -- the chunked SSD at (16, 1024, 24 heads of 64, d_state 64),
                 fp32 and bf16, forward and gradients, against a float64 run
                 of the sequential form; its forward and forward + backward
                 times;
22. 1024^2 sample -- ``cli.sample`` at ``s1024_zigzag8_b2`` (patch 2, 4096
                 tokens) and at patch 1 (16384 tokens), batch 1, 50-step
                 Euler: K1 24 x 49 launches a batch;
23. profile   -- the device time of one flagship forward, one flagship
                 training step, one video training step, one guided video
                 forward, one text training step and one ssm2 training
                 step, by kind (torch.profiler).

Every count is set to 0 just before its path runs and read just after; the
plain versions must run 0 times on every path.
The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``; the nvidia-smi line comes just before.
"""

import json
import math
import os
import re
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
# K1 (and K2) and the plain fp32 version against a float64 truth, per
# output, each as max |err| / max |truth|: the kernel may be at most this
# multiple of the plain version's error (taken as at least FP32_EPS), after
# one bf16 ulp of |truth| per element on bf16 outputs.  The first run on the H100 (H100
# 80GB HBM3, 700 W) measured at most 1.66x, on the long-memory carries in
# fp32 (7.5e-7 against 4.5e-7): the fast exponential errs no more than the
# accurate expf around which the plain version is built, and the two differ
# in summation order.  A per-step bias of the exponential would add up over
# the ~1000-step memory of the long-memory case and show as tens of times.
# K2 (same card, 16 draws over its four cases in two runs) read at most
# 2.50x, on dA, which read 0.39-2.50x at short memory and 1.58-2.42x at
# long memory.  The outputs that use the recomputed states (dA, dB, dC,
# ddelta) carry the forward's state error, which at long memory is K1's (up
# to 1.66x the plain forward's, as above), and dA sums 16 k such terms an
# element; du and dx0, which do not use the states, read at most 1.23x.
TOL_TRUTH_MULT = 4.0
# K2's truth gate runs each of its four cases (short and long memory, fp32
# and bf16) on this many successive draws of the generator
TRUTH_BWD_DRAWS = 3
FP32_EPS = 2.0 ** -23
# one bf16 flagship forward, kernel vs plain scan: 24 layers of bf16
# rounding that can flip at different places
TOL_FORWARD = 5e-2
# K2 against its plain version, per element as above: in fp32 the two differ
# in summation order (dB, dC over D; dA over L) and exp/log1p ulps, at most
# 1.3e-6 of max |ref| over these cases in K2's first run on the H100 (H100
# 80GB HBM3, 700 W); dbias in a bf16 run sums ddelta after its bf16
# rounding, where single roundings may flip (at most 1.4e-4 of max |ref|)
TOL_BWD = 1e-5
# K2 against its plain version at long memory (decays near 0.999): the
# adjoint carries each decay's rounding over about a thousand steps, the
# plain version's (accurate expf) as much as K2's (ex2.approx), so on the
# fp32 outputs the two may differ by the sum of their errors against the
# float64 adjoint.  On dx0 (same card, 12 flagship draws) the plain
# version's reached 7.5e-6 of max |truth|, K2's 3.2e-6; K2 against the plain
# version read 8.1e-6 to 9.5e-6 of max |ref| on dx0 in the three
# long-memory cases below, above TOL_BWD's reach for this kind of input
TOL_BWD_LONG = 3e-5
TOL_DBIAS_BF16 = 1e-3
BWD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dbias", "dx0", "dz", "dD")
# loss and per-parameter gradients of the fp32 depth-2 model, kernels vs
# plain versions: the same summation-order differences through two blocks
TOL_GRAD = 1e-4

FLAGSHIP = dict(batch=16, L=1024, D=1536, N=16)
STEPS, DEPTH, N_BATCHES, BATCH = 50, 24, 2, 16
TRAIN_STEPS = 8
DOPRI5_BATCH = LIK_BATCH = 4
# the video ZigMa 3d_zigzag8sst_b2 as UCF101 trains it (16 frames, 101
# classes, CFG label drop 0.1), at batch 4 (UCF101's is 20)
VIDEO_ARGS = ["model=3d_zigzag8sst_b2", "data=synthetic",
              "data.video_frames=16", "data.num_classes=101",
              "model.params.class_dropout_prob=0.1"]
VIDEO_BATCH = 4
# the scans of its layers at batch 4: a temporal layer scans each token's
# 16 frames (256 tokens x 4 videos), a spatial one each frame's 256 tokens
# (16 frames x 4 videos)
VIDEO_SHAPES = {"temporal": dict(batch=1024, L=16, D=1536, N=16),
                "spatial": dict(batch=64, L=256, D=1536, N=16)}
# the text-to-image data configs' caption features (configs/data/coco.yaml,
# celebamm*.yaml: 77 CLIP tokens of 768), synthetic, on the flagship model
TEXT_ARGS = ["model=zigzag8_b1_pe2", "data=synthetic", "data.has_text=true",
             "data.d_context=768", "data.n_context_token=77"]
N_CTX, D_CTX = 77, 768
# the Mamba-2 / SSD flagship (configs/model/zigzag8_b1_pe2_ssm2.yaml)
SSM2_ARGS = ["model=zigzag8_b1_pe2_ssm2", "data=synthetic"]
# its SSD scan: batch 16 x 1024 tokens, 24 heads of 64, d_state 64
SSD_SHAPE = dict(batch=16, L=1024, H=24, P=64, N=64)
# the chunked SSD against a float64 run of the sequential form, per output
# and gradient, as max |err| / max |truth|.  fp32: at most this multiple of
# the plain fp32 sequential form's error (at least FP32_EPS).  The chunked
# form takes differences of fp32 cumulative log-decays over a 128-token
# chunk, which lose digits the step-by-step product keeps: the first run on
# the H100 (H100 80GB HBM3, 700 W) read 1.0-28.1x at SSD_SHAPE, worst on
# the dt bias's gradient, 8.5x on y, each near 1e-6 of max |truth|; a
# float32 contraction lowered to TF32 or bf16 would err by about 2^-11 to
# 2^-8 of its values, hundreds of times the limit.  bf16: the chunked form
# rounds its inputs and its Y contractions to bf16 (as the JAX package
# does), so its error is held to this many bf16 unit roundoffs (2^-8) of
# max |truth|; the same run read 0.48-1.58
TOL_SSD_FP32_MULT = 64.0
TOL_SSD_BF16_ULPS = 4.0
BF16_EPS = 2.0 ** -8
# the 1024^2 sampling cells of bench.py: 128x128 latents at batch 1, patch
# 2 (configs/model/s1024_zigzag8_b2.yaml, 4096 tokens) and patch 1 (16384)
S1024 = {"p2": ["model=s1024_zigzag8_b2"],
         "p1": ["model=s1024_zigzag8_b2", "model.params.patch_size=1"]}


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


def scan_inputs(gen, batch, L, D, N, dtype, big_dt=False, long_memory=False):
    """Scan inputs from ``gen``: dt = softplus(0.5 randn + 0.1 randn) and
    A = -exp(0.5 randn), decays near 0.5 and a short memory; or, with
    ``long_memory``, the flagship's own init (``models/mamba.py``): bias the
    inverse softplus of a dt log-uniform in [0.001, 0.1], delta 0.1 randn
    around it and A = -(1 ... N), so decays sit near 0.999 and a state
    remembers about a thousand steps."""
    import torch
    dev = "cuda"
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    delta = (0.1 if long_memory else 0.5) * r(batch, L, D)
    if big_dt:  # some channels past softplus's linear cut-off at 20
        delta[:, :, ::97] += 25.0
    u, A = r(batch, L, D), -torch.exp(0.5 * r(D, N))
    B, C, bias = r(batch, L, N), r(batch, L, N), 0.1 * r(D)
    if long_memory:
        A = -torch.arange(1, N + 1, dtype=torch.float32,
                          device=dev).repeat(D, 1)
        dt = torch.exp(torch.rand(D, generator=gen, device=dev)
                       * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        bias = dt + torch.log(-torch.expm1(-dt))
    return dict(u=u.to(dtype), delta=delta.to(dtype), A=A, B=B.to(dtype),
                C=C.to(dtype), bias=bias, Dskip=r(D),
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
                      big_dt=False, long_memory=False, strided=False):
    import torch
    from zigma_tpu_torch.ops.scan_cuda import selective_scan_fwd_cuda
    from zigma_tpu_torch.ops.selective_scan import selective_scan_ref
    d = scan_inputs(gen, batch, L, D, N, dtype, big_dt, long_memory)
    if strided:
        d = strided_like_the_model(d)
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


def least_time(n_bytes, flops, transc):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations, each type over its own peak (fp32 FMA
    work, and transcendentals on the special-function units at the SM
    clock's maximum).  Returns (ms, "bytes" | "operations", breakdown)."""
    import torch
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    fma_ms = flops / FP32_FLOPS_PER_S * 1e3
    sfu_ms = transc / (SFU_OPS_PER_CLK_PER_SM * n_sms * clk_mhz * 1e6) * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"),
                             (max(fma_ms, sfu_ms), "operations"))
    how = (f"{n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} "
           f"GFLOP fp32 -> {fma_ms:.4f} ms; {transc / 1e6:.0f} M "
           f"transcendentals on {n_sms} SMs x {SFU_OPS_PER_CLK_PER_SM}/clk at "
           f"{clk_mhz:.0f} MHz -> {sfu_ms:.4f} ms")
    return bound_ms, bound_by, how


def k1_work(batch, L, D, N, item, carries=False):
    """(bytes, fp32 flops, transcendentals) of K1's function, fused gate:
    each input read once (u, delta, z; B, C; A, bias, D), each output
    written once (y; x_last in fp32; the chunk starts with ``carries``).
    Operations: the JAX kernel's cost estimate of fp32 FMA work, and on the
    special-function units one exp per state plus softplus's exp and log1p
    and the gate's exp per channel."""
    n_bytes = (4 * batch * L * D * item          # u, delta, z in; y out
               + 2 * batch * L * N * item        # B, C
               + D * N * 4 + 2 * D * 4           # A, bias, D
               + batch * N * D * 4)              # x_last
    if carries:
        n_bytes += batch * -(-L // 128) * N * D * 4
    return n_bytes, 9 * batch * L * D * N, batch * L * D * N + 3 * batch * L * D


def k2_work(batch, L, D, N, item):
    """(bytes, fp32 flops, transcendentals) of K2's function as the training
    path calls it: each input read once (u, delta, z, gy; B, C; the chunk
    starts; A, bias, D), each output written once (du, ddelta, dz; dB, dC;
    dA, dbias, dD; dx0).  Operations: the JAX kernel's cost estimate (25 B L
    D N), and one exp per state and step plus softplus's exp and log1p, its
    sigmoid and the gate's sigmoid per channel and step."""
    n_bytes = (7 * batch * L * D * item          # u, delta, z, gy in; 3 out
               + 4 * batch * L * N * item        # B, C in; dB, dC out
               + batch * -(-L // 128) * N * D * 4  # chunk-start states
               + 2 * (D * N * 4 + 2 * D * 4)     # A, bias, D in; grads out
               + batch * N * D * 4)              # dx0
    return n_bytes, 25 * batch * L * D * N, batch * L * D * N + 4 * batch * L * D


def truth_f64(d, device="cuda"):
    """The fused scan of ``scan_inputs`` in float64 on ``device``, step by
    step, with no seed state: (y, chunk-start states, final state)."""
    import torch
    import torch.nn.functional as F
    f64 = {k: v.to(device, torch.float64) for k, v in d.items()}
    u, B, C = f64["u"], f64["B"], f64["C"]
    dt = F.softplus(f64["delta"] + f64["bias"])  # threshold 20
    dtu = dt * u
    At = f64["A"].t()  # (N, D)
    batch, L, D = u.shape
    x = torch.zeros((batch, At.shape[0], D), dtype=torch.float64, device=device)
    carries, ys = [], []
    for t in range(L):
        if t % 128 == 0:
            carries.append(x)
        x = (torch.exp(dt[:, t, None, :] * At) * x
             + dtu[:, t, None, :] * B[:, t, :, None])
        ys.append(torch.einsum("bnd,bn->bd", x, C[:, t]))
    y = (torch.stack(ys, dim=1) + u * f64["Dskip"]) * F.silu(f64["z"])
    return y, torch.stack(carries, dim=1), x


def truth_bwd_f64(d, device="cuda"):
    """The adjoint of ``truth_f64``'s fused scan in float64 on ``device``,
    with ``d["gy"]`` the cotangent of the gated output and none of the final
    state.  Its own loop: each 128-step chunk's states are recomputed from
    the float64 chunk starts, then walked in reverse.  Returns (du, ddelta,
    dA, dB, dC, dbias, dx0, dz, dD), the outputs of the kernel, in
    float64; dbias sums the unrounded ddelta."""
    import torch
    f64 = {k: v.to(device, torch.float64) for k, v in d.items()}
    u, B, C, z, g_out = f64["u"], f64["B"], f64["C"], f64["z"], f64["gy"]
    pre = f64["delta"] + f64["bias"]
    dt = torch.where(pre <= 20, torch.log1p(torch.exp(pre)), pre)
    sig = torch.sigmoid(pre)
    dtu = dt * u
    At, Dsk = f64["A"].t(), f64["Dskip"]  # (N, D), (D,)
    sig_z = torch.sigmoid(z)
    gyr = g_out * z * sig_z  # cotangent of the raw scan output
    _, starts, _ = truth_f64(d, device)
    batch, L, D = u.shape
    N = At.shape[0]
    du, dd, y = (torch.zeros_like(u) for _ in range(3))
    dB = torch.zeros((batch, L, N), dtype=torch.float64, device=device)
    dC = torch.zeros_like(dB)
    dA = torch.zeros((N, D), dtype=torch.float64, device=device)
    g_next = torch.zeros((batch, N, D), dtype=torch.float64, device=device)
    for k in reversed(range(starts.shape[1])):
        t0, t1 = 128 * k, min(L, 128 * (k + 1))
        xs, decays = [starts[:, k]], []  # xs[j]: the state before step t0 + j
        for t in range(t0, t1):
            decays.append(torch.exp(dt[:, t, None, :] * At))
            xs.append(decays[-1] * xs[-1] + dtu[:, t, None, :] * B[:, t, :, None])
        for j in reversed(range(t1 - t0)):
            t = t0 + j
            g = gyr[:, t, None, :] * C[:, t, :, None] + g_next
            dla = g * decays[j] * xs[j]
            gB = (g * B[:, t, :, None]).sum(1)
            dd[:, t] = ((dla * At).sum(1) + gB * u[:, t]) * sig[:, t]
            du[:, t] = dt[:, t] * gB + gyr[:, t] * Dsk
            dA += (dla * dt[:, t, None, :]).sum(0)
            dB[:, t] = (g * dtu[:, t, None, :]).sum(2)
            dC[:, t] = (gyr[:, t, None, :] * xs[j + 1]).sum(2)
            y[:, t] = (C[:, t, :, None] * xs[j + 1]).sum(1)
            g_next = decays[j] * g
    dz = g_out * (y + u * Dsk) * (sig_z * (1 + z * (1 - sig_z)))
    return (du, dd, dA.t(), dB, dC, dd.sum((0, 1)), g_next, dz,
            (gyr * u).sum((0, 1)))


def truth_case(name, gen, batch, L, D, N, dtype, long_memory=False):
    """K1 and the plain fp32 version against the float64 truth, fused gate,
    on all three outputs; K1's error may be TOL_TRUTH_MULT times the plain
    version's (at least FP32_EPS), plus one bf16 ulp per element on bf16
    outputs."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import selective_scan_fwd_cuda
    from zigma_tpu_torch.ops.selective_scan import selective_scan_ref
    d = scan_inputs(gen, batch, L, D, N, dtype, long_memory=long_memory)
    f32 = {k: v.float() for k, v in d.items()}  # the same values in fp32
    with torch.inference_mode():
        got = selective_scan_fwd_cuda(d["u"], d["delta"], d["A"], d["B"],
                                      d["C"], d["bias"], d["Dskip"], d["z"])
        plain = selective_scan_ref(f32["u"], f32["delta"], f32["A"], f32["B"],
                                   f32["C"], f32["Dskip"], f32["z"],
                                   f32["bias"], True)
        truth = truth_f64(d)
        torch.cuda.synchronize()
    ulp_y = BF16_ULP if dtype == torch.bfloat16 else 0.0
    parts, worst = [], 0.0
    for what, k, p, t, ulp in zip(("y", "carries", "x_last"), got, plain,
                                  truth, (ulp_y, 0.0, 0.0)):
        scale = t.abs().max().item()
        e_k = ((k.double() - t).abs() - ulp * t.abs()).max().item() / scale
        e_p = (p.double() - t).abs().max().item() / scale
        ratio = e_k / max(e_p, FP32_EPS)
        worst = max(worst, ratio)
        parts.append(f"{what} K1 {e_k:.3e} plain {e_p:.3e} ({ratio:.2f}x)")
        if not ratio <= TOL_TRUTH_MULT:
            fail(f"{name}: {what} K1's error against the f64 truth is "
                 f"{ratio:.2f}x the plain fp32 version's > {TOL_TRUTH_MULT}")
    print(f"{name:34s} vs f64, of max |truth|: " + "; ".join(parts),
          flush=True)
    return worst


def print_instance(kernel, info, staged, batch, D):
    """The ``K1 flagship instance:`` / ``K2 flagship instance:`` line from
    a kernel's launch info."""
    import torch
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_blocks = -(-D // info["channels_per_block"]) * batch
    warps = info["blocks_per_sm"] * info["threads"] // 32
    print(f"{kernel} flagship instance: {info['registers']} registers a "
          f"thread, {info['spill_bytes']} spill bytes, {info['threads']} "
          f"threads a block, {info['channels_per_block']} channels a block, "
          f"{info[f'steps_per_{staged}']} steps a {staged}, "
          f"{info['shared_bytes']} shared bytes a block; at most "
          f"{info['blocks_per_sm']} blocks ({warps} warps) resident an SM; "
          f"the grid has {n_blocks} blocks ({n_blocks / n_sms:.2f} an SM)",
          flush=True)
    return dict(info, warps_per_sm=warps)


def kernel_phase(gen):
    """K1 against the plain version and a float64 truth; times at the main
    paths' shape."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_fwd_cuda,
                                               selective_scan_fwd_launch_info)
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
        ("flagship long-memory bf16 fused", fs, bf, True, False),
        ("long-memory fp32 unfused x0", dict(batch=2, L=1024, D=1536, N=16),
         f, False, True),
        ("L=129 D=100 N=17 bf16 fused x0", dict(batch=2, L=129, D=100, N=17),
         bf, True, True),
        ("L=1 D=70 N=1 fp32 fused x0", dict(batch=3, L=1, D=70, N=1), f, True,
         True),
    ]
    main_inputs, main_err = None, None
    for name, shp, dtype, fused, with_x0 in cases:
        d, errs = check_kernel_case(name, gen, **shp, dtype=dtype, fused=fused,
                                    with_x0=with_x0, big_dt="dt>20" in name,
                                    long_memory="long-memory" in name)
        if "main path" in name:
            main_inputs, main_err = d, errs["y"]
    truth_worst = max(
        truth_case(f"f64 truth: {kind}flagship {tag}", gen, **fs, dtype=dtype,
                   long_memory=bool(kind))
        for kind in ("", "long-memory ")
        for tag, dtype in (("fp32", f), ("bf16", bf)))
    print(f"f64-truth gate: K1's error at most {truth_worst:.2f}x the plain "
          f"fp32 version's (limit {TOL_TRUTH_MULT})", flush=True)

    d = main_inputs
    B_, L, D, N = fs["batch"], fs["L"], fs["D"], fs["N"]
    args = (d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"],
            d["Dskip"], d["z"])
    with torch.inference_mode():
        # as the sampling path calls it (no chunk starts), then as training
        # does (SelectiveScanFn keeps them for K2)
        ms = cuda_ms(lambda: selective_scan_fwd_cuda(
            *args, return_carries=False), reps=20)
        ms_carries = cuda_ms(lambda: selective_scan_fwd_cuda(
            *args, return_carries=True), reps=20)
        plain_ms = cuda_ms(lambda: selective_scan_ref(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["Dskip"], d["z"],
            d["bias"], True), reps=1, groups=3)
    print_instance("K1", selective_scan_fwd_launch_info(N, L, bf), "chunk",
                   B_, D)
    # least time for the same work (no carries on the sampling path)
    bound_ms, bound_by, how = least_time(
        *k1_work(B_, L, D, N, d["u"].element_size()))
    print(f"K1 at {tuple(fs.values())} bf16 fused: {ms:.4f} ms as sampling "
          f"calls it, {ms_carries:.4f} ms with the chunk starts as training "
          f"calls it; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({how})", flush=True)
    return dict(ms=ms, ms_with_carries=ms_carries, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=main_err)


def strided_like_the_model(d, R=49):
    """``d`` with z a slice of an xz-like (batch, L, 2D + 1) tensor and B, C
    slices of an x_dbl-like (batch, L, R + 2N) one at offset R: with R odd
    the rows of all three are only 2-byte aligned in bf16 (4 in fp32), so
    the narrow copies of the kernels' staging run."""
    import torch
    batch, L, D = d["z"].shape
    N = d["B"].shape[2]
    x_dbl = torch.zeros((batch, L, R + 2 * N), dtype=d["B"].dtype,
                        device=d["B"].device)
    x_dbl[..., R:R + N], x_dbl[..., R + N:] = d["B"], d["C"]
    xz = torch.zeros((batch, L, 2 * D + 1), dtype=d["z"].dtype,
                     device=d["z"].device)
    xz[..., D + 1:] = d["z"]
    return dict(d, B=x_dbl[..., R:R + N], C=x_dbl[..., R + N:],
                z=xz[..., D + 1:])


def check_bwd_case(name, gen, batch, L, D, N, dtype, fused, big_dt=False,
                   long_memory=False, strided=False, tol_fp32=TOL_BWD):
    """K2 against selective_scan_bwd_ref on every output, from the chunk
    starts K1 wrote, with a final-state cotangent, within ``tol_fp32`` of
    max |ref| (after one bf16 ulp on bf16 outputs); two launches
    bit-equal.  Prints each output's max abs error and the worst excess."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_fwd_cuda)
    from zigma_tpu_torch.ops.selective_scan import selective_scan_bwd_ref
    d = scan_inputs(gen, batch, L, D, N, dtype, big_dt, long_memory)
    if strided:
        d = strided_like_the_model(d)
    d["gy"] = torch.randn(batch, L, D, generator=gen, device="cuda").to(dtype)
    d["g_last"] = torch.randn(batch, N, D, generator=gen, device="cuda")
    Dk, zk = (d["Dskip"], d["z"]) if fused else (None, None)
    with torch.no_grad():
        _, carries, _ = selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"], Dk, zk)
        args = (d["u"], d["delta"], d["bias"], d["A"], d["B"], d["C"],
                carries, d["gy"], d["g_last"], Dk, zk)
        got = selective_scan_bwd_cuda(*args)
        again = selective_scan_bwd_cuda(*args)
        torch.cuda.synchronize()
        ref = selective_scan_bwd_ref(*args)
        torch.cuda.synchronize()
    errs, worst = {}, (0.0, "", 0.0)
    for what, g, a, r in zip(BWD_NAMES, got, again, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            fail(f"{name}: {what} {tuple(g.shape)} {g.dtype} vs "
                 f"{tuple(r.shape)} {r.dtype}")
        if not torch.equal(g, a):
            fail(f"{name}: {what} differs between two launches on the same "
                 f"inputs")
        ulp = BF16_ULP if g.dtype == torch.bfloat16 else 0.0
        tol = (TOL_DBIAS_BF16 if what == "dbias" and dtype == torch.bfloat16
               else tol_fp32)
        err, _ = rel_err(g, r)
        over = excess(g, r, ulp)
        if not (over <= tol):
            fail(f"{name}: {what} max abs err {err}; beyond {ulp:g} x |ref| "
                 f"by {over:.3e} of max |ref| > {tol}")
        errs[what] = err
        worst = max(worst, (over / tol, what, over))
    print(f"{name:34s} bit-equal repeat; max abs err "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; worst {worst[1]} {worst[2]:.2e} of max |ref| "
          f"({worst[0]:.2f} of its limit)", flush=True)
    return d, carries, errs


def truth_bwd_case(name, gen, batch, L, D, N, dtype, long_memory=False):
    """K2 and the plain fp32 version against the float64 adjoint, fused
    gate, no final-state cotangent (as the training path calls it), on
    every output; K2's error may be TOL_TRUTH_MULT times the plain
    version's (at least FP32_EPS), plus one bf16 ulp per element on bf16
    outputs.  K2 starts from K1's chunk starts, the plain version from the
    plain forward's, the truth from its own float64 ones.  A bf16 dbias sums
    ddelta after its rounding to bf16, so its truth is the sum of the true
    ddelta rounded to bf16, and the limit TOL_DBIAS_BF16 of max |truth|, as
    against the plain version (single roundings may flip)."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_fwd_cuda)
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    d = scan_inputs(gen, batch, L, D, N, dtype, long_memory=long_memory)
    d["gy"] = torch.randn(batch, L, D, generator=gen, device="cuda").to(dtype)
    f32 = {k: v.float() for k, v in d.items()}  # the same values in fp32
    names = ("u", "delta", "bias", "A", "B", "C")
    with torch.no_grad():
        _, carries, _ = selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"], d["Dskip"],
            d["z"])
        got = selective_scan_bwd_cuda(*(d[k] for k in names), carries,
                                      d["gy"], None, d["Dskip"], d["z"])
        _, carries_p, _ = selective_scan_ref(
            f32["u"], f32["delta"], f32["A"], f32["B"], f32["C"],
            f32["Dskip"], f32["z"], f32["bias"], True)
        plain = selective_scan_bwd_ref(*(f32[k] for k in names), carries_p,
                                       f32["gy"], None, f32["Dskip"],
                                       f32["z"])
        truth = truth_bwd_f64(d)
        torch.cuda.synchronize()
    parts, worst = [], (0.0, "")
    for what, k, p, t in zip(BWD_NAMES, got, plain, truth):
        scale = t.abs().max().item()
        ulp = BF16_ULP if k.dtype == torch.bfloat16 else 0.0
        e_k = ((k.double() - t).abs() - ulp * t.abs()).max().item() / scale
        e_p = (p.double() - t).abs().max().item() / scale
        if what == "dbias" and dtype == torch.bfloat16:
            t = truth[1].to(torch.bfloat16).double().sum((0, 1))
            e_k = (k.double() - t).abs().max().item() / t.abs().max().item()
            parts.append(f"{what} K2 {e_k:.2e} (limit {TOL_DBIAS_BF16})")
            if not e_k <= TOL_DBIAS_BF16:
                fail(f"{name}: bf16 dbias {e_k:.3e} of max |truth| > "
                     f"{TOL_DBIAS_BF16}")
            continue
        ratio = e_k / max(e_p, FP32_EPS)
        worst = max(worst, (ratio, what))
        parts.append(f"{what} {e_k:.2e}/{e_p:.2e} ({ratio:.2f}x)")
        if not ratio <= TOL_TRUTH_MULT:
            fail(f"{name}: {what} K2's error against the f64 truth is "
                 f"{ratio:.2f}x the plain fp32 version's > {TOL_TRUTH_MULT}")
    print(f"{name:34s} vs f64, K2/plain of max |truth|: " + "; ".join(parts)
          + f"; worst {worst[1]} {worst[0]:.2f}x", flush=True)
    return worst[0]


def kernel_bwd_phase(gen):
    """K2 against its plain version and a float64 truth; times at the
    training path's shape."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_bwd_launch_info)
    from zigma_tpu_torch.ops.selective_scan import selective_scan_bwd_ref
    f, bf = torch.float32, torch.bfloat16
    fs = FLAGSHIP
    cases = [
        ("flagship fp32 fused", fs, f, True),
        ("flagship fp32 unfused", fs, f, False),
        ("flagship bf16 fused (main path)", fs, bf, True),
        ("flagship bf16 unfused", fs, bf, False),
        ("ragged L=1000 bf16 fused dt>20",
         dict(batch=2, L=1000, D=1536, N=16), bf, True),
        ("N=64 fp32 fused", dict(batch=2, L=1000, D=256, N=64), f, True),
        ("N=256 fp32 unfused", dict(batch=2, L=300, D=256, N=256), f, False),
        # long memory, and the edges of K2's tiling: L below, at and just
        # past a 128-step chunk (and a single step), D not a multiple of a
        # block's channels, d_state 1 and 17; z, B and C strided as the
        # model passes them, with rows only 2-byte aligned in bf16
        ("flagship long-memory bf16 fused", fs, bf, True),
        ("long-memory L=1024 D=64 fp32 fused", dict(batch=2, L=1024, D=64,
                                                    N=16), f, True),
        ("long-memory L=1024 D=64 fp32 unfused", dict(batch=2, L=1024, D=64,
                                                      N=16), f, False),
        ("L=1 D=70 N=1 fp32 fused", dict(batch=3, L=1, D=70, N=1), f, True),
        ("L=127 D=100 N=16 bf16 fused", dict(batch=2, L=127, D=100, N=16),
         bf, True),
        ("L=128 D=100 N=17 fp32 unfused", dict(batch=2, L=128, D=100, N=17),
         f, False),
        ("L=129 D=100 N=17 bf16 fused", dict(batch=2, L=129, D=100, N=17),
         bf, True),
        ("strided L=300 D=96 bf16 fused", dict(batch=2, L=300, D=96, N=16),
         bf, True),
        ("strided L=300 D=96 fp32 fused", dict(batch=2, L=300, D=96, N=16),
         f, True),
    ]
    main = None
    for name, shp, dtype, fused in cases:
        long = "long-memory" in name
        d, carries, errs = check_bwd_case(
            name, gen, **shp, dtype=dtype, fused=fused, big_dt="dt>20" in name,
            long_memory=long, strided="strided" in name,
            tol_fp32=TOL_BWD_LONG if long else TOL_BWD)
        if "main path" in name:
            main = (d, carries, max(errs.values()))
    truth_worst = max(
        truth_bwd_case(f"f64 truth: {kind}flagship {tag} #{i}", gen, **fs,
                       dtype=dtype, long_memory=bool(kind))
        for kind in ("", "long-memory ")
        for tag, dtype in (("fp32", f), ("bf16", bf))
        for i in range(TRUTH_BWD_DRAWS))
    print(f"f64-truth gate: K2's error at most {truth_worst:.2f}x the plain "
          f"fp32 version's over {4 * TRUTH_BWD_DRAWS} draws (limit "
          f"{TOL_TRUTH_MULT})", flush=True)
    d, carries, main_err = main
    B_, L, D, N = fs["batch"], fs["L"], fs["D"], fs["N"]
    info = print_instance("K2", selective_scan_bwd_launch_info(N, L, bf),
                          "tile", B_, D)
    # the main path's call: no final-state cotangent
    args = (d["u"], d["delta"], d["bias"], d["A"], d["B"], d["C"], carries,
            d["gy"], None, d["Dskip"], d["z"])
    with torch.no_grad():
        ms = cuda_ms(lambda: selective_scan_bwd_cuda(*args), reps=10)
        plain_ms = cuda_ms(lambda: selective_scan_bwd_ref(*args), reps=1,
                           groups=3)
    bound_ms, bound_by, how = least_time(
        *k2_work(B_, L, D, N, d["u"].element_size()))
    print(f"K2 at {tuple(fs.values())} bf16 fused: {ms:.4f} ms; plain "
          f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} ({how})",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=main_err, info=info)


def main_path_phase(gen, tmp):
    """The serving entry point at the flagship config; counts K1 launches.
    Saves the flagship's random weights as ``{tmp}/flagship.pt``, which the
    later sampling phases load."""
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
                             launches=launches, ckpt=ckpt)


def train_phase(gen):
    """The training entry point at the flagship config; counts K1 and K2
    launches and the plain versions' calls over its steps."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli import train as train_cli
    from zigma_tpu_torch.ops import scan_cuda
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9  # by earlier phases
        scan_cuda.selective_scan_fwd_cuda.launches = 0
        scan_cuda.selective_scan_bwd_cuda.launches = 0
        selective_scan_ref.calls = selective_scan_bwd_ref.calls = 0
        t0 = time.perf_counter()
        res = train_cli.main([
            "model=zigzag8_b1_pe2", "data=synthetic",
            f"data.batch_size={BATCH}", f"data.train_steps={TRAIN_STEPS}",
            "log_every=1", f"results_dir={tmp}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = scan_cuda.selective_scan_fwd_cuda.launches
        k2 = scan_cuda.selective_scan_bwd_cuda.launches
        plain = (selective_scan_ref.calls, selective_scan_bwd_ref.calls)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        state = res["state"]
        cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                     ["model=zigzag8_b1_pe2"])
        fresh = sample_cli.build_model(cfg, device="cuda")
        fresh.load_state_dict(sample_cli.load_state_dict(res["checkpoint"]),
                              strict=True)
        ckpt_name = os.path.basename(res["checkpoint"])
    model = state.model
    losses = [r["loss"] for r in res["records"]]
    print(f"train CLI: {len(losses)} steps in {wall:.2f} s (model build "
          f"included); dtype {model.dtype}, remat {model.use_checkpoint}, "
          f"drop-path {model.drop_path_rate}; losses "
          f"{[round(v, 4) for v in losses]}; grad norms "
          f"{[round(r['grad_norm'], 3) for r in res['records']]}", flush=True)
    print(f"K1 launches {k1} (expected {48 * TRAIN_STEPS}), K2 launches {k2} "
          f"(expected {24 * TRAIN_STEPS}); plain scan / plain backward calls "
          f"{plain}; checkpoint {ckpt_name}: EMA loaded with strict=True into "
          f"a fresh flagship model", flush=True)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"training losses {losses}")
    if k1 != 48 * TRAIN_STEPS or k2 != 24 * TRAIN_STEPS:
        fail(f"K1 / K2 launched {k1} / {k2} times in {TRAIN_STEPS} steps, "
             f"expected 48 / 24 a step")
    if plain != (0, 0):
        fail(f"the plain scan / backward ran {plain} times on the main path")
    for name, p in model.named_parameters():
        if p.dtype != torch.float32:
            fail(f"master weight {name} is {p.dtype}")
    steady = [1.0 / r["steps_per_sec"] for r in res["records"][1:]]
    steps_s = len(steady) / sum(steady)
    print(f"flagship training, batch {BATCH}: {steps_s:.4f} steps/s, "
          f"{steps_s * BATCH:.3f} images/s (steady steps 2-{TRAIN_STEPS}; "
          f"their median {statistics.median(steady):.4f} s, range "
          f"{min(steady):.4f}-{max(steady):.4f} s; first step "
          f"{1.0 / res['records'][0]['steps_per_sec']:.3f} s); "
          f"peak device memory {peak_gb:.2f} GB, of which {held_gb:.2f} GB "
          f"held by earlier phases before the run", flush=True)
    return state, dict(steps_per_s=steps_s, images_per_s=steps_s * BATCH,
                       peak_gb=peak_gb, k1=k1, k2=k2)


def grad_check_phase(gen, what, x_shape, **model_kw):
    """A flagship-width model (``model_kw``), weights perturbed so every
    adaLN gate is open: loss and every parameter's gradient through K1/K2
    against the same through the plain versions (same generator seed, so
    the same draws)."""
    import torch
    from zigma_tpu_torch.models import ZigMa
    from zigma_tpu_torch.train import LATENT_SCALE, make_diffusion_loss_fn
    from zigma_tpu_torch.transport import create_transport

    model_kw.setdefault("use_pe", 2)
    model = ZigMa(in_channels=4, embed_dim=768, use_checkpoint=True,
                  device="cuda", generator=gen, **model_kw)
    with torch.no_grad():  # off the DiT zero-init, so every gate is open
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    batch = {"x": torch.randn(x_shape, generator=gen, device="cuda")}
    if model.has_text:
        batch["y"] = torch.randn(x_shape[0], N_CTX, model.d_context,
                                 generator=gen, device="cuda")
    elif model.num_classes > 0:
        batch["y"] = torch.randint(0, model.num_classes, x_shape[:1],
                                   generator=gen, device="cuda")
    loss_fn = make_diffusion_loss_fn(model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    out = []
    for backend in ("auto", "ref"):
        for blk in model.blocks:
            blk.mixer.scan_backend = backend
        model.zero_grad(set_to_none=True)
        loss = loss_fn(batch, torch.Generator(device="cuda").manual_seed(7))
        loss.backward()
        torch.cuda.synchronize()
        out.append((loss.item(), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}))
    (loss_k, gk), (loss_r, gr) = out
    worst_name, worst = None, abs(loss_k - loss_r) / abs(loss_r)
    print(f"{what}: loss {loss_k:.6f} through K1/K2, {loss_r:.6f} through "
          f"the plain versions", flush=True)
    zero = [n for n in gr if gr[n].abs().max().item() == 0]
    if any("mixer" in n for n in zero):
        fail(f"zero mixer gradients {zero}: the scan's gradient was not "
             f"exercised")
    for n in gr:
        _, rel = rel_err(gk[n], gr[n])
        if rel > worst:
            worst_name, worst = n, rel
    print(f"max over {len(gr)} parameters of max |kernel - plain| / max "
          f"|plain|: {worst:.3e} ({worst_name}); tolerance {TOL_GRAD}",
          flush=True)
    if not worst <= TOL_GRAD:
        fail(f"{what}: gradients through K1/K2 and the plain versions "
             f"disagree: {worst_name} {worst}")
    return worst


def video_kernel_phase(gen):
    """K1 and K2 at the video model's shapes (temporal layers: 256 tokens x
    4 videos of 16 frames; spatial: 16 frames x 4 videos of 256 tokens),
    fp32 and bf16, fused, with z, B and C strided as the model passes them,
    against their plain versions; K2 bit-equal over two launches.  Then the
    bf16 times at the shapes each video path gives them beside the bound."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_fwd_cuda)
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    f, bf = torch.float32, torch.bfloat16
    for tag, shp in VIDEO_SHAPES.items():
        for dname, dtype in (("fp32", f), ("bf16", bf)):
            size = tuple(shp.values())
            check_kernel_case(f"K1 {tag} {size} {dname}", gen, **shp,
                              dtype=dtype, fused=True, with_x0=False,
                              strided=True)
            check_bwd_case(f"K2 {tag} {size} {dname}", gen, **shp,
                           dtype=dtype, fused=True, strided=True)
    times = {}
    # (kernel, path, shape, chunk starts): training calls K1 with them (for
    # K2), guided sampling without, at twice the batch (cond and uncond)
    for kernel, path, tag, scale, carries in (
            ("K1", "video_train", "temporal", 1, True),
            ("K1", "video_train", "spatial", 1, True),
            ("K1", "video_sample", "temporal", 2, False),
            ("K1", "video_sample", "spatial", 2, False),
            ("K2", "video_train", "temporal", 1, None),
            ("K2", "video_train", "spatial", 1, None)):
        shp = dict(VIDEO_SHAPES[tag], batch=scale * VIDEO_SHAPES[tag]["batch"])
        B_, L, D, N = shp.values()
        d = strided_like_the_model(scan_inputs(gen, B_, L, D, N, bf))
        args = (d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"],
                d["Dskip"], d["z"])
        with torch.no_grad():
            if kernel == "K1":
                ms = cuda_ms(lambda: selective_scan_fwd_cuda(
                    *args, return_carries=carries), reps=20)
                plain_ms = cuda_ms(lambda: selective_scan_ref(
                    d["u"], d["delta"], d["A"], d["B"], d["C"], d["Dskip"],
                    d["z"], d["bias"], True), reps=1, groups=3)
                work = k1_work(B_, L, D, N, 2, carries)
            else:
                _, starts, _ = selective_scan_fwd_cuda(*args)
                gy = torch.randn(B_, L, D, generator=gen,
                                 device="cuda").to(bf)
                bargs = (d["u"], d["delta"], d["bias"], d["A"], d["B"],
                         d["C"], starts, gy, None, d["Dskip"], d["z"])
                ms = cuda_ms(lambda: selective_scan_bwd_cuda(*bargs), reps=10)
                plain_ms = cuda_ms(lambda: selective_scan_bwd_ref(*bargs),
                                   reps=1, groups=3)
                work = k2_work(B_, L, D, N, 2)
        bound_ms, bound_by, how = least_time(*work)
        key = f"{path} {tag} {(B_, L, D, N)}"
        times.setdefault(kernel, {})[key] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"{kernel} {key} bf16 fused{' with chunk starts' if carries else ''}"
              f": {ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} "
              f"ms by {bound_by} ({how}); {ms / bound_ms:.2f}x the bound",
              flush=True)
    return times


def reset_counts():
    from zigma_tpu_torch.ops import scan_cuda
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    scan_cuda.selective_scan_fwd_cuda.launches = 0
    scan_cuda.selective_scan_bwd_cuda.launches = 0
    selective_scan_ref.calls = selective_scan_bwd_ref.calls = 0


def read_counts():
    """(K1 launches, K2 launches, plain scan calls, plain backward calls)"""
    from zigma_tpu_torch.ops import scan_cuda
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    return (scan_cuda.selective_scan_fwd_cuda.launches,
            scan_cuda.selective_scan_bwd_cuda.launches,
            selective_scan_ref.calls, selective_scan_bwd_ref.calls)


def run_sample_cli(what, args):
    """``cli.sample.main(args)`` with the counts set to 0 just before and
    read just after; fails on non-finite samples or a plain-version call."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    reset_counts()
    t0 = time.perf_counter()
    res = sample_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, p1, p2 = read_counts()
    calls = sum(res["model_calls"])
    print(f"{what}: {wall:.2f} s; {len(res['model_calls'])} batch(es) of "
          f"{[round(v, 3) for v in res['batch_seconds']]} s; model calls "
          f"{res['model_calls']}; K1 {k1}, K2 {k2} launches; plain scan / "
          f"plain backward calls {(p1, p2)}", flush=True)
    if (p1, p2) != (0, 0):
        fail(f"{what}: the plain versions ran {(p1, p2)} times")
    if res["n_nonfinite"]:
        fail(f"{what}: {res['n_nonfinite']} non-finite sample values")
    return res, calls, k1, k2


def sample_dopri5_phase(ckpt, tmp):
    """The repo's default sampler, dopri5 at the ``ode`` config (250 save
    points, atol 1e-6, rtol 1e-3), batch 4: K1 launched 24 times a model
    call."""
    res, calls, k1, k2 = run_sample_cli("sample CLI dopri5", [
        f"ckpt={ckpt}", "model=zigzag8_b1_pe2", "sample_mode=ODE",
        f"offline_sample_local_bs={DOPRI5_BATCH}",
        f"num_fid_samples={DOPRI5_BATCH}", f"sample_dir={tmp}"])
    (st,) = res["dopri5"]
    img_s = DOPRI5_BATCH / res["batch_seconds"][0]
    print(f"flagship dopri5 (250 save points), batch {DOPRI5_BATCH}: {calls} "
          f"model calls, {st['accepted']} accepted and {st['rejected']} "
          f"rejected steps; {img_s:.4f} images/s", flush=True)
    if k1 != DEPTH * calls or k2 != 0:
        fail(f"dopri5: K1 / K2 launched {k1} / {k2} times for {calls} model "
             f"calls, expected {DEPTH} / 0 a call")
    if calls != 7 * (st["accepted"] + st["rejected"]) or calls < 7 * 249:
        fail(f"dopri5: {calls} model calls for {st}")
    return dict(images_per_s=img_s, model_calls=calls, k1=k1, **st)


def sample_sde_phase(ckpt, tmp):
    """``sample_mode=SDE`` at the ``sde`` config (Euler, 250 steps, sigma
    diffusion, Mean last step 0.04), batch 16: one model call a drift
    evaluation, so K1 launched 24 x 250 times."""
    res, calls, k1, k2 = run_sample_cli("sample CLI SDE", [
        f"ckpt={ckpt}", "model=zigzag8_b1_pe2", "sample_mode=SDE",
        f"offline_sample_local_bs={BATCH}", f"num_fid_samples={BATCH}",
        f"sample_dir={tmp}"])
    img_s = BATCH / res["batch_seconds"][0]
    print(f"flagship SDE Euler-250 + Mean, batch {BATCH}: {img_s:.4f} "
          f"images/s", flush=True)
    if calls != 250 or k1 != DEPTH * 250 or k2 != 0:
        fail(f"SDE: {calls} model calls, K1 / K2 {k1} / {k2}; expected 250, "
             f"{DEPTH * 250} / 0")
    return dict(images_per_s=img_s, k1=k1)


def likelihood_phase(ckpt, tmp):
    """``likelihood=true`` by Euler, 10 steps, batch 4: each of the 9 drift
    evaluations runs the model forward (remat: K1 twice a layer) and its
    vector-Jacobian product (K2 once a layer)."""
    res, calls, k1, k2 = run_sample_cli("sample CLI likelihood", [
        f"ckpt={ckpt}", "model=zigzag8_b1_pe2", "likelihood=true",
        "ode.sampling_method=euler", "ode.num_sampling_steps=10",
        f"offline_sample_local_bs={LIK_BATCH}",
        f"num_fid_samples={LIK_BATCH}", f"sample_dir={tmp}"])
    (logp,) = res["logp"]
    print(f"flagship likelihood euler-10, batch {LIK_BATCH}: logp "
          f"{[round(float(v), 2) for v in logp]}; "
          f"{LIK_BATCH / res['batch_seconds'][0]:.4f} samples scored/s",
          flush=True)
    if calls != 9 or k1 != 2 * DEPTH * 9 or k2 != DEPTH * 9:
        fail(f"likelihood: {calls} drift evaluations, K1 / K2 {k1} / {k2}; "
             f"expected 9, {2 * DEPTH * 9} / {DEPTH * 9}")
    if not all(math.isfinite(float(v)) for v in logp):
        fail(f"likelihood: logp {logp}")
    return dict(k1=k1, k2=k2, logp=[float(v) for v in logp])


def video_sample_phase(gen, ckpt, tmp):
    """``cli.sample`` from the video checkpoint, its weights perturbed by
    0.02 so the (trained-from-zero) gates are open, with classifier-free
    guidance 4 (one doubled batch a call), 50-step Euler, 2 batches of 4:
    K1 launched 24 x 49 times a batch; a .npy a batch and a .gif a video."""
    vckpt = perturbed_ckpt(gen, ckpt, os.path.join(tmp, "video.pt"))
    res, calls, k1, k2 = run_sample_cli("video sample CLI (cfg 4)", [
        f"ckpt={vckpt}", *VIDEO_ARGS, "cfg_scale=4", "sample_mode=ODE",
        "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}",
        f"offline_sample_local_bs={VIDEO_BATCH}",
        f"num_fid_samples={2 * VIDEO_BATCH}", f"sample_dir={tmp}"])
    files = sorted(os.listdir(res["out_dir"]))
    want = ([f"{i:06d}.gif" for i in range(2 * VIDEO_BATCH)]
            + ["video_0_0.npy", "video_1_0.npy"])
    videos_s = VIDEO_BATCH / res["batch_seconds"][1]
    print(f"video sampling, cfg 4, 50-step Euler, batch {VIDEO_BATCH} "
          f"({2 * VIDEO_BATCH} under CFG): {videos_s:.4f} videos/s (second "
          f"batch; first {res['batch_seconds'][0]:.3f} s); files {files}",
          flush=True)
    if files != want:
        fail(f"video sampling wrote {files}, expected {want}")
    if res["model_calls"] != [STEPS - 1] * 2 or k1 != 2 * DEPTH * (STEPS - 1):
        fail(f"video sampling: model calls {res['model_calls']}, K1 {k1}; "
             f"expected {STEPS - 1} and {DEPTH * (STEPS - 1)} a batch")
    return vckpt, dict(videos_per_s=videos_s, k1=k1)


def repairs_phase(gen):
    """The two repaired faults of the CUDA scan.  (a) No delta_bias, A a
    non-contiguous view in bf16, D in bf16: K1 without a gradient and K1/K2
    under autograd against the plain versions on the same values.  (b)
    65537 sequences, past the grid's 65535: K1 and K2 (one wrapper call
    each, launched on slices of the batch) against the plain versions, K2
    bit-equal over two calls."""
    import torch
    from zigma_tpu_torch.ops.selective_scan import selective_scan
    f, bf = torch.float32, torch.bfloat16
    for dname, dtype in (("fp32", f), ("bf16", bf)):
        d = scan_inputs(gen, 2, 1024, 1536, 16, dtype)
        A = d["A"].t().contiguous().t().to(bf)  # (1536, 16), strides (1, 1536)
        Dk = d["Dskip"].to(bf)
        ulp = BF16_ULP if dtype == bf else 0.0
        reset_counts()
        with torch.no_grad():
            got = selective_scan(d["u"], d["delta"], A, d["B"], d["C"], Dk,
                                 d["z"], None, delta_softplus=True)
            ref = selective_scan(d["u"], d["delta"], A, d["B"], d["C"], Dk,
                                 d["z"], None, delta_softplus=True,
                                 backend="ref")
        torch.cuda.synchronize()
        worst = [("y no-grad", excess(got, ref, ulp))]
        if read_counts()[:2] != (1, 0):
            fail(f"no-bias scan: K1 / K2 launches {read_counts()[:2]}, "
                 f"expected 1 / 0")
        gy = torch.randn(got.shape, generator=gen, device="cuda")
        grads = []
        for backend in ("auto", "ref"):
            ins = {k: v.detach().clone().requires_grad_()
                   for k, v in dict(u=d["u"], delta=d["delta"], A=A, B=d["B"],
                                    C=d["C"], D=Dk, z=d["z"]).items()}
            out = selective_scan(ins["u"], ins["delta"], ins["A"], ins["B"],
                                 ins["C"], ins["D"], ins["z"], None,
                                 delta_softplus=True, backend=backend)
            (out.float() * gy).sum().backward()
            grads.append((out.detach(), {k: v.grad for k, v in ins.items()}))
        torch.cuda.synchronize()
        (ok_, gk), (or_, gr) = grads
        worst.append(("y autograd", excess(ok_, or_, ulp)))
        for k in gr:
            if gk[k].dtype != gr[k].dtype or gk[k].dtype != ins[k].dtype:
                fail(f"no-bias scan: d{k} {gk[k].dtype} / {gr[k].dtype}, "
                     f"input {ins[k].dtype}")
            worst.append((f"d{k}", excess(gk[k], gr[k], BF16_ULP
                                           if gk[k].dtype == bf else 0.0)))
        k1, k2, p1, p2 = read_counts()
        if (k1, k2) != (2, 1):
            fail(f"no-bias scan: K1 / K2 launches {(k1, k2)}, expected 2 / 1")
        print(f"no delta_bias, A bf16 non-contiguous, D bf16, {dname} inputs "
              f"(2, 1024, 1536, 16), kernel vs plain, excess over one bf16 ulp "
              f"of max |ref|: " + ", ".join(f"{n} {e:.2e}" for n, e in worst)
              + f" (limits {TOL_FP32} y, {TOL_BWD} gradients); K1 {k1}, K2 "
              f"{k2} launches", flush=True)
        for n, e in worst:
            if not e <= (TOL_FP32 if n.startswith("y") else TOL_BWD):
                fail(f"no-bias scan {dname}: {n} excess {e}")
    B_ = 65537
    reset_counts()
    check_kernel_case(f"K1 ({B_}, 16, 128, 16) bf16 fused", gen, B_, 16, 128,
                      16, bf, True, False)
    check_bwd_case(f"K2 ({B_}, 16, 128, 16) bf16 fused", gen, B_, 16, 128, 16,
                   bf, True)
    k1, k2, _, _ = read_counts()
    print(f"{B_} sequences: K1 {k1}, K2 {k2} wrapper launches (one K1 call "
          f"in each case, two K2 calls)", flush=True)
    if (k1, k2) != (2, 2):
        fail(f"{B_} sequences: K1 / K2 counted {(k1, k2)}, expected 2 / 2")


def s1024_kernel_phase(gen):
    """K1 at the 1024^2 sampling cells' shapes, batch 1, against the plain
    version; its time beside the bound and the blocks it launches."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_fwd_cuda,
                                               selective_scan_fwd_launch_info)
    from zigma_tpu_torch.ops.selective_scan import selective_scan_ref
    bf = torch.bfloat16
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {}
    for tag, L in (("p2", 4096), ("p1", 16384)):
        shp = (1, L, 1536, 16)
        d, errs = check_kernel_case(f"K1 1024^2 {tag} {shp} bf16 fused", gen,
                                    *shp, bf, True, False)
        args = (d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"],
                d["Dskip"], d["z"])
        with torch.inference_mode():
            ms = cuda_ms(lambda: selective_scan_fwd_cuda(
                *args, return_carries=False), reps=10)
            plain_ms = cuda_ms(lambda: selective_scan_ref(
                d["u"], d["delta"], d["A"], d["B"], d["C"], d["Dskip"],
                d["z"], d["bias"], True), reps=1, groups=3)
        info = selective_scan_fwd_launch_info(16, L, bf)
        blocks = -(-1536 // info["channels_per_block"])
        bound_ms, bound_by, how = least_time(*k1_work(*shp, 2))
        times[f"sample_1024_{tag} {shp}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            blocks=blocks, max_abs_err=errs["y"])
        print(f"K1 1024^2 {tag} {shp} bf16 fused: {ms:.4f} ms; plain "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
              f"({how}); {ms / bound_ms:.2f}x the bound; {blocks} blocks on "
              f"{n_sms} SMs", flush=True)
    return times


def train_cli_phase(what, args, batch, k1_step, k2_step, tmp, unit="images"):
    """``cli.train`` with ``args`` at ``batch``, TRAIN_STEPS steps, the
    counts set to 0 just before and read just after: every loss finite,
    exactly ``k1_step`` / ``k2_step`` K1 / K2 launches a step and the plain
    versions never; the checkpoint's EMA loads with strict=True into the
    sampler's model.  Returns (state, checkpoint, numbers); ``unit`` names
    a sample (images, videos) in the printed rate."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli import train as train_cli

    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    reset_counts()
    t0 = time.perf_counter()
    res = train_cli.main([*args, f"data.batch_size={batch}",
                          f"data.train_steps={TRAIN_STEPS}", "log_every=1",
                          f"results_dir={tmp}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default", args)
    fresh = sample_cli.build_model(cfg, device="cuda")
    fresh.load_state_dict(sample_cli.load_state_dict(res["checkpoint"]),
                          strict=True)
    del fresh
    model = res["state"].model
    losses = [r["loss"] for r in res["records"]]
    want = (k1_step * TRAIN_STEPS, k2_step * TRAIN_STEPS, 0, 0)
    print(f"{what} train CLI: {len(losses)} steps in {wall:.2f} s (model "
          f"build included); {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params, dtype {model.dtype}, remat {model.use_checkpoint}; losses "
          f"{[round(v, 4) for v in losses]}; K1, K2, plain scan, plain "
          f"backward {counts} (expected {want}); EMA loaded with strict=True "
          f"into the sampler's model", flush=True)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"{what} training losses {losses}")
    if counts != want:
        fail(f"{what} training: K1 / K2 / plain {counts}, expected {want}")
    steady = [1.0 / r["steps_per_sec"] for r in res["records"][1:]]
    steps_s = len(steady) / sum(steady)
    print(f"{what} training, batch {batch}: {steps_s:.4f} steps/s, "
          f"{steps_s * batch:.3f} {unit}/s (steady steps 2-{TRAIN_STEPS}, "
          f"range {min(steady):.4f}-{max(steady):.4f} s; first step "
          f"{1.0 / res['records'][0]['steps_per_sec']:.3f} s); peak device "
          f"memory {peak_gb:.2f} GB, of which {held_gb:.2f} GB held by "
          f"earlier phases before the run", flush=True)
    return res["state"], res["checkpoint"], dict(
        steps_per_s=steps_s, samples_per_s=steps_s * batch, peak_gb=peak_gb,
        held_gb=held_gb, k1=counts[0], k2=counts[1])


def perturbed_ckpt(gen, ckpt, path):
    """``ckpt``'s EMA weights plus 0.02 of normal noise (so the gates a
    short run trained from zero are open), saved as ``path``."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    sd = sample_cli.load_state_dict(ckpt)
    with torch.no_grad():
        sd = {k: v + 0.02 * torch.randn(v.shape, generator=gen,
                                        device="cuda").to(v.device)
              for k, v in sd.items()}
    torch.save({"ema": sd}, path)
    return path


def text_sample_phase(gen, ckpt):
    """Guided sampling of the text model from ``ckpt`` (perturbed), cfg 4
    against the null (zero) features, 50-step Euler, 2 batches of 16 with
    random caption features: the sampler's model and the model API, as the
    CLI's own path feeds zero features.  K1 launched 24 x 49 times a
    batch."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.transport import Sampler, create_transport
    from zigma_tpu_torch.utils.inference import cast_for_inference

    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 TEXT_ARGS)
    model = sample_cli.build_model(cfg, device="cuda")
    model.load_state_dict(sample_cli.load_state_dict(ckpt))
    cast_for_inference(model, model.dtype).eval().requires_grad_(False)
    sample_fn = Sampler(create_transport()).sample_ode(
        sampling_method="euler", num_steps=STEPS)
    seconds = []
    for _ in range(N_BATCHES):
        z = torch.randn(BATCH, 4, 32, 32, generator=gen, device="cuda")
        y = torch.randn(BATCH, N_CTX, D_CTX, generator=gen, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = sample_fn(z, lambda x, t: model.forward_with_cfg(
                x, t, y, 4.0))[-1].float().cpu()
        seconds.append(time.perf_counter() - t0)
        counts = read_counts()
        if counts != (DEPTH * (STEPS - 1), 0, 0, 0):
            fail(f"text guided sampling: K1 / K2 / plain {counts}, expected "
                 f"{DEPTH * (STEPS - 1)} K1 a batch and nothing else")
        if not bool(torch.isfinite(out).all()):
            fail("text guided sampling: non-finite samples")
    img_s = BATCH / seconds[1]
    print(f"text guided sampling, cfg 4, 50-step Euler, batch {BATCH} "
          f"({2 * BATCH} under CFG), 77 x 768 caption features: "
          f"{img_s:.4f} images/s (second batch; first {seconds[0]:.3f} s); "
          f"K1 {counts[0]} launches a batch", flush=True)
    return dict(images_per_s=img_s, k1=counts[0] * N_BATCHES)


def ssd_truth_phase(gen):
    """The chunked SSD on the card at the ssm2 flagship's scan shape, fp32
    and bf16, with D, z and the dt bias, against a float64 run of the
    sequential form; the same for the gradients of ``sum(y * w)``.  fp32:
    at most TOL_SSD_FP32_MULT x the plain fp32 sequential form's error;
    bf16: at most TOL_SSD_BF16_ULPS bf16 unit roundoffs.  Then the chunked
    form's forward and forward-plus-backward times in bf16."""
    import torch
    from zigma_tpu_torch.ops.ssd import ssd_scan, ssd_scan_ref
    b, L, H, P, N = SSD_SHAPE.values()
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    # the Mamba-2 init: A = -U[1, 16], dt bias the inverse softplus of a dt
    # log-uniform in [0.001, 0.1]
    dt0 = torch.exp(torch.rand(H, generator=gen, device="cuda")
                    * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    base = dict(x=r(b, L, H, P), dt=0.5 * r(b, L, H),
                A=-(1 + 15 * torch.rand(H, generator=gen, device="cuda")),
                B=r(b, L, 1, N), C=r(b, L, 1, N), D=r(H), z=r(b, L, H, P),
                dt_bias=dt0 + torch.log(-torch.expm1(-dt0)))
    w = r(b, L, H, P)
    names = ("x", "dt", "A", "B", "C", "D", "z", "dt_bias")
    low = ("x", "dt", "B", "C", "z")  # in the compute dtype

    def run(fn, ins):
        ins = {k: v.detach().clone().requires_grad_() for k, v in ins.items()}
        y = fn(**ins, dt_softplus=True)
        (y.double() * w.double()).sum().backward()
        return y.detach(), {k: ins[k].grad for k in names}

    worst = {}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ins = {k: v.to(dtype) if k in low else v for k, v in base.items()}
        y_c, g_c = run(ssd_scan, ins)
        y_p, g_p = run(ssd_scan_ref, {k: v.float() for k, v in ins.items()})
        y_t, g_t = run(ssd_scan_ref, {k: v.double() for k, v in ins.items()})
        torch.cuda.synchronize()
        parts = []
        for what, c, p, t in [("y", y_c, y_p, y_t)] + [
                (f"d{k}", g_c[k], g_p[k], g_t[k]) for k in names]:
            scale = t.abs().max().item()
            e_c = (c.double() - t).abs().max().item() / scale
            e_p = (p.double() - t).abs().max().item() / scale
            if dtype == torch.float32:
                ratio, limit = e_c / max(e_p, FP32_EPS), TOL_SSD_FP32_MULT
                parts.append(f"{what} {e_c:.2e}/{e_p:.2e} ({ratio:.2f}x)")
            else:
                ratio, limit = e_c / BF16_EPS, TOL_SSD_BF16_ULPS
                parts.append(f"{what} {e_c:.2e} ({ratio:.2f} ulps)")
            worst[dname] = max(worst.get(dname, (0.0, "")), (ratio, what))
            if not ratio <= limit:
                fail(f"SSD {dname}: {what} error against the f64 truth "
                     f"{e_c:.3e} of max |truth|: {ratio:.2f} > {limit}")
        print(f"SSD chunked {dname} {tuple(SSD_SHAPE.values())} vs f64 "
              f"sequential, of max |truth| (fp32: chunked/plain fp32 "
              f"sequential; bf16: in bf16 unit roundoffs): "
              + "; ".join(parts), flush=True)
        del y_c, g_c, y_p, g_p, y_t, g_t
        torch.cuda.empty_cache()
    ins = {k: v.to(torch.bfloat16) if k in low else v for k, v in base.items()}
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: ssd_scan(**ins, dt_softplus=True), reps=5)
    grads_in = {k: v.detach().clone().requires_grad_() for k, v in ins.items()}
    wb = w.to(torch.bfloat16)
    fb_ms = cuda_ms(lambda: (ssd_scan(**grads_in, dt_softplus=True) * wb)
                    .sum().backward(), reps=3)
    print(f"SSD gate: fp32 at most {worst['fp32'][0]:.2f}x the plain fp32 "
          f"version's error ({worst['fp32'][1]}; limit {TOL_SSD_FP32_MULT}), "
          f"bf16 at most {worst['bf16'][0]:.2f} bf16 unit roundoffs "
          f"({worst['bf16'][1]}; limit {TOL_SSD_BF16_ULPS}); chunked bf16 "
          f"forward {fwd_ms:.4f} ms, forward + backward {fb_ms:.4f} ms",
          flush=True)
    return dict(fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms,
                fp32_ratio=worst["fp32"][0], bf16_ulps=worst["bf16"][0])


def ssm2_sample_phase(gen, ckpt, tmp):
    """``cli.sample`` of the ssm2 model from ``ckpt`` (perturbed), 50-step
    Euler, 2 batches of 16: neither scan kernel nor the plain scans."""
    path = perturbed_ckpt(gen, ckpt, os.path.join(tmp, "ssm2.pt"))
    res, calls, k1, k2 = run_sample_cli("ssm2 sample CLI", [
        f"ckpt={path}", *SSM2_ARGS, "sample_mode=ODE",
        "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}",
        f"offline_sample_local_bs={BATCH}",
        f"num_fid_samples={N_BATCHES * BATCH}", f"sample_dir={tmp}"])
    img_s = BATCH / res["batch_seconds"][1]
    print(f"ssm2 50-step Euler, batch {BATCH}: {img_s:.4f} images/s (second "
          f"batch; first {res['batch_seconds'][0]:.3f} s); K1 {k1}, K2 {k2}",
          flush=True)
    if (k1, k2) != (0, 0) or calls != N_BATCHES * (STEPS - 1):
        fail(f"ssm2 sampling: K1 / K2 {(k1, k2)}, {calls} model calls")
    return dict(images_per_s=img_s)


def s1024_sample_phase(gen, tmp):
    """``cli.sample`` at the 1024^2 cells (random weights, perturbed), batch
    1, 50-step Euler, 2 batches: K1 24 x 49 launches a batch."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    out = {}
    for tag, args in S1024.items():
        cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                     args)
        model = sample_cli.build_model(cfg, device="cuda", generator=gen)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen,
                                          device="cuda"))
        path = os.path.join(tmp, f"s1024_{tag}.pt")
        torch.save({"ema": {k: v.cpu() for k, v in model.state_dict().items()}},
                   path)
        tokens = (128 // model.patch_size) ** 2
        del model
        res, calls, k1, k2 = run_sample_cli(f"1024^2 {tag} sample CLI", [
            f"ckpt={path}", *args, "sample_mode=ODE",
            "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}",
            "offline_sample_local_bs=1", "num_fid_samples=2",
            f"sample_dir={tmp}"])
        img_s = 1.0 / res["batch_seconds"][1]
        print(f"1024^2 {tag} ({tokens} tokens), 50-step Euler, batch 1: "
              f"{img_s:.4f} images/s (second batch; first "
              f"{res['batch_seconds'][0]:.3f} s); K1 {k1}", flush=True)
        if k1 != 2 * DEPTH * (STEPS - 1) or k2 != 0:
            fail(f"1024^2 {tag} sampling: K1 / K2 {(k1, k2)}, expected "
                 f"{2 * DEPTH * (STEPS - 1)} / 0")
        out[tag] = dict(images_per_s=img_s, k1=k1)
    return out


def _kind(key):
    k = key.lower()
    return ("K1 selective scan fwd" if "selective_scan_fwd" in k else
            "K2 selective scan bwd" if "selective_scan_bwd" in k else
            "attention (SDPA)" if any(s in k for s in ("flash", "fmha",
                                                       "attention")) else
            "GEMM" if any(s in k for s in ("gemm", "nvjet", "cutlass",
                                           "sm90_xmma")) else
            "gather (scan-path permutation)" if ("index" in k
                                                 or "gather" in k) else
            "optimizer / EMA / clip (foreach)" if ("multi_tensor" in k
                                                   or "foreach" in k) else
            "reduction" if "reduce" in k else
            "convolution (patch embed)" if "conv" in k else
            "elementwise / copy")


def profile_phase(what, fn):
    """Device time of one call of ``fn`` (after one warm-up call), by kind
    and by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernels only: the CPU ops that launched them, and
    # annotated ranges such as the optimizer's step, carry the same time
    # again (the filter of the profiler's own table)
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in rows)
    if total <= 0:
        fail("the profiler saw no device time")
    rows.sort(key=lambda e: -e.self_device_time_total)
    print(f"{what}: device busy {total / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * total / wall_us:.1f}%)")
    kinds = {}
    for e in rows:
        kind = _kind(e.key)
        n, us = kinds.get(kind, (0, 0))
        kinds[kind] = (n + e.count, us + e.self_device_time_total)
    print(f"{'device ms':>15} {'share':>7} {'calls':>6}  kind")
    for kind, (n, us) in sorted(kinds.items(), key=lambda kv: -kv[1][1]):
        print(f"{us / 1e3:15.3f} {100 * us / total:6.1f}% {n:6d}  {kind}")
    print(f"{'self device ms':>15} {'share':>7} {'calls':>6}  kernel")
    for e in rows[:10]:
        print(f"{e.self_device_time_total / 1e3:15.3f} "
              f"{100 * e.self_device_time_total / total:6.1f}% {e.count:6d}  "
              f"{e.key[:90]}", flush=True)


def train_step_fn(state, gen, x_shape, num_classes=-1, text=None):
    """One training step of ``state`` on a fixed batch (for the profile):
    class labels, or ``text`` = (tokens, width) caption features."""
    import torch
    from zigma_tpu_torch.train import (LATENT_SCALE, make_diffusion_loss_fn,
                                       train_step)
    from zigma_tpu_torch.transport import create_transport
    loss_fn = make_diffusion_loss_fn(state.model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    batch = {"x": torch.randn(x_shape, generator=gen, device="cuda")}
    if num_classes > 0:
        batch["y"] = torch.randint(0, num_classes, x_shape[:1], generator=gen,
                                   device="cuda")
    elif text is not None:
        batch["y"] = torch.randn(x_shape[0], *text, generator=gen,
                                 device="cuda")
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    return lambda: train_step(state, loss_fn, batch, step_gen)["loss"].item()


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
            m = re.search(r"Compiling entry function '\w*?"
                          r"(selective_scan_\w{3}_kernel)I(\w+?)EvNS", line)
            if m:  # the instance: element type and template integers
                dtype = "bf16" if "bfloat16" in m.group(2) else "fp32"
                ints = re.findall(r"Li(\d+)E", m.group(2))
                print(f"    {m.group(1)}<{', '.join([dtype, *ints])}>")
            elif "registers" in line or "spill" in line:
                print("   ", line.strip())
    print(f"build {time.perf_counter() - t0:.2f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase("kernel")
    k1 = kernel_phase(gen)
    phase("kernel bwd")
    k2 = kernel_bwd_phase(gen)
    phase("kernels at the video shapes")
    kv = video_kernel_phase(gen)
    phase("repairs: no delta_bias, cast A and D, 65537 sequences")
    repairs_phase(gen)
    phase("kernels at the 1024^2 sampling shapes")
    k1_1024 = s1024_kernel_phase(gen)
    with tempfile.TemporaryDirectory() as tmp:
        phase("sample (main path of the serving slice)")
        model, x, t, e2e = main_path_phase(gen, tmp)
        phase("train (main path of the training slice)")
        state, tr = train_phase(gen)
        phase("grad check")
        grad_check_phase(gen, "flagship-width depth 2", (2, 4, 32, 32),
                         depth=2, img_dim=32, patch_size=1,
                         scan_type="zigzagN8")
        phase("sample dopri5 (the default ode config)")
        dp = sample_dopri5_phase(e2e["ckpt"], tmp)
        phase("sample SDE (the default sde config)")
        sde = sample_sde_phase(e2e["ckpt"], tmp)
        phase("likelihood")
        lik = likelihood_phase(e2e["ckpt"], tmp)
        phase("video train (3d_zigzag8sst_b2)")
        vstate, vckpt, vtr = train_cli_phase(
            "video", VIDEO_ARGS, VIDEO_BATCH, 2 * DEPTH, DEPTH, tmp, "videos")
        phase("video sample (3d_zigzag8sst_b2, cfg 4)")
        vckpt, vs = video_sample_phase(gen, vckpt, tmp)
        phase("video grad check")
        grad_check_phase(gen, "flagship-width video depth 3 (s, s, t)",
                         (2, 16, 4, 32, 32), depth=3, img_dim=32,
                         patch_size=2, scan_type="zzvideo_sst",
                         video_frames=16, tpe=True, num_classes=101,
                         class_dropout_prob=0.1)
        phase("text train (flagship with 77 x 768 caption features)")
        tstate, tckpt, ttr = train_cli_phase(
            "text", TEXT_ARGS, BATCH, 2 * DEPTH, DEPTH, tmp)
        phase("text guided sample (cfg 4)")
        ts = text_sample_phase(gen, perturbed_ckpt(
            gen, tckpt, os.path.join(tmp, "text.pt")))
        phase("text grad check (use_pe 3)")
        grad_check_phase(gen, "flagship-width text depth 2, use_pe 3",
                         (2, 4, 32, 32), depth=2, img_dim=32, patch_size=1,
                         scan_type="zigzagN8", has_text=True,
                         d_context=D_CTX, use_pe=3)
        phase("ssm2 train (zigzag8_b1_pe2_ssm2)")
        sstate, sckpt, s2tr = train_cli_phase("ssm2", SSM2_ARGS, BATCH, 0, 0,
                                              tmp)
        phase("ssm2 sample")
        s2s = ssm2_sample_phase(gen, sckpt, tmp)
        print(f"ssm2 paths: K1 {s2tr['k1']} / K2 {s2tr['k2']} launches in "
              f"training, 0 / 0 in sampling; the plain scans never",
              flush=True)
        phase("SSD truth gate and times")
        ssd = ssd_truth_phase(gen)
        phase("1024^2 sampling (s1024_zigzag8_b2, patch 2 and 1)")
        s1024 = s1024_sample_phase(gen, tmp)
        phase("profile")

        def forward():
            with torch.inference_mode():
                model(x, t)

        profile_phase("one flagship forward (sampling)", forward)
        del model
        profile_phase(f"one flagship training step (batch {BATCH})",
                      train_step_fn(state, gen, (BATCH, 4, 32, 32)))
        del state
        profile_phase(f"one video training step (batch {VIDEO_BATCH})",
                      train_step_fn(vstate, gen, (VIDEO_BATCH, 16, 4, 32, 32),
                                    101))
        del vstate
        profile_phase(f"one text training step (batch {BATCH})",
                      train_step_fn(tstate, gen, (BATCH, 4, 32, 32),
                                    text=(N_CTX, D_CTX)))
        del tstate
        profile_phase(f"one ssm2 training step (batch {BATCH})",
                      train_step_fn(sstate, gen, (BATCH, 4, 32, 32)))
        del sstate
        vmodel, vx, vt, vy = guided_video_inputs(gen, vckpt)

        def guided():
            with torch.inference_mode():
                vmodel.forward_with_cfg(vx, vt, vy, 4.0)

        profile_phase(f"one guided video forward (batch {VIDEO_BATCH}, "
                      f"{2 * VIDEO_BATCH} under CFG)", guided)

    kernels = [
        dict(name="selective_scan_fwd", route="cuda",
             source="zigma_tpu_torch/csrc/selective_scan_fwd.cu",
             replaces="zigma_tpu/ops/scan_pallas.py:55",
             launches=tr["k1"],
             launches_by_path={"train": tr["k1"], "sample": e2e["launches"],
                               "sample_dopri5": dp["k1"],
                               "sample_sde": sde["k1"],
                               "likelihood": lik["k1"],
                               "video_train": vtr["k1"],
                               "video_sample": vs["k1"],
                               "text_train": ttr["k1"],
                               "text_sample": ts["k1"],
                               "sample_1024_p2": s1024["p2"]["k1"],
                               "sample_1024_p1": s1024["p1"]["k1"]},
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             ms_with_carries=k1["ms_with_carries"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             video_shapes=kv["K1"], shapes_1024=k1_1024),
        dict(name="selective_scan_bwd", route="cuda",
             source="zigma_tpu_torch/csrc/selective_scan_bwd.cu",
             replaces="zigma_tpu/ops/scan_pallas.py:418",
             launches=tr["k2"],
             launches_by_path={"train": tr["k2"], "likelihood": lik["k2"],
                               "video_train": vtr["k2"],
                               "text_train": ttr["k2"]},
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None,
             video_shapes=kv["K2"])]
    print(f"\nflagship sampling {e2e['images_per_s']:.4f} images/s, forward "
          f"{e2e['forward_ms']:.3f} ms; training {tr['steps_per_s']:.4f} "
          f"steps/s, {tr['images_per_s']:.3f} images/s, peak "
          f"{tr['peak_gb']:.2f} GB; dopri5 {dp['model_calls']} model calls "
          f"({dp['accepted']} accepted, {dp['rejected']} rejected), "
          f"{dp['images_per_s']:.4f} images/s; SDE {sde['images_per_s']:.4f} "
          f"images/s; video training {vtr['steps_per_s']:.4f} steps/s, "
          f"{vtr['samples_per_s']:.3f} videos/s, peak {vtr['peak_gb']:.2f} GB "
          f"({vtr['held_gb']:.2f} GB held before it); "
          f"guided video sampling {vs['videos_per_s']:.4f} videos/s; text "
          f"training {ttr['steps_per_s']:.4f} steps/s, peak "
          f"{ttr['peak_gb']:.2f} GB ({ttr['held_gb']:.2f} GB held before "
          f"it); text guided sampling {ts['images_per_s']:.4f} images/s; "
          f"ssm2 training {s2tr['steps_per_s']:.4f} steps/s, peak "
          f"{s2tr['peak_gb']:.2f} GB ({s2tr['held_gb']:.2f} GB held before "
          f"it); ssm2 sampling {s2s['images_per_s']:.4f} images/s; SSD "
          f"chunked bf16 forward {ssd['fwd_ms']:.3f} ms, forward + backward "
          f"{ssd['fwd_bwd_ms']:.3f} ms; 1024^2 sampling "
          f"{s1024['p2']['images_per_s']:.4f} (patch 2) and "
          f"{s1024['p1']['images_per_s']:.4f} (patch 1) images/s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


def guided_video_inputs(gen, ckpt):
    """The sampler's video model (bf16 inference cast) from ``ckpt`` and
    one batch of its inputs, for the guided forward's profile."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.utils.inference import cast_for_inference
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 VIDEO_ARGS)
    model = sample_cli.build_model(cfg, device="cuda")
    model.load_state_dict(sample_cli.load_state_dict(ckpt))
    cast_for_inference(model, model.dtype).eval()
    x = torch.randn(VIDEO_BATCH, 16, 4, 32, 32, generator=gen, device="cuda")
    t = torch.rand(VIDEO_BATCH, generator=gen, device="cuda")
    y = torch.randint(0, 101, (VIDEO_BATCH,), generator=gen, device="cuda")
    return model, x, t, y


if __name__ == "__main__":
    main()
