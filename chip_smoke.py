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
23. vae / clip -- the SD-VAE at full width (random weights written as a
                 diffusers-layout file and loaded through ``VAECodec``):
                 encode (mean, logvar, posterior sample) and decode of 2
                 256^2 images on the card against the CPU, then encode and
                 decode at batch 16 and a 1024^2 decode timed beside the
                 fp32 bound; the CLIP ViT-L/14 text tower on 16 x 77 token
                 ids the same way;
24. prepare data -- ``cli.prepare_data --codec sd-vae --keep-jpeg`` on 64
                 seeded PNGs of mixed sizes into churches-layout shards; a
                 coco layout (those members and 5 captions' CLIP features a
                 sample) and a ucf101 layout (``FeaturePrepDataset``: 20
                 VAE-encoded frames and a class id a clip);
25. train from shards -- ``cli.train`` from the churches (flagship), coco
                 (text model) and ucf101 (video model, batch 4) shards, 8
                 steps each: K1 48 and K2 24 launches a step; the loaders'
                 samples/s alone;
26. sample to pixels -- ``cli.sample`` with ``decode_latents=true
                 vae_kind=sd-vae``: 2 batches of 16 flagship samples as
                 256x256 RGB PNGs (K1 24 x 49 a batch), one guided batch of
                 4 videos as 16-frame GIFs; the likelihood on the churches
                 validation split (K1 48 x 9, K2 24 x 9); ``sd-vae``
                 without weights raises; the native tar reader served every
                 shard of phases 24-26;
27. profile   -- the device time of one flagship forward, one flagship
                 training step (synthetic, and from the churches shards
                 with the loader's thread running: the device's idle share
                 of each), one video training step, one guided video
                 forward, one text training step and one ssm2 training
                 step, by kind (torch.profiler).
28. metric nets -- the FID Inception, DINOv2 ViT-L/14, I3D and LPIPS at
                 full width with seeded random weights, written in the real
                 files' layouts where the weight probing reads them
                 (``ZIGMA_INCEPTION_WEIGHTS``, ``ZIGMA_DINOV2_WEIGHTS``, a
                 traced I3D archive as ``ZIGMA_I3D_TORCHSCRIPT``): each on
                 the card against the same net on the CPU, per output
                 (``TOL_NETS``), and timed at the eval's batch beside its
                 FLOPs and the fp32 bound;
29. image eval -- ``cli.train`` on the flagship from the churches shards,
                 8 steps with one eval at step 8: 64 samples in batches of
                 16 by 50-step Euler, decoded by the SD-VAE, the full image
                 menu (fid, is, kid, prdc, sfid, fdd) through the nets on
                 the card, nothing dropped or degraded; K1 exactly 48 a step
                 plus 4 x 49 x 24, K2 exactly 24 a step; ``best_fid`` finite
                 in the checkpoint; the eval's seconds by part;
30. video eval -- ``cli.train`` on the video ZigMa from the ucf101 shards,
                 8 steps and one eval of 16 videos (4 batches of 4): fid
                 per frame and the styleganv fvd, undegraded; K1 exactly;
31. sample metrics -- ``cli.sample metrics=[fid,kid,is,sfid,prdc,fdd]
                 decode_latents=true`` against the churches validation
                 split, 2 batches of 16: ``metrics.json`` written, every
                 score finite, K1 24 x 49 a batch;
32. serve     -- ``cli.serve``'s ``GenerationWorker`` on the flagship at
                 full width (class-conditional, label drop 0.1, random
                 weights, bf16 inference cast), 50-step Euler at
                 serve_batch 8, SD-VAE decode, behind a
                 ``ThreadingHTTPServer`` on 127.0.0.1: /healthz, a request
                 for 3 images, two concurrent requests, a guided one (cfg
                 4), equal arrays for equal seeds, 503 from a full queue of
                 one; K1 exactly 24 x 49 a request, guided or not; warm-up
                 seconds, ms a request and images/s;
33. LM        -- ``models.lm`` at state-spaces/mamba-130m's shape (d_model
                 768, 24 layers, vocab 50277 padded by 8, RMSNorm, residual
                 in fp32, bf16, random weights): K1 at the prefill's (8,
                 128, 1536, 16) against its plain version and the float64
                 truth, timed beside the bound; prefill through K1 against
                 the plain scan and prefill + 4 steps against 132 steps, in
                 bf16 and fp32, and for a depth-4 Mamba-2 LM;
                 ``loglikelihood_batch`` on the card against the CPU; greedy
                 ``generate`` of 128 tokens after 128 at batch 8: K1 exactly
                 24 a call and 0 a decode step, prefill ms, decode ms a
                 token, tokens/s, launches and idle share of a decode step
                 (torch.profiler); ``tools/benchmark_generation.py``;
34. scan contract -- ``core_full`` / ``core_x0`` under autograd at the
                 flagship shape, fp32 and bf16 (after the 1024^2 kernels):
                 K1 seeded with x0 and returning the final state, K2 seeded
                 by the final state's cotangent and returning dx0, exactly
                 one launch each a call, with the loss on both outputs, on
                 y alone and on the final state alone; against the plain
                 versions and the float64 truth (``truth_f64`` /
                 ``truth_bwd_f64`` with a seed and ``g_last``);
35. sequence parallel -- the flagship scan (fused; bf16 and fp32) over 4
                 virtual shards of 256 tokens: pass 1, ``prefix_states``,
                 pass 2, as ``selective_scan_seq_parallel`` runs them with
                 the stack for the all-gather; exactly 8 K1 and 8 K2;
                 outputs and gradients against the unsharded kernels and
                 the float64 truth; times beside the unsharded scan's; K1
                 and K2 at (16, 256, 1536, 16) as the passes call them,
                 beside their bounds (the SSD over 4 shards is held in the
                 SSD truth phase, 21);
36. distributed training -- ``cli.train`` in this process as rank 0 of a
                 world of one over NCCL (the launcher's variables set,
                 after the grad check): DDP, FSDP2 (``parallel.fsdp``) and
                 TP-1 (``parallel.tp=1``) on the flagship, 8 steps each:
                 48 K1 / 24 K2 a step, losses against the single-process
                 train phase's, strict load and one resumed step, steps/s
                 and peak memory; then ``python -m torch.distributed.run
                 --standalone --nproc_per_node=1 -m
                 zigma_tpu_torch.cli.train`` at depth 2 (exit 0, its
                 checkpoint) and the same stopped by SIGTERM to its worker
                 after its first logged step (exit 0, the message, a
                 checkpoint at or past that step);
37. distributed sampling -- ``cli.sample`` at world size 1 over NCCL from
                 the DDP checkpoint, Euler-50, 2 batches of 16: K1 2 x 49 x
                 24 launches, the images equal to the single-process
                 sampler's;
38. microbatch kernels -- K1 and K2 at the pipelined step's microbatch
                 shape (4, 1024, 1536, 16), bf16 fused, as training calls
                 them, against their plain versions; times beside the plain
                 versions and the bounds (after the sequence-parallel phase);
39. selective remat -- ``cli.train`` on the flagship under each
                 ``model.params.remat_policy`` (``scan_out``, ``dots``,
                 ``scan_out+dots``), 8 steps: K1 exactly 24, 48, 24 a step
                 (the recompute takes the registered K1 operator's kept
                 outputs), K2 24; losses against the train phase's full
                 remat for the same seed; steps/s and peak memory beside
                 it; then a depth-2 fp32 flagship-width model under
                 ``scan_out`` against full remat's gradients;
40. pipeline  -- ``cli.train`` with ``parallel.pp=1
                 parallel.pp_microbatches=4`` as rank 0 of a world of one
                 over NCCL, drop-path 0, 4 steps: K1 exactly 192 and K2 96 a
                 step, the losses within 1% of a one-process run's with the
                 same seed, the gathered checkpoint strict; a depth-2 fp32
                 stage through ``zigma_pipelined_apply`` against the plain
                 model (output and gradients);
41. convert   -- the flagship's random weights as a reference-layout
                 ``.pt`` through ``cli.convert`` on the card, then one
                 ``cli.train ckpt=`` step from the step-0 checkpoint: 48 K1,
                 24 K2, a strict load;
42. scan modes -- (after the LM) K1 and K2 with grouped B / C, (batch, L,
                 G, N), at the flagship shape in bf16 with the fused gate
                 for G 2 and 4, and at the edges (G 32: 48 channels a
                 group, tail blocks; a group's B / C 17 elements apart;
                 d_state 64; mixed rank; B / C strided as slices of an
                 x_dbl), and without softplus (dt = delta + bias) at the
                 flagship: each against its plain version under the
                 kernel phases' gates, one K1 and one K2 launch a call, K2
                 bit-equal twice; their times beside the plain versions'
                 and the bounds.  The torch backends: ``chunked`` at the
                 flagship shape, real and complex64, ``auto`` at d_state
                 512 (to ``chunked``) and static B / C (``auto``: to
                 ``assoc``), forward and every gradient against the plain
                 versions, no K1 / K2 launch, timed beside K1 / K2; then
                 ``cli.train`` on the flagship with
                 ``model.params.scan_backend=chunked`` and through K1 / K2,
                 4 steps each from one checkpoint with open adaLN gates
                 (through ``cli.convert``): 0 K1 / K2 against 48 / 24 a
                 step, the losses against each other, steps/s.
43. chained training -- (after the train phase) ``cli.train`` on the
                 flagship, batch 16, ``chain_steps=4``, 12 steps: one eager
                 chain, the capture of one CUDA graph of 4 whole steps, two
                 replays, the whole run under the profiler.  Its K1 / K2
                 launches are its CUPTI kernel records, 48 / 24 a step
                 (the eager chain and both replays; the capture launches
                 nothing and the wrappers count nothing under it); the
                 wrapper counts see the eager chain, 48 / 24 a step; one
                 more replay profiled alone holds 48 / 24 a step and calls
                 no wrapper; the plain versions never.  The same run's 12
                 plain steps built with the capturable AdamW: losses at
                 steps 4, 8 and 12 and every parameter and EMA tensor
                 bit-equal, and the step generator's state equal; against
                 ``cli.train`` with ``chain_steps=1`` (the default AdamW):
                 the gaps printed; the chained checkpoint strict into the
                 sampler's model and resumed for a step under
                 ``chain_steps=1``; steps/s chained (two replays timed
                 without the profiler) and plain, capture seconds, peak
                 memory and the graph's pool, device busy of a replay
                 against an eager step.
44. conv kernels -- (after the video kernels) the causal conv1d kernel pair
                 (``csrc/causal_conv1d.cu``) at the shapes the main paths
                 give it, the flagship (16, 1024, 1536) and the video's
                 spatial (320, 256, 1536) and temporal (5120, 16, 1536)
                 layers: bf16, W 4, bias and SiLU, x read in place out of a
                 (batch, L, 2 d) xz.  The forward equal to the plain version
                 on the card (``torch.equal``); the backward twice bit-equal,
                 within TOL_CONV_BWD of its plain version
                 (``causal_conv1d_bwd_ref``) on every gradient, and no
                 farther from float64 autograd of the plain forward than the
                 plain bf16 autograd chain; one launch a call each.  Times
                 beside the bound (bytes), the plain version and the
                 library's (cuDNN's depthwise ``F.conv1d`` and SiLU); the
                 instances' registers and resident blocks an SM.

Every count is set to 0 just before its path runs and read just after; the
plain versions must run 0 times on every path.  The conv kernels' launches
are read beside K1's and K2's: a Mamba-1 mixer runs one conv before each
scan, so on the flagship, video, text and LM paths they equal K1's and
K2's; the ssm2 paths run the conv (Mamba-2's xBC) with neither.
The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``; the nvidia-smi line comes just before.
"""

import gc
import io
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def peak(key):
    """An H100 peak from the port's one table of them
    (``zigma_tpu_torch.utils.profiling.H100_PEAK``: ``hbm_bytes_per_sec``,
    ``fp32_flops``, ``bf16_flops``)."""
    from zigma_tpu_torch.utils.profiling import H100_PEAK
    return H100_PEAK[key]


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
# The conv backward kernel against its plain version on the card, each
# gradient's norm of the difference over the plain one's norm: both compute
# in fp32 from the same bf16-rounded pre-activation and differ only in
# summation order (dx rounded to bf16 may land one ulp apart); a misplaced
# tap or a lost partial reads of order 1
TOL_CONV_BWD = 1e-3
CONV_SHAPES = ((16, 1024, 1536), (320, 256, 1536), (5120, 16, 1536))
CONV_W = 4
BWD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dbias", "dx0", "dz", "dD")
# loss and per-parameter gradients of the fp32 depth-2 model, kernels vs
# plain versions: the same summation-order differences through two blocks
TOL_GRAD = 1e-4
# sequence parallelism on the one card: the flagship scan over this many
# virtual shards of L (256 tokens each)
SEQ_SHARDS = 4
# the distributed trainer at world size 1 against the single-process one,
# on each loss, of max |loss|: the same kernels on the same inputs in the
# same order, so the runs are expected bit-equal; the bound allows the
# reduction order of a collective to differ
TOL_DIST_LOSS = 1e-5

FLAGSHIP = dict(batch=16, L=1024, D=1536, N=16)
# selective remat: K1 launches a flagship step under each policy (the
# recompute skips K1 where the policy keeps the scan's outputs); K2 24
REMAT_K1 = {"scan_out": 24, "dots": 48, "scan_out+dots": 24}
# scan_out against full remat, fp32 depth 2, of max |full remat|: the kept
# values are the ones the recompute would make, so bit-equal is expected
TOL_REMAT_GRAD = 1e-5
# the pipeline at world size 1: the flagship batch in 4 microbatches of 4,
# the scan shape a microbatch gives K1 and K2
PIPE_MICROBATCHES, PIPE_STEPS = 4, 4
MICROBATCH = dict(batch=4, L=1024, D=1536, N=16)
# its losses against one process's, relative: GEMMs at batch 4 against 16
# and gradients summed over microbatches round otherwise (bf16), so the runs
# drift apart by rounding, not by 1%
TOL_PIPE_LOSS = 1e-2
# the depth-2 fp32 stage's output against the plain model, of max |ref|
TOL_PIPE_OUT = 1e-5
STEPS, DEPTH, N_BATCHES, BATCH = 50, 24, 2, 16
TRAIN_STEPS = 8
# chained training: chain_steps 4 over 12 flagship steps, one eager chain
# (the capture's warm-up) and two replays of the captured graph
CHAIN, CHAIN_TRAIN_STEPS = 4, 12
DOPRI5_BATCH = LIK_BATCH = 4
# the scan modes phase: grouped B / C (G groups of D / G channels) in K1 /
# K2 at the flagship shape, and the torch backends' shapes (d_state 512 is
# past the kernels' 256, so auto sends it to the chunked backend)
MODES_GROUPS = (2, 4)
WIDE_STATE = dict(batch=2, L=1024, D=1536, N=512)
STATIC_BC = dict(batch=4, L=1024, D=1536, N=16)
CHUNKED_STEPS = 4
# the chunked and associative backends against the plain sequential
# versions, fp32, per output as max |err| / max |ref|: a log-step scan in
# chunks against a step-by-step one differ in rounding order only
TOL_TORCH_SCAN = 1e-4
# the flagship trained through the chunked backend against the same
# checkpoint and seed through K1 / K2, relative to max |loss|: the bf16
# model rounds the two scans' outputs apart, not by 1%
TOL_CHUNKED_LOSS = 1e-2
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
# the data path: random full-width SD-VAE and CLIP weights from these
# seeds; 64 seeded images of mixed sizes in 4 shards of each layout
# (churches, coco with 5 captions a sample as COCO has, ucf101: 16 clips
# with 20 stored frames for the 16-frame window, as many as the video eval
# scores); the configs' shard specs are cut to these 4 shards
VAE_SEED = CLIP_SEED = 0
N_IMAGES, SHARD_SIZE, N_SHARDS = 64, 16, 4
DATA_SHARDS = "train-{000000..000003}.tar"
IMAGE_SIZES = [(256, 256), (300, 400), (512, 384), (200, 264), (384, 288)]
N_CAPTIONS = 5
N_VIDEOS, UCF_SRC_FRAMES, UCF_FRAMES = 16, 24, 20
# the metrics: the four feature nets at full width with random weights from
# this seed; the evals cut from the configs' 5000 samples by dopri5 at
# batch 4 to EVAL_N images in batches of EVAL_BS by 50-step Euler, and
# VIDEO_EVAL_N videos in batches of VIDEO_BATCH; the sample CLI scores
# SAMPLE_METRIC_BATCHES batches of BATCH
NET_SEED = 0
EVAL_N, EVAL_BS, VIDEO_EVAL_N, SAMPLE_METRIC_BATCHES = 64, 16, 16, 2
IMAGE_MENU = ("fid", "is", "kid", "prdc", "sfid", "fdd")
# each metric net on the card against the same net on the CPU, per output,
# as max |card - CPU| / max |CPU|: fp32 both sides with TF32 off, so only
# summation order differs.  The first run on the H100 (H100 80GB HBM3,
# 700 W) read 9.3e-8 (LPIPS) to 5.3e-6 (Inception's sFID tap; DINOv2
# 1.6e-6, I3D 1.7e-6); TF32 (10-bit mantissa) would err near 2^-11 =
# 4.9e-4.  The limit sits about 6x above the worst reading and 16x below
# TF32
TOL_NETS = 3e-5
# the SD-VAE and the CLIP tower on the card against the same on the CPU,
# each output as max |card - CPU| / max |CPU|: fp32 both sides (TF32 off),
# so only summation order differs.  The first run on the H100 (H100 80GB
# HBM3, 700 W) read 2.0e-6 to 3.9e-6 on the VAE's mean, logvar, sample and
# decode and 1.9e-6 on the tower; a convolution or matmul lowered to TF32
# (10-bit mantissa) would err near 2^-11 = 4.9e-4 of its values.  The
# limits sit about 8x above the readings and 16x below TF32
TOL_VAE = 3e-5
TOL_CLIP = 2e-5
# the serving phase: the flagship served over HTTP, class-conditional (1000
# classes, as ImageNet) with the CFG label drop, 50-step Euler at
# serve_batch 8, decoding through the random full-width SD-VAE
SERVE_ARGS = ["model=zigzag8_b1_pe2", "data=synthetic", "data.num_classes=1000",
              "model.params.class_dropout_prob=0.1", "sample_mode=ODE",
              "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}",
              "vae_kind=sd-vae"]
SERVE_BATCH = 8
# the LM of benchmarks/benchmark_generation.py, state-spaces/mamba-130m's
# shape: d_model 768, 24 layers, vocab 50277 padded to a multiple of 8,
# RMSNorm, residual in fp32; greedy generate of 128 tokens after a prompt of
# 128 at batch 8
LM_SHAPE = dict(d_model=768, n_layer=24, vocab_size=50277, rms_norm=True,
                residual_in_fp32=True, pad_vocab_size_multiple=8)
LM_BATCH, LM_PROMPT, LM_GEN = 8, 128, 128
# the fp32 LM, each as max |err| / max |ref|: prefill through K1 against the
# plain scan, prefill + steps against steps, and the scores on the card
# against the CPU; fp32 with TF32 off, so only summation order differs.  The
# first run on the H100 (H100 80GB HBM3, 700 W) read at most 1.9e-6 (the
# conv windows) and 1.0e-7 on the scores; bf16 rounding would read near
# 2^-8.  The bf16 LMs are held to TOL_FORWARD, as the flagship forward: the
# same run read 3.2e-3 to 2.0e-2 (a Mamba-2 state)
TOL_LM_FP32 = 2e-5


# the card machine counts every byte written to its disk, deletions
# included, against a cap: the phases that write checkpoints of the
# flagship by the dozen (distributed training, remat, the pipeline,
# convert) write them to memory, each group in a directory of its own that
# goes when the group ends
RAM_DIR = "/dev/shm"


def ram_dir():
    """A temporary directory in RAM_DIR when the machine has it, else in
    the default temporary directory."""
    in_ram = os.path.isdir(RAM_DIR) and os.access(RAM_DIR, os.W_OK)
    return tempfile.TemporaryDirectory(dir=RAM_DIR if in_ram else None)


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


def scan_inputs(gen, batch, L, D, N, dtype, big_dt=False, long_memory=False,
                groups=1, softplus=True, mixed=False):
    """Scan inputs from ``gen``: dt = softplus(0.5 randn + 0.1 randn) and
    A = -exp(0.5 randn), decays near 0.5 and a short memory; or, with
    ``long_memory``, the flagship's own init (``models/mamba.py``): bias the
    inverse softplus of a dt log-uniform in [0.001, 0.1], delta 0.1 randn
    around it and A = -(1 ... N), so decays sit near 0.999 and a state
    remembers about a thousand steps.  With ``groups`` > 1, B and C are
    grouped (batch, L, G, N) (with ``mixed`` B stays (batch, L, N), shared
    by every group); without ``softplus`` delta is softplus(delta + bias) -
    bias, so that dt = delta + bias keeps the same values."""
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
    d = dict(u=u.to(dtype), delta=delta.to(dtype), A=A, B=B.to(dtype),
             C=C.to(dtype), bias=bias, Dskip=r(D),
             z=r(batch, L, D).to(dtype), x0=r(batch, N, D))
    if groups > 1:
        d["C"] = r(batch, L, groups, N).to(dtype)
        if not mixed:
            d["B"] = r(batch, L, groups, N).to(dtype)
    if not softplus:
        d["delta"] = (torch.nn.functional.softplus(delta + bias)
                      - bias).to(dtype)
    return d


def rel_err(a, b):
    err = (a.float() - b.float()).abs().max().item()
    return err, err / max(b.float().abs().max().item(), 1e-30)


def excess(got, ref, ulp):
    """max over elements of |got - ref| - ulp * |ref|, over max |ref|"""
    g, r = got.float(), ref.float()
    worst = ((g - r).abs() - ulp * r.abs()).max().item()
    return worst / max(r.abs().max().item(), 1e-30)


def check_kernel_case(name, gen, batch, L, D, N, dtype, fused, with_x0,
                      big_dt=False, long_memory=False, strided=False,
                      groups=1, softplus=True, mixed=False):
    """K1 against selective_scan_ref on all three outputs (one launch),
    inputs from ``scan_inputs``; ``strided``: z, B and C as the model
    passes them."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import selective_scan_fwd_cuda
    from zigma_tpu_torch.ops.selective_scan import selective_scan_ref
    d = scan_inputs(gen, batch, L, D, N, dtype, big_dt, long_memory, groups,
                    softplus, mixed)
    if strided:
        d = strided_like_the_model(d)
    Dk, zk = (d["Dskip"], d["z"]) if fused else (None, None)
    x0 = d["x0"] if with_x0 else None
    with torch.inference_mode():
        k1 = read_counts()[0]
        got = selective_scan_fwd_cuda(d["u"], d["delta"], d["A"], d["B"],
                                      d["C"], d["bias"], Dk, zk, x0,
                                      delta_softplus=softplus)
        torch.cuda.synchronize()
        if read_counts()[0] != k1 + 1:
            fail(f"{name}: K1 counted {read_counts()[0] - k1} launches a call")
        ref = selective_scan_ref(d["u"], d["delta"], d["A"], d["B"], d["C"],
                                 Dk, zk, d["bias"], softplus, x0)
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
    bytes_ms = n_bytes / peak("hbm_bytes_per_sec") * 1e3
    fma_ms = flops / peak("fp32_flops") * 1e3
    sfu_ms = transc / (SFU_OPS_PER_CLK_PER_SM * n_sms * clk_mhz * 1e6) * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"),
                             (max(fma_ms, sfu_ms), "operations"))
    how = (f"{n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} "
           f"GFLOP fp32 -> {fma_ms:.4f} ms; {transc / 1e6:.0f} M "
           f"transcendentals on {n_sms} SMs x {SFU_OPS_PER_CLK_PER_SM}/clk at "
           f"{clk_mhz:.0f} MHz -> {sfu_ms:.4f} ms")
    return bound_ms, bound_by, how


def k1_work(batch, L, D, N, item, carries=False, fused=True, seeded=False,
            groups=1, softplus=True):
    """(bytes, fp32 flops, transcendentals) of K1's function, fused gate
    unless ``fused`` is false: each input read once (u, delta, z; B, C, of
    ``groups`` groups; A, bias, D; the seed x0 with ``seeded``), each output
    written once (y; x_last in fp32; the chunk starts with ``carries``).
    Operations: the JAX kernel's cost estimate of fp32 FMA work, and on the
    special-function units one exp per state plus (with ``softplus``)
    softplus's exp and log1p and (fused) the gate's exp per channel."""
    n_bytes = ((4 if fused else 3) * batch * L * D * item  # u, delta, z; y
               + 2 * batch * L * groups * N * item  # B, C
               + D * N * 4 + (2 if fused else 1) * D * 4  # A, bias, D
               + (2 if seeded else 1) * batch * N * D * 4)  # x0, x_last
    if carries:
        n_bytes += batch * -(-L // 128) * N * D * 4
    per_channel = (2 if softplus else 0) + (1 if fused else 0)
    return (n_bytes, 9 * batch * L * D * N,
            batch * L * D * N + per_channel * batch * L * D)


def k2_work(batch, L, D, N, item, fused=True, g_last=False, groups=1,
            softplus=True):
    """(bytes, fp32 flops, transcendentals) of K2's function as the training
    path calls it: each input read once (u, delta, z, gy; B, C, of
    ``groups`` groups; the chunk starts; A, bias, D; with ``g_last`` the
    final state's cotangent), each output written once (du, ddelta, dz; dB,
    dC; dA, dbias, dD; dx0); without the fused gate no z, dz, D or dD.
    Operations: the JAX kernel's cost estimate (25 B L D N), and one exp
    per state and step plus (with ``softplus``) softplus's exp and log1p
    and its sigmoid and (fused) the gate's sigmoid per channel and step."""
    n_bytes = ((7 if fused else 5) * batch * L * D * item  # in and out
               + 4 * batch * L * groups * N * item  # B, C in; dB, dC out
               + batch * -(-L // 128) * N * D * 4  # chunk-start states
               + 2 * (D * N * 4 + (2 if fused else 1) * D * 4)  # A, bias, D
               + (2 if g_last else 1) * batch * N * D * 4)  # g_last, dx0
    per_channel = (3 if softplus else 0) + (1 if fused else 0)
    return (n_bytes, 25 * batch * L * D * N,
            batch * L * D * N + per_channel * batch * L * D)


def truth_f64(d, device="cuda", seeded=False, fused=True):
    """The scan of ``scan_inputs`` in float64 on ``device``, step by step:
    (y, chunk-start states, final state).  ``seeded``: from the state
    ``d["x0"]`` (else zeros); ``fused``: y gated, ``(y + u D) silu(z)``."""
    import torch
    import torch.nn.functional as F
    f64 = {k: v.to(device, torch.float64) for k, v in d.items()}
    u, B, C = f64["u"], f64["B"], f64["C"]
    dt = F.softplus(f64["delta"] + f64["bias"])  # threshold 20
    dtu = dt * u
    At = f64["A"].t()  # (N, D)
    batch, L, D = u.shape
    x = (f64["x0"] if seeded else
         torch.zeros((batch, At.shape[0], D), dtype=torch.float64,
                     device=device))
    carries, ys = [], []
    for t in range(L):
        if t % 128 == 0:
            carries.append(x)
        x = (torch.exp(dt[:, t, None, :] * At) * x
             + dtu[:, t, None, :] * B[:, t, :, None])
        ys.append(torch.einsum("bnd,bn->bd", x, C[:, t]))
    y = torch.stack(ys, dim=1)
    if fused:
        y = (y + u * f64["Dskip"]) * F.silu(f64["z"])
    return y, torch.stack(carries, dim=1), x


def truth_bwd_f64(d, device="cuda", seeded=False, fused=True):
    """The adjoint of ``truth_f64``'s scan in float64 on ``device``, with
    ``d["gy"]`` the cotangent of y (gated when ``fused``) and, where ``d``
    has one, ``d["g_last"]`` that of the final state.  Its own loop: each
    128-step chunk's states are recomputed from the float64 chunk starts,
    then walked in reverse.  Returns (du, ddelta, dA, dB, dC, dbias, dx0)
    and, fused, (dz, dD): the outputs of the kernel, in float64; dbias sums
    the unrounded ddelta."""
    import torch
    f64 = {k: v.to(device, torch.float64) for k, v in d.items()}
    u, B, C, g_out = f64["u"], f64["B"], f64["C"], f64["gy"]
    pre = f64["delta"] + f64["bias"]
    dt = torch.where(pre <= 20, torch.log1p(torch.exp(pre)), pre)
    sig = torch.sigmoid(pre)
    dtu = dt * u
    At = f64["A"].t()  # (N, D)
    Dsk = f64["Dskip"] if fused else torch.zeros_like(f64["Dskip"])
    if fused:
        z = f64["z"]
        sig_z = torch.sigmoid(z)
        gyr = g_out * z * sig_z  # cotangent of the raw scan output
    else:
        gyr = g_out
    _, starts, _ = truth_f64(d, device, seeded, fused)
    batch, L, D = u.shape
    N = At.shape[0]
    du, dd, y = (torch.zeros_like(u) for _ in range(3))
    dB = torch.zeros((batch, L, N), dtype=torch.float64, device=device)
    dC = torch.zeros_like(dB)
    dA = torch.zeros((N, D), dtype=torch.float64, device=device)
    g_next = (f64["g_last"].clone() if "g_last" in f64 else
              torch.zeros((batch, N, D), dtype=torch.float64, device=device))
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
    grads = (du, dd, dA.t(), dB, dC, dd.sum((0, 1)), g_next)
    if not fused:
        return grads
    dz = g_out * (y + u * Dsk) * (sig_z * (1 + z * (1 - sig_z)))
    return (*grads, dz, (gyr * u).sum((0, 1)))


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
        # a truth of zeros (the chunk starts of a scan of one chunk) is
        # held absolutely
        scale = t.abs().max().item() or 1.0
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
        # does (scan_with_grad keeps them for K2)
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
    slices of an x_dbl-like (batch, L, R + 2 G N) one at offset R (G N the
    width of B and of C, grouped or not): with R odd the rows of all three
    (and a group's slice) are only 2-byte aligned in bf16 (4 in fp32), so
    the narrow copies of the kernels' staging run."""
    import torch
    batch, L, D = d["z"].shape
    B, C = d["B"].flatten(2), d["C"].flatten(2)
    W = B.shape[2]
    x_dbl = torch.zeros((batch, L, R + 2 * W), dtype=B.dtype, device=B.device)
    x_dbl[..., R:R + W], x_dbl[..., R + W:] = B, C
    xz = torch.zeros((batch, L, 2 * D + 1), dtype=d["z"].dtype,
                     device=d["z"].device)
    xz[..., D + 1:] = d["z"]
    return dict(d, B=x_dbl[..., R:R + W].view(d["B"].shape),
                C=x_dbl[..., R + W:].view(d["C"].shape), z=xz[..., D + 1:])


def check_bwd_case(name, gen, batch, L, D, N, dtype, fused, big_dt=False,
                   long_memory=False, strided=False, tol_fp32=TOL_BWD,
                   groups=1, softplus=True, mixed=False):
    """K2 against selective_scan_bwd_ref on every output, from the chunk
    starts K1 wrote, with a final-state cotangent, within ``tol_fp32`` of
    max |ref| (after one bf16 ulp on bf16 outputs); one launch a call, two
    launches bit-equal; inputs from ``scan_inputs``.  Prints each output's
    max abs error and the worst excess."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_fwd_cuda)
    from zigma_tpu_torch.ops.selective_scan import selective_scan_bwd_ref
    d = scan_inputs(gen, batch, L, D, N, dtype, big_dt, long_memory, groups,
                    softplus, mixed)
    if strided:
        d = strided_like_the_model(d)
    d["gy"] = torch.randn(batch, L, D, generator=gen, device="cuda").to(dtype)
    d["g_last"] = torch.randn(batch, N, D, generator=gen, device="cuda")
    Dk, zk = (d["Dskip"], d["z"]) if fused else (None, None)
    with torch.no_grad():
        _, carries, _ = selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"], Dk, zk,
            delta_softplus=softplus)
        args = (d["u"], d["delta"], d["bias"], d["A"], d["B"], d["C"],
                carries, d["gy"], d["g_last"], Dk, zk, softplus)
        k2 = read_counts()[1]
        got = selective_scan_bwd_cuda(*args)
        torch.cuda.synchronize()
        if read_counts()[1] != k2 + 1:
            fail(f"{name}: K2 counted {read_counts()[1] - k2} launches a call")
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
    reset_counts()
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
    conv = check_conv("sample CLI", (want, 0))
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
          f"{rate / 1e12:.1f} TFLOP/s, {100 * rate / peak('bf16_flops'):.2f}% "
          f"of the bf16 peak", flush=True)
    if not rel <= TOL_FORWARD:
        fail("flagship forward: kernel and plain scan disagree")
    return model, x, t, dict(images_per_s=img_s, forward_ms=fwd_ms,
                             launches=launches, conv=conv, ckpt=ckpt)


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
        reset_counts()
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
        conv = check_conv("train CLI", (48 * TRAIN_STEPS, 24 * TRAIN_STEPS))
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
          f"(expected {24 * TRAIN_STEPS}); conv forward / backward {conv}; "
          f"plain scan / plain backward calls {plain}; checkpoint {ckpt_name}: EMA loaded with strict=True into "
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
                       peak_gb=peak_gb, held_gb=held_gb, k1=k1, k2=k2,
                       conv=conv, losses=losses)


def device_rows(prof):
    """The device-side kernels of a profile (``key_averages`` rows; a CUDA
    graph's replayed kernels are CUPTI records like any others): the CPU
    ops that launched them, and annotated ranges such as the optimizer's
    step, carry the same time again (the filter of the profiler's own
    table)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def scan_kernel_records(rows):
    """(K1, K2) kernel records among ``device_rows``."""
    return (sum(e.count for e in rows if "selective_scan_fwd" in e.key),
            sum(e.count for e in rows if "selective_scan_bwd" in e.key))


def raw_scan_kernel_records(prof):
    """(K1, K2) kernel records of a finished profile, read from its raw
    CUPTI records: a whole training run holds some 1e5 of them, which
    ``key_averages`` would first parse into Python events for tens of
    seconds."""
    from torch.autograd import DeviceType
    k1 = k2 = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            name = e.name()
            k1 += "selective_scan_fwd" in name
            k2 += "selective_scan_bwd" in name
    return k1, k2


def plain_reference_run(args, n_steps):
    """``n_steps`` plain steps of the ``cli.train`` run that ``args`` give
    (``chain_steps=1``: its model, seed, synthetic batches, transport, loss
    and step generator), built here with the AdamW of a captured run
    (``capturable=True``).  Returns (state, {step: loss} at the chain
    boundaries, the step generator)."""
    import torch
    from zigma_tpu_torch.cli import train as train_cli
    from zigma_tpu_torch.train import (LATENT_SCALE, TrainState,
                                       make_diffusion_loss_fn, train_chain)
    from zigma_tpu_torch.transport import create_transport
    cfg = train_cli.load_config(train_cli.DEFAULT_CONFIG_DIR, "default", args)
    device, seed = torch.device("cuda"), int(cfg.get("global_seed", 0))
    model = train_cli.build_model(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(seed))
    transport = create_transport(
        cfg.train.get("path_type", "Linear"),
        cfg.train.get("prediction", "velocity"),
        cfg.train.get("loss_weight"),
        cfg.train.get("train_eps"), cfg.train.get("sample_eps"))
    state = TrainState.create(model, lr=float(cfg.optim.get("lr", 1e-4)),
                              weight_decay=float(cfg.optim.get("wd", 0.0)),
                              capturable=True)
    batches = train_cli.synthetic_batches(cfg, seed)
    next(batches)  # the example batch cli.train takes first
    loss_fn = make_diffusion_loss_fn(
        model, transport,
        latent_scale=LATENT_SCALE if cfg.get("is_latent", True) else None)
    step_gen = torch.Generator(device=device).manual_seed(seed + 1)
    losses = {}
    for step in range(1, n_steps + 1):
        m = train_chain(state, loss_fn,
                        [train_cli._to_device(next(batches), device)],
                        step_gen, float(cfg.get("max_grad_norm", 2.0)),
                        float(cfg.get("ema_rate", 0.9999)))
        if step % CHAIN == 0:
            losses[step] = float(m["loss"])
    return state, losses, step_gen


def chained_train_phase(gen, tmp):
    """``cli.train`` at the flagship, batch 16, ``chain_steps`` CHAIN over
    CHAIN_TRAIN_STEPS steps (one eager chain, the capture, two replays of
    the graph) under the profiler: this run's K1 / K2 launches are its
    CUPTI kernel records (the eager chain and every replay; the capture
    launches nothing), and the wrapper counts, which see only the eager
    chain, must hold 48 / 24 a step of it.  One more replay, profiled
    alone, must hold 48 / 24 a step and call no wrapper.  Then the same
    run's plain steps (``chain_steps=1``) with the chained run's AdamW
    (``plain_reference_run``) and ``cli.train`` with ``chain_steps=1`` and
    the default one.  Losses at the chain boundaries, every parameter and
    EMA tensor and the step generator's state against the plain runs'; the
    chained checkpoint strictly into the sampler's model and resumed for
    one step under ``chain_steps=1``; steps a second (the chained run's
    from two replays timed after it, as the profiler slows the run's own),
    capture seconds, peak memory and the graph's pool, and the device-busy
    share of one replay against one eager step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli import train as train_cli

    args = ["model=zigzag8_b1_pe2", "data=synthetic",
            f"data.batch_size={BATCH}", f"log_every={CHAIN}",
            f"data.train_steps={CHAIN_TRAIN_STEPS}"]

    def snap(state):
        # the state after the last step, before anything else steps it (on
        # the host, so the next run's peak holds none of it)
        return {w: [p.detach().cpu() for p in getattr(state, w).parameters()]
                for w in ("model", "ema")}

    def run(name, *extra, profiled=False):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9  # by earlier phases
        argv = [*args, *extra, f"results_dir={os.path.join(tmp, name)}"]
        reset_counts()
        t0 = time.perf_counter()
        if profiled:  # the device's records only: kernels, copies
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = train_cli.main(argv)
                torch.cuda.synchronize()
        else:
            res = train_cli.main(argv)
            torch.cuda.synchronize()
        res.update(wall=time.perf_counter() - t0, counts=read_counts(),
                   held_gb=held,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   gen_state=res["generator"].get_state(),
                   losses={r["step"]: r["loss"] for r in res["records"]},
                   # after the first chain (the warm-up and the capture):
                   # equal intervals of CHAIN steps
                   steps_per_s=len(res["records"][1:]) / sum(
                       1 / r["steps_per_sec"] for r in res["records"][1:]),
                   snap=snap(res["state"]))
        if profiled:
            t0 = time.perf_counter()
            res["records_k"] = raw_scan_kernel_records(prof)
            res["count_s"] = time.perf_counter() - t0
        return res

    def gaps(a, b):
        return {w: max(float((p - q).abs().max()) for p, q in zip(a[w], b[w]))
                for w in ("model", "ema")}

    t_phase = time.perf_counter()
    c = run("chained", f"chain_steps={CHAIN}", profiled=True)
    chain = c["chain"]
    capture_s = chain.capture_seconds
    n_replays = CHAIN_TRAIN_STEPS // CHAIN - 1
    k1, k2 = c["records_k"]
    want_counts = (48 * CHAIN, 24 * CHAIN, 0, 0)
    want_k = (48 * CHAIN_TRAIN_STEPS, 24 * CHAIN_TRAIN_STEPS)
    print(f"chained train CLI (chain_steps {CHAIN}) under the profiler: "
          f"{CHAIN_TRAIN_STEPS} steps in {c['wall']:.2f} s (model build "
          f"included; its kernel records read in {c['count_s']:.2f} s), "
          f"{c['steps_per_s']:.4f} steps/s over the replays, "
          f"capture {capture_s:.3f} s; losses {c['losses']}; K1 / K2 kernel "
          f"records of the whole run {k1} / {k2} (expected {want_k}: the "
          f"eager chain and {n_replays} replays); K1, K2, plain scan, plain "
          f"backward wrapper counts {c['counts']} (expected {want_counts}: "
          f"the eager chain; the capture launches nothing)", flush=True)
    if (k1, k2) != want_k or c["counts"] != want_counts:
        fail(f"chained training: K1 / K2 kernel records {(k1, k2)}, expected "
             f"{want_k}; wrapper counts {c['counts']}, expected "
             f"{want_counts}")
    boundaries = list(range(CHAIN, CHAIN_TRAIN_STEPS + 1, CHAIN))
    if sorted(c["losses"]) != boundaries or not all(
            map(math.isfinite, c["losses"].values())):
        fail(f"chained training losses {c['losses']}")
    try:  # the graph's private pool: the segments the allocator gave it
        pool = tuple(chain.graph.pool())
        pool_gb = sum(seg["total_size"]
                      for seg in torch.cuda.memory._snapshot()["segments"]
                      if tuple(seg["segment_pool_id"]) == pool) / 1e9
    except (KeyError, TypeError) as e:
        pool_gb = None
        print(f"graph pool: not measured ({e!r})")
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 args[:1])
    fresh = sample_cli.build_model(cfg, device="cuda")
    fresh.load_state_dict(sample_cli.load_state_dict(c["checkpoint"]),
                          strict=True)
    del fresh

    # the graph's steps a second without the profiler: two chains as
    # cli.train runs them (host batches copied in, one replay, the loss
    # read), after the run's last step
    rng = np.random.default_rng(0)
    host = [{"x": rng.standard_normal((BATCH, 4, 32, 32)).astype(np.float32)}
            for _ in range(CHAIN)]
    t0 = time.perf_counter()
    for _ in range(2):
        float(chain(host)["loss"])
    chained_sps = 2 * CHAIN / (time.perf_counter() - t0)
    # one replay (after one warm-up replay) under the profiler: its kernels
    reset_counts()
    rows, wall_us = profile_rows(lambda: chain(host))
    replay_busy, replay_wall, replay_launches = print_profile(
        f"one replay of the chain ({CHAIN} flagship steps, batch {BATCH})",
        rows, wall_us)
    per_replay = scan_kernel_records(rows)
    if read_counts() != (0, 0, 0, 0) or per_replay != (48 * CHAIN, 24 * CHAIN):
        fail(f"a replay ran K1 / K2 {per_replay} times (expected "
             f"{(48 * CHAIN, 24 * CHAIN)}) and called the wrappers "
             f"{read_counts()} times (expected none)")
    eager_busy, eager_wall, eager_launches = profile_phase(
        f"one eager flagship step of the chained state (batch {BATCH}, "
        f"capturable AdamW)", train_step_fn(c["state"], gen,
                                            (BATCH, 4, 32, 32)))
    print(f"chained K1 / K2 launches in the {CHAIN_TRAIN_STEPS}-step run: "
          f"{k1} / {k2} (its kernel records; {c['counts'][0]} / "
          f"{c['counts'][1]} wrapper launches in the eager chain, so "
          f"{(k1 - c['counts'][0]) // (n_replays * CHAIN)} / "
          f"{(k2 - c['counts'][1]) // (n_replays * CHAIN)} a step in the "
          f"graph; {per_replay[0]} / {per_replay[1]} in one more replay "
          f"profiled alone, 0 plain calls); {chained_sps:.4f} steps/s over "
          f"2 chains without the profiler; device busy "
          f"{100 * replay_busy / replay_wall:.1f}% of a replay "
          f"({replay_busy / CHAIN:.3f} ms a step, {replay_launches} kernels) "
          f"against {100 * eager_busy / eager_wall:.1f}% of one eager step "
          f"({eager_busy:.3f} ms, {eager_launches} kernels)", flush=True)
    del chain, c["chain"], c["state"]
    gc.collect()  # the graph and its pool go with the last reference
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ref, ref_losses, ref_gen = plain_reference_run(args, CHAIN_TRAIN_STEPS)
    ref_s = time.perf_counter() - t0
    p1 = dict(losses=ref_losses, snap=snap(ref),
              peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if read_counts() != (48 * CHAIN_TRAIN_STEPS, 24 * CHAIN_TRAIN_STEPS, 0,
                         0):
        fail(f"the plain reference steps ran K1 / K2 / plain "
             f"{read_counts()}")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    p0 = run("plain", "chain_steps=1")
    g1, g0 = gaps(c["snap"], p1["snap"]), gaps(c["snap"], p0["snap"])
    g10 = gaps(p1["snap"], p0["snap"])
    same_gen = (torch.equal(c["gen_state"], ref_gen.get_state())
                and torch.equal(c["gen_state"], p0["gen_state"]))
    print(f"chained against its plain steps with the capturable AdamW "
          f"({ref_s:.2f} s): "
          f"losses {p1['losses']} (bit-equal {c['losses'] == p1['losses']}), "
          f"largest param / EMA gap {g1['model']:.3e} / {g1['ema']:.3e}; "
          f"against cli.train chain_steps=1 (the default AdamW): losses "
          f"{p0['losses']} (bit-equal {c['losses'] == p0['losses']}), gaps "
          f"{g0['model']:.3e} / {g0['ema']:.3e} (the two AdamWs against each "
          f"other {g10['model']:.3e} / {g10['ema']:.3e}); step generator's "
          f"state equal after {CHAIN_TRAIN_STEPS} steps: {same_gen}",
          flush=True)
    if c["losses"] != p1["losses"] or g1["model"] or g1["ema"]:
        fail(f"the chained run is not bit-equal to its plain steps with the "
             f"same AdamW: losses {c['losses']} against {p1['losses']}, "
             f"gaps {g1}")
    if not same_gen:
        fail("the step generator's state after the chained run differs from "
             "the plain runs': the graph's draws did not follow it")
    del p0["state"]
    gc.collect()
    torch.cuda.empty_cache()

    r = train_cli.main([*args[:3], "chain_steps=1", "log_every=1",
                        f"data.train_steps={CHAIN_TRAIN_STEPS + 1}",
                        f"results_dir={os.path.join(tmp, 'chained')}"])
    group = r["state"].opt.param_groups[0]
    step_dev = {st["step"].device.type
                for st in r["state"].opt.state.values()}
    print(f"the chained checkpoint loaded with strict=True into the sampler's "
          f"model and resumed under chain_steps=1: steps "
          f"{[x['step'] for x in r['records']]}, loss "
          f"{[round(x['loss'], 4) for x in r['records']]}, AdamW capturable "
          f"{group['capturable']}, step counts on {step_dev}", flush=True)
    if ([x["step"] for x in r["records"]] != [CHAIN_TRAIN_STEPS + 1]
            or not math.isfinite(r["records"][0]["loss"])
            or group["capturable"] or step_dev != {"cpu"}):
        fail(f"resuming the chained checkpoint under chain_steps=1: "
             f"{r['records']}, capturable {group['capturable']}, steps on "
             f"{step_dev}")
    del r
    smi = nvidia_smi()
    print(f"chained training {chained_sps:.4f} steps/s against "
          f"{p0['steps_per_s']:.4f} plain (cli.train chain_steps=1, steps "
          f"{CHAIN + 1}-{CHAIN_TRAIN_STEPS}); peak device memory "
          f"{c['peak_gb']:.2f} GB chained (the graph's pool "
          f"{'not measured' if pool_gb is None else f'{pool_gb:.2f} GB'}) "
          f"against {p0['peak_gb']:.2f} GB plain ({p1['peak_gb']:.2f} GB "
          f"with the capturable AdamW), of which {c['held_gb']:.2f} / "
          f"{p0['held_gb']:.2f} GB held before the chained / plain run; "
          f"capture {capture_s:.3f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return dict(steps_per_s=chained_sps,
                profiled_steps_per_s=c["steps_per_s"],
                plain_steps_per_s=p0["steps_per_s"], capture_s=capture_s,
                peak_gb=c["peak_gb"], plain_peak_gb=p0["peak_gb"],
                pool_gb=pool_gb, k1=k1, k2=k2,
                busy_replay=replay_busy / replay_wall,
                busy_eager=eager_busy / eager_wall)


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


def conv_inputs(gen, batch, L, d, W=CONV_W):
    """The Mamba mixer's conv inputs at (batch, L, d): x in bf16, read in
    place out of a (batch, L, 2 d) xz; fp32 taps and bias at the init's
    scale (uniform within W^-1/2); a bf16 cotangent."""
    import torch
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = r(batch, L, 2 * d).to(torch.bfloat16)[..., :d]
    bound = W ** -0.5
    w = (2 * torch.rand(d, W, generator=gen, device="cuda") - 1) * bound
    b = (2 * torch.rand(d, generator=gen, device="cuda") - 1) * bound
    return x, w, b, r(batch, L, d).to(torch.bfloat16)


def conv_library(x, w, b):
    """The conv as one library call: cuDNN's depthwise conv1d (groups d,
    W - 1 zeros on the left, the last W - 1 outputs dropped) and SiLU in
    x's dtype, on x seen as (batch, d, L); returns the (batch, L, d)
    view."""
    import torch.nn.functional as F
    W, L = w.shape[1], x.shape[1]
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype)[:, None], b.to(x.dtype),
                 padding=W - 1, groups=x.shape[2])[..., :L]
    return F.silu(y).transpose(1, 2)


def conv_grads(fn, x, w, b, dy):
    """(dx, dw, dbias) by autograd of ``fn`` at (x, w, b), cotangent dy."""
    import torch
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    y = fn(*leaves)
    return torch.autograd.grad(y, leaves, dy.to(y.dtype))


def conv_backward_ms(fn, x, w, b, dy):
    """CUDA-event ms of autograd's backward of ``fn`` (its graph kept)."""
    import torch
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    y = fn(*leaves)
    return cuda_ms(lambda: torch.autograd.grad(y, leaves, dy,
                                               retain_graph=True),
                   reps=3, groups=3)


def norm_gap(a, b):
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def conv_kernel_phase(gen):
    """The conv kernels at CONV_SHAPES as the Mamba mixer calls them: the
    forward equal to the plain version, the backward against its plain
    version and float64 autograd, one launch a call each; times of the
    kernels, the plain versions and the library's conv beside the bound.
    Returns {shape: {"fwd": row, "bwd": row}} and the instances."""
    import torch
    from zigma_tpu_torch.ops.causal_conv1d import (causal_conv1d_bwd_ref,
                                                   causal_conv1d_ref)
    from zigma_tpu_torch.ops.conv_cuda import (causal_conv1d_bwd_cuda,
                                               causal_conv1d_fwd_cuda,
                                               causal_conv1d_launch_info)
    info = {k: causal_conv1d_launch_info(k == "bwd", torch.bfloat16)
            for k in ("fwd", "bwd")}
    print(f"conv kernel instances (W {CONV_W}, bf16): forward {info['fwd']}, "
          f"backward {info['bwd']}", flush=True)
    if any(i["spill_bytes"] or i["blocks_per_sm"] < 1 for i in info.values()):
        fail(f"conv kernel instances spill or do not fit an SM: {info}")
    rows = {}
    for shape in CONV_SHAPES:
        batch, L, d = shape
        x, w, b, dy = conv_inputs(gen, *shape)
        with torch.no_grad():
            before = conv_counts()
            y = causal_conv1d_fwd_cuda(x, w, b)
            got = causal_conv1d_bwd_cuda(x, w, b, dy)[:3]
            torch.cuda.synchronize()
            if conv_counts() != (before[0] + 1, before[1] + 1):
                fail(f"conv {shape}: launches {conv_counts()} after "
                     f"{before}, expected one of each")
            again = causal_conv1d_bwd_cuda(x, w, b, dy)[:3]
            y_ref = causal_conv1d_ref(x, w, b)
            ref = causal_conv1d_bwd_ref(x, w, b, dy)[:3]
            y64 = causal_conv1d_ref(x.double(), w.double(), b.double())
            y_lib = conv_library(x, w, b)
        if not torch.equal(y, y_ref):
            fail(f"conv {shape}: forward differs from the plain version, "
                 f"max abs {rel_err(y, y_ref)[0]:.3e}")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            fail(f"conv {shape}: two backward launches differ")
        truth = conv_grads(causal_conv1d_ref, x.double(), w.double(),
                           b.double(), dy.double())
        plain = conv_grads(causal_conv1d_ref, x, w, b, dy)
        names = ("dx", "dw", "dbias")
        to_ref = {n: norm_gap(g, r) for n, g, r in zip(names, got, ref)}
        to_truth = {n: (norm_gap(g, t), norm_gap(p, t))
                    for n, g, p, t in zip(names, got, plain, truth)}
        fwd_gaps = (norm_gap(y, y64), norm_gap(y_lib, y64))
        del truth, plain, ref, again, y64
        print(f"conv {shape}: forward equal to the plain version; its gap to "
              f"float64 {fwd_gaps[0]:.3e}, the library's {fwd_gaps[1]:.3e}; "
              f"backward gaps to its plain version "
              + ", ".join(f"{n} {v:.2e}" for n, v in to_ref.items())
              + f" (limit {TOL_CONV_BWD}); to float64 autograd, kernel / "
              f"plain bf16 chain "
              + ", ".join(f"{n} {k:.3e} / {p:.3e}"
                          for n, (k, p) in to_truth.items()), flush=True)
        for n in names:
            if not to_ref[n] <= TOL_CONV_BWD:
                fail(f"conv {shape}: {n} {to_ref[n]:.3e} from the plain "
                     f"backward, limit {TOL_CONV_BWD}")
            k, p = to_truth[n]
            if not k <= 1.01 * p + 1e-6:
                fail(f"conv {shape}: {n} {k:.3e} from float64 autograd, "
                     f"the plain bf16 chain {p:.3e}")
        elems = batch * L * d
        n_bytes = x.numel() * x.element_size()
        param_bytes = (w.numel() + b.numel()) * 4
        times = dict(  # no input needs a gradient: the forwards record none
            fwd=(cuda_ms(lambda: causal_conv1d_fwd_cuda(x, w, b), 20),
                 cuda_ms(lambda: causal_conv1d_ref(x, w, b), 3, 3),
                 cuda_ms(lambda: conv_library(x, w, b), 20)),
            bwd=(cuda_ms(lambda: causal_conv1d_bwd_cuda(x, w, b, dy), 20),
                 conv_backward_ms(causal_conv1d_ref, x, w, b, dy),
                 conv_backward_ms(conv_library, x, w, b, dy)))
        # the work: x read and y written forward (the taps' FMAs, the bias,
        # SiLU's exp and division); x and dy read and dx written backward
        # (the taps recomputed, SiLU's derivative, dx's and dw's FMAs)
        work = dict(fwd=(2 * n_bytes + param_bytes, (2 * CONV_W + 5) * elems,
                         elems),
                    bwd=(3 * n_bytes + 2 * param_bytes,
                         (6 * CONV_W + 8) * elems, elems))
        row = {}
        for k, (ms, plain_ms, lib_ms) in times.items():
            bound_ms, bound_by, how = least_time(*work[k])
            row[k] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
            print(f"conv {k} {shape}: {ms:.4f} ms ({ms / bound_ms:.2f}x the "
                  f"bound {bound_ms:.4f} ms by {bound_by}: {how}); plain "
                  f"{plain_ms:.3f} ms; library {lib_ms:.4f} ms", flush=True)
        rows["x".join(map(str, shape))] = row
        del x, w, b, dy, y, y_ref, y_lib, got
        torch.cuda.empty_cache()
    return rows, info


def reset_counts():
    from zigma_tpu_torch.ops import conv_cuda, scan_cuda
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    scan_cuda.selective_scan_fwd_cuda.launches = 0
    scan_cuda.selective_scan_bwd_cuda.launches = 0
    selective_scan_ref.calls = selective_scan_bwd_ref.calls = 0
    conv_cuda.causal_conv1d_fwd_cuda.launches = 0
    conv_cuda.causal_conv1d_bwd_cuda.launches = 0


def conv_counts():
    """(conv forward launches, conv backward launches)"""
    from zigma_tpu_torch.ops import conv_cuda
    return (conv_cuda.causal_conv1d_fwd_cuda.launches,
            conv_cuda.causal_conv1d_bwd_cuda.launches)


def check_conv(what, want):
    """The conv counts, failing unless they are ``want``."""
    got = conv_counts()
    if got != tuple(want):
        fail(f"{what}: conv forward / backward launches {got}, expected "
             f"{tuple(want)}")
    return got


def read_counts():
    """(K1 launches, K2 launches, plain scan calls, plain backward calls)"""
    from zigma_tpu_torch.ops import scan_cuda
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    return (scan_cuda.selective_scan_fwd_cuda.launches,
            scan_cuda.selective_scan_bwd_cuda.launches,
            selective_scan_ref.calls, selective_scan_bwd_ref.calls)


def run_sample_cli(what, args, conv_per_scan=True):
    """``cli.sample.main(args)`` with the counts set to 0 just before and
    read just after; fails on non-finite samples or a plain-version call,
    and (``conv_per_scan``, a Mamba-1 model) unless the conv kernels
    launched as often as K1 and K2.  The conv counts go to
    ``res["conv"]``."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    reset_counts()
    t0 = time.perf_counter()
    res = sample_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, p1, p2 = read_counts()
    res["conv"] = (check_conv(what, (k1, k2)) if conv_per_scan
                   else conv_counts())
    calls = sum(res["model_calls"])
    print(f"{what}: {wall:.2f} s; {len(res['model_calls'])} batch(es) of "
          f"{[round(v, 3) for v in res['batch_seconds']]} s; model calls "
          f"{res['model_calls']}; K1 {k1}, K2 {k2} launches; conv forward / "
          f"backward {res['conv']}; plain scan / plain backward calls "
          f"{(p1, p2)}", flush=True)
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
    return dict(images_per_s=img_s, model_calls=calls, k1=k1,
                conv=res["conv"], **st)


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
    return dict(images_per_s=img_s, k1=k1, conv=res["conv"])


def likelihood_phase(ckpt, tmp):
    """``likelihood=true`` by Euler, 10 steps, batch 4, scoring the starting
    noise (``data=synthetic`` has no validation split): each of the 9
    drift evaluations runs the model forward (remat: K1 twice a layer) and
    its vector-Jacobian product (K2 once a layer)."""
    res, calls, k1, k2 = run_sample_cli("sample CLI likelihood", [
        f"ckpt={ckpt}", "model=zigzag8_b1_pe2", "data=synthetic",
        "likelihood=true",
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
    return dict(k1=k1, k2=k2, conv=res["conv"],
                logp=[float(v) for v in logp])


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
    return vckpt, dict(videos_per_s=videos_s, k1=k1, conv=res["conv"])


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


def train_cli_phase(what, args, batch, k1_step, k2_step, tmp, unit="images",
                    k1_eval=0, steps=TRAIN_STEPS, conv_per_scan=False):
    """``cli.train`` with ``args`` at ``batch``, ``steps`` steps, the
    counts set to 0 just before and read just after: every loss finite,
    exactly ``k1_step`` / ``k2_step`` K1 / K2 launches a step (and
    ``k1_eval`` more for the run's evals) and the plain versions never; the
    checkpoint's EMA loads with strict=True into the sampler's model; with
    ``conv_per_scan`` (a Mamba-1 model through K1 / K2 and full remat) the
    conv kernels launched as often as K1 and K2.  Returns (state,
    checkpoint, numbers, with the run's ``evals``, ``suite`` and ``conv``,
    the conv forward / backward launches); ``unit`` names a sample
    (images, videos) in the printed rate."""
    import torch
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli import train as train_cli

    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    reset_counts()
    t0 = time.perf_counter()
    res = train_cli.main([*args, f"data.batch_size={batch}",
                          f"data.train_steps={steps}", "log_every=1",
                          f"results_dir={tmp}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    conv = (check_conv(f"{what} training", counts[:2]) if conv_per_scan
            else conv_counts())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default", args)
    fresh = sample_cli.build_model(cfg, device="cuda")
    fresh.load_state_dict(sample_cli.load_state_dict(res["checkpoint"]),
                          strict=True)
    del fresh
    model = res["state"].model
    losses = [r["loss"] for r in res["records"]]
    want = (k1_step * steps + k1_eval, k2_step * steps, 0, 0)
    print(f"{what} train CLI: {len(losses)} steps in {wall:.2f} s (model "
          f"build included); {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params, dtype {model.dtype}, remat {model.use_checkpoint}; losses "
          f"{[round(v, 4) for v in losses]}; K1, K2, plain scan, plain "
          f"backward {counts} (expected {want}); conv forward / backward "
          f"{conv}; EMA loaded with strict=True into the sampler's model",
          flush=True)
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"{what} training losses {losses}")
    if counts != want:
        fail(f"{what} training: K1 / K2 / plain {counts}, expected {want}")
    steady = [1.0 / r["steps_per_sec"] for r in res["records"][1:]]
    steps_s = len(steady) / sum(steady)
    print(f"{what} training, batch {batch}: {steps_s:.4f} steps/s, "
          f"{steps_s * batch:.3f} {unit}/s (steady steps 2-{steps}, "
          f"range {min(steady):.4f}-{max(steady):.4f} s; first step "
          f"{1.0 / res['records'][0]['steps_per_sec']:.3f} s); peak device "
          f"memory {peak_gb:.2f} GB, of which {held_gb:.2f} GB held by "
          f"earlier phases before the run", flush=True)
    return res["state"], res["checkpoint"], dict(
        steps_per_s=steps_s, samples_per_s=steps_s * batch, peak_gb=peak_gb,
        held_gb=held_gb, k1=counts[0], k2=counts[1], conv=conv,
        evals=res["evals"], suite=res["metric_suite"], losses=losses)


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
        conv = check_conv("text guided sampling", counts[:2])
        if not bool(torch.isfinite(out).all()):
            fail("text guided sampling: non-finite samples")
    img_s = BATCH / seconds[1]
    print(f"text guided sampling, cfg 4, 50-step Euler, batch {BATCH} "
          f"({2 * BATCH} under CFG), 77 x 768 caption features: "
          f"{img_s:.4f} images/s (second batch; first {seconds[0]:.3f} s); "
          f"K1 {counts[0]} launches a batch", flush=True)
    return dict(images_per_s=img_s, k1=counts[0] * N_BATCHES,
                conv=tuple(n * N_BATCHES for n in conv))


def ssd_truth_phase(gen):
    """The chunked SSD on the card at the ssm2 flagship's scan shape, fp32
    and bf16, with D, z and the dt bias, against a float64 run of the
    sequential form; the same for the gradients of ``sum(y * w)``.  fp32:
    at most TOL_SSD_FP32_MULT x the plain fp32 sequential form's error;
    bf16: at most TOL_SSD_BF16_ULPS bf16 unit roundoffs.  The sequence-
    parallel form over SEQ_SHARDS virtual shards (``ssd_scan_sharded``: the
    two passes and the prefix states of ``ssd_seq_parallel``) is held to
    the same gate and printed beside the chunked form.  Then each form's
    forward and forward-plus-backward times in bf16."""
    import torch
    from zigma_tpu_torch.ops.ssd import ssd_scan, ssd_scan_ref
    from zigma_tpu_torch.parallel import ssd_scan_sharded
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

    sharded = lambda **kw: ssd_scan_sharded(**kw, n_shards=SEQ_SHARDS)
    worst = {}
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ins = {k: v.to(dtype) if k in low else v for k, v in base.items()}
        y_c, g_c = run(ssd_scan, ins)
        y_s, g_s = run(sharded, ins)
        y_p, g_p = run(ssd_scan_ref, {k: v.float() for k, v in ins.items()})
        y_t, g_t = run(ssd_scan_ref, {k: v.double() for k, v in ins.items()})
        torch.cuda.synchronize()
        # the chunked form, then the sequence-parallel one over virtual
        # shards, each held to the same gate
        for form, key, y_f, g_f in (("chunked", dname, y_c, g_c),
                                    (f"over {SEQ_SHARDS} shards",
                                     f"{dname} sharded", y_s, g_s)):
            parts = []
            for what, c, p, t, u in [("y", y_f, y_p, y_t, y_c)] + [
                    (f"d{k}", g_f[k], g_p[k], g_t[k], g_c[k])
                    for k in names]:
                scale = t.abs().max().item()
                e_c = (c.double() - t).abs().max().item() / scale
                e_p = (p.double() - t).abs().max().item() / scale
                if dtype == torch.float32:
                    ratio, limit = e_c / max(e_p, FP32_EPS), TOL_SSD_FP32_MULT
                    parts.append(f"{what} {e_c:.2e}/{e_p:.2e} ({ratio:.2f}x)")
                else:
                    ratio, limit = e_c / BF16_EPS, TOL_SSD_BF16_ULPS
                    parts.append(f"{what} {e_c:.2e} ({ratio:.2f} ulps)")
                if c is not u:  # the sharded form against the chunked one
                    parts[-1] += (f" |- chunked| "
                                  f"{(c - u).abs().max().item():.1e}")
                worst[key] = max(worst.get(key, (0.0, "")), (ratio, what))
                if not ratio <= limit:
                    fail(f"SSD {form} {dname}: {what} error against the f64 "
                         f"truth {e_c:.3e} of max |truth|: {ratio:.2f} > "
                         f"{limit}")
            print(f"SSD {form} {dname} {tuple(SSD_SHAPE.values())} vs f64 "
                  f"sequential, of max |truth| (fp32: against the plain fp32 "
                  f"sequential's; bf16: in bf16 unit roundoffs): "
                  + "; ".join(parts), flush=True)
        del y_c, g_c, y_s, g_s, y_p, g_p, y_t, g_t
        torch.cuda.empty_cache()
    ins = {k: v.to(torch.bfloat16) if k in low else v for k, v in base.items()}
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: ssd_scan(**ins, dt_softplus=True), reps=5)
    grads_in = {k: v.detach().clone().requires_grad_() for k, v in ins.items()}
    wb = w.to(torch.bfloat16)
    fb_ms = cuda_ms(lambda: (ssd_scan(**grads_in, dt_softplus=True) * wb)
                    .sum().backward(), reps=3)
    with torch.no_grad():
        fwd_s = cuda_ms(lambda: sharded(**ins, dt_softplus=True), reps=5)
    fb_s = cuda_ms(lambda: (sharded(**grads_in, dt_softplus=True) * wb)
                   .sum().backward(), reps=3)
    print(f"SSD gate: fp32 at most {worst['fp32'][0]:.2f}x the plain fp32 "
          f"version's error ({worst['fp32'][1]}; limit {TOL_SSD_FP32_MULT}), "
          f"bf16 at most {worst['bf16'][0]:.2f} bf16 unit roundoffs "
          f"({worst['bf16'][1]}; limit {TOL_SSD_BF16_ULPS}); over "
          f"{SEQ_SHARDS} shards fp32 {worst['fp32 sharded'][0]:.2f}x, bf16 "
          f"{worst['bf16 sharded'][0]:.2f} ulps; chunked bf16 forward "
          f"{fwd_ms:.4f} ms, forward + backward {fb_ms:.4f} ms; over "
          f"{SEQ_SHARDS} shards {fwd_s:.4f} ms and {fb_s:.4f} ms", flush=True)
    return dict(fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms,
                fp32_ratio=worst["fp32"][0], bf16_ulps=worst["bf16"][0],
                sharded_fp32_ratio=worst["fp32 sharded"][0],
                sharded_bf16_ulps=worst["bf16 sharded"][0],
                sharded_fwd_ms=fwd_s, sharded_fwd_bwd_ms=fb_s)


def ssm2_sample_phase(gen, ckpt, tmp):
    """``cli.sample`` of the ssm2 model from ``ckpt`` (perturbed), 50-step
    Euler, 2 batches of 16: neither scan kernel nor the plain scans."""
    path = perturbed_ckpt(gen, ckpt, os.path.join(tmp, "ssm2.pt"))
    res, calls, k1, k2 = run_sample_cli("ssm2 sample CLI", [
        f"ckpt={path}", *SSM2_ARGS, "sample_mode=ODE",
        "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}",
        f"offline_sample_local_bs={BATCH}",
        f"num_fid_samples={N_BATCHES * BATCH}", f"sample_dir={tmp}"],
        conv_per_scan=False)
    img_s = BATCH / res["batch_seconds"][1]
    print(f"ssm2 50-step Euler, batch {BATCH}: {img_s:.4f} images/s (second "
          f"batch; first {res['batch_seconds'][0]:.3f} s); K1 {k1}, K2 {k2}",
          flush=True)
    if (k1, k2) != (0, 0) or calls != N_BATCHES * (STEPS - 1):
        fail(f"ssm2 sampling: K1 / K2 {(k1, k2)}, {calls} model calls")
    if res["conv"][0] % calls or not res["conv"][0] or res["conv"][1]:
        fail(f"ssm2 sampling: conv forward / backward {res['conv']} for "
             f"{calls} model calls, expected the same number a call and no "
             f"backward")
    return dict(images_per_s=img_s, conv=res["conv"])


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
        out[tag] = dict(images_per_s=img_s, k1=k1, conv=res["conv"])
    return out


# ------------------------------------------------------------ the data path --

def random_vae_state_dict(seed):
    """A diffusers-layout SD-VAE state dict with random weights, made on the
    CPU from ``seed`` as ``vae_jax.random_params`` makes them: convolutions
    He-normal, q / k / v / out 1/sqrt(c)-normal, biases 0, norms 1 and 0."""
    import torch
    from zigma_tpu_torch.data.sd_vae import AutoencoderKL
    g = torch.Generator().manual_seed(seed)
    model = AutoencoderKL()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                gain = 2.0 if p.ndim == 4 else 1.0
                p.copy_(torch.randn(p.shape, generator=g)
                        * math.sqrt(gain / fan_in))
    return model.state_dict()


def random_clip_tower(seed):
    """The CLIP ViT-L/14 text tower with random weights on the CPU, as
    ``clip_jax.random_params`` makes them."""
    import torch
    from zigma_tpu_torch.data.clip_text import CLIPTextTower
    g = torch.Generator().manual_seed(seed)
    tower = CLIPTextTower()
    with torch.no_grad():
        for name, p in tower.named_parameters():
            if "layer_norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif "embedding" in name:
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g)
                        / math.sqrt(p.shape[1]))
    return tower.eval().requires_grad_(False)


def count_flops(model, fn):
    """Multiply-add FLOPs of the Conv2d / Conv3d / Linear layers and the
    attention products that ``fn()`` runs through ``model`` (forward
    hooks)."""
    import torch
    from zigma_tpu_torch.data.clip_text import CLIPAttention
    from zigma_tpu_torch.data.sd_vae import Attention
    from zigma_tpu_torch.metrics.dinov2 import Attention as ViTAttention
    total = [0]

    def hook(m, inputs, out):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
            k = m.in_channels // m.groups * math.prod(m.kernel_size)
            total[0] += 2 * out.numel() * k
        elif isinstance(m, torch.nn.Linear):
            total[0] += 2 * out.numel() * m.in_features
        elif isinstance(m, Attention):  # QK^T and PV over every position
            B, C, H, W = out.shape
            total[0] += 2 * 2 * B * (H * W) ** 2 * C
        elif isinstance(m, ViTAttention):
            B, L, D = out.shape
            total[0] += 2 * 2 * B * L * L * D
        elif isinstance(m, CLIPAttention):  # causal: half the products
            B, L, D = out.shape
            total[0] += 2 * B * L * L * D
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d,
                                 torch.nn.Linear, Attention, ViTAttention,
                                 CLIPAttention))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def vae_clip_phase(tmp):
    """The SD-VAE and the CLIP text tower at full width with random weights:
    the VAE from a diffusers-layout file through ``VAECodec`` (as the CLIs
    load it), encode (mean, logvar, a posterior sample) and decode of 2
    256^2 images on the card against the CPU with the same weights, inputs
    and noise; the tower on 16 x 77 token ids the same way; their times on
    the card (VAE at batch 16, and a 1024^2 decode at batch 1) beside the
    fp32 bound.  Sets ``ZIGMA_VAE_WEIGHTS`` for the phases after it."""
    import torch
    from zigma_tpu_torch.data import VAECodec
    from zigma_tpu_torch.data.sd_vae import AutoencoderKL

    wdir = os.path.join(tmp, "sd-vae")
    os.makedirs(wdir)
    weights = os.path.join(wdir, "diffusion_pytorch_model.bin")
    sd = random_vae_state_dict(VAE_SEED)
    torch.save(sd, weights)
    os.environ["ZIGMA_VAE_WEIGHTS"] = weights
    codec = VAECodec(device="cuda")
    vae = codec.vae
    cpu_vae = AutoencoderKL.from_state_dict(sd).eval()
    g = torch.Generator().manual_seed(11)
    x = torch.rand(2, 3, 256, 256, generator=g) * 2 - 1
    noise = torch.randn(2, 4, 32, 32, generator=g)
    out = {}
    for dev, net in (("cuda", vae), ("cpu", cpu_vae)):
        t0 = time.perf_counter()
        with torch.inference_mode():
            mean, logvar = net.encode(x.to(dev))
            sample = net.sample(mean, logvar, noise.to(dev))
            dec = net.decode(mean)
        out[dev] = {k: v.float().cpu() for k, v in (
            ("mean", mean), ("logvar", logvar), ("sample", sample),
            ("decode", dec))}
        if dev == "cpu":
            cpu_s = time.perf_counter() - t0
    vae_err = {k: rel_err(out["cuda"][k], out["cpu"][k])[1]
               for k in out["cpu"]}
    print(f"SD-VAE (scale 1, {sum(v.numel() for v in sd.values()) / 1e6:.1f} "
          f"M params, fp32, TF32 off) from {os.path.basename(weights)}: "
          f"2 x 256^2 encode + decode, card vs CPU ({cpu_s:.1f} s on the "
          f"CPU), max |card - CPU| / max |CPU|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in vae_err.items())
          + f"; limit {TOL_VAE}", flush=True)
    if not all(math.isfinite(v) and v <= TOL_VAE for v in vae_err.values()):
        fail(f"SD-VAE card vs CPU: {vae_err}, limit {TOL_VAE}")
    if tuple(out["cuda"]["decode"].shape) != (2, 3, 256, 256):
        fail(f"SD-VAE decode shape {tuple(out['cuda']['decode'].shape)}")

    gc = torch.Generator(device="cuda").manual_seed(12)
    x16 = torch.rand(BATCH, 3, 256, 256, generator=gc, device="cuda") * 2 - 1
    z16 = torch.randn(BATCH, 4, 32, 32, generator=gc, device="cuda")
    times = {}
    with torch.inference_mode():
        for what, fn in (("encode", lambda: vae.encode(x16)),
                         ("decode", lambda: vae.decode(z16))):
            flops = count_flops(vae, fn)
            ms = cuda_ms(fn, reps=3, groups=3)
            times[what] = dict(ms=ms, flops=flops,
                               bound_ms=flops / peak("fp32_flops") * 1e3)
        z1024 = torch.randn(1, 4, 128, 128, generator=gc, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn = lambda: vae.decode(z1024)  # noqa: E731
        flops = count_flops(vae, fn)
        ms = cuda_ms(fn, reps=1, groups=3)
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        times["decode 1024^2 x 1"] = dict(
            ms=ms, flops=flops, bound_ms=flops / peak("fp32_flops") * 1e3,
            peak_gb=peak_gb)
    for what, t in times.items():
        print(f"SD-VAE {what}{'' if '1024' in what else f' x {BATCH} at 256^2'}"
              f": {t['ms']:.2f} ms, {t['flops'] / 1e12:.3f} TFLOP, "
              f"{t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s, fp32 bound "
              f"{t['bound_ms']:.2f} ms ({t['bound_ms'] / t['ms'] * 100:.1f}% "
              f"of it)" + (f"; {t['peak_gb']:.2f} GB above what was held"
                           if "peak_gb" in t else ""), flush=True)

    tower_cpu = random_clip_tower(CLIP_SEED)
    tower = random_clip_tower(CLIP_SEED).cuda()
    ids = torch.randint(0, tower.cfg["vocab"], (BATCH, N_CTX), generator=g)
    with torch.inference_mode():
        ref = tower_cpu(ids)
        got = tower(ids.cuda()).cpu()
        clip_err = rel_err(got, ref)[1]
        idc = ids.cuda()
        clip_flops = count_flops(tower, lambda: tower(idc))
        clip_ms = cuda_ms(lambda: tower(idc), reps=5, groups=3)
    print(f"CLIP ViT-L/14 text tower ({sum(p.numel() for p in tower.parameters()) / 1e6:.1f}"
          f" M params, fp32) on {BATCH} x {N_CTX} token ids: output "
          f"{tuple(got.shape)}, max |card - CPU| / max |CPU| {clip_err:.3e} "
          f"(limit {TOL_CLIP}); {clip_ms:.3f} ms, {clip_flops / 1e9:.1f} "
          f"GFLOP, fp32 bound {clip_flops / peak('fp32_flops') * 1e3:.3f} ms",
          flush=True)
    if tuple(got.shape) != (BATCH, N_CTX, D_CTX):
        fail(f"CLIP output shape {tuple(got.shape)}")
    if not clip_err <= TOL_CLIP:
        fail(f"CLIP card vs CPU: {clip_err}, limit {TOL_CLIP}")
    del cpu_vae, tower_cpu
    return codec, tower, dict(
        vae_err=vae_err, clip_err=clip_err, clip_ms=clip_ms,
        clip_flops=clip_flops, **{f"vae_{k}": v for k, v in times.items()})


def write_images(root, n, seed):
    """``n`` seeded RGB PNGs of mixed sizes (smooth noise, so they compress
    like photographs), for prepare_data's resize and center crop."""
    import numpy as np
    from PIL import Image
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = IMAGE_SIZES[i % len(IMAGE_SIZES)]
        small = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
            os.path.join(root, f"img_{i:04d}.png"))


def prepare_shards_phase(tmp, codec, tower):
    """The three shard layouts the data configs read, from seeded inputs:
    churches (``cli.prepare_data --codec sd-vae --keep-jpeg``: VAE latents
    of the center-cropped 256^2 images and the JPEG), coco (those members
    plus 5 captions' CLIP features a sample, ``caption_feature.npy``, from
    the tower on seeded token ids) and ucf101 (``FeaturePrepDataset``: 20
    frames of a seeded 240 x 320 clip, transformed and VAE-encoded, as
    ``frame_feature256.npy``, with ``cls_id.cls``).  Returns the three
    shard directories and the times."""
    import random

    import numpy as np
    import torch
    from zigma_tpu_torch.cli import prepare_data as prep_cli
    from zigma_tpu_torch.data import FeaturePrepDataset, tar_samples

    imgs, dirs = os.path.join(tmp, "images"), {}
    write_images(imgs, N_IMAGES, 0)
    dirs["churches"] = os.path.join(tmp, "churches_wds")
    t0 = time.perf_counter()
    n = prep_cli.main(["--images", imgs, "--out", dirs["churches"],
                       "--image-size", "256", "--shard-size", str(SHARD_SIZE),
                       "--codec", "sd-vae", "--keep-jpeg",
                       "--batch-size", str(BATCH)])
    prep_s = time.perf_counter() - t0
    shards = sorted(os.listdir(dirs["churches"]))
    want = [f"train-{i:06d}.tar" for i in range(N_SHARDS)]
    if n != N_IMAGES or shards != want:
        fail(f"prepare_data wrote {n} samples in {shards}, expected "
             f"{N_IMAGES} in {want}")

    dirs["coco"] = os.path.join(tmp, "coco_wds")
    g = torch.Generator().manual_seed(13)
    writer = prep_cli.ShardWriter(dirs["coco"], shard_size=SHARD_SIZE)
    t0 = time.perf_counter()
    first = None
    for shard in shards:
        samples = list(tar_samples(os.path.join(dirs["churches"], shard)))
        ids = torch.randint(0, tower.cfg["vocab"],
                            (len(samples) * N_CAPTIONS, N_CTX), generator=g)
        with torch.inference_mode():
            feats = tower(ids.cuda()).float().cpu().numpy().reshape(
                len(samples), N_CAPTIONS, N_CTX, -1)
        for s, f in zip(samples, feats):
            latent = np.load(io.BytesIO(s["img_feature256.npy"]))
            if first is None:
                first = latent
            writer.write(s["__key__"], {
                "img_feature256.npy": s["img_feature256.npy"],
                "image.jpg": s["image.jpg"],
                "caption_feature.npy": prep_cli._npy_bytes(f)})
    writer.close()
    coco_s = time.perf_counter() - t0
    if first.shape != (4, 32, 32) or not np.isfinite(first).all():
        fail(f"prepare_data latents {first.shape}")

    dirs["ucf101"] = os.path.join(tmp, "ucf101_wds")
    csv = os.path.join(tmp, "ucf101.csv")
    with open(csv, "w") as f:
        f.writelines(f"v{i}.avi,video {i},{i % 101}\n"
                     for i in range(N_VIDEOS))
    rng = np.random.default_rng(14)
    clips = {f"v{i}.avi": np.repeat(np.repeat(rng.integers(
        0, 256, (UCF_SRC_FRAMES, 3, 30, 40), dtype=np.uint8), 8, 2), 8, 3)
        for i in range(N_VIDEOS)}
    random.seed(0)  # the transform's random flip
    ds = FeaturePrepDataset(csv, read_video_fn=clips.__getitem__,
                            encode_fn=codec.encode, num_frames=UCF_FRAMES)
    writer = prep_cli.ShardWriter(dirs["ucf101"],
                                 shard_size=N_VIDEOS // N_SHARDS)
    t0 = time.perf_counter()
    for i in range(len(ds)):
        item = ds[i]
        if item["frame_feature256"].shape != (UCF_FRAMES, 4, 32, 32):
            fail(f"ucf101 latents {item['frame_feature256'].shape}")
        writer.write(f"{i:08d}", {
            "frame_feature256.npy": prep_cli._npy_bytes(
                item["frame_feature256"]),
            "cls_id.cls": str(item["cls_id"]).encode(),
            "cls_name.json": json.dumps(item["text"]).encode()})
    writer.close()
    ucf_s = time.perf_counter() - t0
    print(f"prepare_data --codec sd-vae: {N_IMAGES} PNGs of sizes "
          f"{IMAGE_SIZES} -> {len(shards)} churches shards in {prep_s:.2f} s "
          f"({N_IMAGES / prep_s:.1f} images/s, PNG decode, crop, VAE encode "
          f"on the card, JPEG, tar); coco shards with {N_CAPTIONS} captions' "
          f"CLIP features a sample in {coco_s:.2f} s; ucf101 shards, "
          f"{N_VIDEOS} clips of {UCF_FRAMES} frames, in {ucf_s:.2f} s",
          flush=True)
    return dirs, dict(prepare_images_per_s=N_IMAGES / prep_s)


def shard_args(data, root):
    return [f"data={data}", f"data.tar_base={root}",
            f"data.train.shards={DATA_SHARDS}",
            f"data.validation.shards={DATA_SHARDS}", "data.sample_fid_n=0"]


def loader_rate(args, batch, n_batches=16):
    """Samples/s of ``cli.train.wds_batches`` alone (the prefetch thread
    decoding and collating; nothing on the card), after one batch."""
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli import train as train_cli
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 [*args, f"data.batch_size={batch}"])
    gen = train_cli.wds_batches(cfg)
    next(gen)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        b = next(gen)
    rate = n_batches * batch / (time.perf_counter() - t0)
    gen.close()
    return rate, {k: tuple(v.shape) for k, v in b.items()}


def shard_train_phase(dirs, tmp):
    """``cli.train`` from the three layouts, TRAIN_STEPS steps each, with
    the exact K1 / K2 counts; the loaders' rates alone."""
    out = {}
    for tag, data, model_args, batch, unit in (
            ("churches", "churches256", ["model=zigzag8_b1_pe2"], BATCH,
             "images"),
            ("coco", "coco", ["model=zigzag8_b1_pe2"], BATCH, "images"),
            ("ucf101", "ucf101", ["model=3d_zigzag8sst_b2",
                                  "model.params.class_dropout_prob=0.1"],
             VIDEO_BATCH, "videos")):
        args = [*model_args, *shard_args(data, dirs[tag])]
        rate, shapes = loader_rate(args, batch)
        print(f"{tag} loader alone, batch {batch}: {rate:.1f} samples/s; "
              f"batch {shapes}", flush=True)
        state, ckpt, tr = train_cli_phase(f"{tag} shards", args, batch,
                                          2 * DEPTH, DEPTH, tmp, unit)
        out[tag] = dict(tr, loader_samples_per_s=rate, ckpt=ckpt, args=args)
        if tag == "churches":  # for the profile of a step from shards
            out[tag]["state"] = state
        del state
    return out


def shard_step_fn(state, args):
    """One flagship training step with its batch taken from the shards
    (the loader's prefetch thread running), for the profile."""
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli import train as train_cli
    from zigma_tpu_torch.train import (LATENT_SCALE, make_diffusion_loss_fn,
                                       train_step)
    from zigma_tpu_torch.transport import create_transport
    import torch
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 [*args, f"data.batch_size={BATCH}"])
    gen = train_cli.wds_batches(cfg)
    loss_fn = make_diffusion_loss_fn(state.model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    step_gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    return lambda: train_step(state, loss_fn,
                              train_cli._to_device(next(gen), dev),
                              step_gen)["loss"].item()


def decoded_sample_phase(gen, ckpt, vckpt, dirs, tmp):
    """Sampling to pixels through the CLIs: the flagship with
    ``decode_latents=true vae_kind=sd-vae`` (2 batches of 16, 50-step Euler:
    256x256 RGB PNGs, K1 24 x 49 a batch), the video model guided (cfg 4)
    and decoded (one batch of 4: 16-frame 256x256 GIFs), the likelihood on
    the churches validation split (K1 48 x 9, K2 24 x 9), and
    ``vae_kind=sd-vae`` without weights, which must raise."""
    import numpy as np
    import torch
    from PIL import Image
    from zigma_tpu_torch.cli import sample as sample_cli

    res, calls, k1, k2 = run_sample_cli("flagship decoded sample CLI", [
        f"ckpt={ckpt}", "model=zigzag8_b1_pe2", "decode_latents=true",
        "vae_kind=sd-vae", "sample_mode=ODE", "ode.sampling_method=euler",
        f"ode.num_sampling_steps={STEPS}", f"offline_sample_local_bs={BATCH}",
        f"num_fid_samples={N_BATCHES * BATCH}", f"sample_dir={tmp}/decoded"])
    pngs = sorted(f for f in os.listdir(res["out_dir"]) if f.endswith(".png"))
    img = np.asarray(Image.open(os.path.join(res["out_dir"], pngs[0])))
    img_s = BATCH / res["batch_seconds"][1]
    dec_ms = 1e3 * res["decode_seconds"][1]
    print(f"flagship 50-step Euler + SD-VAE decode, batch {BATCH}: "
          f"{img_s:.4f} images/s (second batch; its decode {dec_ms:.1f} ms "
          f"on the host clock, latents to numpy pixels); {len(pngs)} PNGs "
          f"of {img.shape} {img.dtype}, pixel std {img.std():.1f}",
          flush=True)
    if len(pngs) != N_BATCHES * BATCH or img.shape != (256, 256, 3):
        fail(f"decoded sampling wrote {len(pngs)} PNGs of {img.shape}")
    if k1 != N_BATCHES * DEPTH * (STEPS - 1) or k2 != 0:
        fail(f"decoded sampling: K1 / K2 {(k1, k2)}")
    out = dict(images_per_s=img_s, decode_ms=dec_ms, k1=k1)

    vck = perturbed_ckpt(gen, vckpt, os.path.join(tmp, "ucf101.pt"))
    res, calls, vk1, vk2 = run_sample_cli("video decoded sample CLI (cfg 4)", [
        f"ckpt={vck}", "model=3d_zigzag8sst_b2",
        "model.params.class_dropout_prob=0.1",
        *shard_args("ucf101", dirs["ucf101"]), "cfg_scale=4",
        "decode_latents=true", "vae_kind=sd-vae", "sample_mode=ODE",
        "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}",
        f"offline_sample_local_bs={VIDEO_BATCH}",
        f"num_fid_samples={VIDEO_BATCH}", f"sample_dir={tmp}/vdecoded"])
    arr = np.load(os.path.join(res["out_dir"], "video_0_0.npy"))
    gifs = sorted(f for f in os.listdir(res["out_dir"]) if f.endswith(".gif"))
    frame = Image.open(os.path.join(res["out_dir"], gifs[0]))
    print(f"video guided + decode, batch {VIDEO_BATCH}: "
          f"{res['batch_seconds'][0]:.2f} s (decode "
          f"{res['decode_seconds'][0]:.2f} s); pixels {arr.shape}; "
          f"{len(gifs)} GIFs of {frame.n_frames} frames, {frame.size}",
          flush=True)
    if arr.shape != (VIDEO_BATCH, 16, 3, 256, 256) or len(gifs) != VIDEO_BATCH:
        fail(f"decoded video sampling: {arr.shape}, {gifs}")
    if vk1 != DEPTH * (STEPS - 1) or vk2 != 0:
        fail(f"decoded video sampling: K1 / K2 {(vk1, vk2)}")
    out["video_k1"] = vk1

    res, calls, lk1, lk2 = run_sample_cli("likelihood on the churches "
                                          "validation split", [
        f"ckpt={ckpt}", "model=zigzag8_b1_pe2",
        *shard_args("churches256", dirs["churches"]), "likelihood=true",
        "ode.sampling_method=euler", "ode.num_sampling_steps=10",
        f"offline_sample_local_bs={LIK_BATCH}",
        f"num_fid_samples={LIK_BATCH}", f"sample_dir={tmp}/lik"])
    (logp,) = res["logp"]
    print(f"likelihood of {LIK_BATCH} validation latents: logp "
          f"{[round(float(v), 2) for v in logp]}; validation batches "
          f"{res['real_batches']}; K1 {lk1}, K2 {lk2}", flush=True)
    if res["real_batches"] != 1 or not np.isfinite(logp).all():
        fail(f"likelihood on data: {res['real_batches']} batches, {logp}")
    if lk1 != 2 * DEPTH * 9 or lk2 != DEPTH * 9:
        fail(f"likelihood on data: K1 / K2 {(lk1, lk2)}")
    out.update(lik_k1=lk1, lik_k2=lk2)

    saved = {k: os.environ.pop(k, None) for k in ("ZIGMA_VAE_WEIGHTS",
                                                  "HF_HOME")}
    os.environ["HF_HOME"] = os.path.join(tmp, "empty_hf_home")
    try:
        sample_cli.main([f"ckpt={ckpt}", "model=zigzag8_b1_pe2",
                         "decode_latents=true", "vae_kind=sd-vae",
                         f"sample_dir={tmp}/never"])
        fail("vae_kind=sd-vae without weights did not raise")
    except RuntimeError as e:
        print(f"vae_kind=sd-vae without weights raised: {e}", flush=True)
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    return out


# -------------------------------------------------------------- the metrics --

def random_net_state_dict(net, seed):
    """Random full-width weights for a metric net, made on the CPU from
    ``seed`` as the JAX nets' ``random_params`` make them: convolutions
    He-normal, Linear layers 1/sqrt(fan in), BatchNorm scale 1 + 0.1 N and
    bias 0.1 N over unit statistics, LayerNorm 1 / 0, LayerScale 0.5, token
    and position embeddings 0.02 N, lpips heads |N| / channels, other
    biases 0."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=g)

    sd = {}
    for name, t in net.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            v = torch.full(t.shape, float(leaf == "running_var"))
        elif ".bn." in name:
            v = (1.0 + 0.1 * normal(t.shape) if leaf == "weight"
                 else 0.1 * normal(t.shape))
        elif re.search(r"(^|\.)norm\d?\.", name):
            v = torch.full(t.shape, float(leaf == "weight"))
        elif leaf == "gamma":
            v = torch.full(t.shape, 0.5)
        elif leaf in ("cls_token", "pos_embed"):
            v = 0.02 * normal(t.shape)
        elif name.startswith("lin"):
            v = normal(t.shape).abs() / t.shape[1]
        elif leaf == "bias":
            v = torch.zeros(t.shape)
        else:
            fan_in = math.prod(t.shape[1:])
            v = normal(t.shape) * math.sqrt((2.0 if t.ndim > 2 else 1.0)
                                            / fan_in)
        sd[name] = v
    return sd


def metric_nets_phase(tmp):
    """The four metric nets at full width with random weights: written as
    the real files are (a torch-fidelity Inception state dict, the dinov2
    hub state dict with its ``mask_token``, the StyleGAN-V I3D as a traced
    TorchScript archive) behind ``ZIGMA_INCEPTION_WEIGHTS``,
    ``ZIGMA_DINOV2_WEIGHTS`` and ``ZIGMA_I3D_TORCHSCRIPT`` for the eval
    phases; each net on the card (loaded as the probing loads it) against
    the same weights on the CPU on 2 inputs, every output, and timed at the
    eval's batch (Inception and DINOv2 on EVAL_BS 256^2 images, I3D on
    VIDEO_BATCH 16-frame 256^2 clips through the styleganv feed, LPIPS on
    EVAL_BS 256^2 pairs) beside its FLOPs and the fp32 bound."""
    import torch
    from zigma_tpu_torch.convert.torchscript_i3d import convert_torchscript_i3d
    from zigma_tpu_torch.metrics import dinov2, i3d, inception
    from zigma_tpu_torch.metrics import lpips as lp

    wdir = os.path.join(tmp, "metric_weights")
    os.makedirs(wdir)
    g = torch.Generator().manual_seed(21)
    imgs = torch.randint(0, 256, (2, 3, 256, 256), generator=g,
                         dtype=torch.uint8)
    clips = torch.randint(0, 256, (2, 16, 256, 256, 3), generator=g,
                          dtype=torch.uint8)
    pair = (torch.rand(2, 3, 256, 256, generator=g) * 2 - 1,
            torch.rand(2, 3, 256, 256, generator=g) * 2 - 1)
    errs, out = {}, {}

    def check(what, cpu_fn, cuda_fn):
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = cpu_fn()
            cpu_s = time.perf_counter() - t0
            got = cuda_fn()
        ref = ref if isinstance(ref, dict) else {"out": ref}
        got = got if isinstance(got, dict) else {"out": got}
        for k in ref:
            e = rel_err(got[k].float().cpu(), ref[k])[1]
            errs[f"{what} {k}" if k != "out" else what] = e
        print(f"{what}: card vs CPU ({cpu_s:.1f} s on the CPU), max |card - "
              f"CPU| / max |CPU|: " + ", ".join(
                  f"{k} {errs[f'{what} {k}' if k != 'out' else what]:.3e}"
                  for k in ref) + f"; limit {TOL_NETS}", flush=True)

    # Inception: the torch-fidelity file, through the probe's loader
    sd = random_net_state_dict(inception.InceptionV3(), NET_SEED)
    path = os.path.join(wdir, "pt_inception-2015-12-05-6726825d.pth")
    torch.save(sd, path)
    os.environ["ZIGMA_INCEPTION_WEIGHTS"] = path
    inc_cpu = inception.from_state_dict(torch.load(path), "cpu")
    inc = inception.from_state_dict(torch.load(path), "cuda")
    check("Inception (5 taps)",
          lambda: inc_cpu(imgs, features=inception.FEATURE_NAMES),
          lambda: inc(imgs.cuda(), features=inception.FEATURE_NAMES))

    # DINOv2 ViT-L/14: the hub file (its unused mask_token included)
    sd = random_net_state_dict(dinov2.DinoV2("vitl14"), NET_SEED)
    path = os.path.join(wdir, "dinov2_vitl14_pretrain.pth")
    torch.save({**sd, "mask_token": torch.zeros(1, 1024)}, path)
    os.environ["ZIGMA_DINOV2_WEIGHTS"] = path
    dino_cpu = dinov2.from_state_dict(torch.load(path), "vitl14", "cpu")
    dino = dinov2.from_state_dict(torch.load(path), "vitl14", "cuda")
    check("DINOv2 ViT-L/14",
          lambda: dino_cpu(dinov2.fdd_preprocess(imgs)),
          lambda: dino(dinov2.fdd_preprocess(imgs.cuda())))
    del dino_cpu

    # I3D: a traced archive, read back by the converter as the probe does
    net = i3d.InceptionI3d()
    net.load_state_dict(random_net_state_dict(net, NET_SEED), strict=True)
    net.eval().requires_grad_(False)
    path = os.path.join(wdir, "i3d_torchscript.pt")
    with torch.no_grad():
        torch.jit.trace(net, torch.zeros(1, 3, 8, 32, 32)).save(path)
    os.environ["ZIGMA_I3D_TORCHSCRIPT"] = path
    sd = convert_torchscript_i3d(path)
    i3d_cpu = i3d.from_state_dict(sd, "cpu")
    i3d_net = i3d.from_state_dict(sd, "cuda")
    check("I3D (styleganv feed)",
          lambda: i3d_cpu(i3d.styleganv_gating_preprocess(clips)),
          lambda: i3d_net(i3d.styleganv_gating_preprocess(clips.cuda())))
    del i3d_cpu

    # LPIPS: torchvision AlexNet features and the lpips heads
    sd = random_net_state_dict(lp.LPIPS(), NET_SEED)
    alex = {k[len("alex."):]: v for k, v in sd.items()
            if k.startswith("alex.")}
    heads = {k: v for k, v in sd.items() if k.startswith("lin")}
    lp_cpu = lp.from_state_dicts(alex, heads, "cpu")
    lp_net = lp.from_state_dicts(alex, heads, "cuda")
    check("LPIPS (AlexNet)", lambda: lp_cpu(*pair),
          lambda: lp_net(*(p.cuda() for p in pair)))
    if not all(math.isfinite(e) and e <= TOL_NETS for e in errs.values()):
        fail(f"metric nets card vs CPU: {errs}, limit {TOL_NETS}")

    gc = torch.Generator(device="cuda").manual_seed(22)
    x16 = torch.randint(0, 256, (EVAL_BS, 3, 256, 256), generator=gc,
                        device="cuda", dtype=torch.uint8)
    v4 = torch.randint(0, 256, (VIDEO_BATCH, 16, 256, 256, 3), generator=gc,
                       device="cuda", dtype=torch.uint8)
    p16 = [torch.rand(EVAL_BS, 3, 256, 256, generator=gc, device="cuda")
           * 2 - 1 for _ in range(2)]
    times = {}
    with torch.inference_mode():
        for what, model, fn, work in (
                ("Inception 2048 tap", inc,
                 lambda: inc(x16, features=("2048",)),
                 f"{EVAL_BS} x 256^2 -> 299^2"),
                ("Inception sFID tap (to Mixed_6e)", inc,
                 lambda: inc(x16, features=("768",)),
                 f"{EVAL_BS} x 256^2 -> 299^2"),
                ("DINOv2 ViT-L/14", dino,
                 lambda: dino(dinov2.fdd_preprocess(x16)),
                 f"{EVAL_BS} x 256^2 -> 224^2, 257 tokens"),
                ("I3D", i3d_net,
                 lambda: i3d_net(i3d.styleganv_gating_preprocess(v4)),
                 f"{VIDEO_BATCH} x 16 x 256^2 -> 224^2"),
                ("LPIPS (AlexNet)", lp_net, lambda: lp_net(*p16),
                 f"{EVAL_BS} pairs of 256^2")):
            flops = count_flops(model, fn)
            ms = cuda_ms(fn, reps=3, groups=3)
            bound = flops / peak("fp32_flops") * 1e3
            times[what] = dict(ms=ms, flops=flops, bound_ms=bound, work=work)
            print(f"{what}, {work}: {ms:.3f} ms, {flops / 1e9:.1f} GFLOP "
                  f"({flops / 1e9 / (VIDEO_BATCH if what == 'I3D' else EVAL_BS):.2f}"
                  f" a sample), {flops / ms / 1e9:.1f} TFLOP/s, fp32 bound "
                  f"{bound:.3f} ms ({100 * bound / ms:.1f}% of it)",
                  flush=True)
    del inc, dino, i3d_net, lp_net, lp_cpu, inc_cpu
    torch.cuda.empty_cache()
    return dict(errs=errs, times=times)


def check_eval(what, tr, want_choices, flavor=None):
    """One eval in the run, not swallowed by the catch; every score finite;
    nothing dropped; every feature net a ``NetExtractor`` on the card (no
    patch statistics); prints its seconds by part."""
    from zigma_tpu_torch.cli.train import eval_nets
    from zigma_tpu_torch.metrics import NetExtractor
    evals, suite = tr["evals"], tr["suite"]
    if len(evals) != 1 or "error" in evals[0]:
        fail(f"{what}: evals {evals}")
    scores, secs = evals[0]["scores"], evals[0]["seconds"]
    streams = [*suite.image.extractors.values()]
    if suite.image.logits_extractor is not None:
        streams.append(suite.image.logits_extractor)
    if suite.video is not None:
        streams += suite.video.extractors.values()
    nets = eval_nets(suite)
    print(f"{what}: choices {suite.choices}, dropped {list(suite.dropped)}, "
          f"nets {[f'{n.name} on {n.device}' for n in nets]}"
          + (f", fvd flavour {suite.video.flavor}" if suite.video else "")
          + f"; scores {json.dumps(scores)}", flush=True)
    total = (secs["sample"] + secs["decode"] + secs["host"] + secs["compute"]
             + sum(secs["nets"].values()))
    print(f"{what} seconds: {total:.2f} in all; sampling {secs['sample']:.2f}, "
          f"decode {secs['decode']:.2f}, host (copies, uint8, moments) "
          f"{secs['host']:.2f}, statistics on the host {secs['compute']:.2f}; "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs["nets"].items()),
          flush=True)
    if list(suite.choices) != list(want_choices) or suite.dropped:
        fail(f"{what}: choices {suite.choices}, dropped {suite.dropped}")
    if not all(isinstance(f, NetExtractor) and f.device.type == "cuda"
               for f in streams):
        fail(f"{what}: a stream is not a net on the card: {streams}")
    if flavor and suite.video.flavor != flavor:
        fail(f"{what}: fvd flavour {suite.video.flavor}, expected {flavor}")
    if not scores or not all(math.isfinite(v) for v in scores.values()):
        fail(f"{what}: scores {scores}")
    return dict(scores=scores, seconds=secs, total_s=total)


def eval_args(data, root, n, bs):
    """Shard args with one eval at the last step (n samples in batches of
    bs, the validation batches as large) through the SD-VAE, 50-step
    Euler."""
    return [*(a for a in shard_args(data, root)
              if not a.startswith("data.sample_fid_n=")),
            f"data.sample_fid_n={n}",
            f"data.sample_fid_bs={bs}", f"data.val_batch_size={bs}",
            f"data.sample_fid_every={TRAIN_STEPS}", "vae_kind=sd-vae",
            "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}"]


def image_eval_phase(dirs, tmp):
    """The flagship trained from the churches shards with one eval: the
    full image menu through the nets on the card; K1 48 a step plus
    EVAL_N / EVAL_BS x 49 x 24 for the eval, K2 24 a step; best_fid finite
    in the checkpoint."""
    import torch
    args = ["model=zigzag8_b1_pe2",
            *eval_args("churches256", dirs["churches"], EVAL_N, EVAL_BS)]
    k1_eval = EVAL_N // EVAL_BS * (STEPS - 1) * DEPTH
    state, ckpt, tr = train_cli_phase(  # a run dir of its own: no resume
        "churches + eval", args, BATCH, 2 * DEPTH, DEPTH,
        os.path.join(tmp, "eval"), k1_eval=k1_eval)
    out = check_eval("image eval", tr, IMAGE_MENU)
    best = torch.load(ckpt, weights_only=False)["best_fid"]
    print(f"checkpoint best_fid {best} (the eval's fid {out['scores']['fid']})",
          flush=True)
    if not math.isfinite(best) or best != out["scores"]["fid"]:
        fail(f"best_fid {best} in the checkpoint")
    del state
    return dict(out, k1=tr["k1"], k2=tr["k2"], k1_eval=k1_eval)


def video_eval_phase(dirs, tmp):
    """The video ZigMa from the ucf101 shards with one eval of
    VIDEO_EVAL_N videos: fid per frame and the styleganv fvd through the
    nets on the card; K1 exactly."""
    args = ["model=3d_zigzag8sst_b2", "model.params.class_dropout_prob=0.1",
            *eval_args("ucf101", dirs["ucf101"], VIDEO_EVAL_N, VIDEO_BATCH)]
    k1_eval = VIDEO_EVAL_N // VIDEO_BATCH * (STEPS - 1) * DEPTH
    state, ckpt, tr = train_cli_phase(
        "ucf101 + eval", args, VIDEO_BATCH, 2 * DEPTH, DEPTH,
        os.path.join(tmp, "eval"), "videos", k1_eval=k1_eval)
    del state
    out = check_eval("video eval", tr, ("fid", "fvd"), flavor="styleganv")
    return dict(out, k1=tr["k1"], k2=tr["k2"], k1_eval=k1_eval)


def sample_metrics_phase(ckpt, dirs, tmp):
    """``cli.sample metrics=[fid,kid,is,sfid,prdc,fdd] decode_latents=true``
    against the churches validation split: metrics.json written, every
    score finite, nothing dropped, K1 24 x 49 a batch."""
    res, calls, k1, k2 = run_sample_cli("sample CLI with metrics", [
        f"ckpt={ckpt}", "model=zigzag8_b1_pe2",
        *shard_args("churches256", dirs["churches"]),
        f"data.val_batch_size={BATCH}",
        "metrics=[fid,kid,is,sfid,prdc,fdd]", "decode_latents=true",
        "vae_kind=sd-vae", "sample_mode=ODE", "ode.sampling_method=euler",
        f"ode.num_sampling_steps={STEPS}", f"offline_sample_local_bs={BATCH}",
        f"num_fid_samples={SAMPLE_METRIC_BATCHES * BATCH}",
        f"sample_dir={tmp}/metrics"])
    path = os.path.join(res["out_dir"], "metrics.json")
    with open(path) as f:
        scores = json.load(f)
    suite = res["metric_suite"]
    print(f"metrics.json: {json.dumps(scores)}; choices {res['metrics']}, "
          f"dropped {list(suite.dropped)}; {res['real_batches']} validation "
          f"batches; K1 {k1}, K2 {k2}", flush=True)
    want_k1 = SAMPLE_METRIC_BATCHES * DEPTH * (STEPS - 1)
    if (k1, k2) != (want_k1, 0):
        fail(f"sample metrics: K1 / K2 {(k1, k2)}, expected {(want_k1, 0)}")
    if sorted(res["metrics"]) != sorted(IMAGE_MENU) or suite.dropped:
        fail(f"sample metrics: {res['metrics']}, dropped {suite.dropped}")
    if scores != res["scores"] or not all(math.isfinite(v)
                                          for v in scores.values()):
        fail(f"sample metrics: {scores}")
    return dict(k1=k1, scores=scores)


def serve_phase(gen, tmp):
    """The serving entry point, ``cli.serve``: a ``GenerationWorker`` on the
    flagship at full width, class-conditional with the CFG label drop, bf16
    inference cast, 50-step Euler at ``serve_batch`` 8 and a queue of one,
    decoding through the random full-width SD-VAE (``ZIGMA_VAE_WEIGHTS``,
    set by the VAE phase), behind a ``ThreadingHTTPServer`` on
    127.0.0.1.  Checks /healthz; a request for fewer than 8 images, two
    concurrent requests and a guided one, each answered with decodable
    256x256 PNGs; equal arrays for equal seeds; a burst of guided requests
    against the full queue answered in part by 503.  K1 launches exactly
    24 x 49 a completed request, guided or not; K2 and the plain versions
    never.  Reports the warm-up seconds, ms a request of 8 and images/s."""
    import base64
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from PIL import Image
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli.serve import GenerationWorker, make_handler

    per_request = DEPTH * (STEPS - 1)
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 SERVE_ARGS)
    model = sample_cli.build_model(cfg, device="cuda", generator=gen)
    with torch.no_grad():  # off the DiT zero-init, so every gate is open
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    ckpt = os.path.join(tmp, "serve.pt")
    torch.save({"ema": {k: v.cpu() for k, v in model.state_dict().items()}},
               ckpt)
    del model
    cfg = sample_cli.load_config(
        sample_cli.DEFAULT_CONFIG_DIR, "default",
        SERVE_ARGS + [f"ckpt={ckpt}", "serve_queue_max=1"])
    reset_counts()
    worker = GenerationWorker(cfg, max_batch=SERVE_BATCH)
    counts = read_counts()
    if counts != (2 * per_request, 0, 0, 0):
        fail(f"serve warm-up: K1 / K2 / plain {counts}, expected "
             f"{2 * per_request} K1 (one unguided and one guided request)")
    if not worker.is_latent:
        fail("serve: the SD-VAE codec did not load")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker, cfg))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def pngs(resp, n, what):
        if len(resp["images"]) != n:
            fail(f"serve {what}: {len(resp['images'])} images, expected {n}")
        for b in resp["images"]:
            img = np.asarray(Image.open(io.BytesIO(base64.b64decode(b))))
            if img.shape != (256, 256, 3) or img.dtype != np.uint8:
                fail(f"serve {what}: a PNG of {img.shape} {img.dtype}")

    def posts(bodies):
        """The bodies POSTed at once, one thread each; (status, reply)s in
        order, and the counts of the whole burst."""
        out = [None] * len(bodies)

        def one(i):
            out[i] = call("POST", "/generate", bodies[i])

        reset_counts()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
            time.sleep(0.05)  # in this order into the queue
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            fail("serve: a request did not come back within 600 s")
        return out, read_counts()

    try:
        code, health = call("GET", "/healthz")
        if code != 200 or health["backend"] != "cuda" or \
                health["max_batch"] != SERVE_BATCH:
            fail(f"serve /healthz: {code} {health}")
        print(f"serve /healthz: {health}", flush=True)
        checks = (("n 3 < max_batch", [{"n": 3, "seed": 1, "cls": 207}]),
                  ("two concurrent", [{"n": 8, "seed": 2, "cls": 1},
                                      {"n": 8, "seed": 3, "cls": 2}]),
                  ("guided cfg 4", [{"n": 8, "seed": 4, "cls": 3,
                                     "cfg_scale": 4.0}]))
        for what, bodies in checks:
            out, counts = posts(bodies)
            for (code, resp), body in zip(out, bodies):
                if code != 200:
                    fail(f"serve {what}: HTTP {code} {resp}")
                pngs(resp, body["n"], what)
            if counts != (per_request * len(bodies), 0, 0, 0):
                fail(f"serve {what}: K1 / K2 / plain {counts}, expected "
                     f"{per_request} K1 a request")
            print(f"serve {what}: {[r['ms'] for _, r in out]} ms; K1 "
                  f"{counts[0]} launches ({per_request} a request)",
                  flush=True)
        reset_counts()
        a = worker.submit(n=2, seed=5, cls=9)
        b = worker.submit(n=2, seed=5, cls=9)
        if read_counts() != (2 * per_request, 0, 0, 0) or \
                not np.array_equal(a, b):
            fail("serve: two requests with the same seed differ")
        print(f"serve: two requests with seed 5 gave equal {a.shape} "
              f"arrays", flush=True)
        # the queue holds one: with one guided request in flight (~2 s) and
        # one waiting, the later ones wait 1 s for room and get 503
        burst = [{"n": 8, "seed": 10 + i, "cls": i, "cfg_scale": 4.0}
                 for i in range(4)]
        out, counts = posts(burst)
        codes = [c for c, _ in out]
        done = codes.count(200)
        if 503 not in codes or set(codes) - {200, 503} or done < 2 or \
                counts != (per_request * done, 0, 0, 0):
            fail(f"serve burst against a queue of one: HTTP {codes}, K1 / "
                 f"K2 / plain {counts}")
        print(f"serve burst of 4 guided requests against a queue of one: "
              f"HTTP {codes}; K1 {counts[0]} launches", flush=True)
        times = []
        for i in range(3):  # a request of 8 at a time, decode and PNGs in
            reset_counts()
            t0 = time.perf_counter()
            code, resp = call("POST", "/generate",
                              {"n": SERVE_BATCH, "seed": 20 + i, "cls": i})
            times.append((time.perf_counter() - t0) * 1e3)
            if code != 200 or read_counts() != (per_request, 0, 0, 0):
                fail(f"serve timing request: HTTP {code}, {read_counts()}")
            conv = check_conv("serve timing request", (per_request, 0))
        ms = statistics.median(times)
        # the parts of a request, on this thread while the worker is idle
        y = torch.full((SERVE_BATCH,), 1, device="cuda")
        with torch.inference_mode():
            t0 = time.perf_counter()
            lat = worker._generate(30, y, 1.0, False).float().cpu().numpy()
            t1 = time.perf_counter()
            worker.codec.decode(lat)
            t2 = time.perf_counter()
        sample_ms, decode_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        print(f"serve flagship, 50-step Euler, batch {SERVE_BATCH}, SD-VAE "
              f"decode and PNGs: {ms:.1f} ms a request (median of "
              f"{[round(t, 1) for t in times]}), "
              f"{SERVE_BATCH * 1e3 / ms:.3f} images/s; of it sampling "
              f"{sample_ms:.1f} ms, decode {decode_ms:.1f} ms, the rest "
              f"(PNGs, HTTP, queue) {ms - sample_ms - decode_ms:.1f} ms; "
              f"warm-up {worker.compile_s} s", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        worker.close()
    return dict(k1=per_request, conv=conv, warmup_s=worker.compile_s, ms=ms,
                images_per_s=SERVE_BATCH * 1e3 / ms, sample_ms=sample_ms,
                decode_ms=decode_ms)


def lm_model(gen, dtype, **kw):
    """The benchmark's LM (``LM_SHAPE`` unless ``kw`` overrides) with random
    weights from ``gen``, on the card."""
    from zigma_tpu_torch.models.lm import MambaLMHeadModel
    return MambaLMHeadModel(**{**LM_SHAPE, **kw}, dtype=dtype, device="cuda",
                            generator=gen).eval()


def set_scan_backend(model, backend):
    for layer in model.backbone.layers:
        layer.mixer.scan_backend = backend


def lm_cache_checks(name, model, ids, tol):
    """Prefill logits and caches against the same model with its plain
    scan, and prefill + 4 steps against steps from empty caches; each as
    max |err| / max |ref| within ``tol``.  Returns the worst ratio."""
    import torch
    n_prompt = ids.shape[1] - 4
    with torch.inference_mode():
        logits, caches = model.prefill(ids[:, :n_prompt])
        set_scan_backend(model, "ref")
        ref_logits, ref_caches = model.prefill(ids[:, :n_prompt])
        set_scan_backend(model, "auto")
        errs = {"prefill logits": rel_err(logits, ref_logits)[1],
                "prefill states": max(rel_err(a[1], b[1])[1]
                                      for a, b in zip(caches, ref_caches)),
                "prefill windows": max(rel_err(a[0], b[0])[1]
                                       for a, b in zip(caches, ref_caches))}
        for t in range(n_prompt, ids.shape[1]):
            logits, caches = model.step(ids[:, t:t + 1], caches)
        steps = model.init_caches(ids.shape[0])
        for t in range(ids.shape[1]):
            step_logits, steps = model.step(ids[:, t:t + 1], steps)
        torch.cuda.synchronize()
    errs["prefill+4 vs steps logits"] = rel_err(logits, step_logits)[1]
    errs["prefill+4 vs steps states"] = max(rel_err(a[1], b[1])[1]
                                            for a, b in zip(caches, steps))
    errs["prefill+4 vs steps windows"] = max(rel_err(a[0], b[0])[1]
                                             for a, b in zip(caches, steps))
    print(f"{name}: of max |ref|, " + "; ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f" (limit {tol})",
        flush=True)
    for k, v in errs.items():
        if not v <= tol:
            fail(f"{name}: {k} {v:.3e} of max |ref| > {tol}")
    return max(errs.values())


def lm_phase(gen):
    """The LM's serving path (``models.lm``) at the shape of
    ``benchmarks/benchmark_generation.py`` (state-spaces/mamba-130m's):
    K1 at its prefill shape against the plain version and the float64
    truth, timed beside the bound; the prefill through K1 against the plain
    scan and prefill + steps against steps, in bf16 and fp32, and the same
    for a depth-4 Mamba-2 LM; ``loglikelihood_batch`` on the card against
    the CPU; then ``generate``'s prefill, decode and launch counts, a decode
    token's profile and the benchmark tool's line."""
    import torch
    from zigma_tpu_torch.evals import loglikelihood_batch
    from zigma_tpu_torch.models.lm import generate
    from zigma_tpu_torch.ops.scan_cuda import selective_scan_fwd_cuda
    from zigma_tpu_torch.ops.selective_scan import selective_scan_ref
    from zigma_tpu_torch.tools import benchmark_generation

    bf, f32 = torch.bfloat16, torch.float32
    B_, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    shp = dict(batch=B_, L=P, D=2 * LM_SHAPE["d_model"], N=16)
    d, errs = check_kernel_case(f"K1 LM prefill {tuple(shp.values())} bf16 "
                                f"fused", gen, **shp, dtype=bf, fused=True,
                                with_x0=False)
    worst = max(truth_case(f"f64 truth: {kind}LM prefill bf16", gen, **shp,
                           dtype=bf, long_memory=bool(kind))
                for kind in ("", "long-memory "))
    args = (d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"],
            d["Dskip"], d["z"])
    with torch.inference_mode():
        ms = cuda_ms(lambda: selective_scan_fwd_cuda(
            *args, return_carries=False), reps=50)
        plain_ms = cuda_ms(lambda: selective_scan_ref(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["Dskip"], d["z"],
            d["bias"], True), reps=1, groups=3)
    bound_ms, bound_by, how = least_time(*k1_work(*shp.values(), 2))
    print(f"K1 at the LM prefill {tuple(shp.values())} bf16 fused: "
          f"{ms:.4f} ms; plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({how}); {ms / bound_ms:.2f}x the bound; f64-truth "
          f"ratio at most {worst:.2f} (limit {TOL_TRUTH_MULT})", flush=True)
    k1_lm = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, max_abs_err=errs["y"])

    V = LM_SHAPE["vocab_size"]
    model = lm_model(gen, bf)
    print(f"LM: d_model {LM_SHAPE['d_model']}, {LM_SHAPE['n_layer']} layers, "
          f"vocab {V} padded to {model.padded_vocab}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"bf16", flush=True)
    ids = torch.randint(0, V, (B_, P + 4), generator=gen, device="cuda")
    lm_cache_checks("LM bf16 (through K1 vs plain scan; prefill+4 vs 132 "
                    "steps)", model, ids, TOL_FORWARD)
    m32 = lm_model(gen, f32)
    lm_cache_checks("LM fp32", m32, ids, TOL_LM_FP32)
    mamba2 = lm_model(gen, bf, n_layer=4, ssm_cfg={"ssm_version": 2})
    lm_cache_checks("Mamba-2 LM depth 4 bf16 (chunked SSD vs sequential)",
                    mamba2, ids, TOL_FORWARD)
    del mamba2

    # teacher-forced scores on the card against the same weights on the CPU
    cpu = lm_model(gen, f32).cpu()
    cpu.load_state_dict(m32.state_dict())
    sids = ids[:2, :32].cpu().numpy()
    mask = torch.zeros(2, 32, dtype=torch.bool)
    mask[0, 20:], mask[1, 5:] = True, True
    s, g = loglikelihood_batch(m32, sids, mask.numpy())
    s_c, g_c = loglikelihood_batch(cpu, sids, mask.numpy())
    _, rel = rel_err(s.cpu(), s_c)
    print(f"loglikelihood_batch fp32, card vs CPU: sums {s.tolist()} vs "
          f"{s_c.tolist()}, {rel:.3e} of max |CPU| (limit {TOL_LM_FP32}); "
          f"greedy {g.tolist()} vs {g_c.tolist()}", flush=True)
    if not rel <= TOL_LM_FP32 or not torch.equal(g.cpu(), g_c):
        fail("loglikelihood_batch on the card disagrees with the CPU")
    del cpu, m32

    # greedy generate at the benchmark's shape
    prompt = ids[:, :P]
    generate(model, prompt, G)  # warm-up
    reset_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = generate(model, prompt, G)
    b.record()
    torch.cuda.synchronize()
    gen_ms = a.elapsed_time(b)
    counts = read_counts()
    if counts != (LM_SHAPE["n_layer"], 0, 0, 0):
        fail(f"LM generate: K1 / K2 / plain {counts}, expected "
             f"{LM_SHAPE['n_layer']} K1 (the prefill) and nothing else")
    conv = check_conv("LM generate (the decode steps' conv is plain)",
                      counts[:2])
    if out.shape != (B_, P + G) or not torch.equal(out[:, :P], prompt) or \
            int(out.min()) < 0 or int(out.max()) >= model.padded_vocab:
        fail(f"LM generate: output {tuple(out.shape)} out of range")
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: model.prefill(prompt), reps=5)
        _, caches = model.prefill(prompt)
        tok = out[:, P:P + 1]
        reset_counts()
        step_ms = cuda_ms(lambda: model.step(tok, caches), reps=16)
        if read_counts()[0] or conv_counts()[0]:
            fail(f"LM decode steps launched K1 / the conv "
                 f"{read_counts()[0]} / {conv_counts()[0]} times")

    def decode_step():
        with torch.inference_mode():
            model.step(tok, caches)

    busy, wall, n_kernels = profile_phase(f"one LM decode step (batch {B_})",
                                          decode_step)
    print(f"LM greedy generate, prompt {P} + {G} x batch {B_}: "
          f"{gen_ms:.1f} ms ({B_ * G / gen_ms * 1e3:.1f} generated tok/s); "
          f"prefill {prefill_ms:.3f} ms; decode {step_ms:.3f} ms a token "
          f"step; {n_kernels} kernel launches a decode step; device idle "
          f"{100 * (1 - busy / wall):.1f}% of a decode step; K1 "
          f"{counts[0]} launches a generate call (all in the prefill), 0 a "
          f"decode step", flush=True)
    del model
    phase("benchmark_generation (the tool, default shape)")
    tool = benchmark_generation.main(["--repeats", "2"])
    return dict(k1=counts[0], conv=conv, k1_lm=k1_lm, gen_ms=gen_ms,
                gen_tok_per_s=B_ * G / gen_ms * 1e3, prefill_ms=prefill_ms,
                step_ms=step_ms, kernels_per_step=n_kernels,
                idle_share=1 - busy / wall, tool_ms=tool["ms"])


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


def profile_rows(fn):
    """One call of ``fn`` (after one warm-up call) under the profiler: its
    device-side kernels (``key_averages`` rows; a CUDA graph's replayed
    kernels are CUPTI records like any others) and its wall time in us."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_rows(prof), wall_us


def profile_phase(what, fn):
    """Device time of one call of ``fn`` (after one warm-up call), by kind
    and by kernel.  Returns (device busy ms, wall ms, kernel launches)."""
    return print_profile(what, *profile_rows(fn))


def print_profile(what, rows, wall_us):
    """``profile_rows``' device time by kind and by kernel; returns (device
    busy ms, wall ms, kernel launches)."""
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
    return total / 1e3, wall_us / 1e3, sum(e.count for e in rows)


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


def _held(name, got, ref, tol, ulp=0.0):
    """``got`` against ``ref`` per element (after ``ulp`` x |ref|), within
    ``tol`` of max |ref|; returns the excess."""
    over = excess(got, ref, ulp)
    if not over <= tol:
        fail(f"{name}: beyond {ulp:g} x |ref| by {over:.3e} of max |ref| > "
             f"{tol}")
    return over


def _truth_ratio(name, got, plain, truth, is_bf16_dbias=False):
    """``got``'s error against the float64 ``truth`` over the plain fp32
    version's (at least FP32_EPS), after one bf16 ulp of |truth| per element
    on bf16 outputs; a bf16 dbias is held to TOL_DBIAS_BF16 of the sum of
    the rounded true ddelta, which ``truth`` is then."""
    import torch
    scale = truth.abs().max().item() or 1.0
    if is_bf16_dbias:
        e = (got.double() - truth).abs().max().item() / scale
        if not e <= TOL_DBIAS_BF16:
            fail(f"{name}: bf16 dbias {e:.3e} of max |truth| > "
                 f"{TOL_DBIAS_BF16}")
        return 0.0
    ulp = BF16_ULP if got.dtype == torch.bfloat16 else 0.0
    e_k = ((got.double() - truth).abs() - ulp * truth.abs()).max().item()
    e_p = (plain.double() - truth).abs().max().item()
    ratio = (e_k / scale) / max(e_p / scale, FP32_EPS)
    if not ratio <= TOL_TRUTH_MULT:
        fail(f"{name}: error against the f64 truth {e_k / scale:.3e} is "
             f"{ratio:.2f}x the plain fp32 version's > {TOL_TRUTH_MULT}")
    return ratio


CONTRACT_OUT = ("y", "x_last", "du", "ddelta", "dA", "dB", "dC", "dbias",
                "dx0")


def contract_run(d, loss, backend):
    """``core_full`` (``core_x0`` for a loss on y alone) of ``scan_inputs``
    with its seed, under autograd: the loss on y and the final state, on y
    alone or on the final state alone, with the cotangents ``d["gy"]`` and
    ``d["g_last"]``.  Returns (y, x_last or None, the 7 gradients) and the
    counts of the call."""
    import torch
    from zigma_tpu_torch.ops.selective_scan import core_full, core_x0
    keys = ("u", "delta", "A", "B", "C", "bias", "x0")
    t = {k: d[k].detach().clone().requires_grad_() for k in keys}
    reset_counts()
    if loss == "y alone":
        y, last = core_x0(*(t[k] for k in keys), backend=backend), None
    else:
        y, last = core_full(*(t[k] for k in keys), backend=backend)
    total = 0.0
    if loss != "x_last alone":
        total = (y.float() * d["gy"].float()).sum()
    if loss != "y alone":
        total = total + (last * d["g_last"]).sum()
    grads = torch.autograd.grad(total, [t[k] for k in keys])
    torch.cuda.synchronize()
    return ([y.detach(), None if last is None else last.detach(), *grads],
            read_counts())


def scan_contract_phase(gen):
    """The seeded scan and its final state under autograd (``core_x0`` /
    ``core_full``) at the flagship shape, fp32 and bf16: K1 seeded with x0
    and returning the final state, K2 seeded by the final state's cotangent
    and returning dx0, exactly one launch each a call; every output against
    the plain versions, and against the float64 truth (fp32: each loss;
    bf16: the loss on both outputs) under TOL_TRUTH_MULT.  A loss on y
    alone or on the final state alone leaves autograd's other cotangent
    None."""
    import torch
    fs = FLAGSHIP
    worst_truth, lines = 0.0, []
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        d = scan_inputs(gen, **fs, dtype=dtype)
        d["gy"] = torch.randn(fs["batch"], fs["L"], fs["D"], generator=gen,
                              device="cuda").to(dtype)
        d["g_last"] = torch.randn(fs["batch"], fs["N"], fs["D"],
                                  generator=gen, device="cuda")
        for loss in ("both", "y alone", "x_last alone"):
            name = f"contract {tag}, loss on {loss}"
            got, c_k = contract_run(d, loss, "auto")
            ref, c_p = contract_run(d, loss, "ref")
            if c_k != (1, 1, 0, 0) or c_p != (0, 0, 1, 1):
                fail(f"{name}: counts {c_k} (kernels) / {c_p} (plain), "
                     f"expected one K1 and one K2 launch a call")
            worst = 0.0
            for what, g, r in zip(CONTRACT_OUT, got, ref):
                if g is None:
                    continue
                ulp = BF16_ULP if g.dtype == torch.bfloat16 else 0.0
                tol = (TOL_FP32 if what in ("y", "x_last") else
                       TOL_DBIAS_BF16 if what == "dbias" and tag == "bf16"
                       else TOL_BWD)
                worst = max(worst, _held(f"{name}: {what}", g, r, tol, ulp)
                            / tol)
            msg = f"{name:38s} kernels vs plain: worst {worst:.2f} of limit"
            if tag == "fp32" or loss == "both":
                dl = dict(d)
                if loss == "y alone":
                    del dl["g_last"]
                elif loss == "x_last alone":
                    dl["gy"] = torch.zeros_like(d["gy"])
                plain = ref if tag == "fp32" else contract_run(
                    {k: v.float() for k, v in d.items()}, loss, "ref")[0]
                y_t, _, last_t = truth_f64(dl, seeded=True, fused=False)
                truth = [y_t, last_t, *truth_bwd_f64(dl, seeded=True,
                                                     fused=False)]
                if tag == "bf16":  # it sums the bf16-rounded ddelta
                    truth[7] = truth[3].to(torch.bfloat16).double().sum(
                        (0, 1))
                ratios = {
                    what: _truth_ratio(f"{name}: {what}", g, p, t,
                                       what == "dbias" and tag == "bf16")
                    for what, g, p, t in zip(CONTRACT_OUT, got, plain, truth)
                    if g is not None}
                top = max(ratios, key=ratios.get)
                worst_truth = max(worst_truth, ratios[top])
                msg += (f"; vs f64 at most {ratios[top]:.2f}x the plain fp32 "
                        f"version's error ({top}; dx0 {ratios['dx0']:.2f}x"
                        + (f", x_last {ratios['x_last']:.2f}x"
                           if "x_last" in ratios else "") + ")")
            print(msg, flush=True)
        del d
    print(f"scan contract: K1 with x0 and the final state, K2 with g_last "
          f"and dx0, one launch each a call; against the f64 truth at most "
          f"{worst_truth:.2f}x the plain fp32 version's error (limit "
          f"{TOL_TRUTH_MULT})", flush=True)
    return dict(truth_ratio=worst_truth, k1_per_call=1, k2_per_call=1)


def seq_parallel_phase(gen):
    """The flagship scan (fused gate; bf16, then fp32) over SEQ_SHARDS
    virtual shards of L on the one card, through the sequence-parallel
    passes: exactly 2 x SEQ_SHARDS K1 and K2 launches, outputs and every
    gradient against the unsharded kernels and, like theirs, against the
    float64 truth of the unsharded scan (the largest error of any element;
    at most TOL_TRUTH_MULT x the unsharded kernels'); the sharded scan's
    times beside the unsharded one's in bf16; K1 and K2 at a shard's (16,
    256, 1536, 16) as the two passes call them, with their bounds and the
    plain versions' times."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_fwd_cuda)
    from zigma_tpu_torch.ops.selective_scan import (selective_scan,
                                                    selective_scan_bwd_ref,
                                                    selective_scan_ref)
    from zigma_tpu_torch.parallel import selective_scan_sharded
    fs, n = FLAGSHIP, SEQ_SHARDS
    bf = torch.bfloat16
    keys = ("u", "delta", "A", "B", "C", "Dskip", "z", "bias")
    sharded = lambda *a: selective_scan_sharded(*a, delta_softplus=True,
                                                n_shards=n)
    whole = lambda *a: selective_scan(*a, delta_softplus=True)
    worst, problems = {}, []
    for tag, dtype in (("bf16", bf), ("fp32", torch.float32)):
        # long memory (decays near 0.999): a shard's incoming state reaches
        # far into the next shard; at short memory it would be forgotten
        # within one and the prefix exchange would go untested
        d = scan_inputs(gen, **fs, dtype=dtype, long_memory=True)
        d["gy"] = torch.randn(fs["batch"], fs["L"], fs["D"], generator=gen,
                              device="cuda").to(dtype)

        def run(fn):
            t = {k: d[k].detach().clone().requires_grad_() for k in keys}
            reset_counts()
            y = fn(*(t[k] for k in keys))
            grads = torch.autograd.grad((y.float() * d["gy"].float()).sum(),
                                        [t[k] for k in keys])
            torch.cuda.synchronize()
            return (dict(zip(("y", *keys), (y.detach(), *grads))),
                    read_counts())

        got, c_s = run(sharded)
        ref, c_w = run(whole)
        if c_s != (2 * n, 2 * n, 0, 0) or c_w != (1, 1, 0, 0):
            fail(f"sequence parallel {tag}: counts {c_s} sharded / {c_w} "
                 f"unsharded, expected {2 * n} K1 and {2 * n} K2 / one each")
        y_t, _, _ = truth_f64(d)
        truth = dict(zip(("y", "u", "delta", "A", "B", "C", "bias", "dx0",
                          "z", "Dskip"), (y_t, *truth_bwd_f64(d))))
        parts, worst[tag] = [], (0.0, "")
        for what in ("y", *keys):
            t = truth[what]
            scale = t.abs().max().item()
            # the largest error of any element, of max |truth|: a bf16
            # output of the sharded scan that sums both passes' (du,
            # ddelta, dB, dC) is rounded three times, so no per-element
            # ulp is allowed either side; dbias, which sums rounded ddelta
            # on both sides (and an fp32 term through the shard decays on
            # the sharded one), against the exact sum
            e_s, e_w = ((v.double() - t).abs().max().item() / scale
                        for v in (got[what], ref[what]))
            ratio = e_s / max(e_w, FP32_EPS)
            worst[tag] = max(worst[tag], (ratio, what))
            diff = (got[what].float() - ref[what].float()).abs().max().item()
            parts.append(f"{what} {e_s:.2e}/{e_w:.2e} ({ratio:.2f}x; "
                         f"|sharded - unsharded| {diff:.1e})")
            if not ratio <= TOL_TRUTH_MULT:
                problems.append(f"{tag} {what} {ratio:.2f}x")
        print(f"flagship {tag} fused over {n} shards, vs the f64 truth of "
              f"the unsharded scan, sharded/unsharded kernels' largest error "
              f"of max |truth|: " + "; ".join(parts) + f"; worst "
              f"{worst[tag][1]} {worst[tag][0]:.2f}x", flush=True)
        del got, ref, truth, y_t
    if problems:
        fail(f"sequence parallel: error against the f64 truth above "
             f"{TOL_TRUTH_MULT}x the unsharded kernels': {problems}")
    d = scan_inputs(gen, **fs, dtype=bf, long_memory=True)
    d["gy"] = torch.randn(fs["batch"], fs["L"], fs["D"], generator=gen,
                          device="cuda").to(bf)
    args = [d[k] for k in keys]
    with torch.no_grad():
        fwd_s = cuda_ms(lambda: sharded(*args), reps=10)
        fwd_w = cuda_ms(lambda: whole(*args), reps=10)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    gy = d["gy"]
    fb_s = cuda_ms(lambda: (sharded(*leaves) * gy).float().sum().backward(),
                   reps=3)
    fb_w = cuda_ms(lambda: (whole(*leaves) * gy).float().sum().backward(),
                   reps=3)
    print(f"sequence-parallel scan over {n} shards: forward {fwd_s:.4f} ms "
          f"against {fwd_w:.4f} ms unsharded ({fwd_s / fwd_w:.2f}x); "
          f"forward + backward {fb_s:.4f} ms against {fb_w:.4f} ms "
          f"({fb_s / fb_w:.2f}x)", flush=True)

    # K1 and K2 at a shard's shape, as the two passes call them
    Ls = fs["L"] // n
    sl = {k: d[k][:, :Ls].contiguous() for k in ("u", "delta", "B", "C", "z",
                                                  "gy")}
    A, bias, Dk = d["A"], d["bias"], d["Dskip"]
    x_in, g_last = d["x0"], torch.randn(fs["batch"], fs["N"], fs["D"],
                                        generator=gen, device="cuda")
    zeros = torch.zeros_like(sl["gy"])
    with torch.no_grad():
        _, car1, _ = selective_scan_fwd_cuda(sl["u"], sl["delta"], A, sl["B"],
                                             sl["C"], bias)
        _, car2, _ = selective_scan_fwd_cuda(sl["u"], sl["delta"], A, sl["B"],
                                             sl["C"], bias, Dk, sl["z"], x_in)
        calls = {
            "K1 pass 1 (final state)": (
                lambda: selective_scan_fwd_cuda(
                    sl["u"], sl["delta"], A, sl["B"], sl["C"], bias),
                lambda: selective_scan_ref(
                    sl["u"], sl["delta"], A, sl["B"], sl["C"], None, None,
                    bias, True),
                k1_work(fs["batch"], Ls, fs["D"], fs["N"], 2, carries=True,
                        fused=False)),
            "K1 pass 2 (seeded, fused)": (
                lambda: selective_scan_fwd_cuda(
                    sl["u"], sl["delta"], A, sl["B"], sl["C"], bias, Dk,
                    sl["z"], x_in),
                lambda: selective_scan_ref(
                    sl["u"], sl["delta"], A, sl["B"], sl["C"], Dk, sl["z"],
                    bias, True, x_in),
                k1_work(fs["batch"], Ls, fs["D"], fs["N"], 2, carries=True,
                        seeded=True)),
            "K2 pass 1 (from g_last)": (
                lambda: selective_scan_bwd_cuda(
                    sl["u"], sl["delta"], bias, A, sl["B"], sl["C"], car1,
                    zeros, g_last),
                lambda: selective_scan_bwd_ref(
                    sl["u"], sl["delta"], bias, A, sl["B"], sl["C"], car1,
                    zeros, g_last),
                k2_work(fs["batch"], Ls, fs["D"], fs["N"], 2, fused=False,
                        g_last=True)),
            "K2 pass 2 (fused, dx0)": (
                lambda: selective_scan_bwd_cuda(
                    sl["u"], sl["delta"], bias, A, sl["B"], sl["C"], car2,
                    sl["gy"], None, Dk, sl["z"]),
                lambda: selective_scan_bwd_ref(
                    sl["u"], sl["delta"], bias, A, sl["B"], sl["C"], car2,
                    sl["gy"], None, Dk, sl["z"]),
                k2_work(fs["batch"], Ls, fs["D"], fs["N"], 2))}
        rows = {}
        for what, (kernel, plain, work) in calls.items():
            ms = cuda_ms(kernel, reps=20)
            plain_ms = cuda_ms(plain, reps=1, groups=3)
            bound_ms, bound_by, _ = least_time(*work)
            rows[what] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, launches=n)
            print(f"{what} at {(fs['batch'], Ls, fs['D'], fs['N'])} bf16: "
                  f"{ms:.4f} ms ({ms / bound_ms:.1f}x the bound {bound_ms:.4f} "
                  f"ms by {bound_by}); plain {plain_ms:.3f} ms; {n} launches "
                  f"a sharded call", flush=True)
    return dict(k1=2 * n, k2=2 * n, truth_ratio={k: v[0] for k, v in
                                                 worst.items()},
                fwd_ms=fwd_s, fwd_ms_unsharded=fwd_w, fwd_bwd_ms=fb_s,
                fwd_bwd_ms_unsharded=fb_w, shard_rows=rows)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher_env(port):
    """The variables a launcher sets for rank 0 of a world of one."""
    return dict(ZIGMA_DISTRIBUTED="1", RANK="0", WORLD_SIZE="1",
                LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))


def dist_train_phase(tr, tmp):
    """``cli.train`` in this process as rank 0 of a world of one over NCCL
    (``ZIGMA_DISTRIBUTED`` with the launcher's variables), the flagship at
    full width, batch 16, 8 steps: DDP, FSDP2 (``parallel.fsdp``) and the
    tensor-parallel code path over a model group of one
    (``parallel.tp=1``).  Each: exactly 48 K1 / 24 K2 launches a step, the
    losses against the single-process train phase's (``tr``) for the same
    seed, the checkpoint loaded strict into a fresh flagship model and
    resumed for one more step, steps/s and peak memory; the process group
    is gone after each.  Then a real launch through ``torch.distributed.run``
    (depth 2, 2 steps) and one stopped by SIGTERM after its first logged
    step."""
    import torch
    import torch.distributed as dist
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli import train as train_cli
    base = ["model=zigzag8_b1_pe2", "data=synthetic",
            f"data.batch_size={BATCH}", "log_every=1"]
    out, saved = {}, {k: os.environ.get(k) for k in launcher_env(0)}
    for mode, extra in (("DDP", []), ("FSDP2", ["parallel.fsdp=true"]),
                        ("TP-1", ["parallel.tp=1"])):
        run_dir = os.path.join(tmp, f"dist_{mode}")
        os.environ.update(launcher_env(free_port()))
        try:
            torch.cuda.reset_peak_memory_stats()
            held_gb = torch.cuda.memory_allocated() / 1e9
            reset_counts()
            res = train_cli.main([*base, *extra,
                                  f"data.train_steps={TRAIN_STEPS}",
                                  f"results_dir={run_dir}"])
            torch.cuda.synchronize()
            counts = read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if dist.is_initialized():
                fail(f"{mode}: the process group outlived cli.train")
            del res["state"]
            os.environ["MASTER_PORT"] = str(free_port())
            again = train_cli.main([*base, *extra,
                                    f"data.train_steps={TRAIN_STEPS + 1}",
                                    f"results_dir={run_dir}"])
            del again["state"]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        gc.collect()  # FSDP2's hooks hold the modules in reference cycles
        torch.cuda.empty_cache()
        want = (48 * TRAIN_STEPS, 24 * TRAIN_STEPS, 0, 0)
        if counts != want:
            fail(f"{mode}: K1 / K2 / plain {counts}, expected {want}")
        losses = [r["loss"] for r in res["records"]]
        diffs = [abs(a - b) for a, b in zip(losses, tr["losses"])]
        if len(losses) != TRAIN_STEPS or not max(diffs) <= TOL_DIST_LOSS * max(
                map(abs, tr["losses"])):
            fail(f"{mode}: losses {losses} against the single-process run's "
                 f"{tr['losses']}")
        if [r["step"] for r in again["records"]] != [TRAIN_STEPS + 1]:
            fail(f"{mode}: the resumed run logged {again['records']}")
        cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                     base[:1])
        fresh = sample_cli.build_model(cfg, device="cuda")
        fresh.load_state_dict(sample_cli.load_state_dict(res["checkpoint"]),
                              strict=True)
        del fresh
        steady = [1.0 / r["steps_per_sec"] for r in res["records"][1:]]
        steps_s = len(steady) / sum(steady)
        out[mode] = dict(steps_per_s=steps_s, peak_gb=peak_gb,
                         held_gb=held_gb, k1=counts[0], k2=counts[1],
                         max_loss_diff=max(diffs), ckpt=res["checkpoint"])
        print(f"{mode} at world size 1 over NCCL: losses "
              f"{'bit-equal to' if max(diffs) == 0 else 'within ' + format(max(diffs), '.2e') + ' of'}"
              f" the single-process run's; {steps_s:.4f} steps/s (single "
              f"process {tr['steps_per_s']:.4f}); peak {peak_gb:.2f} GB "
              f"({held_gb:.2f} GB held before it; single process "
              f"{tr['peak_gb']:.2f} GB); K1 {counts[0]} / K2 {counts[1]}; "
              f"checkpoint loaded strict, resumed at step {TRAIN_STEPS + 1}",
              flush=True)

    # two launches through torch.distributed.run side by side (each its own
    # standalone rendezvous): one runs 2 steps to its end, the other is
    # stopped by SIGTERM to its trainer after its first logged step
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ZIGMA_DISTRIBUTED"] = "1"
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node=1", "-m", "zigma_tpu_torch.cli.train",
              "model=zigzag8_b1_pe2", "data=synthetic",
              f"data.batch_size={BATCH}", "model.params.depth=2",
              "log_every=1"]
    dirs = {k: os.path.join(tmp, k) for k in ("launched", "preempted")}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [*launch, f"data.train_steps={steps}", f"results_dir={dirs[k]}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k, steps in (("launched", 2), ("preempted", 100000))}
    try:
        lines, seen, first_s = [], 0, None
        proc = procs["preempted"]
        while time.perf_counter() - t0 < 300:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"step (\d+) .*steps/sec", line)
            if m:
                seen, first_s = int(m.group(1)), time.perf_counter() - t0
                break
        workers = child_pids(proc.pid)
        if not seen or not workers:
            fail("the launched trainer never logged a step:\n"
                 + "".join(lines[-40:]))
        for pid in workers:  # the trainer, as a scheduler signals a job
            os.kill(pid, signal.SIGTERM)
        outs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
        wall = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    outs["preempted"] = "".join(lines) + outs["preempted"]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "launches.log"), "w") as f:
        for k, text in outs.items():
            f.write(f"== {k} (exit {procs[k].returncode})\n{text}\n")

    ckpts = sorted(glob_ckpts(dirs["launched"]))
    if procs["launched"].returncode != 0 or not ckpts or \
            not ckpts[-1].endswith("0000002.pt"):
        fail(f"torch.distributed.run: exit {procs['launched'].returncode}, "
             f"checkpoints {ckpts}:\n{outs['launched'][-3000:]}")
    print(f"torch.distributed.run --standalone --nproc_per_node=1 -m "
          f"zigma_tpu_torch.cli.train (depth 2, 2 steps): exit 0, "
          f"{os.path.basename(ckpts[-1])} written", flush=True)
    text = outs["preempted"]
    m = re.search(r"signal (\d+) received: checkpointing and exiting at "
                  r"step (\d+)", text)
    ckpts = sorted(glob_ckpts(dirs["preempted"]))
    if procs["preempted"].returncode != 0 or not m or not ckpts:
        fail(f"SIGTERM: exit {procs['preempted'].returncode}, message "
             f"{bool(m)}, checkpoints {ckpts}:\n{text[-3000:]}")
    step = int(m.group(2))
    if step < seen or not ckpts[-1].endswith(f"{step:07d}.pt"):
        fail(f"SIGTERM: stopped at step {step} after step {seen} was seen, "
             f"checkpoints {ckpts}")
    print(f"SIGTERM to the launched trainer after step {seen} "
          f"({first_s:.1f} s after the launch): exit 0, 'signal "
          f"{m.group(1)} received: checkpointing and exiting at step "
          f"{step}', {os.path.basename(ckpts[-1])} written; both launches "
          f"done {wall:.1f} s after they started (their logs: "
          f"chiprun_out/launches.log)", flush=True)
    return out


def glob_ckpts(run_dir):
    import glob
    return glob.glob(os.path.join(run_dir, "*", "checkpoints", "*.pt"))


def child_pids(pid):
    """Every process below ``pid`` (Linux /proc)."""
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        try:
            with open(f"/proc/{p}/task/{p}/children") as f:
                kids = [int(k) for k in f.read().split()]
        except OSError:
            kids = []
        out += kids
        todo += kids
    return out


def dist_sample_phase(ckpt, tmp):
    """``cli.sample`` as rank 0 of a world of one over NCCL from the DDP
    checkpoint, 50-step Euler, 2 batches of 16: K1 2 x 49 x 24 launches and
    the same images as the single-process sampler with the same seed."""
    import numpy as np
    from PIL import Image
    args = [f"ckpt={ckpt}", "model=zigzag8_b1_pe2", "sample_mode=ODE",
            "ode.sampling_method=euler", f"ode.num_sampling_steps={STEPS}",
            f"offline_sample_local_bs={BATCH}",
            f"num_fid_samples={N_BATCHES * BATCH}"]
    saved = {k: os.environ.get(k) for k in launcher_env(0)}
    os.environ.update(launcher_env(free_port()))
    try:
        res, calls, k1, k2 = run_sample_cli(
            "distributed sample CLI (world size 1, NCCL)",
            [*args, f"sample_dir={os.path.join(tmp, 'dist_samples')}"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    one, _, _, _ = run_sample_cli(
        "single-process sample CLI, same seed",
        [*args, f"sample_dir={os.path.join(tmp, 'one_samples')}"])
    want = N_BATCHES * (STEPS - 1) * DEPTH
    if (k1, k2) != (want, 0):
        fail(f"distributed sampling: K1 / K2 {k1} / {k2}, expected {want} / 0")
    names = sorted(os.listdir(res["out_dir"]))
    if names != sorted(os.listdir(one["out_dir"])) or \
            len(names) != N_BATCHES * BATCH:
        fail(f"distributed sampling wrote {names}")
    for name in names:
        a = np.asarray(Image.open(os.path.join(res["out_dir"], name)))
        b = np.asarray(Image.open(os.path.join(one["out_dir"], name)))
        if not np.array_equal(a, b):
            fail(f"distributed sampling: {name} differs from the "
                 f"single-process sampler's")
    print(f"distributed sampling: {len(names)} images equal to the "
          f"single-process sampler's; K1 {k1} launches", flush=True)
    return dict(k1=k1, batch_seconds=res["batch_seconds"])


def microbatch_kernel_phase(gen):
    """K1 and K2 at the pipelined step's microbatch shape (MICROBATCH: 4 of
    the flagship's 16 sequences) in bf16 with the fused gate, as training
    calls them (K1 keeping the chunk starts, K2 without a final-state
    cotangent): each against its plain version on the same inputs, timed
    beside the plain version and the bound."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_fwd_cuda)
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    mb, bf = MICROBATCH, torch.bfloat16
    d, errs = check_kernel_case("microbatch bf16 fused (pipeline)", gen,
                                **mb, dtype=bf, fused=True, with_x0=False)
    d2, carries, errs2 = check_bwd_case("microbatch bf16 fused (pipeline)",
                                        gen, **mb, dtype=bf, fused=True)
    fwd = (d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"],
           d["Dskip"], d["z"])
    bwd = (d2["u"], d2["delta"], d2["bias"], d2["A"], d2["B"], d2["C"],
           carries, d2["gy"], None, d2["Dskip"], d2["z"])
    calls = {
        "K1": (lambda: selective_scan_fwd_cuda(*fwd, return_carries=True),
               lambda: selective_scan_ref(
                   d["u"], d["delta"], d["A"], d["B"], d["C"], d["Dskip"],
                   d["z"], d["bias"], True),
               k1_work(*mb.values(), 2, carries=True), errs["y"]),
        "K2": (lambda: selective_scan_bwd_cuda(*bwd),
               lambda: selective_scan_bwd_ref(*bwd),
               k2_work(*mb.values(), 2), max(errs2.values()))}
    rows = {}
    with torch.no_grad():
        for what, (kernel, plain, work, err) in calls.items():
            ms = cuda_ms(kernel, reps=20)
            plain_ms = cuda_ms(plain, reps=1, groups=3)
            bound_ms, bound_by, how = least_time(*work)
            rows[what] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, max_abs_err=err)
            print(f"{what} at {tuple(mb.values())} bf16 fused (a pipelined "
                  f"microbatch): {ms:.4f} ms ({ms / bound_ms:.1f}x the bound "
                  f"{bound_ms:.4f} ms by {bound_by}: {how}); plain "
                  f"{plain_ms:.3f} ms", flush=True)
    return rows


def remat_phase(gen, tr, tmp):
    """``cli.train`` on the flagship (batch 16, bf16, drop-path 0.1) under
    each selective-remat policy, TRAIN_STEPS steps: K1 exactly 24 a step
    under ``scan_out`` and ``scan_out+dots`` (the recompute takes the
    registered op's kept outputs) and 48 under ``dots``, K2 24, the plain
    versions never; losses against the full-remat train phase's for the
    same seed; steps/s and peak memory beside it; the profile of one step
    (full remat's is in the profile phase)."""
    out = {}
    for policy, k1_step in REMAT_K1.items():
        state, _, r = train_cli_phase(
            f"remat {policy}", ["model=zigzag8_b1_pe2", "data=synthetic",
                                f"model.params.remat_policy={policy}"],
            BATCH, k1_step, DEPTH, os.path.join(tmp, f"remat_{policy}"))
        diff = max(abs(a - b) for a, b in zip(r["losses"], tr["losses"]))
        print(f"remat {policy}: losses "
              + ("bit-equal to" if diff == 0 else f"within {diff:.3e} of")
              + f" full remat's; {r['steps_per_s']:.4f} steps/s against "
              f"{tr['steps_per_s']:.4f}; peak {r['peak_gb']:.2f} GB "
              f"({r['peak_gb'] - r['held_gb']:.2f} GB its own) against "
              f"{tr['peak_gb']:.2f} GB ({tr['peak_gb'] - tr['held_gb']:.2f} "
              f"GB)", flush=True)
        if not diff <= TOL_DIST_LOSS * max(map(abs, tr["losses"])):
            fail(f"remat {policy}: losses {r['losses']} against full "
                 f"remat's {tr['losses']}")
        busy, wall, _ = profile_phase(
            f"one flagship training step, remat_policy={policy} (batch "
            f"{BATCH})", train_step_fn(state, gen, (BATCH, 4, 32, 32)))
        del state
        out[policy] = dict(r, max_loss_diff=diff, busy_ms=busy, wall_ms=wall)
    return out


def remat_grad_check_phase(gen):
    """A flagship-width depth-2 fp32 model under ``remat_policy=scan_out``
    against the same weights under full remat: loss and every gradient
    through K1 / K2, within TOL_REMAT_GRAD of max |full remat|."""
    import torch
    from zigma_tpu_torch.models import ZigMa
    from zigma_tpu_torch.train import LATENT_SCALE, make_diffusion_loss_fn
    from zigma_tpu_torch.transport import create_transport

    kw = dict(in_channels=4, embed_dim=768, depth=2, img_dim=32,
              patch_size=1, scan_type="zigzagN8", use_pe=2,
              use_checkpoint=True, device="cuda")
    full = ZigMa(**kw, generator=gen)
    with torch.no_grad():  # off the DiT zero-init, so every gate is open
        for p in full.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    kept = ZigMa(**kw, remat_policy="scan_out")
    kept.load_state_dict(full.state_dict())
    batch = {"x": torch.randn(2, 4, 32, 32, generator=gen, device="cuda")}
    res = []
    for model in (full, kept):
        loss_fn = make_diffusion_loss_fn(model, create_transport(),
                                         latent_scale=LATENT_SCALE)
        reset_counts()
        loss = loss_fn(batch, torch.Generator(device="cuda").manual_seed(7))
        loss.backward()
        torch.cuda.synchronize()
        res.append((loss.item(), read_counts(),
                    {n: p.grad for n, p in model.named_parameters()}))
    (lf, cf, gf), (lk, ck, gk) = res
    worst = max((rel_err(gk[n], gf[n])[1], n) for n in gf)
    print(f"remat scan_out vs full remat, flagship width depth 2 fp32: loss "
          f"{lk:.6f} / {lf:.6f}; K1, K2, plain {ck} / {cf}; worst gradient "
          f"{worst[0]:.3e} of max |full| ({worst[1]}); limit "
          f"{TOL_REMAT_GRAD}", flush=True)
    if ck != (2, 2, 0, 0) or cf != (4, 2, 0, 0):
        fail(f"remat grad check: launches {ck} / {cf}")
    if not (worst[0] <= TOL_REMAT_GRAD and lk == lf):
        fail(f"remat scan_out gradients differ from full remat's: {worst}")
    return worst[0]


def pipeline_phase(gen, tmp):
    """The pipeline at world size 1 over NCCL (``cli.train`` in this
    process with the launcher's variables, ``parallel.pp=1``): the flagship
    at depth 24, drop-path 0, batch 16 in PIPE_MICROBATCHES microbatches,
    PIPE_STEPS steps: K1 exactly 192 and K2 96 a step (48 / 24 a
    microbatch, with remat), the plain versions never, the losses within
    TOL_PIPE_LOSS of a one-process run's with the same seed, the gathered
    checkpoint strict.  Then ``zigma_pipelined_apply`` on a depth-2 fp32
    flagship-width stage against the plain model: the output within
    TOL_PIPE_OUT of max |ref|, the gradients within TOL_GRAD of theirs."""
    import copy

    import torch
    import torch.distributed as dist
    from zigma_tpu_torch.models import ZigMa
    from zigma_tpu_torch.parallel import (make_mesh, split_stage,
                                          zigma_pipelined_apply)
    args = ["model=zigzag8_b1_pe2", "data=synthetic",
            "model.params.drop_path_rate=0"]
    _, _, one = train_cli_phase("one process, drop-path 0", args, BATCH,
                                2 * DEPTH, DEPTH,
                                os.path.join(tmp, "pipe_ref"),
                                steps=PIPE_STEPS)
    saved = {k: os.environ.get(k) for k in launcher_env(0)}
    os.environ.update(launcher_env(free_port()))
    try:
        _, _, pp = train_cli_phase(
            f"pipeline, 1 stage x {PIPE_MICROBATCHES} microbatches",
            [*args, "parallel.pp=1",
             f"parallel.pp_microbatches={PIPE_MICROBATCHES}"], BATCH,
            2 * DEPTH * PIPE_MICROBATCHES, DEPTH * PIPE_MICROBATCHES,
            os.path.join(tmp, "pipe"), steps=PIPE_STEPS)
        if dist.is_initialized():
            fail("pipeline: the process group outlived cli.train")
        dist.init_process_group("nccl", init_method="env://",
                                device_id=torch.device("cuda", 0))
        group = make_mesh(pipe=1)["pipe"].get_group()
        ref = ZigMa(in_channels=4, embed_dim=768, depth=2, img_dim=32,
                    patch_size=1, scan_type="zigzagN8", use_pe=2,
                    use_checkpoint=True, drop_path_rate=0.0, device="cuda",
                    generator=gen)
        with torch.no_grad():
            for p in ref.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen,
                                          device="cuda"))
        stage = split_stage(copy.deepcopy(ref), 0, 1)
        x = torch.randn(PIPE_MICROBATCHES, 4, 32, 32, generator=gen,
                        device="cuda")
        t = torch.rand(PIPE_MICROBATCHES, generator=gen, device="cuda")
        w = torch.randn(x.shape, generator=gen, device="cuda")
        got = zigma_pipelined_apply(stage, x, t, group=group,
                                    n_microbatches=PIPE_MICROBATCHES)
        want = ref(x, t)
        (got * w).sum().backward()
        (want * w).sum().backward()
        torch.cuda.synchronize()
        grads = dict(stage.named_parameters())
        out_err = rel_err(got, want)[1]
        worst = max((rel_err(grads[n].grad, p.grad)[1], n)
                    for n, p in ref.named_parameters())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rel = [abs(a - b) / abs(b) for a, b in zip(pp["losses"], one["losses"])]
    print(f"pipeline losses {[round(v, 5) for v in pp['losses']]} against one "
          f"process {[round(v, 5) for v in one['losses']]}: worst "
          f"{max(rel):.3e} relative (limit {TOL_PIPE_LOSS}); "
          f"{pp['steps_per_s']:.4f} steps/s against {one['steps_per_s']:.4f} "
          f"({100 * (pp['steps_per_s'] / one['steps_per_s'] - 1):+.1f}%), "
          f"peak {pp['peak_gb']:.2f} GB against {one['peak_gb']:.2f} GB; "
          f"depth-2 fp32 stage: output {out_err:.3e} of max |ref| (limit "
          f"{TOL_PIPE_OUT}), worst gradient {worst[0]:.3e} ({worst[1]}; "
          f"limit {TOL_GRAD})", flush=True)
    if not max(rel) <= TOL_PIPE_LOSS:
        fail(f"pipeline losses {pp['losses']} against {one['losses']}")
    if not (out_err <= TOL_PIPE_OUT and worst[0] <= TOL_GRAD):
        fail(f"pipelined stage against the plain model: output {out_err}, "
             f"gradients {worst}")
    return dict(pp, one=one, loss_rel=max(rel), out_err=out_err,
                grad_err=worst[0])


def convert_phase(gen, tmp):
    """The flagship's random weights written as a reference-layout ``.pt``
    (``module.`` keys, ``ema`` and ``model``) through ``cli.convert`` on the
    card, then one ``cli.train ckpt=`` step from the step-0 checkpoint: 48
    K1 / 24 K2, the plain versions never, the run's EMA strict."""
    import torch
    from zigma_tpu_torch.cli import convert as convert_cli
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli import train as train_cli
    args = ["model=zigzag8_b1_pe2", "data=synthetic"]
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 args)
    model = sample_cli.build_model(cfg, device="cuda", generator=gen)
    sd = {f"module.{k}": v.cpu() for k, v in model.state_dict().items()}
    pt = os.path.join(tmp, "reference_0000100.pt")
    torch.save({"model": sd, "ema": sd, "opt": {}, "args": None,
                "train_steps": 100, "best_fid": 9.5}, pt)
    del model
    t0 = time.perf_counter()
    path = convert_cli.main(["--ckpt", pt, "--out",
                             os.path.join(tmp, "converted"), *args])
    conv_s = time.perf_counter() - t0
    ck = torch.load(path, map_location="cpu", weights_only=False)
    if ck["train_steps"] != 0 or ck["opt"]["state"] or not all(
            torch.equal(ck["ema"][k[len("module."):]], v)
            for k, v in sd.items()):
        fail("convert: the step-0 checkpoint is not the reference weights")
    reset_counts()
    res = train_cli.main([*args, f"ckpt={path}", f"data.batch_size={BATCH}",
                          "data.train_steps=1", "log_every=1",
                          f"results_dir={os.path.join(tmp, 'finetune')}"])
    torch.cuda.synchronize()
    counts = read_counts()
    fresh = sample_cli.build_model(cfg, device="cuda")
    fresh.load_state_dict(sample_cli.load_state_dict(res["checkpoint"]),
                          strict=True)
    (rec,) = res["records"]
    print(f"convert: {conv_s:.2f} s to {os.path.basename(path)}; one "
          f"fine-tuning step from it: loss {rec['loss']:.4f}, K1, K2, plain "
          f"{counts}; its EMA loads strict", flush=True)
    if rec["step"] != 1 or not math.isfinite(rec["loss"]):
        fail(f"convert: the fine-tuning step logged {rec}")
    if counts != (2 * DEPTH, DEPTH, 0, 0):
        fail(f"convert: K1 / K2 / plain {counts}")
    return dict(k1=counts[0], k2=counts[1], seconds=conv_s)


def modes_kernel_phase(gen):
    """K1 / K2 with grouped B / C and without softplus: each case against
    the plain versions (``check_kernel_case`` / ``check_bwd_case``: one
    launch a call, K2 bit-equal twice), then the times at the flagship shape
    (bf16, fused gate) beside the plain versions' and the bounds."""
    import torch
    from zigma_tpu_torch.ops.scan_cuda import (selective_scan_bwd_cuda,
                                               selective_scan_fwd_cuda)
    from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                    selective_scan_ref)
    f, bf = torch.float32, torch.bfloat16
    fs = FLAGSHIP
    small = dict(batch=2, L=300, D=1536, N=16)
    cases = [
        *((f"G={G} flagship bf16 fused", fs, G, bf, True, True, False, False)
          for G in MODES_GROUPS),
        ("no softplus flagship bf16 fused", fs, 1, bf, True, False, False,
         False),
        # a group's tail block: H = 48 channels against K1's 64 and K2's 32
        # a block
        ("G=32 (H=48) L=300 bf16 fused", small, 32, bf, True, True, False,
         False),
        ("G=32 (H=48) L=300 fp32 unfused", small, 32, f, False, True, False,
         False),
        # a group's B / C 17 elements apart: copies narrower than a row's
        ("G=2 N=17 L=129 D=100 bf16 fused", dict(batch=2, L=129, D=100,
                                                 N=17), 2, bf, True, True,
         False, False),
        ("G=2 N=17 L=129 D=100 fp32 unfused", dict(batch=2, L=129, D=100,
                                                   N=17), 2, f, False, True,
         False, False),
        ("G=4 N=64 L=1000 D=256 fp32 fused", dict(batch=2, L=1000, D=256,
                                                  N=64), 4, f, True, True,
         False, False),
        ("G=4 mixed rank L=300 bf16 fused", small, 4, bf, True, True, True,
         False),
        ("G=4 strided L=300 bf16 fused", small, 4, bf, True, True, False,
         True),
        ("no softplus G=4 L=300 fp32 unfused", small, 4, f, False, False,
         False, False),
    ]
    timed = {}
    for name, shp, G, dtype, fused, softplus, mixed, strided in cases:
        kw = dict(dtype=dtype, fused=fused, strided=strided, groups=G,
                  softplus=softplus, mixed=mixed)
        _, errs = check_kernel_case(f"K1 {name}", gen, **shp, with_x0=True,
                                    **kw)
        d, carries, errs2 = check_bwd_case(f"K2 {name}", gen, **shp, **kw)
        if shp is fs:
            timed[name] = (d, carries, G, softplus, errs["y"],
                           max(errs2.values()))
    rows = {}
    B_, L, D, N = fs.values()
    for name, (d, carries, G, softplus, y_err, bwd_err) in timed.items():
        fwd = (d["u"], d["delta"], d["A"], d["B"], d["C"])
        bwd = (d["u"], d["delta"], d["bias"], *fwd[2:], carries, d["gy"],
               None, d["Dskip"], d["z"])
        tag = "no_softplus" if not softplus else f"G{G}"
        with torch.no_grad():
            for kernel, call, plain, work, err in (
                    ("K1", lambda: selective_scan_fwd_cuda(
                        *fwd, d["bias"], d["Dskip"], d["z"],
                        return_carries=False, delta_softplus=softplus),
                     lambda: selective_scan_ref(*fwd, d["Dskip"], d["z"],
                                                d["bias"], softplus),
                     k1_work(B_, L, D, N, 2, groups=G, softplus=softplus),
                     y_err),
                    ("K2", lambda: selective_scan_bwd_cuda(
                        *bwd, delta_softplus=softplus),
                     lambda: selective_scan_bwd_ref(
                         *bwd, delta_softplus=softplus),
                     k2_work(B_, L, D, N, 2, groups=G, softplus=softplus),
                     bwd_err)):
                reset_counts()
                ms = cuda_ms(call, reps=20 if kernel == "K1" else 10)
                plain_ms = cuda_ms(plain, reps=1, groups=3)
                bound_ms, bound_by, how = least_time(*work)
                rows[f"{kernel} {tag}"] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=err, launches_a_call=1)
                print(f"{kernel} {name} at {tuple(fs.values())}: {ms:.4f} ms "
                      f"({ms / bound_ms:.2f}x the bound {bound_ms:.4f} ms by "
                      f"{bound_by}: {how}); plain {plain_ms:.3f} ms",
                      flush=True)
    return rows


def torch_backend_case(name, gen, backend, shp, complex_=False,
                       static=False, chunk=128):
    """``selective_scan`` (fp32, D and z, ``delta_bias``, softplus) under
    autograd through ``backend`` against the plain sequential versions on
    the same inputs: y and every gradient within TOL_TORCH_SCAN of max
    |ref|.  The real plain gradient is ``selective_scan_bwd_ref``'s from the
    plain forward's chunk starts; a complex one is torch autograd's through
    ``selective_scan_ref``.  Exactly one call of the backend, and no K1 /
    K2 launch or plain call in it.  Returns (inputs, the call's ms without
    a gradient and with one, worst error)."""
    import torch
    from zigma_tpu_torch.ops.scan_chunked import (selective_scan_assoc,
                                                  selective_scan_chunked)
    from zigma_tpu_torch.ops.selective_scan import (selective_scan,
                                                    selective_scan_bwd_ref,
                                                    selective_scan_ref)
    batch, L, D, N = shp.values()
    d = scan_inputs(gen, batch, L, D, N, torch.float32)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    if complex_:
        d["A"] = torch.complex(d["A"], r(D, N))
        d["B"] = torch.complex(d["B"], r(batch, L, N))
        d["C"] = torch.complex(d["C"], r(batch, L, N))
    if static:
        d["B"], d["C"] = r(D, N), r(D, N)
    gy = r(batch, L, D)
    names = ("u", "delta", "A", "B", "C", "Dskip", "z", "bias")
    leaves = [d[k].detach().requires_grad_() for k in names]
    counter = {"chunked": selective_scan_chunked,
               "assoc": selective_scan_assoc}[backend]

    def run(grad):
        ls = leaves if grad else [t.detach() for t in leaves]
        out = selective_scan(*ls[:5], ls[5], ls[6], ls[7], True,
                             backend="auto" if backend == "assoc" or
                             N > 256 else backend, chunk=chunk)
        if grad:
            return out, torch.autograd.grad(out, leaves, gy)
        return out, None

    reset_counts()
    calls = counter.calls
    y, grads = run(True)
    torch.cuda.synchronize()
    if read_counts() != (0, 0, 0, 0) or counter.calls != calls + 1:
        fail(f"{name}: K1 / K2 / plain counts {read_counts()}, "
             f"{counter.calls - calls} {backend} calls: expected 0 and 1")
    if complex_:
        ref_leaves = [t.detach().requires_grad_() for t in leaves]
        y_ref, _, _ = selective_scan_ref(*ref_leaves[:5], ref_leaves[5],
                                         ref_leaves[6], ref_leaves[7], True)
        ref_grads = torch.autograd.grad(y_ref, ref_leaves, gy)
    else:
        with torch.no_grad():
            y_ref, carries, _ = selective_scan_ref(
                *(d[k] for k in names[:5]), d["Dskip"], d["z"], d["bias"],
                True)
            g = selective_scan_bwd_ref(
                d["u"], d["delta"], d["bias"], d["A"], d["B"], d["C"],
                carries, gy, None, d["Dskip"], d["z"])
        ref_grads = (g[0], g[1], g[2], g[3], g[4], g[8], g[7], g[5])
    torch.cuda.synchronize()
    errs = {"y": excess(y, y_ref, 0.0)}
    for what, a, b in zip(names, grads, ref_grads):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name}: d{what} {tuple(a.shape)} {a.dtype} vs "
                 f"{tuple(b.shape)} {b.dtype}")
        errs[f"d{what}"] = ((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-30)).item()
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"{name:38s} one {backend} call, 0 K1 / K2, vs plain of max |ref|: "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    if not worst[1] <= TOL_TORCH_SCAN:
        fail(f"{name}: {worst[0]} {worst[1]:.3e} of max |ref| > "
             f"{TOL_TORCH_SCAN}")
    with torch.no_grad():
        ms = cuda_ms(lambda: run(False), reps=1, groups=3)
    ms_grad = cuda_ms(lambda: run(True), reps=1, groups=3)
    del leaves, grads, ref_grads
    torch.cuda.empty_cache()
    return d, ms, ms_grad, worst[1]


def torch_backends_phase(gen, k1_ms, k2_ms):
    """The chunked backend at the flagship shape, real and complex64; auto
    at d_state 512 (to chunked); static B / C (auto: assoc); each against
    the plain versions, timed beside K1 / K2 at the flagship."""
    rows = {}
    for name, backend, shp, cplx, static in (
            ("chunked flagship fp32", "chunked", FLAGSHIP, False, False),
            ("chunked flagship complex64", "chunked", FLAGSHIP, True, False),
            ("auto N=512 (chunked) fp32", "chunked", WIDE_STATE, False,
             False),
            ("static B/C (assoc) fp32", "assoc", STATIC_BC, False, True)):
        _, ms, ms_grad, err = torch_backend_case(name, gen, backend, shp,
                                                 cplx, static)
        rows[name] = dict(shape=tuple(shp.values()), ms=ms,
                          ms_with_grad=ms_grad, max_rel_err=err)
        print(f"{name} at {tuple(shp.values())}: {ms:.3f} ms forward, "
              f"{ms_grad:.3f} ms forward + backward"
              + (f" (K1 {k1_ms:.4f} ms, K1 + K2 {k1_ms + k2_ms:.4f} ms at "
                 f"the flagship bf16)" if shp is FLAGSHIP else ""),
              flush=True)
    return rows


def chunked_train_phase(gen, tr, tmp):
    """``cli.train`` on the flagship with ``model.params.scan_backend=
    chunked``, batch 16, CHUNKED_STEPS steps, and the same through K1 / K2,
    both from one step-0 checkpoint whose weights (the flagship's init plus
    0.02 of normal noise, through ``cli.convert``) open every adaLN gate, so
    that the scan reaches the loss from the first step: no K1 / K2 launch
    through chunked, exactly 48 / 24 a step through the kernels, the losses
    within TOL_CHUNKED_LOSS of each other (relative), steps/s beside each
    other and the train phase's."""
    import torch
    from zigma_tpu_torch.cli import convert as convert_cli
    from zigma_tpu_torch.cli import sample as sample_cli
    args = ["model=zigzag8_b1_pe2", "data=synthetic"]
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 args)
    model = sample_cli.build_model(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        sd = {f"module.{k}": (v + 0.02 * torch.randn(
            v.shape, generator=gen, device="cuda")).cpu()
              for k, v in model.state_dict().items()}
    del model
    pt = os.path.join(tmp, "open_gates.pt")
    torch.save({"model": sd, "ema": sd}, pt)
    ckpt = convert_cli.main(["--ckpt", pt, "--out",
                             os.path.join(tmp, "converted"), *args])
    runs = {}
    for name, extra, k1, k2 in (
            ("chunked scan", ["model.params.scan_backend=chunked"], 0, 0),
            ("K1 / K2 scan", [], 2 * DEPTH, DEPTH)):
        _, _, runs[name] = train_cli_phase(
            name, [*args, f"ckpt={ckpt}", *extra], BATCH, k1, k2,
            os.path.join(tmp, name.split()[0].replace("/", "")),
            steps=CHUNKED_STEPS)
    ch, kk = runs["chunked scan"], runs["K1 / K2 scan"]
    rel = (max(abs(a - b) for a, b in zip(ch["losses"], kk["losses"]))
           / max(map(abs, kk["losses"])))
    print(f"chunked scan training from open gates: losses "
          f"{[round(v, 5) for v in ch['losses']]} against K1 / K2's "
          f"{[round(v, 5) for v in kk['losses']]}, within {rel:.3e} "
          f"(relative, limit {TOL_CHUNKED_LOSS}); {ch['steps_per_s']:.4f} "
          f"steps/s against {kk['steps_per_s']:.4f} (the train phase "
          f"{tr['steps_per_s']:.4f})", flush=True)
    if not rel <= TOL_CHUNKED_LOSS:
        fail(f"chunked scan training: losses {ch['losses']} against "
             f"{kk['losses']}")
    return dict(ch, max_rel_loss_diff=rel, kernel_steps_per_s=kk[
        "steps_per_s"])


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
                ints = re.findall(r"L[ib](\d+)E", m.group(2))
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
    phase("conv kernels (causal conv1d, forward and backward) at the "
          "flagship and video shapes")
    kc, kc_info = conv_kernel_phase(gen)
    phase("repairs: no delta_bias, cast A and D, 65537 sequences")
    repairs_phase(gen)
    phase("kernels at the 1024^2 sampling shapes")
    k1_1024 = s1024_kernel_phase(gen)
    phase("scan contract (core_x0 / core_full: K1 with x0 and the final "
          "state, K2 with g_last and dx0)")
    contract = scan_contract_phase(gen)
    phase(f"sequence parallel ({SEQ_SHARDS} virtual shards of the flagship "
          f"scan)")
    sp = seq_parallel_phase(gen)
    phase(f"kernels at the pipelined microbatch shape "
          f"{tuple(MICROBATCH.values())}")
    kmb = microbatch_kernel_phase(gen)
    with tempfile.TemporaryDirectory() as tmp:
        phase("sample (main path of the serving slice)")
        model, x, t, e2e = main_path_phase(gen, tmp)
        phase("train (main path of the training slice)")
        state, tr = train_phase(gen)
        with ram_dir() as rtmp:
            phase(f"chained training (chain_steps {CHAIN}: one CUDA graph "
                  f"of {CHAIN} flagship steps, replayed)")
            ctr = chained_train_phase(gen, rtmp)
        phase("grad check")
        grad_check_phase(gen, "flagship-width depth 2", (2, 4, 32, 32),
                         depth=2, img_dim=32, patch_size=1,
                         scan_type="zigzagN8")
        with ram_dir() as rtmp:
            phase("distributed training (world size 1 over NCCL: DDP, "
                  "FSDP2, TP-1; torch.distributed.run; SIGTERM)")
            dtr = dist_train_phase(tr, rtmp)
            phase("distributed sampling (world size 1 over NCCL)")
            dsm = dist_sample_phase(dtr["DDP"]["ckpt"], rtmp)
        with ram_dir() as rtmp:
            phase("selective remat (scan_out, dots, scan_out+dots)")
            rm = remat_phase(gen, tr, rtmp)
            phase("selective remat grad check (scan_out, depth 2 fp32)")
            remat_grad_check_phase(gen)
            phase(f"pipeline (1 stage over NCCL, {PIPE_MICROBATCHES} "
                  f"microbatches)")
            pl = pipeline_phase(gen, rtmp)
            phase("convert (a reference .pt through cli.convert, then "
                  "cli.train ckpt=)")
            cv = convert_phase(gen, rtmp)
        phase("sample dopri5 (the default ode config)")
        dp = sample_dopri5_phase(e2e["ckpt"], tmp)
        phase("sample SDE (the default sde config)")
        sde = sample_sde_phase(e2e["ckpt"], tmp)
        phase("likelihood")
        lik = likelihood_phase(e2e["ckpt"], tmp)
        phase("video train (3d_zigzag8sst_b2)")
        vstate, vckpt, vtr = train_cli_phase(
            "video", VIDEO_ARGS, VIDEO_BATCH, 2 * DEPTH, DEPTH, tmp, "videos",
            conv_per_scan=True)
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
            "text", TEXT_ARGS, BATCH, 2 * DEPTH, DEPTH, tmp,
            conv_per_scan=True)
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
              f"training, 0 / 0 in sampling; the plain scans never; conv "
              f"forward / backward {s2tr['conv']} in training, "
              f"{s2s['conv']} in sampling", flush=True)
        if not all(s2tr["conv"]) or s2tr["conv"][0] != 2 * s2tr["conv"][1]:
            fail(f"ssm2 training: conv forward / backward {s2tr['conv']}, "
                 f"expected a backward for every two forwards (remat)")
        phase("SSD truth gate and times")
        ssd = ssd_truth_phase(gen)
        phase("1024^2 sampling (s1024_zigzag8_b2, patch 2 and 1)")
        s1024 = s1024_sample_phase(gen, tmp)
        phase("SD-VAE and CLIP text tower (full width, random weights)")
        codec, tower, vc = vae_clip_phase(tmp)
        from zigma_tpu_torch.data import tar_samples
        from zigma_tpu_torch.native import available as native_available
        tar_samples.served.update(native=0, tarfile=0)
        phase("prepare data (churches, coco and ucf101 shard layouts)")
        dirs, prep = prepare_shards_phase(tmp, codec, tower)
        del tower
        phase("train from shards (churches, coco, ucf101)")
        sh = shard_train_phase(dirs, tmp)
        print("steps/s from shards against synthetic data in this run: "
              + "; ".join(
                  f"{k} {sh[k]['steps_per_s']:.4f} against {syn['steps_per_s']:.4f}"
                  f" ({100 * (sh[k]['steps_per_s'] / syn['steps_per_s'] - 1):+.1f}%)"
                  for k, syn in (("churches", tr), ("coco", ttr),
                                 ("ucf101", vtr))), flush=True)
        phase("sample to pixels (SD-VAE decode; likelihood on data)")
        dec = decoded_sample_phase(gen, e2e["ckpt"], sh["ucf101"]["ckpt"],
                                   dirs, tmp)
        served = dict(tar_samples.served)
        print(f"tar shards served since the data phases began: {served} "
              f"(native reader built: {native_available()})", flush=True)
        if not native_available() or served["tarfile"] or not served["native"]:
            fail(f"the native tar reader did not serve every shard: {served}")
        phase("profile")

        def forward():
            with torch.inference_mode():
                model(x, t)

        profile_phase("one flagship forward (sampling)", forward)
        del model
        syn_busy, syn_wall, _ = profile_phase(
            f"one flagship training step (batch {BATCH})",
            train_step_fn(state, gen, (BATCH, 4, 32, 32)))
        del state
        sh_busy, sh_wall, _ = profile_phase(
            f"one flagship training step from churches shards (batch "
            f"{BATCH}, the loader's thread running)",
            shard_step_fn(sh["churches"].pop("state"), sh["churches"]["args"]))
        print(f"device idle share of a flagship step: synthetic "
              f"{100 * (1 - syn_busy / syn_wall):.1f}%, from shards "
              f"{100 * (1 - sh_busy / sh_wall):.1f}%", flush=True)
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
        del vmodel
        torch.cuda.empty_cache()
        phase("metric nets (Inception, DINOv2 ViT-L/14, I3D, LPIPS; full "
              "width, random weights)")
        mn = metric_nets_phase(tmp)
        phase("image eval through cli.train (churches shards, full menu)")
        ev = image_eval_phase(dirs, tmp)
        phase("video eval through cli.train (ucf101 shards, fid and fvd)")
        vev = video_eval_phase(dirs, tmp)
        phase("sample CLI metrics (churches validation split)")
        sm = sample_metrics_phase(e2e["ckpt"], dirs, tmp)
        phase("serve (cli.serve: the flagship over HTTP, batch 8, SD-VAE "
              "decode)")
        sv = serve_phase(gen, tmp)
    phase("LM (models.lm at state-spaces/mamba-130m's shape: prefill "
          "through K1, cached decode)")
    lm = lm_phase(gen)
    phase("scan modes (K1 / K2 with grouped B/C and without softplus; the "
          "chunked and associative backends; cli.train through chunked)")
    km = modes_kernel_phase(gen)
    tb = torch_backends_phase(gen, k1["ms"], k2["ms"])
    with ram_dir() as rtmp:
        ct = chunked_train_phase(gen, tr, rtmp)

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
                               "sample_1024_p1": s1024["p1"]["k1"],
                               "train_churches_shards": sh["churches"]["k1"],
                               "train_coco_shards": sh["coco"]["k1"],
                               "train_ucf101_shards": sh["ucf101"]["k1"],
                               "sample_decoded": dec["k1"],
                               "video_sample_decoded": dec["video_k1"],
                               "likelihood_validation": dec["lik_k1"],
                               "train_churches_eval": ev["k1"],
                               "train_ucf101_eval": vev["k1"],
                               "sample_metrics": sm["k1"],
                               "serve_request": sv["k1"],
                               "lm_generate": lm["k1"],
                               "scan_contract_call": contract["k1_per_call"],
                               "seq_parallel_4_shards": sp["k1"],
                               "train_ddp": dtr["DDP"]["k1"],
                               "train_fsdp2": dtr["FSDP2"]["k1"],
                               "train_tp1": dtr["TP-1"]["k1"],
                               "sample_distributed": dsm["k1"],
                               **{f"train_remat_{k}": v["k1"]
                                  for k, v in rm.items()},
                               "train_pipeline_1x4": pl["k1"],
                               "train_from_converted": cv["k1"],
                               "scan_modes_call": 1,
                               "train_chunked_backend": ct["k1"],
                               "train_chained": ctr["k1"]},
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             ms_with_carries=k1["ms_with_carries"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             video_shapes=kv["K1"], shapes_1024=k1_1024,
             lm_prefill_shape=lm["k1_lm"],
             seq_parallel_shard_shape={
                 k: v for k, v in sp["shard_rows"].items()
                 if k.startswith("K1")},
             pipeline_microbatch_shape=kmb["K1"],
             modes={k.split(" ", 1)[1]: v for k, v in km.items()
                    if k.startswith("K1")}),
        dict(name="selective_scan_bwd", route="cuda",
             source="zigma_tpu_torch/csrc/selective_scan_bwd.cu",
             replaces="zigma_tpu/ops/scan_pallas.py:418",
             launches=tr["k2"],
             launches_by_path={"train": tr["k2"], "likelihood": lik["k2"],
                               "video_train": vtr["k2"],
                               "text_train": ttr["k2"],
                               "train_churches_shards": sh["churches"]["k2"],
                               "train_coco_shards": sh["coco"]["k2"],
                               "train_ucf101_shards": sh["ucf101"]["k2"],
                               "likelihood_validation": dec["lik_k2"],
                               "train_churches_eval": ev["k2"],
                               "train_ucf101_eval": vev["k2"],
                               "serve_request": 0, "lm_generate": 0,
                               "scan_contract_call": contract["k2_per_call"],
                               "seq_parallel_4_shards": sp["k2"],
                               "train_ddp": dtr["DDP"]["k2"],
                               "train_fsdp2": dtr["FSDP2"]["k2"],
                               "train_tp1": dtr["TP-1"]["k2"],
                               **{f"train_remat_{k}": v["k2"]
                                  for k, v in rm.items()},
                               "train_pipeline_1x4": pl["k2"],
                               "train_from_converted": cv["k2"],
                               "scan_modes_call": 1,
                               "train_chunked_backend": ct["k2"],
                               "train_chained": ctr["k2"]},
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None,
             video_shapes=kv["K2"],
             seq_parallel_shard_shape={
                 k: v for k, v in sp["shard_rows"].items()
                 if k.startswith("K2")},
             pipeline_microbatch_shape=kmb["K2"],
             modes={k.split(" ", 1)[1]: v for k, v in km.items()
                    if k.startswith("K2")})]
    # the conv kernels: one forward a Mamba-1 mixer (remat recomputes it),
    # one backward; no TPU kernel stands behind them (XLA fuses the taps)
    conv_paths = {"train": tr["conv"], "sample": e2e["conv"],
                  "sample_dopri5": dp["conv"], "sample_sde": sde["conv"],
                  "likelihood": lik["conv"], "video_train": vtr["conv"],
                  "video_sample": vs["conv"], "text_train": ttr["conv"],
                  "text_sample": ts["conv"], "ssm2_train": s2tr["conv"],
                  "ssm2_sample": s2s["conv"],
                  "sample_1024_p2": s1024["p2"]["conv"],
                  "sample_1024_p1": s1024["p1"]["conv"],
                  "serve_request": sv["conv"], "lm_generate": lm["conv"]}
    flag = "x".join(map(str, CONV_SHAPES[0]))
    for i, which in enumerate(("fwd", "bwd")):
        kernels.append(dict(
            name=f"causal_conv1d_{which}", route="cuda",
            source="zigma_tpu_torch/csrc/causal_conv1d.cu", replaces=None,
            launches=tr["conv"][i],
            launches_by_path={k: v[i] for k, v in conv_paths.items()},
            max_abs_err=0.0 if which == "fwd" else None,
            **kc[flag][which], instance=kc_info[which],
            video_shapes={k: v[which] for k, v in kc.items() if k != flag}))
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
          f"{s1024['p1']['images_per_s']:.4f} (patch 1) images/s; "
          f"SD-VAE encode / decode x {BATCH} at 256^2 "
          f"{vc['vae_encode']['ms']:.2f} / {vc['vae_decode']['ms']:.2f} ms, "
          f"1024^2 decode {vc['vae_decode 1024^2 x 1']['ms']:.2f} ms; CLIP "
          f"{vc['clip_ms']:.3f} ms; prepare_data "
          f"{prep['prepare_images_per_s']:.1f} images/s; from shards: "
          + "; ".join(f"{k} training {v['steps_per_s']:.4f} steps/s, loader "
                      f"{v['loader_samples_per_s']:.1f} samples/s"
                      for k, v in sh.items())
          + f" (synthetic {tr['steps_per_s']:.4f} steps/s); decoded sampling "
          f"{dec['images_per_s']:.4f} images/s (undecoded "
          f"{e2e['images_per_s']:.4f}); metric nets "
          + ", ".join(f"{k} {v['ms']:.3f} ms" for k, v in mn["times"].items())
          + f"; image eval of {EVAL_N} {ev['total_s']:.2f} s (sampling "
          f"{ev['seconds']['sample']:.2f}), video eval of {VIDEO_EVAL_N} "
          f"{vev['total_s']:.2f} s; fid {ev['scores']['fid']:.4f}, fvd "
          f"{vev['scores']['fvd']:.4f} (random nets, random weights); serve "
          f"{sv['ms']:.1f} ms a request of {SERVE_BATCH}, "
          f"{sv['images_per_s']:.3f} images/s, warm-up {sv['warmup_s']} s; "
          f"LM prefill {lm['prefill_ms']:.3f} ms, decode {lm['step_ms']:.3f} "
          f"ms a token step, generate {lm['gen_tok_per_s']:.1f} tok/s, "
          f"{lm['kernels_per_step']} launches a decode step, idle "
          f"{100 * lm['idle_share']:.1f}%; sequence-parallel scan over "
          f"{SEQ_SHARDS} shards forward {sp['fwd_ms']:.4f} ms (unsharded "
          f"{sp['fwd_ms_unsharded']:.4f}), forward + backward "
          f"{sp['fwd_bwd_ms']:.4f} ms (unsharded "
          f"{sp['fwd_bwd_ms_unsharded']:.4f}); world size 1 over NCCL: "
          + "; ".join(f"{k} {v['steps_per_s']:.4f} steps/s, peak "
                      f"{v['peak_gb']:.2f} GB" for k, v in dtr.items())
          + f" (single process {tr['steps_per_s']:.4f} steps/s, peak "
          f"{tr['peak_gb']:.2f} GB); selective remat "
          + "; ".join(f"{k} {v['steps_per_s']:.4f} steps/s, peak "
                      f"{v['peak_gb']:.2f} GB" for k, v in rm.items())
          + f" (full remat {tr['steps_per_s']:.4f}, {tr['peak_gb']:.2f} GB); "
          f"pipeline 1 x {PIPE_MICROBATCHES} {pl['steps_per_s']:.4f} steps/s "
          f"(one process, drop-path 0: {pl['one']['steps_per_s']:.4f}); K1 / "
          f"K2 at the microbatch shape {kmb['K1']['ms']:.4f} / "
          f"{kmb['K2']['ms']:.4f} ms; "
          + "; ".join(f"{k} {v['ms']:.4f} ms" for k, v in km.items())
          + "; " + "; ".join(f"{k} {v['ms']:.3f} / {v['ms_with_grad']:.3f} ms"
                             for k, v in tb.items())
          + f" (forward / with the backward); chunked-scan training "
          f"{ct['steps_per_s']:.4f} steps/s; chained training (chain_steps "
          f"{CHAIN}, one CUDA graph a chain) {ctr['steps_per_s']:.4f} steps/s "
          f"against {ctr['plain_steps_per_s']:.4f} plain, device busy "
          f"{100 * ctr['busy_replay']:.1f}% of a replay against "
          f"{100 * ctr['busy_eager']:.1f}% of an eager step, capture "
          f"{ctr['capture_s']:.3f} s, peak {ctr['peak_gb']:.2f} GB against "
          f"{ctr['plain_peak_gb']:.2f} GB; conv kernels at the flagship "
          f"forward / backward {kc[flag]['fwd']['ms']:.4f} / "
          f"{kc[flag]['bwd']['ms']:.4f} ms (plain "
          f"{kc[flag]['fwd']['plain_ms']:.3f} / "
          f"{kc[flag]['bwd']['plain_ms']:.3f}, library "
          f"{kc[flag]['fwd']['library_ms']:.4f} / "
          f"{kc[flag]['bwd']['library_ms']:.4f})")
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
