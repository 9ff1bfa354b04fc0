"""Training entry point: ``python -m zigma_tpu_torch.cli.train model=... data=... [k=v ...]``

Counterpart of ``zigma_tpu/cli/train.py`` for one process on one card: the
same ``configs/`` tree and overrides, the same step (latent scale 0.18215,
velocity flow-matching loss, AdamW lr 1e-4 wd 0, global-norm clip 2.0
before the update, EMA 0.9999, stochastic depth and per-block remat from the
model config, the class-label drop when ``class_dropout_prob > 0``), the
same synthetic latent stream (``np.random.default_rng`` of the seed, so both
packages see the same latents, labels and caption features; video latents
(B, T, C, H, W) when ``data.video_frames > 0``; (B, n_context_token,
d_context) normal features for a text model, ``data.has_text``) and the same
webdataset stream for every other data group (``wds_batches``: latents,
class labels, caption features, video clips cut to the model's frames;
batches go to the card through pinned memory), JSONL metrics, periodic EMA vis samples
with the configured ODE method (a PNG grid, or an animated GIF for video)
and checkpoints in the reference layout
(``{results_dir}/{model}_{data}/checkpoints/{step:07d}.pt``), resuming from
the largest step (or ``ckpt=<path>``).

In-training evaluation (``data.sample_fid_n > 0`` every
``data.sample_fid_every`` steps; the shipped data configs set 5000 every
20000), as the JAX trainer's ``fid_eval``: ``sample_fid_n`` samples in
batches of ``data.sample_fid_bs`` from the EMA model through the configured
``ode`` sampler (caption features or labels from the real batch), divided
by the latent scale, decoded by the ``vae_kind`` codec and turned into
uint8 pixels, against as many real latents from a fresh pass over the
validation split (else from the training stream, with a warning), decoded
the same way.  The metric menu is ``eval_metrics`` (checked at start-up),
else the reference's: fid / is / kid / prdc / sfid / fdd for images, fid
and fvd for video; the feature nets come from local weights and run on the
training device, and each choice degrades as ``metrics/menu.py`` says
(patch statistics on latents or without weights).  Scores go to the
metric stream as ``eval/*``, the lowest FID to the checkpoint's
``best_fid``; a ``RuntimeError`` / ``ValueError`` in an eval is logged and
stops the evals, not the training.

Several processes (``ZIGMA_DISTRIBUTED=1`` under a launcher such as
``torchrun``, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``): the process group (NCCL on CUDA, gloo
on the CPU), each process on the card of its ``LOCAL_RANK``, a
``("data", "model")`` mesh with ``parallel.tp`` ranks on ``model``, and the
state placed by ``parallel.parallelize``: DDP over ``data``, or FSDP2 with
``parallel.fsdp`` (``parallel.fsdp_min_size``: smaller parameters stay
whole, 0 shards everything), after tensor parallelism over ``model`` when
``parallel.tp`` is above 1 or given on the command line (``parallel.tp=1``
runs that code path over a group of one).  ``parallel.fsdp`` or
``parallel.tp`` without a launcher run on a group of this one process.
Each process draws its own batch of ``data.batch_size`` (the global batch
is ``world x data.batch_size``), the streams and the step generator seeded
``global_seed + data rank``, the shards split by data rank: the ranks of
one model group read the same batch (and broadcast it from the group's
first rank all the same), and so do vis and the eval, whose metrics gather
each sample once, over ``data``.  The logged loss is the global batch's
mean and ``grad_norm`` the global norm.  Logging, metrics and vis images
come from rank 0 (and go to wandb with ``use_wandb``); every rank takes
part in vis sampling, the eval and the checkpoints, which rank 0 writes in
the one-process layout.

``parallel.pp`` (above 1, or given on the command line: ``parallel.pp=1``
runs the pipeline over a group of one) adds a ``pipe`` axis, innermost: a
GPipe over the block stack (``parallel/pipeline.py``), each rank a stage
in DDP over ``data``, ``parallel.pp_microbatches`` microbatches a step
(default one a stage).  The pipe ranks of a data rank share its batch; vis
and eval run the EMA gathered into a whole model on every rank.  JAX's
refusals stay (``parallel.tp`` with ``parallel.pp``, use_pe 3, drop-path
above 0, a depth or batch the stages or microbatches do not divide), and
FSDP2 with the pipeline is refused.

SIGTERM or SIGINT sets a flag; the loop stops at the next step (or chain)
boundary (every rank at the same one), logs ``signal N received:
checkpointing and exiting at step S``, writes the final checkpoint,
restores the previous handlers and returns, so the process exits 0.

``chain_steps`` N above 1 runs N steps a chain, as the JAX trainer's one
jitted ``lax.scan`` of N steps: on one card, one CUDA graph of the N whole
steps (``train.CapturedChain``: the first chain runs eagerly and is the
capture's warm-up, every later one is one replay; AdamW is built with
``capturable=True`` for the whole run); on the CPU and under a parallel
layout, N eager steps (``train.train_chain``; the collectives are not
captured, logged once at start-up).  A run's last ``train_steps mod N``
steps run eagerly.  Logging, checkpoints, vis and the eval fire at the
first chain boundary at or after each multiple of their cadence, and a
signal is seen at chain boundaries.  The draws follow the one step
generator, so a chained run takes the steps, draws and state of an
unchained one.

Runs on CUDA unless ``device=cpu`` is given; asking for CUDA on a machine
without it raises.
"""

from __future__ import annotations

import copy
import logging
import math
import os
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from zigma_tpu_torch.cli.sample import DEFAULT_CONFIG_DIR, build_model
from zigma_tpu_torch.config import config_to_dict, load_config
from zigma_tpu_torch.device import resolve_device
from zigma_tpu_torch.parallel import (data_rank, init_process_group,
                                      make_mesh, parallelize,
                                      pipeline_parallelize, replicate,
                                      same_in_group, shard_batch)
from zigma_tpu_torch.train import (LATENT_SCALE, CapturedChain, TrainState,
                                   latest_checkpoint, make_diffusion_loss_fn,
                                   restore_checkpoint, save_checkpoint,
                                   train_chain)
from zigma_tpu_torch.transport import Sampler, create_transport
from zigma_tpu_torch.utils.logging_utils import (MetricLogger,
                                                 array_to_image_grid,
                                                 create_logger,
                                                 write_video_grid)

__all__ = ["synthetic_batches", "wds_batches", "Evaluator", "eval_nets",
           "main"]


def synthetic_batches(cfg, seed: int = 0):
    """Random latent batches of the model's input shape, numpy float32, with
    class labels or normal caption features where the data group has them:
    the JAX trainer's stream (the same ``default_rng(seed)`` draws)."""
    rng = np.random.default_rng(seed)
    data = cfg.data
    bs = data["batch_size"]
    p = cfg.model.params
    shape = (bs, p["in_channels"], p["img_dim"], p["img_dim"])
    if data.get("video_frames", 0) > 0:
        shape = (bs, data["video_frames"], *shape[1:])
    while True:
        batch = {"x": rng.normal(size=shape).astype(np.float32)}
        if data.get("num_classes", -1) > 0:
            batch["y"] = rng.integers(0, data["num_classes"], (bs,))
        elif data.get("has_text"):
            batch["y"] = rng.normal(
                size=(bs, data.get("n_context_token", 77),
                      data.get("d_context", 768))).astype(np.float32)
        yield batch


def wds_batches(cfg, split: str = "train", mesh=None):
    """Batches ``{"x", "y"?}`` (numpy) from the data group's tar shards, as
    the JAX trainer's ``wds_batches`` makes them (train_acc.py:287-396): the
    ``latent`` or ``img_feature`` key, ``cls_id`` labels, or
    ``caption_feature`` (one random caption a sample when the features are
    (B, n_captions, tokens, d)); video: ``frame_feature256`` with a random
    window of ``video_frames`` frames a batch when the clips are longer.
    The shards split and the draws come from ``np.random.default_rng`` by
    data rank (``mesh``'s; without one, the process's): the JAX package's
    per-process stream, shared by the ranks of one model or pipe group.

    split: "train" (infinite, shuffled as configured) or "validation" (one
    finite pass, partial tail kept)."""
    from zigma_tpu_torch.data import WebDataModuleFromConfig

    data = config_to_dict(cfg.data)
    dm_keys = ("tar_base", "batch_size", "image_size", "train", "validation",
               "multinode", "is_video", "video_frames", "val_batch_size")
    rank, n_ranks = data_rank(mesh)
    dm = WebDataModuleFromConfig(**{k: data[k] for k in dm_keys if k in data},
                                 host_split=(rank, n_ranks))
    if split == "validation":
        loader = dm.val_dataloader()
    elif split == "train":
        loader = dm.train_dataloader()
    else:
        raise ValueError(f"unknown split {split!r}")
    rng = np.random.default_rng(rank)
    n_frames = int(data.get("video_frames", 0))
    for raw in loader:
        if n_frames > 0:
            x = np.asarray(raw["frame_feature256"])
            if x.shape[1] > n_frames:  # train_acc.py:309-317
                start = int(rng.integers(0, x.shape[1] - n_frames + 1))
                x = x[:, start:start + n_frames]
            batch = {"x": x}
            if "cls_id" in raw:
                batch["y"] = raw["cls_id"]
        else:
            batch = {"x": raw.get("latent", raw.get("img_feature"))}
            if "cls_id" in raw:
                batch["y"] = raw["cls_id"]
            elif "caption_feature" in raw:
                y = np.asarray(raw["caption_feature"])
                if y.ndim == 4:  # train_acc.py:297-302
                    idx = rng.integers(0, y.shape[1], y.shape[0])
                    y = y[np.arange(y.shape[0]), idx]
                batch["y"] = y
        yield batch


def _check_supported(cfg):
    chain = int(cfg.get("chain_steps", 1))
    if chain < 1:
        raise ValueError(f"chain_steps must be >= 1, got {chain}")


def eval_nets(suite) -> list:
    """The feature nets (``NetExtractor``) a metric suite runs, each once."""
    from zigma_tpu_torch.metrics import NetExtractor

    out = []
    for m in (suite.image, suite.video):
        if m is None:
            continue
        for fn in (*m.extractors.values(), m.logits_extractor):
            if isinstance(fn, NetExtractor) and fn not in out:
                out.append(fn)
    return out


class Evaluator:
    """The in-training evaluation, counterpart of the JAX trainer's
    ``fid_eval`` (zigma_tpu/cli/train.py; train_acc.py:507-646).  The codec
    and the metric suite are built at the first call and reset for each
    later one.  ``__call__(ema)`` returns ``(scores, seconds)``: the suite's
    scores ({} when the validation split gave no batch) and the eval's host
    clock split into ``sample`` (noise to latents on the device),
    ``decode`` (the codec, real and fake, its copies included), ``host``
    (device -> host copies of the samples, uint8 conversion, the nets'
    input and output copies, the moments), each net's own seconds under
    ``nets`` and ``compute`` (the statistics from the moments, on the
    host)."""

    def __init__(self, cfg, device, logger, train_batches, sample_fn,
                 latent_scale, seed: int, grad_free=torch.inference_mode,
                 mesh=None):
        self.cfg, self.device, self.logger = cfg, device, logger
        # across processes: the real batches are the model group's first
        # rank's, and the metrics gather over data, each sample once
        self.mesh = mesh
        self.grad_free = grad_free  # the context the sampling runs in
        self.train_batches, self.sample_fn = train_batches, sample_fn
        self.latent_scale = latent_scale
        self.n = int(cfg.data.get("sample_fid_n", 0) or 0)
        self.bs = int(cfg.data.get("sample_fid_bs", 4))
        self.video = cfg.data.get("video_frames", 0) > 0
        self.choices = cfg.data.get("eval_metrics") or cfg.get("eval_metrics")
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.suite = self.codec = None
        self.warned_train_reals = False

    def _build(self):
        from zigma_tpu_torch.data.vae import IdentityCodec, get_codec
        from zigma_tpu_torch.metrics import build_metric_suite

        codec = get_codec(self.cfg.get("vae_kind", "auto"),
                          device=self.device)
        # keyed on pixels, not on weights alone: raw float latents would
        # break the nets' 3-channel uint8 contract, so they take patch
        # statistics
        self.in_pixels = not isinstance(codec, IdentityCodec)
        suite = build_metric_suite(choices=self.choices, video=self.video,
                                   in_pixels=self.in_pixels,
                                   logger=self.logger, device=self.device)
        if suite.empty:
            raise RuntimeError(
                "no evaluation metric survived degradation "
                f"(requested {self.choices}, dropped {suite.dropped})")
        if self.mesh is not None:
            for m in (suite.image, suite.video):
                if m is not None:
                    m.group = self.mesh["data"].get_group()
        self.logger.info("eval metrics: %s%s", suite.choices,
                         f" (dropped: {list(suite.dropped)})"
                         if suite.dropped else "")
        self.suite, self.codec = suite, codec

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _real_batches(self):
        cfg = self.cfg
        if cfg.data.get("validation") and not cfg.data.get("synthetic"):
            return wds_batches(cfg, split="validation", mesh=self.mesh)
        if not self.warned_train_reals:
            self.warned_train_reals = True
            self.logger.warning(
                "no validation split configured: FID real batches come "
                "from (and are consumed out of) the training stream")
        return self.train_batches

    def __call__(self, ema):
        from zigma_tpu_torch.data.vae import decode_maybe_video
        from zigma_tpu_torch.metrics import to_uint8_images

        if self.suite is None:
            self._build()
        suite, nets = self.suite, eval_nets(self.suite)
        suite.reset()
        for net in nets:
            net.reset_timers()
        secs = dict(sample=0.0, decode=0.0, host=0.0, compute=0.0)
        real_gen, done = self._real_batches(), 0
        clock = time.perf_counter
        while done < self.n:
            try:
                batch = next(real_gen)
            except StopIteration:
                self.logger.warning("validation split exhausted at %d/%d "
                                    "FID samples", done, self.n)
                break
            batch = same_in_group(
                {k: np.asarray(v)[:self.bs] for k, v in batch.items()},
                self.mesh)
            real = batch["x"]
            t0 = clock()
            z = torch.randn(real.shape, generator=self.generator,
                            device=self.device)
            y = None
            if "y" in batch:
                y = torch.as_tensor(batch["y"]).to(self.device)
                if y.is_floating_point():
                    y = y.float()
            with self.grad_free():
                fake = self.sample_fn(z, lambda x, t: ema(x, t, y))[-1]
                if self.latent_scale:
                    fake = fake / self.latent_scale
            self._sync()
            t1 = clock()
            fake = fake.float().cpu().numpy()
            t2 = clock()
            # video latents are decoded frame by frame (the suite refolds
            # them for FVD, my_metrics.py:58-69)
            real_px = decode_maybe_video(self.codec, real)
            fake_px = decode_maybe_video(self.codec, fake)
            t3 = clock()
            if self.in_pixels:
                real_px, fake_px = (to_uint8_images(real_px),
                                    to_uint8_images(fake_px))
            suite.update_real(real_px)
            suite.update_fake(fake_px)
            t4 = clock()
            secs["sample"] += t1 - t0
            secs["decode"] += t3 - t2
            secs["host"] += (t2 - t1) + (t4 - t3)
            done += real.shape[0]
        if real_gen is not self.train_batches:
            real_gen.close()
        if done == 0:
            # compute() on no statistics is undefined: skip the eval
            self.logger.warning("FID eval skipped: validation split yielded "
                                "no batches")
            return {}, secs
        t0 = clock()
        scores = suite.compute()
        secs["compute"] = clock() - t0
        secs["nets"] = {net.name: net.seconds for net in nets}
        secs["host"] -= sum(net.seconds for net in nets)
        return scores, secs


def _to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device`` (through pinned memory, without
    waiting, on CUDA); floating arrays as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.is_floating_point():
            t = t.float()
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def main(argv=None) -> dict:
    """Train.  Returns ``{"state", "records", "checkpoint", "run_dir",
    "evals", "metric_suite", "signal", "chain", "generator"}``: the final
    ``TrainState``, the logged metric records (``step``, ``loss``,
    ``grad_norm``, ``steps_per_sec``), the final checkpoint's path, one
    record an eval (``step`` with ``scores`` and ``seconds`` as
    ``Evaluator`` returns them, or ``error``), the eval's metric suite
    (None without one), the signal that stopped the run early (None when
    it ran to its end), the ``CapturedChain`` of a captured run (None
    otherwise) and the step generator (the draws of the steps and of
    vis)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = DEFAULT_CONFIG_DIR
    if argv and argv[0].startswith("--config-dir="):
        config_dir = argv.pop(0).split("=", 1)[1]
    cfg = load_config(config_dir, "default", argv)
    _check_supported(cfg)
    fid_every = int(cfg.data.get("sample_fid_every", 0) or 0)
    fid_n = int(cfg.data.get("sample_fid_n", 0) or 0)
    if fid_n and fid_every:
        # a typo'd eval_metrics or fvd on an image run fails before step 1
        from zigma_tpu_torch.metrics import validate_choices

        validate_choices(
            cfg.data.get("eval_metrics") or cfg.get("eval_metrics"),
            video=cfg.data.get("video_frames", 0) > 0)
    device = resolve_device(cfg.get("device"))
    par = cfg.get("parallel") or {}
    tp = int(par.get("tp", 1) or 1)
    fsdp = bool(par.get("fsdp"))
    fsdp_min = (65536 if par.get("fsdp_min_size") is None
                else int(par["fsdp_min_size"]))
    pp = int(par.get("pp", 1) or 1)
    # tensor parallelism or the pipeline where asked for: above 1, or given
    # explicitly (1 then runs the code path over a group of one)
    given = {a.split("=", 1)[0].lstrip("+") for a in argv}
    tp_asked = tp > 1 or "parallel.tp" in given
    pp_asked = pp > 1 or "parallel.pp" in given
    if pp_asked:
        if tp_asked:
            raise ValueError("parallel.tp and parallel.pp cannot be combined")
        if fsdp:
            raise ValueError("parallel.fsdp with parallel.pp is not "
                             "supported: each stage runs in DDP over data")
        if float(cfg.model.params.get("drop_path_rate", 0.1)) > 0:
            raise ValueError("stochastic depth is not supported under "
                             "pipeline parallelism; set "
                             "model.params.drop_path_rate=0")
    launched = bool(os.environ.get("ZIGMA_DISTRIBUTED"))
    placed = launched or fsdp or tp_asked or pp_asked
    owns_group = init_process_group(device, launched) if placed else False
    try:
        return _train(cfg, device, placed, tp, tp_asked,
                      pp if pp_asked else None, fsdp, fsdp_min, fid_every,
                      fid_n)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(cfg, device, placed, tp, tp_asked, pp, fsdp, fsdp_min,
           fid_every, fid_n) -> dict:
    mesh = make_mesh(model=tp, pipe=pp) if placed else None
    rank = dist.get_rank() if placed else 0

    run_dir = os.path.join(
        cfg.get("results_dir", "outputs"),
        f"{cfg.model.get('name', 'model')}_{cfg.data.get('name', 'data')}")
    logger = create_logger(run_dir if rank == 0 else None)
    if rank:
        logger.setLevel(logging.WARNING)
    mlog = (MetricLogger(run_dir, use_wandb=bool(cfg.get("use_wandb")))
            if rank == 0 else None)
    logger.info("config: %s", dict(cfg))

    # one init on every rank (broadcast from rank 0 below); the streams
    # and the step generator of each data rank its own
    init_gen = torch.Generator(device=device).manual_seed(
        int(cfg.get("global_seed", 0)))
    seed = int(cfg.get("global_seed", 0)) + data_rank(mesh)[0]
    model = build_model(cfg, device=device, generator=init_gen)
    logger.info("parameters: %.2fM",
                sum(p.numel() for p in model.parameters()) / 1e6)
    transport = create_transport(
        cfg.train.get("path_type", "Linear"),
        cfg.train.get("prediction", "velocity"),
        cfg.train.get("loss_weight"),
        cfg.train.get("train_eps"), cfg.train.get("sample_eps"))
    ema = layout = None
    if placed:
        replicate(model)
        ema = copy.deepcopy(model)
        if pp is None:
            layout = parallelize(model, ema, mesh, tp_asked, fsdp, fsdp_min)
        else:
            n_mb = int((cfg.get("parallel") or {}).get("pp_microbatches", 0)
                       or 0) or None
            layout = pipeline_parallelize(model, ema, mesh, n_mb)
        logger.info("mesh %s over %s, tensor parallel %s, fsdp %s",
                    dict(zip(mesh.mesh_dim_names, mesh.shape)),
                    dist.get_backend(), tp_asked, fsdp)
    chain = int(cfg.get("chain_steps", 1))
    captured = chain > 1 and device.type == "cuda" and not placed
    state = TrainState.create(
        model, lr=float(cfg.optim.get("lr", 1e-4)),
        weight_decay=float(cfg.optim.get("wd", 0.0)), ema=ema, layout=layout,
        capturable=captured)

    ckpt_dir = os.path.join(run_dir, "checkpoints")
    resume = cfg.get("ckpt") or latest_checkpoint(ckpt_dir)
    if resume:
        logger.info("resuming from %s", resume)
        restore_checkpoint(resume, state)

    gen = (synthetic_batches(cfg, seed) if cfg.data.get("synthetic")
           else wds_batches(cfg, mesh=mesh))
    # the JAX trainer initialises from this one; vis samples with its shape
    # and labels, the model group's first rank's
    example = same_in_group(next(gen), mesh)
    latent_scale = LATENT_SCALE if cfg.get("is_latent", True) else None
    loss_fn = make_diffusion_loss_fn(state.train_module, transport,
                                     latent_scale=latent_scale)
    step_gen = torch.Generator(device=device).manual_seed(seed + 1)
    max_grad_norm = float(cfg.get("max_grad_norm", 2.0))
    ema_rate = float(cfg.get("ema_rate", 0.9999))
    graph = (CapturedChain(state, loss_fn, chain, step_gen, max_grad_norm,
                           ema_rate) if captured else None)
    if chain > 1:
        logger.info("chain_steps %d: %s", chain,
                    "one CUDA graph a chain" if captured else
                    "eager steps a chain (a parallel layout's collectives "
                    "are not captured)" if placed else "eager steps a chain")

    train_steps = int(cfg.data.get("train_steps", 100))
    sample_every = int(cfg.get("sample_every", 10_000))
    # in-training sampling (vis and eval) takes the ode group, euler-50
    # where it sets nothing
    ode_cfg = cfg.get("ode") or {}
    ode_fn = Sampler(transport).sample_ode(
        sampling_method=ode_cfg.get("sampling_method", "euler"),
        num_steps=int(ode_cfg.get("num_sampling_steps", 50)),
        atol=float(ode_cfg.get("atol", 1e-6)),
        rtol=float(ode_cfg.get("rtol", 1e-3)))
    vis_fn = ode_fn if sample_every and sample_every <= train_steps else None
    evaluator = (Evaluator(cfg, device, logger, gen, ode_fn, latent_scale,
                           seed + 2, lambda: _no_grad(state.layout), mesh)
                 if fid_n and fid_every else None)

    whole_ema = None  # under the pipeline: built at the first vis or eval

    def vis_ema():
        """The EMA as vis and eval call it: under the pipeline, every
        stage's part gathered into the whole model (every rank calls)."""
        nonlocal whole_ema
        if pp is None:
            return state.ema
        if whole_ema is None:
            whole_ema = build_model(cfg, device=device).requires_grad_(False)
        whole_ema.load_state_dict(state.layout.gather_state(state.ema))
        return whole_ema

    args = config_to_dict(cfg)

    # SIGTERM / SIGINT: stop at the next step boundary and checkpoint
    # (beyond the reference, which restarts from its last periodic one)
    stop_requested = []

    def _request_stop(signum, frame):
        del frame
        stop_requested.append(signum)

    prev_handlers = {s: signal.signal(s, _request_stop)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    # the ranks agree on the stop over a CPU group, without a device sync
    stop_group = (dist.new_group(backend="gloo")
                  if placed and dist.get_world_size() > 1 else None)
    log_every = int(cfg.get("log_every", 100))
    ckpt_every = int(cfg.get("ckpt_every", 50_000))
    logger.info("training for %d steps on %s", train_steps, device)
    records, evals, saved_at, path, stopped = [], [], None, None, 0
    t_log, last_log_step = time.perf_counter(), state.step
    try:
        while state.step < train_steps:
            stopped = _agreed_stop(stop_requested, stop_group)
            if stopped:
                logger.warning(
                    "signal %s received: checkpointing and exiting at step "
                    "%d", stopped, state.step)
                break
            prev_step = state.step
            n = min(chain, train_steps - prev_step)
            host = [next(gen) for _ in range(n)]
            if graph is not None and n == chain:
                metrics = graph(host)
            else:  # eager: one step, a chain off the card, a run's tail
                batches = [_to_device(b, device) for b in host]
                if mesh is not None:
                    batches = [shard_batch(b, mesh) for b in batches]
                metrics = train_chain(state, loss_fn, batches, step_gen,
                                      max_grad_norm, ema_rate)
            step = state.step

            def crossed(every):
                # the first chain boundary at or after each multiple of
                # ``every`` (step % every == 0 when a chain is one step)
                return every and step // every > prev_step // every

            if crossed(log_every):
                loss = float(_global_mean(metrics["loss"], state.layout))
                now = time.perf_counter()  # the float above synchronised
                sps = (step - last_log_step) / max(now - t_log, 1e-9)
                t_log, last_log_step = now, step
                rec = dict(step=step, loss=loss, steps_per_sec=sps,
                           grad_norm=float(metrics["grad_norm"]))
                records.append(rec)
                logger.info("step %d  loss %.4f  steps/sec %.2f", step, loss,
                            sps)
                if mlog is not None:
                    mlog.log(**rec)

            if crossed(ckpt_every):
                path = save_checkpoint(ckpt_dir, state, args)
                saved_at = (step, state.best_fid)
                logger.info("saved checkpoint %s", path)

            if vis_fn is not None and crossed(sample_every):
                try:  # every rank samples (FSDP2 and TP gather), 0 writes
                    z = torch.randn(example["x"].shape, generator=step_gen,
                                    device=device)
                    y = (torch.as_tensor(example["y"]).to(device)
                         if "y" in example else None)
                    ema = vis_ema()
                    with _no_grad(state.layout):
                        samples = vis_fn(z, lambda x, t: ema(x, t, y))[-1]
                    if latent_scale:
                        samples = samples / latent_scale
                    if rank == 0:
                        mlog.log_media(step, _write_vis(samples, run_dir,
                                                        step))
                except Exception as e:  # training survives a sampler blow-up
                    logger.warning("in-training sampling failed: %s", e)

            if evaluator is not None and crossed(fid_every):
                try:
                    scores, secs = evaluator(vis_ema())
                    logger.info("step %d  eval %s (%s)", step, scores, secs)
                    if mlog is not None:
                        mlog.log(step, **{f"eval/{k}": v
                                          for k, v in scores.items()})
                    evals.append(dict(step=step, scores=scores, seconds=secs))
                    if scores.get("fid", math.inf) < state.best_fid:
                        state.best_fid = float(scores["fid"])
                except (RuntimeError, ValueError) as e:
                    # RuntimeError: no feature net survived degradation;
                    # ValueError: a metric's sample-count precondition
                    # failed.  Neither fixes itself by the next interval,
                    # and neither may stop training (the final checkpoint
                    # must be saved)
                    logger.warning("eval unavailable: %s", e)
                    evals.append(dict(step=step, error=repr(e)))
                    fid_every = 0  # no retry every interval

        if saved_at != (state.step, state.best_fid):  # an eval may follow
            path = save_checkpoint(ckpt_dir, state, args)
            logger.info("final checkpoint %s", path)
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if mlog is not None:
            mlog.close()
    return {"state": state, "records": records, "checkpoint": path,
            "run_dir": run_dir, "evals": evals,
            "metric_suite": evaluator.suite if evaluator else None,
            "signal": stopped or None, "chain": graph, "generator": step_gen}


def _agreed_stop(stop_requested: list, group) -> int:
    """The signal that stops every rank at this step boundary, else 0."""
    sig = max(stop_requested, default=0)
    if group is None:
        return sig
    t = torch.tensor([sig])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t)


def _no_grad(layout):
    """``inference_mode``, or ``no_grad`` for an FSDP2 model, whose
    all-gathers write tensors that inference mode cannot version."""
    return (torch.no_grad() if layout is not None and layout.fsdp
            else torch.inference_mode())


def _global_mean(loss, layout):
    """The loss over the global batch: the mean over the data ranks."""
    if layout is None:
        return loss
    loss = loss.clone()
    dist.all_reduce(loss, group=layout.data_group)
    return loss / dist.get_world_size(layout.data_group)


def _write_vis(samples, run_dir: str, step: int) -> str:
    """A PNG grid of the vis samples, or an animated grid of every frame
    for video; returns its path."""
    from PIL import Image

    arr = samples.float().cpu().numpy()
    vis_dir = os.path.join(run_dir, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    if arr.ndim == 5:
        return write_video_grid(arr[:, :, :3],
                                os.path.join(vis_dir, f"{step:07d}.gif"))
    path = os.path.join(vis_dir, f"{step:07d}.png")
    Image.fromarray(array_to_image_grid(arr[:, :3])).save(path)
    return path


if __name__ == "__main__":
    main()
