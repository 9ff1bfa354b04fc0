"""The two kinds of work a traffic mix can ask for, each driving the
program's own entry points.

``train``: ``zigma_tpu_torch.train.train_step`` (loss, backward, clip,
AdamW, EMA) one step a unit, on batches made from the seed on the device
ahead of the window (latents, labels, and the transport's t and x0, which
the loss takes as injected draws).  The drop-path and label drops come
from the step generator, as in ``cli.train``.

``sample``: ``transport.Sampler``'s ODE sampler over the model in the
inference cast, one batch a unit, from noise drawn on the device ahead of
the window, under ``torch.inference_mode`` as ``cli.sample`` runs it.

Each job keeps what its check needs (the weights and inputs it made,
the generator's state, the program's outputs) and compares the program
with ``reference`` once the program's state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference, weights as W

__all__ = ["KINDS", "Training", "Sampling", "model_kwargs",
           "widest_gap"]


EMA_ROUNDING = 16 * 2.0 ** -24  # 16 float32 half-ulps, relative


def model_kwargs(cfg: dict) -> dict:
    """The program's ZigMa arguments for a configuration file."""
    keys = ("in_channels", "embed_dim", "depth", "img_dim", "patch_size",
            "num_classes", "class_dropout_prob", "drop_path_rate",
            "norm_epsilon", "scan_type", "use_pe", "use_checkpoint",
            "video_frames", "tpe")
    kw = {k: cfg[k] for k in keys if k in cfg}
    kw["ssm_cfg"] = {k: cfg[k] for k in ("d_state", "d_conv", "expand")
                     if k in cfg}
    kw["dtype"] = {"bf16": torch.bfloat16, "fp32": torch.float32}[
        cfg["mixed_precision"]]
    return kw


def _input_shape(cfg: dict, batch: int) -> tuple:
    shape = (batch, cfg["in_channels"], cfg["img_dim"], cfg["img_dim"])
    if cfg.get("video_frames", 0):
        shape = (batch, cfg["video_frames"], *shape[1:])
    return shape


def _build(cfg: dict, seed: int, device):
    """The program's model with the benchmark's weights loaded, and those
    weights (float32, on the CPU) for the reference."""
    from zigma_tpu_torch.models.zigma import ZigMa
    model = ZigMa(**model_kwargs(cfg), device=device)
    made = W.make_weights({k: tuple(v.shape)
                           for k, v in model.state_dict().items()},
                          cfg, seed, device)
    model.load_state_dict(made)
    weights = {k: v.to("cpu", copy=True) for k, v in made.items()}
    del made
    if torch.device(device).type == "cuda":
        # the peak from here on is the program's: the draws above are not
        torch.cuda.reset_peak_memory_stats()
    return model, weights


def widest_gap(got, ref) -> float:
    """The worst leaf's gap between the norm of ``got[k]`` and that of
    ``ref[k]``, over the larger of the reference leaf's norm and the
    median leaf's."""
    ref_n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    floor = float(np.median(list(ref_n.values())))
    return max(abs(float(torch.linalg.vector_norm(got[k].double())) - n)
               / max(n, floor, 1e-30) for k, n in ref_n.items())


class Training:
    """Eager training steps of one configuration."""

    steps_per_unit = 1
    forwards_per_unit = 1

    def __init__(self, cfg, traffic, seed, device):
        from zigma_tpu_torch import train as T
        from zigma_tpu_torch.transport import create_transport
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.batch = traffic["batch"]
        model, self.weights = _build(cfg, seed, device)
        self.state = T.TrainState.create(model, lr=cfg["lr"],
                                         weight_decay=cfg["weight_decay"])
        base = T.make_diffusion_loss_fn(model, create_transport(),
                                        latent_scale=T.LATENT_SCALE)
        self.loss_fn = lambda batch, generator=None: base(
            batch, generator, t=batch["t"], x0=batch["x0"])
        self.gen = W.generator(device, seed, 2)
        self.gen_state = self.gen.get_state()
        self.pool = self._batches(traffic["pool"])
        self.losses, self.n_steps = [], 0

    def _batches(self, n):
        """``n`` batches of distinct rows, made on the device from the seed."""
        gen, dev, B = W.generator(self.device, self.seed, 1), self.device, self.batch
        x = W.normal((n, *_input_shape(self.cfg, B)), gen, dev)
        x0 = W.normal(x.shape, gen, dev)
        t = W.uniform((n, B), gen, dev)
        out = [{"x": x[i], "x0": x0[i], "t": t[i]} for i in range(n)]
        if self.cfg.get("num_classes", -1) > 0:
            y = torch.randint(0, self.cfg["num_classes"], (n, B), generator=gen,
                              device=dev)
            for i, b in enumerate(out):
                b["y"] = y[i]
        return out

    def unit(self):
        """One step; returns its loss."""
        from zigma_tpu_torch.train import state as S
        m = S.train_step(self.state, self.loss_fn,
                         self.pool[self.n_steps % len(self.pool)], self.gen,
                         self.cfg["max_grad_norm"], self.cfg["ema_rate"])
        self.n_steps += 1
        return m["loss"]

    def setup(self):
        """The checked steps through the window's own call, then warm-up
        units.  Keeps the first gradient as AdamW got it (its first moment
        over 1 - beta1 after one step), and the parameters and the EMA
        after the checked steps, on the CPU."""
        opt, named = self.state.opt, list(self.state.model.named_parameters())
        self.checked = [float(self.unit())]
        beta1 = opt.defaults["betas"][0]
        self.first_grads = {k: (opt.state[p]["exp_avg"] / (1 - beta1)).cpu()
                            for k, p in named}
        while self.n_steps < self.traffic["checked_steps"]:
            self.checked.append(float(self.unit()))
        self.after = {k: p.detach().to("cpu", copy=True) for k, p in named}
        self.ema_after = {k: p.detach().to("cpu", copy=True)
                          for k, p in self.state.ema.named_parameters()}
        for _ in range(self.traffic["warmup_units"]):
            self.unit()

    def record(self, loss):
        self.losses.append(loss)

    def samples(self, units):
        return units * self.batch

    def failed(self):
        """Samples of the window's steps whose loss is not finite."""
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum()) * self.batch

    def release(self):
        del self.state, self.loss_fn, self.pool, self.losses

    def _reference(self, precision):
        n = self.traffic["checked_steps"]
        batches = self._batches(self.traffic["pool"])
        return reference.train_steps(
            self.weights, [batches[i % len(batches)] for i in range(n)],
            self.cfg, self.device, self.gen_state, precision, self.cfg["lr"],
            self.cfg["max_grad_norm"], self.traffic.get("ref_rows"),
            self.cfg["ema_rate"])

    def _readings(self, losses, grads, after, ema, ref):
        """Each checked step's loss, the first gradient, and the parameters'
        and the EMA's change after the checked steps, each as its gap from
        the reference over the reference's size.  Both changes leave out
        the leaves whose reference gradient is under a thousandth of the
        median leaf's: they move by round-off alone.  The EMA's change
        also leaves out the leaves whose reference move is under 16 of
        float32's half-ulps of their values (``EMA_ROUNDING``): float32
        cannot hold it (norm weights and ``D`` near 1, ``A_log``, the
        ``dt`` biases)."""
        ref_losses, ref_grads, ref_last, ref_ema = ref
        out = {"loss_gap": max(abs(a - b) / abs(b)
                               for a, b in zip(losses, ref_losses)),
               "grad_gap": widest_gap(grads, ref_grads)}
        norms = {k: float(torch.linalg.vector_norm(g))
                 for k, g in ref_grads.items()}
        floor = 1e-3 * float(np.median(list(norms.values())))
        moved = [k for k, v in norms.items() if v >= floor]
        out["change_gap"] = widest_gap(
            {k: after[k] - self.weights[k] for k in moved},
            {k: ref_last[k] - self.weights[k] for k in moved})
        w0 = {k: self.weights[k].double() for k in moved}
        ref_move = {k: ref_ema[k].double() - w0[k] for k in moved}
        held = [k for k in moved if float(torch.linalg.vector_norm(
            ref_move[k])) >= EMA_ROUNDING * float(
                torch.linalg.vector_norm(w0[k]))]
        out["ema_change_gap"] = widest_gap(
            {k: ema[k].double() - w0[k] for k in held},
            {k: ref_move[k] for k in held})
        return out

    def check(self):
        """The program's checked steps against the float32 reference."""
        return self._readings(self.checked, self.first_grads, self.after,
                              self.ema_after, self._reference("fp32"))

    def control(self, precision="fp8"):
        """The reference in a lower precision, in the program's place."""
        return self._readings(*self._reference(precision),
                              self._reference("fp32"))


class Sampling:
    """Batches of the ODE sampler over one configuration."""

    def __init__(self, cfg, traffic, seed, device):
        from zigma_tpu_torch.transport import Sampler, create_transport
        from zigma_tpu_torch.utils.inference import cast_for_inference
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.batch = traffic["batch"]
        self.forwards_per_unit = traffic["num_steps"] - 1
        model, self.weights = _build(cfg, seed, device)
        if model.dtype != torch.float32:
            cast_for_inference(model, model.dtype)
        self.model = model.eval().requires_grad_(False)
        self.sample_fn = Sampler(create_transport()).sample_ode(
            sampling_method=traffic["method"], num_steps=traffic["num_steps"])
        gen = W.generator(device, seed, 1)
        self.noise = W.normal((traffic["pool"], *_input_shape(cfg, self.batch)),
                              gen, device)
        self.n, self.outputs = 0, []

    def unit(self):
        with torch.inference_mode():
            z = self.noise[self.n % len(self.noise)]
            # a copy: the last point alone, not the whole trajectory
            out = self.sample_fn(z, lambda x, t: self.model(x, t, None))[-1].clone()
        self.n += 1
        return out

    def setup(self):
        for _ in range(self.traffic["warmup_units"]):
            self.unit()
        self.n = 0

    def record(self, out):
        self.outputs.append(out)

    def samples(self, units):
        return units * self.batch

    def failed(self):
        return sum(int((~torch.isfinite(o.flatten(1))).any(1).sum())
                   for o in self.outputs)

    def release(self):
        del self.model, self.sample_fn

    def _pick(self):
        """One window batch and ``check_rows`` of its samples, from the seed."""
        rng = np.random.default_rng(self.seed)
        j = int(rng.integers(max(len(self.outputs), 1)))
        rows = torch.as_tensor(np.sort(rng.choice(
            self.batch, self.traffic["check_rows"], replace=False)),
            device=self.device)
        return j, rows

    def _readings(self, got, z, precision="fp32"):
        """The widest gap (max |got - ref| over max |ref|) and the
        root-mean-square gap (||got - ref|| over ||ref||) of the worst
        sample."""
        ref = reference.euler_sample(self.weights, z, None, self.cfg,
                                     self.traffic["num_steps"], precision)
        d, r = (got.float() - ref).flatten(1), ref.flatten(1)
        return {"sample_max_gap": float((d.abs().amax(1) / r.abs().amax(1)).max()),
                "sample_rms_gap": float((d.norm(dim=1) / r.norm(dim=1)).max())}

    def check(self):
        """The sampled rows of the sampled window batch against the float32
        reference from the same noise."""
        j, rows = self._pick()
        return self._readings(self.outputs[j][rows],
                              self.noise[j % len(self.noise)][rows])

    def control(self, precision="fp8"):
        """The reference in a lower precision, in the program's place."""
        j, rows = self._pick()
        z = self.noise[j % len(self.noise)][rows]
        return self._readings(reference.euler_sample(
            self.weights, z, None, self.cfg, self.traffic["num_steps"],
            precision), z)


KINDS = {"train": Training, "sample": Sampling}
