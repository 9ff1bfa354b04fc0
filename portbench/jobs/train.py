"""``train``: eager training steps of one configuration through the
program's own entry point, ``zigma_tpu_torch.train.train_step`` (loss,
backward, clip, AdamW, EMA), one step a unit, on batches made from the
seed on the device ahead of the window (the family's inputs and
conditions, and the transport's t and x0, which the flow-matching loss
takes as injected draws).  The drop-path and label drops come from the
step generator, as in ``cli.train``.

The job keeps what its check needs (the weights and inputs it made, the
generator's state, the program's checked steps) and compares the program
with the family's ``reference.train_steps`` once the program's state is
freed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import faults as F, weights as W

__all__ = ["JOB", "Training", "widest_gap"]


EMA_ROUNDING = 16 * 2.0 ** -24  # 16 float32 half-ulps, relative


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
    root_span = "train_step"
    faults = {"unchanged_state": F.unchanged_state,
              "ema_unchanged": F.ema_unchanged,
              "half_batch": F.half_batch}

    def __init__(self, family, cfg, traffic, seed, device):
        from zigma_tpu_torch import train as T
        from zigma_tpu_torch.transport import create_transport
        self.family = family
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.batch = traffic["batch"]
        model, self.weights = family.build(cfg, seed, device)
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
        x = W.normal((n, *self.family.input_shape(self.cfg, B)), gen, dev)
        x0 = W.normal(x.shape, gen, dev)
        t = W.uniform((n, B), gen, dev)
        conds = self.family.conditions(self.cfg, n, B, gen, dev)
        return [{"x": x[i], "x0": x0[i], "t": t[i],
                 **{k: v[i] for k, v in conds.items()}} for i in range(n)]

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
        return self.family.reference.train_steps(
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


JOB = Training
