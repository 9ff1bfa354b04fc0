"""``sample``: batches of ``transport.Sampler``'s ODE sampler over the
program's model in the inference cast, one batch a unit, from noise drawn
on the device ahead of the window, under ``torch.inference_mode`` as
``cli.sample`` runs it.

The job keeps the noise and the program's outputs, and compares a sample
of them with the family's ``reference.euler_sample`` from the same noise
once the program's state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import faults as F, weights as W

__all__ = ["JOB", "Sampling"]


class Sampling:
    """Batches of the ODE sampler over one configuration."""

    root_span = "sampler.sample"
    faults = {"altered_answer": F.altered_answer}

    def __init__(self, family, cfg, traffic, seed, device):
        from zigma_tpu_torch.transport import Sampler, create_transport
        from zigma_tpu_torch.utils.inference import cast_for_inference
        self.family = family
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.batch = traffic["batch"]
        self.forwards_per_unit = traffic["num_steps"] - 1
        model, self.weights = family.build(cfg, seed, device)
        if model.dtype != torch.float32:
            cast_for_inference(model, model.dtype)
        self.model = model.eval().requires_grad_(False)
        self.sample_fn = Sampler(create_transport()).sample_ode(
            sampling_method=traffic["method"], num_steps=traffic["num_steps"])
        gen = W.generator(device, seed, 1)
        self.noise = W.normal(
            (traffic["pool"], *family.input_shape(cfg, self.batch)), gen,
            device)
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
        ref = self.family.reference.euler_sample(self.weights, z, None, self.cfg,
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
        return self._readings(self.family.reference.euler_sample(
            self.weights, z, None, self.cfg, self.traffic["num_steps"],
            precision), z)


JOB = Sampling
