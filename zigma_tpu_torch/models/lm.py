"""Mamba language model and autoregressive generation.

Counterpart of ``zigma_tpu/models/lm.py`` (the reference's
``mixer_seq_simple.py`` and ``utils/generation.py``): an embedding, a stack
of add -> norm -> mixer blocks (``Mamba`` with the v1 scan, or ``Mamba2``
with ``ssm_cfg["ssm_version"] == 2``), a final norm and an LM head tied to
the embedding, with the vocabulary padded to ``pad_vocab_size_multiple``.

Parameters carry the reference's torch names (``backbone.embedding.weight``,
``backbone.layers.{i}.norm.weight``, ``backbone.layers.{i}.mixer.*``,
``backbone.norm_f.weight``, the tied ``lm_head.weight``), so a
``state-spaces/mamba-*`` state dict loads with ``strict=True``; one without
``lm_head.weight`` loads too (the head is the embedding).

Decode: ``prefill`` runs the prompt through each mixer's parallel scan with
its final state (K1 on CUDA for Mamba-1) and returns the last position's
logits with the per-layer caches; ``step`` takes one token and the caches.
``generate`` is ``prefill`` then a Python loop of ``step`` calls under
``torch.inference_mode()``, with greedy, temperature or top-k selection
(``select``); the JAX package's loop is a ``lax.scan``.  ``generate`` runs
without a gradient; a ``prefill`` under autograd is differentiable through
each layer's final state too (K2 seeded by its cotangent on CUDA).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from zigma_tpu_torch.models.inits import normal_
from zigma_tpu_torch.models.mamba import Mamba, MambaCache
from zigma_tpu_torch.models.mamba2 import Mamba2, Mamba2Cache
from zigma_tpu_torch.models.zigma import _Norm
from zigma_tpu_torch.ops.norms import add_norm

__all__ = ["MixerModel", "MambaLMHeadModel", "generate", "select"]


class _LMBlock(nn.Module):
    """Add -> norm -> mixer prenorm block (mixer_seq_simple.py:21-48)."""

    def __init__(self, d_model: int, n_layer: int,
                 ssm_cfg: Optional[dict] = None, rms_norm: bool = False,
                 norm_epsilon: float = 1e-5, residual_in_fp32: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kind = "rms" if rms_norm else "layer"
        self.eps, self.residual_in_fp32 = norm_epsilon, residual_in_fp32
        self.norm = _Norm(d_model, bias=not rms_norm, device=device)
        cfg = dict(ssm_cfg or {})
        mixer_cls = {1: Mamba, 2: Mamba2}[int(cfg.pop("ssm_version", 1))]
        self.mixer = mixer_cls(d_model, scan_type="v1", n_layer=n_layer,
                               dtype=dtype, device=device, **cfg)

    def _prenorm(self, x, residual):
        return add_norm(x, self.norm.weight, self.norm.bias, residual,
                        kind=self.kind, eps=self.eps, prenorm=True,
                        residual_in_fp32=self.residual_in_fp32)

    def forward(self, x, residual):
        x, residual = self._prenorm(x, residual)
        return self.mixer(x), residual

    def step(self, x, residual, cache):
        x, residual = self._prenorm(x, residual)
        out, cache = self.mixer.step(x, cache)
        return out, residual, cache

    def prefill(self, x, residual):
        x, residual = self._prenorm(x, residual)
        out, cache = self.mixer.prefill(x)
        return out, residual, cache


class MixerModel(nn.Module):
    """Embedding + blocks + final norm (mixer_seq_simple.py:83-170)."""

    def __init__(self, d_model: int, n_layer: int, vocab_size: int,
                 ssm_cfg: Optional[dict] = None, norm_epsilon: float = 1e-5,
                 rms_norm: bool = False, residual_in_fp32: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.residual_in_fp32 = dtype, residual_in_fp32
        self.kind, self.eps = "rms" if rms_norm else "layer", norm_epsilon
        self.embedding = nn.Embedding(vocab_size, d_model, device=device)
        self.layers = nn.ModuleList(
            _LMBlock(d_model, n_layer, ssm_cfg, rms_norm, norm_epsilon,
                     residual_in_fp32, dtype, device)
            for _ in range(n_layer))
        self.norm_f = _Norm(d_model, bias=not rms_norm, device=device)

    def _embed(self, ids):
        return self.embedding(ids).to(self.dtype)

    def _final_norm(self, h, residual):
        return add_norm(h, self.norm_f.weight, self.norm_f.bias, residual,
                        kind=self.kind, eps=self.eps, prenorm=False,
                        residual_in_fp32=self.residual_in_fp32)

    def forward(self, input_ids):
        h, residual = self._embed(input_ids), None
        for layer in self.layers:
            h, residual = layer(h, residual)
        return self._final_norm(h, residual)

    def step(self, token_ids, caches):
        """One decode step: token_ids (batch, 1) and the per-layer caches."""
        h, residual, new = self._embed(token_ids), None, []
        for layer, cache in zip(self.layers, caches):
            h, residual, cache = layer.step(h, residual, cache)
            new.append(cache)
        return self._final_norm(h, residual), tuple(new)

    def prefill(self, input_ids):
        """The prompt through the parallel scans: (hidden (batch, L,
        d_model), caches)."""
        h, residual, caches = self._embed(input_ids), None, []
        for layer in self.layers:
            h, residual, cache = layer.prefill(h, residual)
            caches.append(cache)
        return self._final_norm(h, residual), tuple(caches)


class MambaLMHeadModel(nn.Module):
    """MixerModel + LM head tied to the embedding (mixer_seq_simple.py:
    173-227).  Weights from ``generator`` with the JAX package's inits:
    embedding N(0, 0.02), unit norms, each mixer's own init with
    ``out_proj`` rescaled by sqrt(n_layer)."""

    def __init__(self, d_model: int, n_layer: int, vocab_size: int,
                 ssm_cfg: Optional[dict] = None, rms_norm: bool = False,
                 residual_in_fp32: bool = False,
                 pad_vocab_size_multiple: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        m = pad_vocab_size_multiple
        self.vocab_size, self.padded_vocab = vocab_size, -(-vocab_size // m) * m
        self.dtype = dtype
        self.backbone = MixerModel(d_model, n_layer, self.padded_vocab,
                                   ssm_cfg=ssm_cfg, rms_norm=rms_norm,
                                   residual_in_fp32=residual_in_fp32,
                                   dtype=dtype, device=device)
        self.lm_head = nn.Linear(d_model, self.padded_vocab, bias=False,
                                 device=device)
        self.lm_head.weight = self.backbone.embedding.weight
        self._register_load_state_dict_pre_hook(_tie_head_on_load,
                                                 with_module=True)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        normal_(self.backbone.embedding.weight, 0.02, generator)
        for layer in self.backbone.layers:
            layer.norm.reset_parameters()
            layer.mixer.reset_parameters(generator)
        self.backbone.norm_f.reset_parameters()

    def _logits(self, h):
        return F.linear(h, self.lm_head.weight.to(h.dtype))

    def forward(self, input_ids, num_last_tokens: int = 0):
        """(batch, L) ids -> (batch, L, padded vocab) logits (of the last
        ``num_last_tokens`` positions when > 0)."""
        h = self.backbone(input_ids)
        if num_last_tokens > 0:
            h = h[:, -num_last_tokens:]
        return self._logits(h)

    def step(self, token_ids, caches):
        """(logits (batch, 1, V), caches) for one token a row."""
        h, caches = self.backbone.step(token_ids, caches)
        return self._logits(h), caches

    def prefill(self, input_ids):
        """(last-position logits (batch, V), caches) through the parallel
        scans."""
        h, caches = self.backbone.prefill(input_ids)
        return self._logits(h[:, -1]), caches

    def init_caches(self, batch: int):
        """Empty caches for ``step``, sized from each constructed mixer."""
        dev = self.lm_head.weight.device
        out = []
        for layer in self.backbone.layers:
            m = layer.mixer
            if isinstance(m, Mamba2):
                out.append(Mamba2Cache.init(batch, m.conv_dim, m.d_conv,
                                            m.nheads, m.headdim, m.d_state,
                                            device=dev))
            else:
                out.append(MambaCache.init(batch, m.d_inner, m.d_conv,
                                           m.d_state, device=dev))
        return tuple(out)


def _tie_head_on_load(module, state_dict, prefix, *args):
    """A state dict without the tied ``lm_head.weight`` loads: the head is
    the embedding."""
    emb = state_dict.get(prefix + "backbone.embedding.weight")
    if emb is not None:
        state_dict.setdefault(prefix + "lm_head.weight", emb)


def select(logits, temperature: float = 1.0, top_k: int = 0,
           noise: Optional[torch.Tensor] = None):
    """Next tokens from (batch, V) logits: greedy (argmax) when ``noise``
    is None, else a draw from softmax(logits / temperature), restricted to
    the ``top_k`` largest when > 0, by the Gumbel-max rule that
    ``jax.random.categorical`` uses: ``argmax(logits - log(-log(noise)))``
    with ``noise`` uniform in (0, 1], shaped like the logits."""
    logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if noise is None:
        return logits.argmax(-1)
    return (logits - torch.log(-torch.log(noise))).argmax(-1)


def generate(model: MambaLMHeadModel, prompt_ids, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 1.0, top_k: int = 0):
    """Prefill the prompt, then ``max_new_tokens`` decode steps.

    prompt_ids: (batch, L0) int on the model's device.  Greedy when
    ``generator`` is None, else temperature / top-k sampling with uniform
    noise from ``generator``.  Returns (batch, L0 + max_new_tokens).
    """
    if max_new_tokens <= 0:
        return prompt_ids
    tiny = torch.finfo(torch.float32).tiny
    with torch.inference_mode():
        logits, caches = model.prefill(prompt_ids)
        new = []
        for i in range(max_new_tokens):
            noise = None if generator is None else torch.rand(
                logits.shape, generator=generator,
                device=logits.device).clamp_(min=tiny)
            tok = select(logits, temperature, top_k, noise)
            new.append(tok)
            if i + 1 < max_new_tokens:
                logits, caches = model.step(tok[:, None], caches)
                logits = logits[:, 0]
        return torch.cat([prompt_ids, torch.stack(new, 1).to(prompt_ids.dtype)],
                         dim=1)
