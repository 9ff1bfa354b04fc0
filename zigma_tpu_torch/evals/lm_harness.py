"""LM evaluation: loglikelihood scoring and an lm-evaluation-harness adapter.

Counterpart of ``zigma_tpu/evals/lm_harness.py`` (the reference's
``evals/lm_harness_eval.py``).  The scoring runs on any model that maps
(batch, L) token ids to (batch, L, V) logits, such as
``models.lm.MambaLMHeadModel``, on the model's device and without a
gradient; ``MambaEvalLM`` adapts it to the harness's ``LM`` API and needs
the ``lm_eval`` package, which neither machine has: without it the adapter
raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["loglikelihood_batch", "loglikelihood_rolling", "MambaEvalLM"]


def _device(model):
    return next(model.parameters()).device


def loglikelihood_batch(model, input_ids, cont_mask):
    """Score continuations under teacher forcing.

    input_ids: (batch, L) ints, each row ``[context; continuation; pad]``
    (pad with any id; causality keeps padding out of the scores); cont_mask:
    (batch, L) bool, True exactly on the continuation positions.  Returns
    ``(logprob sums (batch,) float32, is_greedy (batch,) bool)`` on the
    model's device, the pair the harness's loglikelihood requests need.
    """
    dev = _device(model)
    with torch.inference_mode():
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=dev)
        m = torch.as_tensor(np.asarray(cont_mask), dtype=torch.bool,
                            device=dev)[:, 1:]
        lp = F.log_softmax(model(ids)[:, :-1].float(), dim=-1)
        tgt = ids[:, 1:]
        tok_lp = lp.gather(-1, tgt[..., None])[..., 0]
        sums = (tok_lp * m.float()).sum(-1)
        greedy = torch.where(m, lp.argmax(-1) == tgt, True).all(-1)
    return sums, greedy


def loglikelihood_rolling(model, token_ids, window: int,
                          stride: Optional[int] = None) -> float:
    """Full-text log-likelihood by sliding windows (the harness's
    ``loglikelihood_rolling``): each window scores its last ``stride``
    tokens (default ``window - 1``), so every token past the first window
    has ``window - stride`` tokens of context.  ``stride`` must be below
    ``window``: a window's first token is context only."""
    ids = np.asarray(token_ids, np.int64)
    stride = stride or window - 1
    if not 1 <= stride < window:
        raise ValueError(f"stride must be in [1, window-1], got {stride} "
                         f"for window {window}")
    total, pos, n = 0.0, 0, len(ids)  # pos: the last scored (or context) token
    while pos + 1 < n:
        end = min(pos + 1 + stride, n)
        start = max(0, end - window)
        chunk = ids[start:end]
        row = np.pad(chunk, (0, window - len(chunk)))
        mask = np.zeros(window, bool)
        mask[pos + 1 - start:len(chunk)] = True
        s, _ = loglikelihood_batch(model, row[None], mask[None])
        total += float(s[0])
        pos = end - 1
    return total


class MambaEvalLM:
    """lm-evaluation-harness ``LM`` adapter around the scorer:
    ``loglikelihood``, ``loglikelihood_rolling`` and ``generate_until``, as
    the reference registers them.  Needs ``lm_eval`` and a tokenizer."""

    def __init__(self, model, tokenizer, batch_size: int = 8,
                 max_length: int = 2048):
        try:
            import lm_eval  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "lm_eval is not installed; use loglikelihood_batch / "
                "loglikelihood_rolling / models.lm.generate directly") from e
        self.model, self.tokenizer = model, tokenizer
        self.batch_size, self.max_length = batch_size, max_length

    def _encode_pair(self, context: str, continuation: str):
        ctx = self.tokenizer.encode(context) if context else []
        full = self.tokenizer.encode(context + continuation)
        # the harness's rule: the continuation is full minus the context
        return full, len(ctx)

    def loglikelihood(self, requests) -> list:
        out = []
        pairs = [self._encode_pair(r.args[0], r.args[1]) for r in requests]
        for i in range(0, len(pairs), self.batch_size):
            chunk = pairs[i:i + self.batch_size]
            L = min(max(len(ids) for ids, _ in chunk), self.max_length)
            rows, masks = [], []
            for ids, nctx in chunk:
                removed = max(0, len(ids) - L)
                ids = ids[-L:]
                nctx = max(0, nctx - removed)
                rows.append(np.pad(np.asarray(ids, np.int64), (0, L - len(ids))))
                m = np.zeros(L, bool)
                m[nctx:len(ids)] = True
                masks.append(m)
            s, g = loglikelihood_batch(self.model, np.stack(rows),
                                       np.stack(masks))
            out.extend((float(a), bool(b)) for a, b in zip(s, g))
        return out

    def loglikelihood_rolling(self, requests) -> list:
        return [loglikelihood_rolling(self.model,
                                      self.tokenizer.encode(r.args[0]),
                                      window=self.max_length)
                for r in requests]

    def generate_until(self, requests) -> list:
        from zigma_tpu_torch.models.lm import generate

        out = []
        for r in requests:
            text, kwargs = r.args[0], (r.args[1] if len(r.args) > 1 else {})
            ids = torch.tensor([self.tokenizer.encode(text)],
                               device=_device(self.model))
            full = generate(self.model, ids,
                            int(kwargs.get("max_gen_toks", 128)))
            gen = self.tokenizer.decode(full[0, ids.shape[1]:].tolist())
            for stop in kwargs.get("until", []):
                gen = gen.split(stop)[0]
            out.append(gen)
        return out
