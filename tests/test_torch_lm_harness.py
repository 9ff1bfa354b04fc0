"""The port's LM scoring vs ``zigma_tpu.evals.lm_harness``.

The same perturbed tiny LM (weights through ``lm_state_dict_from_jax``) and
the same numpy token ids and masks go through both scorers.  Log-prob sums
within 1e-5 of max |jax| (fp32 log-softmax over the same logits, which
agree to ~3e-7, ``tests/test_torch_lm.py``); greedy flags equal.
"""

import jax
import numpy as np
import pytest
import torch

from zigma_tpu.evals.lm_harness import loglikelihood_batch as jax_ll_batch
from zigma_tpu.evals.lm_harness import loglikelihood_rolling as jax_ll_rolling
from zigma_tpu.models.lm import MambaLMHeadModel as JaxLM
from zigma_tpu_torch.convert import lm_state_dict_from_jax
from zigma_tpu_torch.evals import (MambaEvalLM, loglikelihood_batch,
                                   loglikelihood_rolling)
from zigma_tpu_torch.models.lm import MambaLMHeadModel

TOL = 1e-5
CFG = dict(d_model=32, n_layer=2, vocab_size=40, ssm_cfg={"d_state": 8},
           rms_norm=True, residual_in_fp32=True)


@pytest.fixture(scope="module")
def lms():
    jm = JaxLM(**CFG)
    ids = np.zeros((1, 8), np.int32)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.jit(jm.init)(jax.random.PRNGKey(0), ids))
    model = MambaLMHeadModel(**CFG)
    model.load_state_dict(lm_state_dict_from_jax(params))
    return jm, params, model.eval()


def test_loglikelihood_batch_matches_jax(lms):
    jm, params, model = lms
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 40, (3, 12)).astype(np.int32)
    mask = np.zeros((3, 12), bool)
    mask[0, 5:9] = mask[1, 1:12] = mask[2, 10:] = True
    # row 2's continuation is the greedy choice of its context, so the
    # greedy flag is true somewhere
    with torch.inference_mode():
        ids[2, 10] = int(model(torch.from_numpy(ids[2:3, :10]).long())[0, -1]
                         .argmax())
        ids[2, 11] = int(model(torch.from_numpy(ids[2:3, :11]).long())[0, -1]
                         .argmax())
    s, g = loglikelihood_batch(model, ids, mask)
    js, jg = jax_ll_batch(jm, params, ids, mask)
    js = np.asarray(js)
    assert s.dtype == torch.float32 and s.shape == (3,)
    assert np.abs(s.numpy() - js).max() <= TOL * np.abs(js).max()
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert bool(g[2])


@pytest.mark.parametrize("stride", [None, 3])
def test_loglikelihood_rolling_matches_jax(lms, stride):
    jm, params, model = lms
    toks = np.random.default_rng(3).integers(0, 40, 23)
    got = loglikelihood_rolling(model, toks, window=8, stride=stride)
    ref = jax_ll_rolling(jm, params, toks, window=8, stride=stride)
    assert abs(got - ref) <= TOL * abs(ref)
    # one window over the whole text scores every token after the first
    whole = loglikelihood_rolling(model, toks[:8], window=8)
    mask = np.ones((1, 8), bool)
    mask[0, 0] = False
    s, _ = loglikelihood_batch(model, toks[None, :8], mask)
    assert abs(whole - float(s[0])) <= 1e-6 * abs(whole)
    with pytest.raises(ValueError, match="stride"):
        loglikelihood_rolling(model, toks, window=8, stride=8)


def test_eval_adapter_needs_lm_eval(lms):
    with pytest.raises(RuntimeError, match="lm_eval is not installed"):
        MambaEvalLM(lms[2], tokenizer=None)
