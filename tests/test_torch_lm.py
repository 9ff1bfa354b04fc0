"""The port's Mamba LM and its decode vs the JAX package.

``zigma_tpu.models.lm.MambaLMHeadModel`` params (perturbed by 0.05 off the
init, so no weight sits at a constant) go through
``lm_state_dict_from_jax`` into ``zigma_tpu_torch.models.lm``; the same
numpy token ids go through both, the JAX side jitted.  Configs cover
``ssm_version`` 1 and 2, RMSNorm and LayerNorm, ``residual_in_fp32`` on and
off.

Tolerances, fp32: logits and caches within 1e-5 of max |jax| (the JAX
package's own step-vs-parallel bound is atol 2e-4, rtol 1e-3,
``tests/test_lm.py``; the first run here read at most 3e-7 of max |jax|:
the two packages differ in summation order only).  Generated ids are
equal; ``select`` with injected noise gives ``jax.random.categorical``'s
draw from the same uniform numbers.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.convert.torch_mamba_lm import load_hf_mamba_lm
from zigma_tpu.models.lm import MambaLMHeadModel as JaxLM
from zigma_tpu.models.lm import generate as jax_generate
from zigma_tpu.models.mamba import MambaCache as JaxMambaCache
from zigma_tpu.models.mamba import Mamba as JaxMamba
from zigma_tpu.models.mamba2 import Mamba2 as JaxMamba2
from zigma_tpu.models.mamba2 import Mamba2Cache as JaxMamba2Cache
from zigma_tpu_torch.convert import lm_state_dict_from_jax, load_mamba_lm
from zigma_tpu_torch.convert.from_jax import _mixer
from zigma_tpu_torch.convert.mamba_lm import lm_kwargs
from zigma_tpu_torch.models import Mamba, Mamba2
from zigma_tpu_torch.models.lm import MambaLMHeadModel, generate, select

TOL = 1e-5
D_MODEL, N_LAYER, VOCAB, PAD = 32, 2, 30, 8
CONFIGS = {
    "ssm1-rms-fp32res": dict(ssm_cfg={"d_state": 8}, rms_norm=True,
                             residual_in_fp32=True),
    "ssm1-layer": dict(ssm_cfg={"d_state": 8, "d_conv": 3}, rms_norm=False,
                       residual_in_fp32=False),
    "ssm2-rms": dict(ssm_cfg={"ssm_version": 2, "d_state": 16, "headdim": 16},
                     rms_norm=True, residual_in_fp32=False),
    "ssm2-layer-fp32res": dict(ssm_cfg={"ssm_version": 2, "d_state": 8,
                                        "headdim": 16, "ngroups": 2},
                               rms_norm=False, residual_in_fp32=True),
}
L = 9


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, f"{what}: {err:.3e} of max |jax| > {TOL}"


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)


def _jax_caches(cfg, batch):
    """Empty JAX caches from the explicit sizes (the JAX ``init_caches``
    reads defaults, not the mixers)."""
    s = dict(cfg["ssm_cfg"])
    d_inner, d_conv = 2 * D_MODEL, s.get("d_conv", 4)
    if s.get("ssm_version", 1) == 2:
        conv_dim = d_inner + 2 * s.get("ngroups", 1) * s["d_state"]
        return tuple(JaxMamba2Cache.init(batch, conv_dim, d_conv,
                                         d_inner // s["headdim"], s["headdim"],
                                         s["d_state"]) for _ in range(N_LAYER))
    return tuple(JaxMambaCache.init(batch, d_inner, d_conv, s["d_state"])
                 for _ in range(N_LAYER))


@pytest.fixture(scope="module", params=list(CONFIGS))
def lm(request):
    """(name, cfg, jax model, params, port model, ids) per config."""
    cfg = CONFIGS[request.param]
    jm = JaxLM(d_model=D_MODEL, n_layer=N_LAYER, vocab_size=VOCAB,
               pad_vocab_size_multiple=PAD, **cfg)
    ids = np.random.default_rng(0).integers(0, VOCAB, (2, L)).astype(np.int32)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), ids), 1)
    model = MambaLMHeadModel(D_MODEL, N_LAYER, VOCAB,
                             pad_vocab_size_multiple=PAD, **cfg)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return request.param, cfg, jm, params, model.eval(), ids


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_forward_matches_jax(lm):
    name, _, jm, params, model, ids = lm
    ref = jax.jit(lambda p, i: jm.apply(p, i))(params, ids)
    with torch.no_grad():
        got = model(_t(ids))
    assert got.shape == (2, L, 32) and got.dtype == torch.float32
    _close(got, ref, f"{name} logits")
    with torch.no_grad():
        _close(model(_t(ids), num_last_tokens=2), np.asarray(ref)[:, -2:],
               f"{name} last logits")


def test_prefill_and_steps_match_jax(lm):
    """Prefill logits and caches, and steps from empty caches over the
    prompt (logits at every position, the final caches), against JAX's."""
    name, cfg, jm, params, model, ids = lm
    jpre = jax.jit(lambda p, i: jm.apply(p, i, method=JaxLM.prefill))
    jstep = jax.jit(lambda p, t, c: jm.apply(p, t, c, method=JaxLM.step))
    jlog, jcaches = jpre(params, ids)
    with torch.inference_mode():
        plog, pcaches = model.prefill(_t(ids))
    _close(plog, jlog, f"{name} prefill logits")
    for i, (pc, jc) in enumerate(zip(pcaches, jcaches)):
        assert pc[0].dtype == pc[1].dtype == torch.float32
        _close(pc[0], jc[0], f"{name} prefill conv window {i}")
        _close(pc[1], jc[1], f"{name} prefill state {i}")
    caches, jc = model.init_caches(2), _jax_caches(cfg, 2)
    for t in range(L):
        with torch.inference_mode():
            slog, caches = model.step(_t(ids[:, t:t + 1]), caches)
        jlog_t, jc = jstep(params, ids[:, t:t + 1], jc)
        _close(slog, jlog_t, f"{name} step {t} logits")
    for i, (sc, j) in enumerate(zip(caches, jc)):
        _close(sc[0], j[0], f"{name} stepped conv window {i}")
        _close(sc[1], j[1], f"{name} stepped state {i}")
    # and the port's prefill is its own steps
    for (a0, a1), (b0, b1) in zip(pcaches, caches):
        _close(a0, b0, f"{name} prefill vs steps conv window")
        _close(a1, b1, f"{name} prefill vs steps state")


def test_generate_teacher_forced_and_greedy(lm):
    """Prefill of the first 4 tokens, then steps over the rest, give the
    forward's logits at every later position; greedy ids equal JAX's."""
    name, _, jm, params, model, ids = lm
    with torch.inference_mode():
        full = model(_t(ids))
        logits, caches = model.prefill(_t(ids[:, :4]))
        _close(logits, full[:, 3], f"{name} prefill position 3")
        for t in range(4, L):
            logits, caches = model.step(_t(ids[:, t:t + 1]), caches)
            _close(logits[:, 0], full[:, t], f"{name} teacher-forced {t}")
    got = generate(model, _t(ids[:, :5]), 6)
    ref = jax.jit(lambda p, i: jax_generate(jm, p, i, 6))(params, ids[:, :5])
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 5)])
def test_select_matches_jax_categorical(temperature, top_k):
    """``select`` with the uniform numbers behind ``jax.random.categorical``
    (its Gumbel-max draw) picks the same tokens; without noise, argmax."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((64, 40)).astype(np.float32) * 3
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, logits.shape, jnp.float32,
                                      minval=jnp.finfo(jnp.float32).tiny,
                                      maxval=1.0))
    lg = jnp.asarray(logits) / temperature
    if top_k:
        kth = jnp.sort(lg, axis=-1)[:, -top_k][:, None]
        lg = jnp.where(lg < kth, -jnp.inf, lg)
    ref = np.asarray(jax.random.categorical(key, lg, axis=-1))
    got = select(torch.from_numpy(logits), temperature, top_k,
                 torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), ref)
    if top_k:  # every draw among the top k
        top = np.argsort(-logits, axis=-1)[:, :top_k]
        assert all(g in row for g, row in zip(got.numpy(), top))
    np.testing.assert_array_equal(
        select(torch.from_numpy(logits), temperature, top_k).numpy(),
        logits.argmax(-1))


def test_sampled_generate_is_seeded_and_in_vocab():
    model = MambaLMHeadModel(D_MODEL, N_LAYER, VOCAB,
                             ssm_cfg={"d_state": 8},
                             generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[1, 2], [3, 4]])
    a, b = (generate(model, ids, 5, generator=torch.Generator().manual_seed(7),
                     temperature=1.0, top_k=5) for _ in range(2))
    assert a.shape == (2, 7) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < model.padded_vocab
    assert torch.equal(generate(model, ids, 0), ids)


@pytest.mark.parametrize("version", [1, 2])
def test_mixer_step_and_prefill_match_jax(version):
    """One mixer alone (the LM's v1 layout): prefill's output and cache,
    then 3 steps continuing from it, against JAX."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, D_MODEL)).astype(np.float32)
    if version == 1:
        jmix = JaxMamba(d_model=D_MODEL, d_state=8, scan_type="v1")
        mix = Mamba(D_MODEL, d_state=8, scan_type="v1")
    else:
        jmix = JaxMamba2(d_model=D_MODEL, d_state=8, headdim=16, ngroups=2)
        mix = Mamba2(D_MODEL, d_state=8, headdim=16, ngroups=2)
    params = _perturb(jax.jit(jmix.init)(jax.random.PRNGKey(1), x), 9)
    sd = {}
    _mixer(sd, "m", params["params"])
    mix.load_state_dict({k[2:]: v for k, v in sd.items()})
    jout, jc = jax.jit(lambda p, v: jmix.apply(p, v, method=type(jmix).prefill))(
        params, x[:, :4])
    with torch.inference_mode():
        out, c = mix.prefill(torch.from_numpy(x[:, :4]))
    _close(out, jout, f"v{version} prefill out")
    _close(c[0], jc[0], f"v{version} prefill conv window")
    _close(c[1], jc[1], f"v{version} prefill state")
    jstep = jax.jit(lambda p, v, cc: jmix.apply(p, v, cc,
                                                method=type(jmix).step))
    for t in range(4, 7):
        with torch.inference_mode():
            out, c = mix.step(torch.from_numpy(x[:, t:t + 1]), c)
        jout, jc = jstep(params, x[:, t:t + 1], jc)
        _close(out, jout, f"v{version} step {t}")
        _close(c[0], jc[0], f"v{version} step conv window")
        _close(c[1], jc[1], f"v{version} step state")
    with pytest.raises(ValueError, match="scan_type='v1'"):
        (Mamba(D_MODEL, scan_type="v2") if version == 1
         else Mamba2(D_MODEL, headdim=16, scan_type="v2")).prefill(
            torch.from_numpy(x))


def test_init_caches_read_the_mixers():
    """Cache sizes come from the constructed mixers (JAX's hard-codes the
    Mamba-2 defaults): a d_conv 3, two-group, d_state 8 model steps from
    its own empty caches."""
    model = MambaLMHeadModel(D_MODEL, 2, VOCAB, ssm_cfg={
        "ssm_version": 2, "d_state": 8, "headdim": 8, "ngroups": 2,
        "d_conv": 3, "expand": 3})
    caches = model.init_caches(3)
    m = model.backbone.layers[0].mixer
    assert caches[0][0].shape == (3, 3, m.conv_dim)
    assert caches[0][1].shape == (3, m.nheads, 8, 8)
    with torch.inference_mode():
        logits, _ = model.step(torch.zeros(3, 1, dtype=torch.long), caches)
    assert logits.shape == (3, 1, VOCAB)


def _write_state_spaces_dir(root, sd, config, with_head=True):
    os.makedirs(root, exist_ok=True)
    if not with_head:
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    torch.save(sd, os.path.join(root, "pytorch_model.bin"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    return root


@pytest.mark.parametrize("with_head", [True, False])
def test_state_spaces_checkpoint_loads_in_both_packages(tmp_path, with_head):
    """A ``state-spaces/mamba-*`` directory (config.json with the reference
    keys, pytorch_model.bin with its names) through ``load_mamba_lm`` and
    through ``zigma_tpu.convert.torch_mamba_lm``: equal logits."""
    config = {"d_model": D_MODEL, "n_layer": N_LAYER, "vocab_size": VOCAB,
              "ssm_cfg": {"d_state": 8}, "rms_norm": True,
              "residual_in_fp32": True, "fused_add_norm": True,
              "pad_vocab_size_multiple": PAD}
    src = MambaLMHeadModel(**lm_kwargs(config),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(3)
        for p in src.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    root = _write_state_spaces_dir(str(tmp_path / "mamba"), src.state_dict(),
                                   config, with_head)
    model = load_mamba_lm(root, device="cpu")
    jcfg, jparams = load_hf_mamba_lm(root)
    jm = JaxLM(d_model=jcfg["d_model"], n_layer=jcfg["n_layer"],
               vocab_size=jcfg["vocab_size"], ssm_cfg=jcfg["ssm_cfg"],
               rms_norm=jcfg["rms_norm"],
               residual_in_fp32=jcfg["residual_in_fp32"],
               pad_vocab_size_multiple=jcfg["pad_vocab_size_multiple"])
    ids = np.random.default_rng(4).integers(0, VOCAB, (2, L)).astype(np.int32)
    ref = jax.jit(lambda p, i: jm.apply(p, i))(jparams, ids)
    with torch.no_grad():
        _close(model(_t(ids)), ref, "state-spaces checkpoint logits")
        torch.testing.assert_close(model(_t(ids)), src(_t(ids)))
    assert model.lm_head.weight is model.backbone.embedding.weight


def test_load_mamba_lm_refusals(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="d_intermediate"):
        lm_kwargs({"d_model": 8, "n_layer": 1, "vocab_size": 8,
                   "d_intermediate": 32})
    with pytest.raises(NotImplementedError, match="attention"):
        lm_kwargs({"d_model": 8, "n_layer": 1, "vocab_size": 8,
                   "attn_layer_idx": [0]})
    with pytest.raises(ValueError, match="unknown Mamba LM config"):
        lm_kwargs({"d_model": 8, "n_layer": 1, "vocab_size": 8, "foo": 1})
    assert lm_kwargs({"d_model": 8, "n_layer": 1, "vocab_size": 8,
                      "ssm_cfg": {"layer": "Mamba2"}})["ssm_cfg"] == {
        "ssm_version": 2}
    # a hub name needs transformers' local cache lookup; without the
    # package it raises before anything is read
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "transformers.utils", None)
    with pytest.raises(RuntimeError, match="transformers"):
        load_mamba_lm("state-spaces/mamba-130m", device="cpu")


def test_benchmark_generation_tool_on_the_cpu():
    from zigma_tpu_torch.tools import benchmark_generation
    res = benchmark_generation.main([
        "--d-model", "32", "--n-layer", "2", "--vocab-size", "30",
        "--promptlen", "5", "--genlen", "3", "--batch", "2", "--repeats", "1",
        "--device", "cpu"])
    assert res["device"] == "cpu" and res["ms"] > 0
    assert res["new_tok_per_s"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            benchmark_generation.main(["--n-layer", "1"])
