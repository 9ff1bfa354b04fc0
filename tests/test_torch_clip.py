"""The port's CLIP text tower (``data/clip_text.py``) against the JAX
package's ``data/clip_jax.py`` and, where it imports, Hugging Face's
``CLIPTextModel``; and the frozen embedder's refusal without local weights.

Weights: ``clip_jax.random_params`` at depth 2, dim 64 (4 heads) through
``convert.clip_state_dict_from_jax``; the same fp32 ops in another order,
so within 1e-5 of max |reference|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.data import clip_jax
from zigma_tpu_torch.convert import clip_state_dict_from_jax
from zigma_tpu_torch.data.clip_text import CLIPTextTower, load_hf_state_dict

TOL = 1e-5  # of max |reference|
CFG = {"vocab": 101, "dim": 64, "depth": 2, "heads": 4, "mlp": 128, "ctx": 16}


def _close(got, ref):
    got = got.detach().numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOL, err


@pytest.mark.parametrize("length", [CFG["ctx"], 7])
def test_tower_matches_jax(length):
    params = clip_jax.random_params(seed=0, cfg=CFG)
    ids = np.random.default_rng(1).integers(0, CFG["vocab"], (3, length))
    ref = np.asarray(clip_jax.clip_text_forward(
        params, jnp.asarray(ids, jnp.int32), heads=CFG["heads"]))
    tower = CLIPTextTower.from_state_dict(
        clip_state_dict_from_jax(jax.tree.map(np.asarray, params)),
        heads=CFG["heads"])
    assert tower.cfg == CFG
    with torch.no_grad():
        _close(tower(torch.from_numpy(ids)), ref)


def test_tower_matches_transformers():
    """An HF state dict (``text_model.`` prefix, maybe the position_ids
    buffer) loads with strict=True and computes ``last_hidden_state``."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPTextConfig(
        vocab_size=CFG["vocab"], hidden_size=CFG["dim"],
        intermediate_size=CFG["mlp"], num_hidden_layers=CFG["depth"],
        num_attention_heads=CFG["heads"],
        max_position_embeddings=CFG["ctx"], hidden_act="quick_gelu")
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(cfg).eval()
    sd = hf.state_dict()
    assert all(k.startswith("text_model.") for k in sd)
    tower = CLIPTextTower(CFG)
    tower.load_state_dict(load_hf_state_dict(sd), strict=True)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG["vocab"], (2, CFG["ctx"])))
    with torch.no_grad():
        want = hf(input_ids=ids).last_hidden_state.numpy()
        _close(tower(ids), want)


def test_load_hf_state_dict_takes_the_text_tower():
    """A CLIPModel checkpoint holds both towers: only ``text_model.*`` is
    kept; a bare text state dict is kept whole."""
    bare = {k: v for k, v in CLIPTextTower(CFG).state_dict().items()}
    full = {f"text_model.{k}": v for k, v in bare.items()}
    full.update({"vision_model.embeddings.patch_embedding.weight":
                 torch.zeros(2), "logit_scale": torch.zeros(()),
                 "text_model.embeddings.position_ids": torch.arange(16)})
    assert sorted(load_hf_state_dict(full)) == sorted(bare)
    assert sorted(load_hf_state_dict(bare)) == sorted(bare)


def test_embedder_raises_without_local_weights(tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    from zigma_tpu_torch.data.text import FrozenCLIPEmbedder

    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="local HF cache"):
        FrozenCLIPEmbedder(device="cpu")
