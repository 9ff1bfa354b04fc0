"""The port's copies of the JAX package's small helpers: ``MetricLogger.
log_media`` (with a wandb stub), ``pos_embed_similarity_grid``,
``CaptionEmbedder`` and ``utils/registry.py``, each against the JAX one on
the same inputs where it computes something."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.models import CaptionEmbedder as JaxCaptionEmbedder
from zigma_tpu.utils import logging_utils as jax_lu
from zigma_tpu_torch.models import CaptionEmbedder, ZigMa
from zigma_tpu_torch.utils import logging_utils as lu
from zigma_tpu_torch.utils.registry import (get_obj_from_str,
                                            instantiate_from_config)


class _Wandb:
    """Records what would go to wandb."""

    def __init__(self):
        self.logged = []

    def Image(self, path):
        return ("image", path)

    def Video(self, path):
        return ("video", path)

    def log(self, data, step=None):
        self.logged.append((data, step))


@pytest.mark.parametrize("name,kind", [("0000004.png", "image"),
                                       ("0000004.gif", "video")])
def test_log_media_mirrors_vis_files_to_wandb(tmp_path, name, kind):
    mlog = lu.MetricLogger(str(tmp_path))
    path = str(tmp_path / name)
    mlog.log_media(4, path)  # without wandb: nothing
    mlog._wandb = _Wandb()
    mlog.log_media(4, path)
    mlog.close()
    assert mlog._wandb.logged == [({"samples": (kind, path)}, 4)]


def test_pos_embed_similarity_grid_matches_jax():
    pe = np.random.default_rng(0).standard_normal((1, 64, 16))
    got = lu.pos_embed_similarity_grid(pe, 8, anchors=9)
    np.testing.assert_array_equal(got,
                                  jax_lu.pos_embed_similarity_grid(pe, 8, 9))
    assert got.shape == (3 * 8 + 4, 3 * 8 + 4, 3) and got.dtype == np.uint8
    with pytest.raises(ValueError, match="!= 7"):
        lu.pos_embed_similarity_grid(pe, 7)


def test_caption_embedder_matches_jax():
    rng = np.random.default_rng(1)
    cap = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jm = JaxCaptionEmbedder(in_channels=16, hidden_size=8, uncond_prob=0.5,
                            token_num=5)
    p = jm.init(jax.random.PRNGKey(0), cap)["params"]
    m = CaptionEmbedder(16, 8, uncond_prob=0.5, token_num=5)
    t = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        m.y_embedding.copy_(t(p["y_embedding"]))
        for name in ("fc1", "fc2"):
            lin = getattr(m.y_proj, name)
            lin.weight.copy_(t(p[name]["kernel"]).T)
            lin.bias.copy_(t(p[name]["bias"]))
        for drop in (None, np.array([1, 0])):
            ref = jm.apply({"params": p}, jnp.asarray(cap),
                           force_drop_ids=drop)
            got = m(torch.from_numpy(cap), force_drop_ids=(
                None if drop is None else torch.from_numpy(drop)))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-5)
        # uncond_prob 1 under training: every caption is the null one
        m.uncond_prob = 1.0
        out = m(torch.from_numpy(cap), train=True)
        torch.testing.assert_close(out[0], out[1], atol=1e-6, rtol=0)


def test_registry():
    assert get_obj_from_str("zigma_tpu_torch.models.zigma.ZigMa") is ZigMa
    model = instantiate_from_config({
        "target": "zigma_tpu_torch.models.zigma.ZigMa",
        "params": {"in_channels": 4, "embed_dim": 32, "depth": 2,
                   "img_dim": 8, "patch_size": 2, "scan_type": "zigzagN2",
                   "device": "cpu"}})
    assert isinstance(model, ZigMa) and model.embed_dim == 32
    with pytest.raises(KeyError, match="target"):
        instantiate_from_config({"params": {}})
