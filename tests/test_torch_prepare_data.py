"""``cli.prepare_data`` of the port against the JAX package's.

With the identity codec both write the same shards: the same members (the
center-cropped [-1, 1] pixels as ``img_feature{size}.npy``, ``image.jpg``,
``caption.txt``) with the same bytes.  With ``--codec sd-vae --device
cpu`` the latents are the VAE codec's posterior samples of the same crops.
"""

import io
import json
import os
import tarfile

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from zigma_tpu.cli.prepare_data import main as jax_prepare
from zigma_tpu.data import vae_jax as vj
from zigma_tpu_torch.cli.prepare_data import main as prepare
from zigma_tpu_torch.convert import vae_state_dict_from_jax
from zigma_tpu_torch.data import VAECodec, get_transforms_image


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    sizes = [(40, 40), (50, 36), (20, 70), (33, 33), (64, 48)]
    for i in range(7):
        h, w = sizes[i % len(sizes)]
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / f"img_{i:03d}.png")
    caps = root / "caps.json"
    caps.write_text(json.dumps({f"img_{i:03d}.png": f"caption {i}"
                                for i in range(6)}))  # one without
    return str(root), str(caps)


def _members(out_dir):
    out = {}
    for shard in sorted(os.listdir(out_dir)):
        with tarfile.open(os.path.join(out_dir, shard)) as tf:
            out[shard] = [(m.name, tf.extractfile(m).read()) for m in tf]
    return out


def test_identity_shards_match_jax(tmp_path, images, capsys):
    img_dir, caps = images
    args = ["--images", img_dir, "--image-size", "32", "--shard-size", "3",
            "--keep-jpeg", "--captions", caps, "--batch-size", "2"]
    assert prepare(args + ["--out", str(tmp_path / "port")]) == 7
    assert jax_prepare(args + ["--out", str(tmp_path / "jax")]) == 7
    port, ref = _members(tmp_path / "port"), _members(tmp_path / "jax")
    assert sorted(port) == [f"train-{i:06d}.tar" for i in range(3)]
    assert port == ref
    names = [n for n, _ in port["train-000000.tar"]]
    assert names[:3] == ["00000000.img_feature32.npy", "00000000.image.jpg",
                         "00000000.caption.txt"]
    # no CLIP weights here: captions are stored as text only
    assert "captions stored as text only" in capsys.readouterr().out


def test_sd_vae_shards(tmp_path, images, monkeypatch):
    img_dir, _ = images
    path = str(tmp_path / "vae.pt")
    sd = vae_state_dict_from_jax(jax.tree.map(
        np.asarray, vj.random_params(seed=0, scale=4)))
    torch.save(sd, path)
    monkeypatch.setenv("ZIGMA_VAE_WEIGHTS", path)
    out = str(tmp_path / "wds")
    prepare(["--images", img_dir, "--out", out, "--image-size", "32",
             "--codec", "sd-vae", "--device", "cpu", "--batch-size", "4"])
    members = _members(out)["train-000000.tar"]
    got = np.stack([np.load(io.BytesIO(b))
                    for n, b in members if n.endswith(".npy")])
    crops = np.stack([get_transforms_image(32, flip=False)(
        Image.open(os.path.join(img_dir, f"img_{i:03d}.png")).convert("RGB"))
        for i in range(7)])
    want = VAECodec(device="cpu").encode(crops)  # seed 0: the same noise
    assert got.shape == (7, 4, 4, 4)
    # batches of 4 there, one of 7 here: fp32 sums in another order
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    monkeypatch.setenv("ZIGMA_VAE_WEIGHTS", str(tmp_path / "missing.pt"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    with pytest.raises(RuntimeError, match="not found locally"):
        prepare(["--images", img_dir, "--out", out, "--codec", "sd-vae",
                 "--device", "cpu"])
