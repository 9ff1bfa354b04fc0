"""The port's data path against the JAX package's, on shards written once.

The same tar shards (image latents with a JPEG and a class id, text
latents with (n_captions, tokens, d) caption features, 5-frame video
latents) go through ``zigma_tpu.data`` / ``zigma_tpu.cli.train.wds_batches``
and through ``zigma_tpu_torch.data`` / ``zigma_tpu_torch.cli.train.
wds_batches``: keys and arrays must be equal, unshuffled and shuffled, for
the repeating training stream and the finite validation pass.  Then the
native reader's grouping, a corrupt shard, ``split_by_host``, the video
feature-prep dataset, and the train and likelihood CLIs on shards.
"""

import io
import os
import random
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from zigma_tpu import config as jax_config
from zigma_tpu import data as jax_data
from zigma_tpu.cli import train as jax_train_cli
from zigma_tpu_torch import data
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.cli import train as train_cli
from zigma_tpu_torch.cli.prepare_data import ShardWriter, _npy_bytes
from zigma_tpu_torch.data import wds
from zigma_tpu_torch.native import native_tar_samples

CONFIG_DIR = sample_cli.DEFAULT_CONFIG_DIR
N_SHARDS = 2


def _jpeg(rng, h, w):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _write(root, kind, n):
    """``n`` samples of ``kind`` in N_SHARDS shards ``train-00000{i}.tar``."""
    rng = np.random.default_rng({"img": 0, "txt": 1, "vid": 2}[kind])
    w = ShardWriter(str(root), shard_size=-(-n // N_SHARDS))
    for i in range(n):
        if kind == "vid":
            members = {"frame_feature256.npy": _npy_bytes(
                rng.standard_normal((5, 4, 8, 8)).astype(np.float32)),
                "cls_id.cls": str(i % 7).encode(),
                "cls_name.json": b'"class"'}
        else:
            members = {"img_feature256.npy": _npy_bytes(
                rng.standard_normal((4, 8, 8)).astype(np.float32)),
                "image.jpg": _jpeg(rng, 16, 16)}
            if kind == "img":
                members["cls_id.cls"] = str(i % 5).encode()
            else:
                members["caption_feature.npy"] = _npy_bytes(
                    rng.standard_normal((3, 5, 8)).astype(np.float32))
        w.write(f"{i:08d}", members)
    w.close()
    return str(root)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    return {kind: _write(root / kind, kind, n)
            for kind, n in (("img", 10), ("txt", 10), ("vid", 8))}


SPEC = {"shards": "train-{000000..000001}.tar", "image_key": "image.jpg",
        "rename": {"image": "image.jpg", "latent": "img_feature256.npy",
                   "cls_id": "cls_id.cls"}}


def _assert_same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("split,shuffle", [("train", 0), ("train", 4),
                                           ("validation", 0)])
def test_loader_matches_jax(shards, split, shuffle):
    spec = dict(SPEC, shuffle=shuffle)
    kw = dict(tar_base=shards["img"], batch_size=4, image_size=8,
              multinode=False, train=spec, validation=spec, val_batch_size=3)
    port = data.WebDataModuleFromConfig(**kw)
    ref = jax_data.WebDataModuleFromConfig(**kw)
    if split == "train":  # repeats past the 10 samples, full batches only
        a, b = iter(port.train_dataloader()), iter(ref.train_dataloader())
        batches = [(next(a), next(b)) for _ in range(5)]
        assert all(x["latent"].shape == (4, 4, 8, 8) for x, _ in batches)
    else:  # one finite pass, the partial tail kept
        batches = list(zip(port.val_dataloader(), ref.val_dataloader()))
        assert [x["latent"].shape[0] for x, _ in batches] == [3, 3, 3, 1]
        assert len(list(port.val_dataloader())) == 4
    for x, y in batches:
        _assert_same_batch(x, y)
        assert x["image"].shape[1:] == (3, 8, 8)  # JPEG decoded and resized
        assert np.isfinite(x["image"]).all()


def _cfg(load, shards, kind, *extra):
    args = {"img": ["data=churches256", f"data.tar_base={shards['img']}"],
            "txt": ["data=coco", f"data.tar_base={shards['txt']}"],
            "vid": ["data=ucf101", f"data.tar_base={shards['vid']}",
                    "data.video_frames=3"]}[kind]
    return load(CONFIG_DIR, "default", [
        *args, "data.multinode=false", "data.batch_size=4",
        f"data.train.shards={SPEC['shards']}",
        f"data.validation.shards={SPEC['shards']}", *extra])


@pytest.mark.parametrize("kind", ["img", "txt", "vid"])
def test_wds_batches_match_jax(shards, kind):
    """x / y as the JAX trainer makes them: image latents (class ids as y
    only where a cls_id is renamed), one caption of three picked a sample,
    a random 3-frame window of the 5 stored."""
    port = train_cli.wds_batches(_cfg(train_cli.load_config, shards, kind))
    ref = jax_train_cli.wds_batches(
        _cfg(jax_config.load_config, shards, kind), None)
    for _ in range(4):
        a, b = next(port), next(ref)
        _assert_same_batch(a, b)
    want = {"img": (4, 4, 8, 8), "txt": (4, 4, 8, 8), "vid": (4, 3, 4, 8, 8)}
    assert a["x"].shape == want[kind]
    if kind == "txt":
        assert a["y"].shape == (4, 5, 8)
    if kind == "vid":
        assert a["y"].dtype == np.int64
    val = list(train_cli.wds_batches(
        _cfg(train_cli.load_config, shards, kind), split="validation"))
    ref_val = list(jax_train_cli.wds_batches(
        _cfg(jax_config.load_config, shards, kind), None, split="validation"))
    assert len(val) == len(ref_val) > 0
    for a, b in zip(val, ref_val):
        _assert_same_batch(a, b)
    with pytest.raises(ValueError, match="unknown split"):
        next(train_cli.wds_batches(_cfg(train_cli.load_config, shards, kind),
                                   split="test"))


def test_native_reader_groups_as_tarfile(tmp_path):
    path = str(tmp_path / "s.tar")
    rng = np.random.default_rng(3)
    with tarfile.open(path, "w", format=tarfile.GNU_FORMAT) as tf:
        for i in range(6):
            prefix = "deep/" * 25 if i % 2 else ""  # GNU long names too
            for ext in ("latent.npy", "cls_id.cls", "noext"):
                payload = rng.bytes(100 + 37 * i)
                name = (f"{prefix}{i:04d}.{ext}" if ext != "noext"
                        else f"{prefix}{i:04d}")
                info = tarfile.TarInfo(name)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    want = []
    with tarfile.open(path) as tf:
        for m in tf:
            base = os.path.basename(m.name)
            key, ext = (base.split(".", 1) if "." in base else (base, ""))
            key = os.path.join(os.path.dirname(m.name), key)
            if not want or want[-1]["__key__"] != key:
                want.append({"__key__": key})
            want[-1][ext] = tf.extractfile(m).read()
    before = dict(wds.tar_samples.served)
    assert list(native_tar_samples(path)) == want
    assert list(wds.tar_samples(path)) == want
    assert list(jax_data.tar_samples(path)) == want
    assert wds.tar_samples.served["native"] == before["native"] + 1
    assert wds.tar_samples.served["tarfile"] == before["tarfile"]
    # a streamed (non-local) shard takes tarfile's path: same samples
    assert list(wds.tar_samples(f"pipe:cat {path}")) == want
    assert wds.tar_samples.served["tarfile"] == before["tarfile"] + 1


def test_corrupt_and_missing_shards_are_skipped(tmp_path, shards):
    bad = str(tmp_path / "bad.tar")
    with open(bad, "wb") as f:
        f.write(b"this is not a tar file" * 100)
    good = os.path.join(shards["img"], "train-000000.tar")
    missing = str(tmp_path / "missing.tar")
    reader = data.WebDatasetReader([bad, missing, good], batch_size=5,
                                   repeat=False, prefetch=0)
    (batch,) = list(reader)
    assert batch["img_feature256.npy"].shape == (5, 4, 8, 8)
    # a repeating stream with nothing readable raises (it would spin)
    with pytest.raises(RuntimeError, match="no readable sample"):
        next(iter(data.WebDatasetReader([bad, missing], batch_size=1,
                                        prefetch=0)))


def test_split_by_host():
    urls = [f"s{i}" for i in range(10)]
    parts = [data.split_by_host(urls, r, 3) for r in range(3)]
    assert parts == [jax_data.split_by_host(urls, r, 3) for r in range(3)]
    assert sorted(sum(parts, [])) == urls
    assert parts[1] == ["s1", "s4", "s7"]
    # without torch.distributed initialised: rank 0 of 1, every shard
    assert not torch.distributed.is_initialized()
    assert data.split_by_host(urls) == urls


def test_feature_prep_dataset_matches_jax(tmp_path):
    """CSV rows -> temporal crop -> video transforms -> encode_fn, with an
    injected reader (no container decode) and the same seeds."""
    from zigma_tpu.data import video as jax_video
    from zigma_tpu_torch.data import video

    csv = tmp_path / "videos.csv"
    csv.write_text("a.mp4,a caption,3\nb.mp4,b caption,x\n")
    rng = np.random.default_rng(5)
    clips = {p: rng.integers(0, 255, (9, 3, 12, 10), dtype=np.uint8)
             for p in ("a.mp4", "b.mp4")}
    out = []
    for mod in (video, jax_video):
        ds = mod.FeaturePrepDataset(str(csv), read_video_fn=clips.__getitem__,
                                    encode_fn=lambda v: v[:, :2] * 2,
                                    num_frames=4, frame_interval=2,
                                    transform=mod.get_transforms_video(8))
        random.seed(0)  # the random flip draws from the module's generator
        out.append([ds[i] for i in range(len(ds))])
    for a, b in zip(*out):
        assert a["text"] == b["text"] and a["cls_id"] == b["cls_id"]
        np.testing.assert_array_equal(a["video"], b["video"])
        np.testing.assert_array_equal(a["frame_feature256"],
                                      b["frame_feature256"])
    assert out[0][0]["video"].shape == (4, 3, 8, 8)
    assert out[0][0]["cls_id"] == 3 and out[0][1]["cls_id"] == "x"


TINY = ["model.params.embed_dim=32", "model.params.depth=2",
        "model.params.img_dim=8", "model.params.patch_size=2"]


def test_train_and_likelihood_clis_on_shards(tmp_path, shards, capsys):
    """``cli.train`` takes 2 CPU steps from the image shards (the config's
    own sample_fid_n, 5000, gets past the start-up checks; the eval is
    ``tests/test_torch_eval.py``'s), and the likelihood scores the
    validation split's latents, not noise."""
    shard_args = ["data=churches256", f"data.tar_base={shards['img']}",
                  f"data.train.shards={SPEC['shards']}",
                  f"data.validation.shards={SPEC['shards']}",
                  "data.multinode=false"]
    cfg = sample_cli.load_config(CONFIG_DIR, "default", [*TINY, *shard_args])
    assert cfg.data.sample_fid_n == 5000
    train_cli._check_supported(cfg)
    res = train_cli.main([*TINY, *shard_args, "data.sample_fid_n=0",
                          "data.batch_size=4", "data.train_steps=2",
                          "log_every=1", "device=cpu",
                          f"results_dir={tmp_path}"])
    assert res["state"].step == 2
    assert all(np.isfinite(r["loss"]) for r in res["records"])
    lik = ["likelihood=true", "ode.sampling_method=euler",
           "ode.num_sampling_steps=3", "num_fid_samples=4",
           "offline_sample_local_bs=2", f"sample_dir={tmp_path}",
           "device=cpu"]
    capsys.readouterr()
    out = sample_cli.main([f"ckpt={res['checkpoint']}", *TINY, *shard_args,
                           *lik])
    assert out["real_batches"] == 2 and len(out["logp"]) == 2
    assert all(np.isfinite(lp).all() for lp in out["logp"])
    assert "scores gaussian noise" not in capsys.readouterr().err
    noise = sample_cli.main([f"ckpt={res['checkpoint']}", *TINY,
                             "data=synthetic", *lik])
    assert noise["real_batches"] == 0
    assert not np.allclose(noise["logp"][0], out["logp"][0])
    assert "scores gaussian noise" in capsys.readouterr().err
