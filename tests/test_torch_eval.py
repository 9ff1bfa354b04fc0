"""The evaluation through the port's entry points, on the CPU.

``cli.train`` with ``data.sample_fid_n > 0`` evaluates as the JAX trainer's
``fid_eval`` does: real batches from a fresh pass over the validation split,
fakes from the EMA model (with the validation batch's caption features for a
text model), scores logged as ``eval/*`` and the lowest FID in the
checkpoint's ``best_fid``.  Without weights the choices degrade as the JAX
menu does (patch statistics on latents; is / sfid / fdd dropped); with a
VAE and registered nets the full image menu runs on decoded uint8 pixels.
``cli.sample metrics=[...]`` writes ``metrics.json``; an unknown metric, or
``fvd`` on an image run, raises at start-up in both CLIs.  Tiny shapes:
depth 2, embed 32, 8x8 latents.
"""

import io
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.cli import train as train_cli
from zigma_tpu_torch.cli.prepare_data import ShardWriter, _npy_bytes
from zigma_tpu_torch.config import load_config
from zigma_tpu_torch.metrics import features

CONFIG_DIR = sample_cli.DEFAULT_CONFIG_DIR
TINY = ["model.params.embed_dim=32", "model.params.depth=2",
        "model.params.img_dim=8", "model.params.patch_size=2"]
SHARDS = "train-{000000..000001}.tar"
EVAL = ["data.sample_fid_n=8", "data.sample_fid_every=2",
        "data.sample_fid_bs=4", "data.val_batch_size=4",
        "ode.sampling_method=euler", "ode.num_sampling_steps=3"]
N_CTX, D_CTX = 5, 8


def _jpeg(rng):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def _write(root, text: bool, n: int = 10):
    """``n`` churches-layout samples (latent + JPEG) in two shards, with 3
    captions' features a sample in the coco layout when ``text``."""
    rng = np.random.default_rng(int(text))
    w = ShardWriter(str(root), shard_size=n // 2)
    for i in range(n):
        members = {"img_feature256.npy": _npy_bytes(
            rng.standard_normal((4, 8, 8)).astype(np.float32)),
            "image.jpg": _jpeg(rng)}
        if text:
            members["caption_feature.npy"] = _npy_bytes(rng.standard_normal(
                (3, N_CTX, D_CTX)).astype(np.float32))
        w.write(f"{i:08d}", members)
    w.close()
    return str(root)


def _data(root, data="churches256"):
    return [f"data={data}", f"data.tar_base={root}",
            f"data.train.shards={SHARDS}", f"data.validation.shards={SHARDS}",
            "data.multinode=false"]


@pytest.fixture(autouse=True)
def no_weights(tmp_path, monkeypatch):
    for var in ("ZIGMA_INCEPTION_WEIGHTS", "ZIGMA_DINOV2_WEIGHTS",
                "ZIGMA_I3D_WEIGHTS", "ZIGMA_I3D_TORCHSCRIPT",
                "ZIGMA_VAE_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    monkeypatch.setattr(features, "_REGISTRY", {})
    monkeypatch.setattr(features, "_RESOLVED", {})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 steps from churches-layout shards with an eval at step 2."""
    root = tmp_path_factory.mktemp("eval")
    data = _data(_write(root / "wds", text=False))
    res = train_cli.main([*TINY, *data, *EVAL, "data.batch_size=4",
                          "data.train_steps=2", "log_every=1", "device=cpu",
                          f"results_dir={root / 'out'}"])
    return res, data, root


def test_train_eval_logs_fid_and_saves_best_fid(trained, caplog):
    res, _, _ = trained
    (ev,) = res["evals"]
    assert ev["step"] == 2 and "error" not in ev
    scores = ev["scores"]
    assert {"fid", "kid", "kid_std", "precision", "recall", "density",
            "coverage"} == set(scores)
    assert all(math.isfinite(v) for v in scores.values())
    # raw latents (no VAE weights): the JAX menu's degradation
    suite = res["metric_suite"]
    assert suite.choices == ["fid", "kid", "prdc"]
    assert set(suite.dropped) == {"is", "sfid", "fdd"}
    assert set(ev["seconds"]) == {"sample", "decode", "host", "compute",
                                  "nets"}
    with open(os.path.join(res["run_dir"], "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    evals = [r for r in logged if "eval/fid" in r]
    assert len(evals) == 1 and evals[0]["step"] == 2
    assert evals[0]["eval/fid"] == scores["fid"]
    ck = torch.load(res["checkpoint"], weights_only=False)
    assert ck["best_fid"] == res["state"].best_fid == scores["fid"]


def test_shipped_data_configs_get_past_the_start_up_checks():
    """Every data config keeps its own sample_fid_n (5000 in nine of ten)
    and passes the refusals and the menu check."""
    from zigma_tpu_torch.metrics import validate_choices

    names = sorted(f[:-5] for f in os.listdir(os.path.join(CONFIG_DIR, "data"))
                   if f.endswith(".yaml"))
    assert len(names) == 10
    fid_n = {}
    for name in names:
        cfg = load_config(CONFIG_DIR, "default", [f"data={name}"])
        train_cli._check_supported(cfg)
        validate_choices(cfg.get("eval_metrics"),
                         video=cfg.data.get("video_frames", 0) > 0)
        fid_n[name] = int(cfg.data.get("sample_fid_n", 0) or 0)
    assert fid_n["churches256"] == 5000 and fid_n["synthetic"] == 0
    assert sum(v == 5000 for v in fid_n.values()) == 9


def test_text_eval_uses_the_validation_captions(tmp_path, monkeypatch):
    """A coco-layout text run: each eval batch's fakes are conditioned on
    the caption features of the validation batch it is scored against."""
    from zigma_tpu_torch.models import zigma

    data = [*_data(_write(tmp_path / "wds", text=True), "coco"),
            f"data.d_context={D_CTX}", f"data.n_context_token={N_CTX}"]
    seen = []
    forward = zigma.ZigMa.forward

    def spy(self, x, t, y=None, *a, **kw):
        if not torch.is_grad_enabled():  # the eval's sampler
            seen.append(y.clone())
        return forward(self, x, t, y, *a, **kw)

    monkeypatch.setattr(zigma.ZigMa, "forward", spy)
    args = [*TINY, *data, *EVAL, "data.batch_size=4", "data.train_steps=2",
            "device=cpu", f"results_dir={tmp_path}"]
    res = train_cli.main(args)
    (ev,) = res["evals"]
    assert math.isfinite(ev["scores"]["fid"])
    cfg = load_config(CONFIG_DIR, "default", args)
    val = [b["y"][:4] for b in train_cli.wds_batches(cfg, split="validation")]
    # 2 batches of 4, 2 Euler forwards each (3 steps)
    assert len(seen) == 4
    for i, y in enumerate(seen):
        np.testing.assert_array_equal(y.numpy(), val[i // 2])


def test_video_eval_fid_and_fvd(tmp_path):
    """The video menu (per-frame fid, fvd) on a tiny video ZigMa; raw
    latents take the weight-free video statistics."""
    res = train_cli.main([
        "model=3d_zigzag8sst_b2", "data=synthetic", "data.video_frames=2",
        "model.params.video_frames=2", "data.num_classes=5",
        "model.params.class_dropout_prob=0.1", "model.params.depth=3",
        "model.params.embed_dim=32", "model.params.img_dim=8",
        "data.batch_size=2", "data.train_steps=2", "data.sample_fid_n=4",
        "data.sample_fid_every=2", "data.sample_fid_bs=2",
        "ode.sampling_method=euler", "ode.num_sampling_steps=3",
        "device=cpu", f"results_dir={tmp_path}"])
    (ev,) = res["evals"]
    assert res["metric_suite"].choices == ["fid", "fvd"]
    assert res["metric_suite"].video.flavor == "patch_stats"
    for k in ("fid", "fvd", "fvd_patch_stats"):
        assert math.isfinite(ev["scores"][k])


def _img_fn(imgs):
    x = np.asarray(imgs, np.float64)
    assert x.dtype == np.float64 and x.shape[1] == 3
    return np.stack([x.mean((1, 2, 3)), x.std((1, 2, 3)),
                     x[:, 0].mean((1, 2)), x[:, 2].mean((1, 2))], 1)


def test_eval_in_pixels_runs_the_full_image_menu(tmp_path, monkeypatch):
    """With a VAE (``vae_kind=sd-vae``, a small random file) and nets under
    the canonical names, nothing degrades: fid / is / kid / prdc / sfid /
    fdd on decoded uint8 pixels, and the decode is timed."""
    from zigma_tpu_torch.data.sd_vae import AutoencoderKL

    torch.manual_seed(0)
    torch.save(AutoencoderKL(scale=4).state_dict(), tmp_path / "vae.pt")
    monkeypatch.setenv("ZIGMA_VAE_WEIGHTS", str(tmp_path / "vae.pt"))
    got = []

    def fn(imgs):
        got.append(np.asarray(imgs))
        return _img_fn(imgs)

    for name in ("inception", "inception_sfid", "dinov2"):
        features.register_extractor(name, fn)
    features.register_extractor("inception_logits",
                                lambda x: _img_fn(x) / 50.0)
    res = train_cli.main([
        *TINY, *_data(_write(tmp_path / "wds", text=False)), *EVAL,
        "vae_kind=sd-vae", "data.batch_size=4", "data.train_steps=2",
        "device=cpu", f"results_dir={tmp_path}"])
    (ev,) = res["evals"]
    assert res["metric_suite"].dropped == ()
    assert set(res["metric_suite"].choices) == {"fid", "is", "kid", "prdc",
                                                "sfid", "fdd"}
    assert {"fid", "is", "kid", "precision", "sfid", "fdd"} <= set(
        ev["scores"])
    assert all(math.isfinite(v) for v in ev["scores"].values())
    assert got[0].dtype == np.uint8 and got[0].shape == (4, 3, 64, 64)
    assert ev["seconds"]["decode"] > 0


def test_eval_failure_is_logged_and_training_goes_on(tmp_path):
    """A menu with nothing left on latents (``is`` alone) raises in the
    eval, which is logged; the run finishes and saves its checkpoint."""
    res = train_cli.main([
        *TINY, "data=synthetic", "data.batch_size=2", "data.train_steps=4",
        "data.sample_fid_n=2", "data.sample_fid_every=2",
        "data.sample_fid_bs=2", "eval_metrics=[is]",
        "ode.sampling_method=euler", "ode.num_sampling_steps=3",
        "device=cpu", f"results_dir={tmp_path}"])
    assert len(res["evals"]) == 1 and "survived" in res["evals"][0]["error"]
    assert res["state"].step == 4 and os.path.exists(res["checkpoint"])


def test_sample_cli_metrics_write_json(trained, tmp_path):
    res, data, _ = trained
    out = sample_cli.main([
        f"ckpt={res['checkpoint']}", *TINY, *data, "data.val_batch_size=4",
        "metrics=[fid,kid]", "sample_mode=ODE", "ode.sampling_method=euler",
        "ode.num_sampling_steps=3", "num_fid_samples=8",
        "offline_sample_local_bs=4", f"sample_dir={tmp_path}", "device=cpu"])
    assert out["metrics"] == ["fid", "kid"] and out["real_batches"] == 2
    with open(os.path.join(out["out_dir"], "metrics.json")) as f:
        scores = json.load(f)
    assert scores == out["scores"]
    assert set(scores) == {"fid", "kid", "kid_std"}
    assert all(math.isfinite(v) for v in scores.values())


def test_bad_metrics_raise_at_start_up(tmp_path):
    for extra in (["eval_metrics=[fid,bogus]"],
                  ["data.eval_metrics=[fid,fvd]"]):
        with pytest.raises(ValueError, match="bogus|video run"):
            train_cli.main([*TINY, "data=synthetic", "data.sample_fid_n=4",
                            "data.sample_fid_every=1", *extra, "device=cpu",
                            f"results_dir={tmp_path}"])
    assert not os.path.exists(tmp_path / "zigzagN8_b1_pe2_synthetic")
    for choices, match in (("[fvd]", "video run"), ("[fid,nope]", "nope")):
        with pytest.raises(ValueError, match=match):  # before the ckpt loads
            sample_cli.main([f"ckpt={tmp_path / 'missing.pt'}", *TINY,
                             f"metrics={choices}", "device=cpu"])
