"""The port's metric maths and containers against the JAX package's.

Seeded numpy features go through ``zigma_tpu.metrics`` and
``zigma_tpu_torch.metrics``: the Fréchet distance and its running moments,
KID, IS, PRDC, PSNR and SSIM agree to 1e-10 relative (the port's modules
are copies, so any difference is a fault).  ``MyMetric``, ``VideoMetric``
and ``MetricSuite`` are driven in both packages with the same registered
numpy extractors: the scores, the dropped choices and the degradation
decisions over the menu x (pixels or latents) x (weights present or
absent) grid, and ``validate_choices``' errors, must be identical.  The
``torch.distributed`` gather of ``MyMetric.compute`` runs in two gloo
processes on the CPU against one process holding all the features.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from zigma_tpu import metrics as jm
from zigma_tpu.metrics import features as jax_features
from zigma_tpu.metrics import menu as jax_menu
from zigma_tpu_torch import metrics as pm
from zigma_tpu_torch.metrics import features as port_features
from zigma_tpu_torch.metrics import menu as port_menu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10  # the port's maths are copies of the JAX package's


def _feats(seed, n=40, d=12):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d))


@pytest.fixture(autouse=True)
def no_weights(tmp_path, monkeypatch):
    """Empty registries and caches: no weight file, no hub directory (the
    JAX package's DINOv2 fallback, ``torch.hub.load``, may reach the
    network, so it is switched off here)."""
    for var in ("ZIGMA_INCEPTION_WEIGHTS", "ZIGMA_DINOV2_WEIGHTS",
                "ZIGMA_I3D_WEIGHTS", "ZIGMA_I3D_TORCHSCRIPT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(jax_features, "_try_torch_dinov2", lambda: None)
    monkeypatch.setattr(jax_features, "_REGISTRY", {})
    monkeypatch.setattr(port_features, "_REGISTRY", {})
    monkeypatch.setattr(port_features, "_RESOLVED", {})


# ---------------------------------------------------------------- the maths --

def test_frechet_and_running_moments_match_jax():
    a, b = _feats(0), _feats(1) + 0.3
    moms = []
    for mod in (jm, pm):
        ra, rb = mod.RunningMoments(12), mod.RunningMoments(12)
        for i in range(0, 40, 16):  # streamed in uneven chunks
            ra.update(a[i:i + 16])
            rb.update(b[i:i + 16])
        moms.append((ra.finalize(), rb.finalize(),
                     mod.frechet_distance(*ra.finalize(), *rb.finalize())))
    (ja, jb, jd), (pa, pb, pd) = moms
    for x, y in zip((*ja, *jb), (*pa, *pb)):
        np.testing.assert_allclose(y, x, rtol=RTOL)
    np.testing.assert_allclose(pd, jd, rtol=RTOL)
    assert pd > 0


def test_moments_merge_and_state_match_jax():
    a = _feats(2)
    out = []
    for mod in (jm, pm):
        r1, r2 = mod.RunningMoments(12), mod.RunningMoments(12)
        r1.update(a[:15])
        r2.update(a[15:])
        r1.merge(r2)
        r3 = mod.RunningMoments(12)
        r3.load_state(r1.state())
        out.append(r3.finalize())
    for x, y in zip(*out):
        np.testing.assert_allclose(y, x, rtol=RTOL)


@pytest.mark.parametrize("subset_size", [10, 1000])
def test_kid_matches_jax(subset_size):
    a, b = _feats(3), _feats(4) * 1.1
    want = jm.kid(a, b, subsets=20, subset_size=subset_size)
    got = pm.kid(a, b, subsets=20, subset_size=subset_size)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_inception_score_and_prdc_match_jax():
    logits = _feats(5, n=50, d=30)
    np.testing.assert_allclose(pm.inception_score(logits),
                               jm.inception_score(logits), rtol=RTOL)
    a, b = _feats(6), _feats(7) + 0.2
    want, got = jm.prdc(a, b, nearest_k=5), pm.prdc(a, b, nearest_k=5)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    with pytest.raises(ValueError, match=">= 2"):
        pm.prdc(a[:1], b[:1])


def test_psnr_ssim_per_timestep_match_jax():
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 3, 3, 16, 16))
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1)
    np.testing.assert_allclose(pm.psnr(x[0, 0], y[0, 0]),
                               jm.psnr(x[0, 0], y[0, 0]), rtol=RTOL)
    np.testing.assert_allclose(pm.ssim(x[0, 0], y[0, 0]),
                               jm.ssim(x[0, 0], y[0, 0]), rtol=RTOL)
    assert pm.psnr(x[0, 0], x[0, 0]) == float("inf")
    for fn in ("psnr", "ssim"):
        want = jm.video_metric_per_timestep(x, y, getattr(jm, fn))
        got = pm.video_metric_per_timestep(x, y, getattr(pm, fn))
        for k in ("mean", "std"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
        for k in ("value", "value_std"):
            assert got[k] == pytest.approx(want[k], rel=RTOL)


# ------------------------------------------------------------- containers --

def _img_fn(imgs):  # (B, C, H, W) -> (B, 6): a shared numpy "net"
    x = np.asarray(imgs, np.float64)
    return np.stack([x.mean((1, 2, 3)), x.std((1, 2, 3)),
                     x[:, 0].mean((1, 2)), x[:, -1].mean((1, 2)),
                     x[..., :4, :4].mean((1, 2, 3)),
                     (x ** 2).mean((1, 2, 3)) / 255.0], 1)


def _logit_fn(imgs):
    return _img_fn(imgs)[:, :5] / 40.0


def _vid_fn(videos):  # (B, T, H, W, C) -> (B, 5)
    v = np.asarray(videos, np.float64)
    return np.stack([v.mean((1, 2, 3, 4)), v.std((1, 2, 3, 4)),
                     np.abs(np.diff(v, axis=1)).mean((1, 2, 3, 4)),
                     v[:, 0].mean((1, 2, 3)), v[:, -1].mean((1, 2, 3))], 1)


def _images(seed, n=12, shape=(3, 16, 16)):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), np.uint8)


def _close_scores(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("sync", [False, True])
def test_my_metric_and_video_metric_match_jax(sync):
    real, fake = _images(0), _images(1)
    out = []
    for mod in (jm, pm):
        m = mod.MyMetric(choices=["fid", "kid", "is", "prdc"],
                         extractor=_img_fn, logits_extractor=_logit_fn,
                         kid_subset_size=8)
        for i in range(0, 12, 5):
            m.update_real(real[i:i + 5])
            m.update_fake(fake[i:i + 5])
        v = mod.VideoMetric(extractor=_vid_fn)
        v.update_real(_images(2, n=6, shape=(4, 8, 8, 3)))
        v.update_fake(_images(3, n=6, shape=(4, 8, 8, 3)))
        out.append((m.compute(sync=sync), v.compute(sync=sync)))
    for got, want in zip(out[1], out[0]):
        _close_scores(got, want)
    assert "fvd_custom" in out[1][1]


def _register(mod_features):
    for name in ("inception", "inception_sfid", "inception_logits",
                 "dinov2"):
        mod_features.register_extractor(
            name, _logit_fn if name == "inception_logits" else _img_fn)
    mod_features.register_extractor("i3d_styleganv", _vid_fn)


def _decisions(suite):
    """What the suite decided: its choices, drops, which extractor each
    stream got (the registered one, or the patch statistics) and the FVD
    flavour."""
    kinds = {}
    if suite.image is not None:
        for stream, fn in suite.image.extractors.items():
            kinds[stream] = fn.__name__ if fn.__name__.startswith("_") \
                else fn.__qualname__.split(".")[0]
        if suite.image.logits_extractor is not None:
            kinds["logits"] = suite.image.logits_extractor.__name__
    if suite.video is not None:
        kinds["video"] = suite.video.flavor
    return list(suite.choices), list(suite.dropped), kinds


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
@pytest.mark.parametrize("in_pixels", [True, False], ids=["pixels", "latents"])
@pytest.mark.parametrize("weights", [True, False], ids=["nets", "no_nets"])
def test_suite_degradation_matches_jax(video, in_pixels, weights, caplog):
    """The full menu of the run kind over the grid: identical decisions,
    warnings and scores."""
    if weights:
        _register(jax_features)
        _register(port_features)
    frames = (2, 3, 16, 16) if video else (3, 16, 16)
    real = _images(4, n=6, shape=frames)
    fake = _images(5, n=6, shape=frames)
    out = []
    for mod, menu in ((jm, jax_menu), (pm, port_menu)):
        caplog.clear()
        kw = {} if mod is jm else {"device": "cpu"}
        suite = menu.build_metric_suite(video=video, in_pixels=in_pixels,
                                        kid_subset_size=4, **kw)
        warned = sorted(r.getMessage() for r in caplog.records
                        if r.levelname == "WARNING")
        suite.update_real(real)
        suite.update_fake(fake)
        out.append((_decisions(suite), warned, suite.compute(sync=False)))
    (jd, jw, js), (pd, pw, ps) = out
    assert pd == jd
    assert pw == jw
    _close_scores(ps, js)
    if weights and in_pixels:
        assert pd[1] == [] and "patch" not in json.dumps(pd[2])


def test_validate_choices_errors_match_jax():
    for choices, video in ((["fid", "bogus"], False), (["fvd"], False)):
        errs = []
        for menu in (jax_menu, port_menu):
            with pytest.raises(ValueError) as e:
                menu.validate_choices(choices, video=video)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    for video in (False, True):
        assert (port_menu.validate_choices(None, video=video)
                == jax_menu.validate_choices(None, video=video))


def test_unavailable_net_raises_like_jax():
    for mod in (jax_features, port_features):
        with pytest.raises(RuntimeError, match="unavailable"):
            mod.get_extractor("dinov2", *(() if mod is jax_features
                                          else ("cpu",)))


_RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, {repo!r})
from zigma_tpu_torch.metrics import MyMetric
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                        world_size=2, rank=rank)
rng = np.random.default_rng(0)
real, fake = rng.normal(size=(2, 9, 6)), rng.normal(size=(2, 9, 6)) + 0.5
m = MyMetric(choices=["fid", "kid", "prdc", "is"], extractor=lambda x: x,
             logits_extractor=lambda x: x[:, :4], kid_subset_size=6)
m.update_real(real[rank][: 4 + rank])
m.update_fake(fake[rank][: 5 - rank])
print(json.dumps(m.compute(sync=True)))
dist.destroy_process_group()
"""


def test_distributed_gather_matches_one_process():
    """Two gloo processes, each holding part of the features: the gathered
    moments and raw features give the scores of one process holding all."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = _RANK_SCRIPT.format(repo=REPO, port=port)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    scores = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    rng = np.random.default_rng(0)
    real, fake = rng.normal(size=(2, 9, 6)), rng.normal(size=(2, 9, 6)) + 0.5
    one = pm.MyMetric(choices=["fid", "kid", "prdc", "is"],
                      extractor=lambda x: x, logits_extractor=lambda x: x[:, :4],
                      kid_subset_size=6)
    one.update_real(np.concatenate([real[0][:4], real[1][:5]]))
    one.update_fake(np.concatenate([fake[0][:5], fake[1][:4]]))
    want = one.compute(sync=False)
    for got in scores:
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)
