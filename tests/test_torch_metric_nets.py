"""The port's metric nets against the JAX package's, on the same weights.

Weights come from the JAX nets' ``random_params(seed)`` through
``zigma_tpu_torch.convert.from_jax``; the same seeded numpy inputs go
through both.  Tolerances are relative: max |port - JAX| <= TOL x max |JAX|
per output, TOL = 1e-4.  fp32 convolutions and matmuls sum in another order
in XLA:CPU than in torch, and Inception's and I3D's activations reach
1e3 (the styleganv feed is in [0, 255]), so an absolute limit would hold
the small taps loosely and the large ones too tightly.  The reading that
set it (XLA:CPU against torch on an x86 CPU): 3.9e-7 to 2.4e-6 over Inception's five taps, 2.1e-6
for DINOv2 vits14, 1.4e-6 for both I3D flavours, 4.4e-7 for LPIPS: the
limit sits about 40x above the worst.

Also: the TF1 resize, the SAME pads and pools, the Unit3D and the bicubic
resizes (image and position embedding) each alone; the JAX loaders' torch
state dicts load into the port with ``strict=True`` and the port's state
dicts back through the JAX loaders to the same trees; the TorchScript I3D
converter gives the JAX converter's weights from an archive the test
traces and saves; missing keys raise; weight files found through the
environment variables become nets on the asked-for device.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zigma_tpu.convert.torchscript_i3d import (
    convert_torchscript_i3d as jax_convert_ts)
from zigma_tpu.metrics import dinov2_jax, i3d_jax, inception_jax, lpips_jax
from zigma_tpu_torch.convert import from_jax
from zigma_tpu_torch.convert.torchscript_i3d import convert_torchscript_i3d
from zigma_tpu_torch.metrics import dinov2, features, i3d, inception
from zigma_tpu_torch.metrics import lpips as lp

TOL = 1e-4  # of max |JAX output|; see the module docstring


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= tol, err


# ---------------------------------------------------------------- Inception --

@pytest.fixture(scope="module")
def inc():
    params = _np(inception_jax.random_params(0))
    imgs = np.random.default_rng(0).integers(0, 256, (2, 3, 64, 64), np.uint8)
    ref = inception_jax.inception_forward(
        params, jnp.asarray(imgs), features=inception_jax.FEATURE_NAMES)
    net = inception.from_state_dict(
        from_jax.inception_state_dict_from_jax(params))
    with torch.inference_mode():
        got = net(torch.from_numpy(imgs), features=inception.FEATURE_NAMES)
    return dict(params=params, imgs=imgs, net=net,
                ref={k: np.asarray(v) for k, v in ref.items()},
                got={k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("tap", inception.FEATURE_NAMES)
def test_inception_taps_match_jax(inc, tap):
    want = {"64": 64, "192": 192, "768": 7 * 17 * 17, "2048": 2048,
            "logits_unbiased": inception.NUM_CLASSES}[tap]
    assert inc["got"][tap].shape == (2, want)
    _close(inc["got"][tap], inc["ref"][tap])


@pytest.mark.parametrize("hw", [(64, 64), (300, 217), (17, 40)])
def test_tf1_resize_matches_jax(hw):
    x = np.random.default_rng(1).uniform(0, 255, (2, 3, *hw)).astype(
        np.float32)
    want = np.asarray(inception_jax.tf1_bilinear_resize(
        jnp.asarray(x.transpose(0, 2, 3, 1)), 299)).transpose(0, 3, 1, 2)
    got = inception.tf1_bilinear_resize(torch.from_numpy(x), 299).numpy()
    _close(got, want, tol=1e-6)
    # not torch's half-pixel bilinear
    half = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(299, 299), mode="bilinear",
        align_corners=False).numpy()
    assert np.max(np.abs(half - want)) > 1.0


def test_inception_pools_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 9, 11, 5)).astype(
        np.float32)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    for got, want in (
            (inception._avg_pool_nopad(tx), inception_jax._avg_pool_nopad(x)),
            (inception._max_pool(tx), inception_jax._max_pool(x)),
            (inception._max_pool(tx, 3, 1, 1),
             inception_jax._max_pool(x, 3, 1, 1))):
        _close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), tol=1e-6)


# ------------------------------------------------------------------ DINOv2 ---

def test_dinov2_vits14_matches_jax():
    params = _np(dinov2_jax.random_params(0, "vits14"))
    imgs = np.random.default_rng(3).integers(0, 256, (2, 3, 40, 40), np.uint8)
    want = dinov2_jax.dinov2_extractor(params, "vits14", batch=2,
                                       resolution=56)(imgs)
    net = dinov2.from_state_dict(
        from_jax.dinov2_state_dict_from_jax(params), "vits14")
    got = dinov2.dinov2_extractor(net, batch=2, resolution=56)(imgs)
    assert got.shape == (2, 384)
    _close(got, want)


@pytest.mark.parametrize("hw_in,hw_out", [((256, 256), (224, 224)),
                                          ((40, 40), (56, 56)),
                                          ((7, 9), (13, 5))])
def test_bicubic_resize_matches_jax(hw_in, hw_out):
    """torch's bicubic (a = -0.75, half-pixel, no antialias) is the
    function the JAX package emulates, within TOL: torch takes the source
    coordinates in float32, the emulation in float64, which read 2.3e-5 of
    max |JAX| at 256 -> 224 on the CPU; the port keeps torch's (the hub model's
    own resize)."""
    x = np.random.default_rng(4).uniform(0, 1, (2, *hw_in, 3)).astype(
        np.float32)
    want = np.asarray(dinov2_jax.torch_bicubic_resize(jnp.asarray(x),
                                                      *hw_out))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), size=hw_out,
        mode="bicubic", align_corners=False, antialias=False)
    _close(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("grid", [16, 4, 37])
def test_pos_embed_interpolation_matches_jax(grid):
    pe = np.random.default_rng(5).standard_normal((1, 1 + 37 * 37, 8)).astype(
        np.float32)
    want = dinov2_jax._interp_pos_embed(jnp.asarray(pe), grid, grid)
    got = dinov2.interp_pos_embed(torch.from_numpy(pe), grid, grid)
    for g, w in zip(got, want):  # read at most 2.3e-6 of max |JAX|
        _close(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------- I3D ---

@pytest.fixture(scope="module")
def i3d_nets():
    params = _np(i3d_jax.random_params(0))
    net = i3d.from_state_dict(from_jax.i3d_state_dict_from_jax(params))
    vids = np.random.default_rng(6).integers(0, 256, (2, 16, 64, 64, 3),
                                             np.uint8)
    return params, net, vids


@pytest.fixture(scope="module")
def i3d_archive(i3d_nets, tmp_path_factory):
    """The port's I3D traced and saved as a TorchScript archive (the
    StyleGAN-V detector's format), at a small input."""
    path = str(tmp_path_factory.mktemp("ts") / "i3d_torchscript.pt")
    with torch.no_grad():
        torch.jit.trace(i3d_nets[1], torch.zeros(1, 3, 8, 32, 32)).save(path)
    return path


@pytest.mark.parametrize("flavor", ["videogpt", "styleganv"])
def test_i3d_matches_jax(i3d_nets, flavor):
    params, net, vids = i3d_nets
    jax_ex, port_ex = {"videogpt": (i3d_jax.i3d_extractor,
                                    i3d.i3d_extractor),
                       "styleganv": (i3d_jax.styleganv_extractor,
                                     i3d.styleganv_extractor)}[flavor]
    want = jax_ex(params, batch=2, resolution=64)(vids)
    got = port_ex(net, batch=2, resolution=64)(vids)
    assert got.shape == (2, i3d.NUM_CLASSES)
    _close(got, want)
    assert got.std(0).max() > 1e-4  # not collapsed


@pytest.mark.parametrize("shape,res", [((2, 4, 37, 61, 3), 32),
                                       ((1, 3, 50, 30, 3), 24)])
def test_i3d_preprocessing_matches_jax(shape, res):
    """torch's bilinear, which the JAX package emulates, within TOL (its
    float32 source coordinates read 3.3e-6 of max |JAX| on the CPU)."""
    v = np.random.default_rng(7).integers(0, 256, shape, np.uint8)
    for jfn, pfn in ((i3d_jax.fvd_preprocess, i3d.fvd_preprocess),
                     (i3d_jax.styleganv_gating_preprocess,
                      i3d.styleganv_gating_preprocess)):
        _close(pfn(torch.from_numpy(v), res).numpy(),
               np.asarray(jfn(v, res)))


def test_same_pads_and_pools_match_jax():
    for size in range(1, 12):
        for k in (1, 2, 3, 7):
            for s in (1, 2):
                assert i3d.same_pads(size, k, s) == i3d_jax._same_pads(
                    size, k, s)
    x = np.random.default_rng(8).standard_normal((2, 5, 9, 10, 4)).astype(
        np.float32)
    tx = torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy())
    for kernel, stride in (((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)),
                           ((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))):
        want = np.asarray(i3d_jax._max_pool_same(jnp.asarray(x), kernel,
                                                 stride))
        got = i3d.max_pool_same(tx, kernel, stride).numpy()
        _close(got, want.transpose(0, 4, 1, 2, 3), tol=1e-7)
    # zero padding, not -inf: an all-negative input pools to 0 at the edge
    neg = -torch.ones(1, 1, 3, 3, 3)
    assert i3d.max_pool_same(neg, (3, 3, 3), (2, 2, 2)).max() == 0.0


@pytest.mark.parametrize("name", ["Conv3d_1a_7x7", "Mixed_3b.b1b"])
def test_unit3d_matches_jax(i3d_nets, name):
    params, net, _ = i3d_nets
    cin = i3d.UNIT_SPECS[name][0]
    x = np.random.default_rng(9).standard_normal((1, 5, 11, 12, cin)).astype(
        np.float32)
    want = np.asarray(i3d_jax._unit3d(jnp.asarray(x), params[name],
                                      i3d_jax.UNIT_SPECS[name]))
    with torch.inference_mode():
        got = net.get_submodule(name)(
            torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()))
    _close(got.numpy(), want.transpose(0, 4, 1, 2, 3))


# ------------------------------------------------------------------- LPIPS ---

def test_lpips_matches_jax():
    params = _np(lpips_jax.random_params(0))
    model = lp.from_state_dicts(*from_jax.lpips_state_dicts_from_jax(params))
    rng = np.random.default_rng(10)
    a = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    _close(lp.lpips(model, a, b).numpy(),
           np.asarray(lpips_jax.lpips(params, jnp.asarray(a), jnp.asarray(b))))
    assert float(lp.lpips(model, a, a).abs().max()) < 1e-6
    v0 = rng.uniform(0, 1, (2, 3, 3, 32, 32)).astype(np.float32)
    v1 = rng.uniform(0, 1, (2, 3, 3, 32, 32)).astype(np.float32)
    _close(lp.lpips_video(model, v0, v1).numpy(),
           np.asarray(lpips_jax.lpips_video(params, jnp.asarray(v0),
                                            jnp.asarray(v1))))
    want = lpips_jax.lpips_per_timestep(params, v0, v1)
    got = lp.lpips_per_timestep(model, v0, v1)
    assert got["value"].keys() == want["value"].keys()
    for t in want["value"]:
        assert got["value"][t] == pytest.approx(want["value"][t], rel=TOL)
    assert got["mean"] == pytest.approx(want["mean"], rel=TOL)


# ----------------------------------------------------------------- weights ---

def _with_bn_counters(sd):
    return {**sd, **{k.replace("running_mean", "num_batches_tracked"):
                     torch.tensor(0) for k in sd if k.endswith("running_mean")}}


def _same_tree(a, b):
    fa, ta = jax.tree.flatten(_np(a))
    fb, tb = jax.tree.flatten(_np(b))
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)


def test_inception_weights_round_trip(inc):
    sd = _with_bn_counters(from_jax.inception_state_dict_from_jax(
        inc["params"]))
    net = inception.InceptionV3()
    net.load_state_dict(sd, strict=True)  # the file JAX reads loads here
    inception.from_state_dict({f"base.{k}": v for k, v in sd.items()})
    back = inception_jax.load_torch_state_dict(net.state_dict())
    _same_tree(back, inc["params"])
    del sd["Mixed_6e.branch7x7_2.bn.running_var"]
    with pytest.raises(RuntimeError, match="Missing key"):
        inception.from_state_dict(sd)


def test_dinov2_weights_round_trip():
    params = _np(dinov2_jax.random_params(1, "vits14"))
    sd = from_jax.dinov2_state_dict_from_jax(params)
    net = dinov2.DinoV2("vits14")
    net.load_state_dict(sd, strict=True)
    # the hub file carries a mask_token, which the features never use
    dinov2.from_state_dict({**sd, "mask_token": torch.zeros(1, 384)},
                           "vits14")
    _same_tree(dinov2_jax.load_torch_state_dict(net.state_dict(), "vits14"),
               params)
    del sd["blocks.3.ls2.gamma"]
    with pytest.raises(RuntimeError, match="Missing key"):
        dinov2.from_state_dict(sd, "vits14")


def test_i3d_and_lpips_weights_round_trip(i3d_nets):
    params, net, _ = i3d_nets
    sd = _with_bn_counters(from_jax.i3d_state_dict_from_jax(params))
    i3d.from_state_dict({f"module.{k}": v for k, v in sd.items()})
    _same_tree(i3d_jax.load_torch_state_dict(net.state_dict()), params)
    del sd["logits.conv3d.bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        i3d.from_state_dict(sd)

    lparams = _np(lpips_jax.random_params(2))
    alex, heads = from_jax.lpips_state_dicts_from_jax(lparams)
    model = lp.from_state_dicts(
        {**alex, "classifier.1.weight": torch.zeros(4096, 9216)},
        {f"lins.{k[3:]}": v for k, v in heads.items()})
    back = lpips_jax.load_torch_state_dicts(
        model.alex.state_dict(),
        {k: v for k, v in model.state_dict().items() if k.startswith("lin")})
    _same_tree(back, lparams)
    with pytest.raises(RuntimeError, match="Missing key"):
        lp.from_state_dicts({}, heads)


def test_torchscript_i3d_converter_matches_jax(i3d_archive):
    path = i3d_archive
    got = convert_torchscript_i3d(path)
    want = from_jax.i3d_state_dict_from_jax(_np(jax_convert_ts(path)))
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    i3d.from_state_dict(got)
    # renamed keys, registration order kept: the by-order mapping
    sd = torch.jit.load(path).state_dict()
    renamed = {f"opaque.{i:03d}": v for i, v in enumerate(sd.values())}
    by_order = convert_torchscript_i3d(renamed)
    jax_by_order = from_jax.i3d_state_dict_from_jax(
        _np(jax_convert_ts(renamed)))
    for k in want:
        torch.testing.assert_close(by_order[k], got[k], rtol=0, atol=0)
        torch.testing.assert_close(jax_by_order[k], got[k], rtol=0, atol=0)
    with pytest.raises((KeyError, ValueError)):
        convert_torchscript_i3d(
            {"a.weight": np.zeros((4, 4, 3, 3, 3), np.float32)})


def test_weight_files_become_nets_on_the_device(inc, i3d_nets, tmp_path,
                                                monkeypatch):
    """``ZIGMA_INCEPTION_WEIGHTS`` / ``ZIGMA_I3D_WEIGHTS`` /
    ``ZIGMA_I3D_TORCHSCRIPT`` files resolve to the port's nets on the
    device asked for, computing what the nets compute."""
    monkeypatch.setattr(features, "_REGISTRY", {})
    monkeypatch.setattr(features, "_RESOLVED", {})
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    torch.save(inc["net"].state_dict(), tmp_path / "pt_inception.pth")
    torch.save(i3d_nets[1].state_dict(), tmp_path / "i3d_pretrained_400.pt")
    monkeypatch.setenv("ZIGMA_INCEPTION_WEIGHTS",
                       str(tmp_path / "pt_inception.pth"))
    monkeypatch.setenv("ZIGMA_I3D_WEIGHTS",
                       str(tmp_path / "i3d_pretrained_400.pt"))
    with pytest.raises(RuntimeError, match="unavailable"):
        features.get_extractor("i3d_styleganv", "cpu")
    monkeypatch.setenv("ZIGMA_I3D_TORCHSCRIPT",
                       str(tmp_path / "i3d_pretrained_400.pt"))
    for name, tap in (("inception", "2048"), ("inception_sfid", "768"),
                      ("inception_logits", "logits_unbiased")):
        ex = features.get_extractor(name, "cpu")
        assert isinstance(ex, features.NetExtractor)
        assert ex.device == torch.device("cpu")
        assert features.get_extractor(name, "cpu") is ex  # built once
        # one tap at a time: the early return gives the full graph's tap
        np.testing.assert_allclose(ex(inc["imgs"]), inc["got"][tap],
                                   rtol=1e-5, atol=1e-5)
        assert ex.seconds > 0 and ex.copy_seconds > 0
    for name in ("i3d", "i3d_styleganv"):
        ex = features.get_extractor(name, "cpu")
        assert isinstance(ex, features.NetExtractor) and ex.name == name


def test_torchscript_archives_in_the_hub_cache_are_the_second_route(
        inc, i3d_nets, i3d_archive, tmp_path, monkeypatch):
    """With no state dict anywhere, TorchScript archives under the torch
    hub cache are run as they are, on the device asked for: Inception fed
    uint8 images, I3D behind the videogpt preprocessing."""
    class Pool(torch.nn.Module):  # a FID-Inception archive: uint8 -> 2048
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x, features=("2048",))["2048"]

    monkeypatch.setattr(features, "_REGISTRY", {})
    monkeypatch.setattr(features, "_RESOLVED", {})
    for var in ("ZIGMA_INCEPTION_WEIGHTS", "ZIGMA_I3D_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    hub = tmp_path / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    with torch.no_grad():  # traced at batch 1, the resize baked at 64^2
        torch.jit.trace(Pool(inc["net"]), torch.from_numpy(
            inc["imgs"][:1])).save(str(hub / "inception-2015-12-05.pt"))
    shutil.copy(i3d_archive, hub / "i3d_torchscript.pt")
    ex = features.get_extractor("inception", "cpu")
    assert ex.name == "inception:torchscript"
    np.testing.assert_allclose(ex(inc["imgs"]), inc["got"]["2048"],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="unavailable"):
        features.get_extractor("inception_sfid", "cpu")  # no such archive
    vids = np.random.default_rng(11).integers(0, 256, (1, 8, 40, 48, 3),
                                              np.uint8)
    ex = features.get_extractor("i3d", "cpu")
    assert ex.name == "i3d:torchscript" and ex.device.type == "cpu"
    with torch.inference_mode():
        want = i3d_nets[1](i3d.fvd_preprocess(torch.from_numpy(vids), 32))
    got = features.NetExtractor("i3d", ex.net, lambda v: ex.net(
        i3d.fvd_preprocess(v, 32)), "cpu", 8, image=False)(vids)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-4)
