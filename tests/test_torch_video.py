"""Port video ZigMa, parallelN and classifier-free guidance vs the JAX package.

The same perturbed tiny models (depth <= 4, embed 32, 8x8 latents, at most
4 frames) run in both packages, their weights carried by
``state_dict_from_jax``; JAX runs its CPU path.  Perturbing the JAX params
first opens every adaLN gate, so the mixers (and the video folds) are on
the path.

Tolerances (fp32): forward within 1e-5 of max |jax|; each parameter's
gradient of a velocity loss within 1e-4 of its max |jax| (summation order
only).  Scan tables are bit-equal.  A temporal layer whose backward took the
paired ``perm_rev`` (the other frame order) as the gather's inverse would
flip its gradient: the trap test builds such a model and sees the gradients
leave the tolerance by orders of magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zigma_tpu.models.embedders as jax_embedders_mod
from zigma_tpu.convert import convert_state_dict
from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.models.embedders import LabelEmbedder as JaxLabelEmbedder
from zigma_tpu.ops import paths as jax_paths
from zigma_tpu.train import make_diffusion_loss_fn as jax_loss_fn
from zigma_tpu.transport import create_transport as jax_create_transport
from zigma_tpu.transport.transport import Transport as JaxTransport
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.cli import train as train_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.models import embedders as port_embedders
from zigma_tpu_torch.models import mamba as port_mamba
from zigma_tpu_torch.ops import paths
from zigma_tpu_torch.train import make_diffusion_loss_fn
from zigma_tpu_torch.transport import create_transport

TOL_FWD, TOL_GRAD = 1e-5, 1e-4
BASE = dict(in_channels=4, embed_dim=32, img_dim=8, patch_size=2)
CASES = {
    # s, s, t: both spatial zigzags and the forward frame order, with the
    # temporal PE, learned PE over every frame and the label table's null row
    "zzvideo_sst_tpe_pe2_class": dict(
        depth=3, scan_type="zzvideo_sst", video_frames=4, tpe=True, use_pe=2,
        num_classes=5, class_dropout_prob=0.1),
    # s, t, s, t: the forward and the reversed frame order; sin-cos PE
    # tiled over the frames
    "video_st_pe1": dict(depth=4, scan_type="video_st", video_frames=3,
                         use_pe=1),
    # the 3d_sweep2_b2 form: bidirectional v2 over the whole video
    "sweep2_v2_video_class": dict(depth=2, scan_type="v2", video_frames=2,
                                  use_pe=2, num_classes=5),
    # image parallelN: the forward branch and 4 zigzag branches a layer
    "parallelN4": dict(depth=2, scan_type="parallelN4", use_pe=2),
}


def _inputs(cfg, seed=3, batch=2):
    rng = np.random.default_rng(seed)
    T = cfg.get("video_frames", 0)
    shape = (batch, *((T,) if T else ()), 4, 8, 8)
    x1, x0 = (rng.standard_normal(shape).astype(np.float32) for _ in "ab")
    t = rng.uniform(0.05, 0.95, (batch,)).astype(np.float32)
    n = cfg.get("num_classes", -1)
    y = rng.integers(0, n, (batch,)) if n > 0 else None
    return x1, x0, t, y


def _perturbed_params(jmodel, x, t, y, seed=7):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, t, y)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)


def _velocity_loss(out, x0, x1):
    return ((out - (x1 - x0)) ** 2).mean()


def _jax_forward_and_grads(jmodel, params, x1, x0, t, y):
    xt = t.reshape(-1, *[1] * (x1.ndim - 1)) * x1 + (
        1 - t.reshape(-1, *[1] * (x1.ndim - 1))) * x0

    def loss(p):
        out = jmodel.apply(p, xt, t, y)
        return _velocity_loss(out, x0, x1), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return xt, np.asarray(out), state_dict_from_jax(
        jax.tree.map(np.array, grads))


def _port_grads(model, xt, x0, x1, t, y):
    model.zero_grad(set_to_none=True)
    yt = None if y is None else torch.from_numpy(y)
    out = model(torch.from_numpy(xt), torch.from_numpy(t), yt)
    _velocity_loss(out, torch.from_numpy(x0), torch.from_numpy(x1)).backward()
    return out.detach().numpy(), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


def _worst_grad(grads, ref):
    assert set(grads) == set(ref)
    return max((np.max(np.abs(grads[n] - ref[n].numpy()))
                / max(np.max(np.abs(ref[n].numpy())), 1e-8), n)
               for n in grads)


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: JAX model, perturbed params, inputs, forward and grads."""
    out = {}
    for name, cfg in CASES.items():
        # the sequential JAX scan: the same values, the quickest compile
        jmodel = JaxZigMa(**BASE, **cfg, scan_layers=False, scan_backend="ref")
        x1, x0, t, y = _inputs(cfg)
        params = _perturbed_params(jmodel, x1, t, y)
        xt, ref, gref = _jax_forward_and_grads(jmodel, params, x1, x0, t, y)
        out[name] = (jmodel, params, (x1, x0, t, y, xt), ref, gref)
    return out


def _port(cfg, params, **kw):
    model = ZigMa(**BASE, **cfg, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(params))
    return model


@pytest.mark.parametrize("side", [4, 8])
@pytest.mark.parametrize("scan_type,depth,frames", [
    ("zzvideo_sst", 24, 16), ("video_st", 7, 3), ("zzvideo_t", 5, 4),
    ("parallelN4", 3, 0)])
def test_layer_paths_bit_equal(scan_type, depth, frames, side):
    p, pr, st = paths.build_layer_paths(scan_type, depth, side,
                                        video_frames=frames)
    jp, jpr, jst = jax_paths.build_layer_paths(scan_type, depth, side,
                                               video_frames=frames)
    assert st == jst
    for a, b in zip(p + pr, jp + jpr):
        if b is None:
            assert a is None
        else:
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    if scan_type.startswith("parallelN"):
        for (a, ar), (b, br) in zip(
                paths.parallel_scan_perms(scan_type, side),
                jax_paths.parallel_scan_perms(scan_type, side)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ar, br)
    if st is not None and "t" in st:  # the temporal pairs are not inverses
        i = st.index("t")
        assert not np.array_equal(p[i][pr[i]], np.arange(frames))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_jax(name, jax_runs):
    jmodel, params, (x1, x0, t, y, xt), ref, gref = jax_runs[name]
    model = _port(CASES[name], params)
    out, grads = _port_grads(model, xt, x0, x1, t, y)
    assert out.shape == ref.shape == x1.shape
    assert np.max(np.abs(out - ref)) <= TOL_FWD * np.max(np.abs(ref))
    worst, which = _worst_grad(grads, gref)
    assert worst <= TOL_GRAD, (which, worst)
    # the reference state-dict names, both ways
    back = convert_state_dict(model.state_dict(), scan_layers=False)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for u, v in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_paired_perm_rev_in_the_backward_would_fail(jax_runs, monkeypatch):
    """Trusting a temporal layer's paired table as the inverse gather
    flips its gradient: the gradients leave TOL_GRAD."""
    name = "video_st_pe1"
    jmodel, params, (x1, x0, t, y, xt), ref, gref = jax_runs[name]
    monkeypatch.setattr(port_mamba, "vjp_inverse",
                        lambda perm, paired_rev, trust_pair: paired_rev)
    model = _port(CASES[name], params)
    out, grads = _port_grads(model, xt, x0, x1, t, y)
    assert np.max(np.abs(out - ref)) <= TOL_FWD * np.max(np.abs(ref))
    worst, _ = _worst_grad(grads, gref)
    assert worst > 100 * TOL_GRAD


@pytest.mark.parametrize("cfg_channels", [None, 3])
def test_forward_with_cfg_matches_jax(jax_runs, cfg_channels):
    name = "zzvideo_sst_tpe_pe2_class"
    jmodel, params, (x1, x0, t, y, xt), _, _ = jax_runs[name]
    ref = np.asarray(jax.jit(lambda p, a, b, c: jmodel.apply(
        p, a, b, c, 4.0, cfg_channels=cfg_channels,
        method=JaxZigMa.forward_with_cfg))(params, xt, t, y))
    model = _port(CASES[name], params)
    with torch.inference_mode():
        got = model.forward_with_cfg(
            torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(y),
            4.0, cfg_channels=cfg_channels).numpy()
    assert got.shape == ref.shape == xt.shape
    assert np.max(np.abs(got - ref)) <= TOL_FWD * np.max(np.abs(ref))
    if cfg_channels is not None:  # the unguided channels are the cond ones
        with torch.inference_mode():
            cond = model(torch.from_numpy(xt), torch.from_numpy(t),
                         torch.from_numpy(y)).numpy()
        np.testing.assert_array_equal(got[:, :, 3:], cond[:, :, 3:])
    no_null = ZigMa(**BASE, **{**CASES[name], "class_dropout_prob": 0.0},
                    device="cpu")
    with pytest.raises(ValueError, match="null-class"):
        no_null.forward_with_cfg(torch.from_numpy(xt), torch.from_numpy(t),
                                 torch.from_numpy(y), 4.0)


def test_label_embedder_force_drop_and_training_drop():
    """force_drop_ids against JAX's LabelEmbedder (the null row included);
    the ValueError when the table has no null row; the training drop drawn
    from the caller's generator."""
    labels = np.array([0, 3, 4, 1, 2])
    ids = np.array([1, 0, 1, 0, 0])
    jemb = JaxLabelEmbedder(5, 8, dropout_prob=0.1)
    jp = jemb.init(jax.random.PRNGKey(1), labels)
    ref = np.asarray(jemb.apply(jp, labels, force_drop_ids=ids))
    emb = port_embedders.LabelEmbedder(5, 8, dropout_prob=0.1)
    table = np.array(jp["params"]["embedding"]["embedding"])
    assert table.shape == emb.embedding_table.weight.shape == (6, 8)
    with torch.no_grad():
        emb.embedding_table.weight.copy_(torch.from_numpy(table))
        got = emb(torch.from_numpy(labels),
                  force_drop_ids=torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], table[5])
    jbad, bad = JaxLabelEmbedder(5, 8), port_embedders.LabelEmbedder(5, 8)
    with pytest.raises(ValueError, match="null-class"):
        jbad.apply(jbad.init(jax.random.PRNGKey(1), labels), labels,
                   force_drop_ids=ids)
    with pytest.raises(ValueError, match="null-class"):
        bad(torch.from_numpy(labels), force_drop_ids=torch.from_numpy(ids))
    # no null row and no drop: training looks the labels up as they are
    assert bad(torch.from_numpy(labels), train=True).shape == (5, 8)
    many = torch.zeros(20000, dtype=torch.long)
    with torch.no_grad():
        a = emb(many, train=True, generator=torch.Generator().manual_seed(4))
        b = emb(many, train=True, generator=torch.Generator().manual_seed(4))
        c = emb(many, train=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    dropped = (a == emb.embedding_table.weight[5]).all(-1).float().mean()
    assert abs(float(dropped) - 0.1) < 0.01
    assert not (c == emb.embedding_table.weight[5]).all(-1).any()


class _RecordUniform:
    """Stands in for the ``jax`` module inside ``zigma_tpu.models.embedders``
    and records every ``jax.random.uniform`` draw there (the label drop) by
    ``jax.debug.callback``."""

    def __init__(self, sink):
        class _Random:
            def __getattr__(self, n):
                return getattr(jax.random, n)

            def uniform(self, key, shape, *a, **kw):
                u = jax.random.uniform(key, shape, *a, **kw)
                jax.debug.callback(lambda v: sink.append(np.array(v)), u,
                                   ordered=True)
                return u

        self.random = _Random()

    def __getattr__(self, n):
        return getattr(jax, n)


def test_training_loss_replays_the_jax_label_drop(monkeypatch):
    """The class-conditional video model's training loss with the label
    drop on (rate 0.5, drop-path off): JAX's (t, x0) draw and its label-drop
    uniforms are recorded and replayed in the port through
    ``force_drop_ids``; loss within 1e-5 relative, gradients TOL_GRAD."""
    cfg = dict(CASES["zzvideo_sst_tpe_pe2_class"], depth=2,
               scan_type="zzvideo_st", class_dropout_prob=0.5,
               drop_path_rate=0.0)
    jmodel = JaxZigMa(**BASE, **cfg, scan_layers=False, scan_backend="ref")
    x1, _, t, y = _inputs(cfg, batch=4)
    params = _perturbed_params(jmodel, x1, t, y)
    draws, uniforms = [], []
    real_sample = JaxTransport.sample

    def sample(tr, rng, x):
        tt, x0, x = real_sample(tr, rng, x)
        jax.debug.callback(lambda a, b: draws.append((np.array(a),
                                                      np.array(b))),
                           tt, x0, ordered=True)
        return tt, x0, x

    monkeypatch.setattr(JaxTransport, "sample", sample)
    monkeypatch.setattr(jax_embedders_mod, "jax", _RecordUniform(uniforms))
    batch = {"x": x1, "y": y}
    vg = jax.jit(jax.value_and_grad(jax_loss_fn(jmodel,
                                                jax_create_transport())))
    for k in range(40):  # a key whose drop takes some labels, not all
        draws.clear()
        uniforms.clear()
        jloss, jgrads = vg(params, jax.random.PRNGKey(k), batch)
        jax.effects_barrier()
        (u,) = uniforms
        if 0 < (u < 0.5).sum() < 4:
            break
    drop = torch.from_numpy((u < 0.5).astype(np.int64))
    (tt, x0), = draws

    real_forward = port_embedders.LabelEmbedder.forward
    seen = []

    def replay(self, labels, train=False, force_drop_ids=None,
               generator=None):
        assert train
        seen.append(True)
        return real_forward(self, labels, force_drop_ids=drop)

    monkeypatch.setattr(port_embedders.LabelEmbedder, "forward", replay)
    model = _port(cfg, params)
    loss = make_diffusion_loss_fn(model, create_transport())(
        {"x": torch.from_numpy(x1), "y": torch.from_numpy(y)},
        t=torch.from_numpy(tt), x0=torch.from_numpy(x0))
    loss.backward()
    assert seen == [True]
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    worst, which = _worst_grad(
        grads, state_dict_from_jax(jax.tree.map(np.array, jgrads)))
    assert worst <= TOL_GRAD, (which, worst)


def test_write_video_grid_matches_jax(tmp_path):
    from zigma_tpu.utils import logging_utils as jax_lu
    from zigma_tpu_torch.utils import logging_utils as lu

    v = np.random.default_rng(5).uniform(-1.1, 1.1, (3, 4, 3, 6, 6))
    a = lu.write_video_grid(v, str(tmp_path / "port.gif"))
    b = jax_lu.write_video_grid(v, str(tmp_path / "jax.gif"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    from PIL import Image
    with Image.open(a) as im:
        assert im.n_frames == 4
    with pytest.raises(ValueError, match="B, T, C, H, W"):
        lu.write_video_grid(v[0], str(tmp_path / "bad.gif"))


VIDEO_TINY = ["model=3d_zigzag8sst_b2", "data=synthetic",
              "data.video_frames=2", "model.params.video_frames=2",
              "data.num_classes=5",
              "model.params.class_dropout_prob=0.1", "model.params.depth=3",
              "model.params.embed_dim=32", "model.params.img_dim=8"]


def test_video_train_and_guided_sample_clis(tmp_path):
    """cli.train on synthetic class-conditional video (remat, label drop,
    in-training dopri5 sampling to a GIF), then cli.sample from its
    checkpoint with classifier-free guidance: one .npy a batch and one .gif
    a sample."""
    res = train_cli.main([*VIDEO_TINY, "data.batch_size=2",
                          "data.train_steps=2", "log_every=1",
                          "sample_every=2", "ode.num_sampling_steps=3",
                          f"results_dir={tmp_path}", "device=cpu"])
    assert [r["step"] for r in res["records"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in res["records"])
    assert os.path.exists(os.path.join(res["run_dir"], "vis", "0000002.gif"))
    model = res["state"].model
    assert model.video_frames == 2 and model.use_checkpoint
    assert model.y_embedder.embedding_table.weight.shape[0] == 6
    out = sample_cli.main([
        f"ckpt={res['checkpoint']}", *VIDEO_TINY, "cfg_scale=4",
        "sample_mode=ODE", "ode.sampling_method=euler",
        "ode.num_sampling_steps=3", "num_fid_samples=2",
        "offline_sample_local_bs=2", f"sample_dir={tmp_path}", "device=cpu"])
    assert out["n_nonfinite"] == 0 and out["model_calls"] == [2]
    files = sorted(os.listdir(out["out_dir"]))
    assert files == ["000000.gif", "000001.gif", "video_0_0.npy"]
    arr = np.load(os.path.join(out["out_dir"], "video_0_0.npy"))
    assert arr.shape == (2, 2, 4, 8, 8)
    with pytest.raises(ValueError, match="class_dropout_prob"):
        sample_cli.main([
            f"ckpt={res['checkpoint']}", *VIDEO_TINY[:-4],
            "model.params.depth=3", "model.params.embed_dim=32",
            "model.params.img_dim=8", "cfg_scale=4",
            f"sample_dir={tmp_path}", "device=cpu"])


@pytest.mark.parametrize("name", ["zzvideo_sst_tpe_pe2_class", "parallelN4"])
def test_inference_cast_matches_jax(name, jax_runs):
    """The bf16 inference cast casts the same leaves as the JAX package's
    (temporal PE and label table kept fp32, parallelN branch weights cast):
    a 1/0 "was cast" mark is carried through the layout converter."""
    from zigma_tpu.utils.inference import cast_params_for_inference
    from zigma_tpu_torch.utils.inference import cast_for_inference

    _, params, _, _, _ = jax_runs[name]
    jcast = cast_params_for_inference(jax.tree.map(jnp.asarray, params))
    mark = state_dict_from_jax(jax.tree.map(
        lambda p: np.full(p.shape, float(p.dtype == jnp.bfloat16), np.float32),
        jcast))
    model = cast_for_inference(_port(CASES[name], params, dtype=torch.bfloat16))
    n_cast = 0
    for pname, p in model.named_parameters():
        was_cast = bool(mark[pname].flatten()[0])
        assert p.dtype == (torch.bfloat16 if was_cast else torch.float32), pname
        n_cast += was_cast
    assert n_cast > 0
