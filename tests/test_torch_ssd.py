"""Port SSD scan and Mamba-2 mixer vs the JAX package.

The same numpy inputs from a seed go through ``zigma_tpu.ops.ssd`` /
``zigma_tpu.models.mamba2`` and their port counterparts; weights go through
``state_dict_from_jax`` (module params perturbed by 0.02, so the DiT
zero-init does not gate the mixers off).  JAX has no Pallas kernel here:
both sides are plain einsum / matmul code.

Tolerances: fp32 outputs within 1e-5 of max |jax| (summation order only),
fp32 gradients within 1e-4 of max |jax| per input or parameter; the model
forward within 1e-4 max abs (as ``tests/test_torch_model.py``).  bf16: the
chunked form rounds where JAX's does (bf16 Y contractions, fp32 scores and
aggregates), so outputs agree within 2e-2 of max |jax| (bf16 roundings of
the same fp32 values that flip under a different summation order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.models.mamba2 import Mamba2 as JaxMamba2
from zigma_tpu.ops import paths as jax_paths
from zigma_tpu.ops.ssd import ssd_scan as jax_ssd_scan
from zigma_tpu.ops.ssd import ssd_state_update as jax_state_update
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.cli import train as train_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.convert.from_jax import _block
from zigma_tpu_torch.models import Mamba2, ZigMa
from zigma_tpu_torch.ops.ssd import ssd_scan, ssd_scan_ref, ssd_state_update

TOL_FP32, TOL_GRAD, TOL_BF16, TOL_FWD = 1e-5, 1e-4, 2e-2, 1e-4
ARGS = ("x", "dt", "A", "B", "C", "D", "z", "dt_bias", "initial_state")
SCAN_CASES = {
    # L not a multiple of the chunk, two groups, D per head, the gate, a
    # seed state and the last state
    "L200_Q64_G2_Dh_z_init_last": dict(batch=2, L=200, H=4, P=8, G=2, N=16,
                                       chunk=64, D="h", z=True, init=True,
                                       last=True),
    # L below one chunk, one group, D per (head, channel)
    "L96_Q128_G1_Dhp": dict(batch=2, L=96, H=2, P=8, G=1, N=8, chunk=128,
                            D="hp", z=False, init=False, last=False),
}


def _scan_inputs(batch, L, H, P, G, N, D, z, init, seed=0, **_):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(batch, L, H, P), dt=0.5 * f(batch, L, H),
                A=-np.exp(0.5 * f(H)), B=f(batch, L, G, N), C=f(batch, L, G, N),
                D=f(H) if D == "h" else f(H, P), z=f(batch, L, H, P) if z else None,
                dt_bias=0.1 * f(H),
                initial_state=f(batch, H, P, N) if init else None)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(
        np.asarray(a)).requires_grad_(grad)


def _loss_weights(y_shape, s_shape, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(y_shape).astype(np.float32),
            rng.standard_normal(s_shape).astype(np.float32))


@pytest.fixture(scope="module")
def jax_scans():
    """Per case: inputs, JAX's chunked y (and last state) and the gradients
    of ``sum(y * wy) + sum(S * wS)`` by ``jax.grad``."""
    out = {}
    for name, c in SCAN_CASES.items():
        d = _scan_inputs(**c)
        wy, ws = _loss_weights((c["batch"], c["L"], c["H"], c["P"]),
                               (c["batch"], c["H"], c["P"], c["N"]))
        names = [k for k in ARGS if d[k] is not None]

        def f(*vals):
            kw = dict(zip(names, vals))
            res = jax_ssd_scan(**kw, dt_softplus=True, return_last_state=True,
                               backend="chunked", chunk=c["chunk"])
            return jnp.sum(res[0] * wy) + c["last"] * jnp.sum(res[1] * ws), res

        (_, (y, S)), g = jax.jit(jax.value_and_grad(
            f, argnums=tuple(range(len(names))), has_aux=True))(
                *(jnp.asarray(d[k]) for k in names))
        out[name] = (d, wy, ws, np.asarray(y), np.asarray(S),
                     dict(zip(names, (np.asarray(v) for v in g))))
    return out


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got, np.float32) - ref))
                 / max(np.max(np.abs(ref)), 1e-30))


@pytest.mark.parametrize("backend", ["chunked", "ref"])
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_ssd_scan_and_gradients_match_jax(name, backend, jax_scans):
    c = SCAN_CASES[name]
    d, wy, ws, y_ref, s_ref, g_ref = jax_scans[name]
    ins = {k: _t(v, grad=True) for k, v in d.items()}
    y, S = ssd_scan(**ins, dt_softplus=True, return_last_state=True,
                    backend=backend, chunk=c["chunk"])
    assert y.shape == y_ref.shape and S.shape == s_ref.shape
    assert y.dtype == S.dtype == torch.float32
    assert _rel(y.detach(), y_ref) <= TOL_FP32
    assert _rel(S.detach(), s_ref) <= TOL_FP32
    (torch.sum(y * _t(wy)) + c["last"] * torch.sum(S * _t(ws))).backward()
    for k, r in g_ref.items():
        assert _rel(ins[k].grad, r) <= TOL_GRAD, k


def test_ssd_scan_without_options_and_bf16_match_jax():
    """No D, z, bias or seed, at the default chunk; then bf16 inputs
    through the chunked form on both sides."""
    c = dict(batch=2, L=160, H=4, P=8, G=1, N=16, D="h", z=True, init=False)
    d = _scan_inputs(**c, seed=4)
    base = ("x", "dt", "A", "B", "C")
    ref = np.asarray(jax.jit(jax_ssd_scan)(*(jnp.asarray(d[k]) for k in base)))
    got = ssd_scan(*(_t(d[k]) for k in base))
    assert _rel(got, ref) <= TOL_FP32
    bf = {k: jnp.asarray(v, jnp.bfloat16) if k in ("x", "dt", "B", "C", "z")
          else jnp.asarray(v) for k, v in d.items() if v is not None}
    ref = np.asarray(jax.jit(lambda kw: jax_ssd_scan(**kw, dt_softplus=True))(bf),
                     np.float32)
    got = ssd_scan(**{k: torch.from_numpy(np.array(v.astype(jnp.float32)))
                      .to(torch.bfloat16 if v.dtype == jnp.bfloat16
                          else torch.float32) for k, v in bf.items()},
                   dt_softplus=True)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), ref) <= TOL_BF16


def test_ssd_ref_in_float64_is_the_truth_of_both():
    """In float64 the sequential form and the chunked one agree to float64
    rounding (the truth the card's gate holds fp32 and bf16 runs against)."""
    c = SCAN_CASES["L200_Q64_G2_Dh_z_init_last"]
    d = {k: None if v is None else torch.from_numpy(v).double()
         for k, v in _scan_inputs(**c).items()}
    y_ref = ssd_scan_ref(**d, dt_softplus=True)
    y_chk = ssd_scan(**d, dt_softplus=True, chunk=c["chunk"])
    assert y_ref.dtype == y_chk.dtype == torch.float64
    assert float((y_ref - y_chk).abs().max() / y_ref.abs().max()) <= 1e-12


def test_ssd_state_update_matches_jax_and_checks_shapes():
    rng = np.random.default_rng(2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    b, H, P, G, N = 3, 4, 8, 2, 16
    args = dict(state=f(b, H, P, N), x=f(b, H, P), dt=0.5 * f(b, H),
                A=-np.exp(0.5 * f(H)), B=f(b, G, N), C=f(b, G, N))
    opt = dict(D=f(H, P), z=f(b, H, P), dt_bias=0.1 * f(H))
    y_j, s_j = jax_state_update(**{k: jnp.asarray(v) for k, v in args.items()},
                                **{k: jnp.asarray(v) for k, v in opt.items()},
                                dt_softplus=True)
    y, s = ssd_state_update(**{k: _t(v) for k, v in {**args, **opt}.items()},
                            dt_softplus=True)
    assert _rel(y, np.asarray(y_j)) <= TOL_FP32
    assert _rel(s, np.asarray(s_j)) <= TOL_FP32
    bad = {"state": f(b, H, P, N + 1), "dt": f(b, H + 1), "A": f(H, 1),
           "B": f(b, G, N + 1), "z": f(b, H, P + 1), "D": f(P)}
    for k, v in bad.items():
        kw = {**args, **opt, k: v}
        with pytest.raises(ValueError, match="shape|must be"):
            ssd_state_update(**{n: _t(a) for n, a in kw.items()})
    with pytest.raises(ValueError, match="divisible"):
        ssd_state_update(**{n: _t(a) for n, a in
                            {**args, "B": f(b, 3, N), "C": f(b, 3, N)}.items()})


MIXER_CASES = {
    "v1": dict(scan_type="v1", L=20),
    "v2": dict(scan_type="v2", L=20, ngroups=2),
    "zigzagN8": dict(scan_type="zigzagN8", L=16, layer=3),
    "video_s": dict(scan_type="zzvideo_sst", L=32, layer=0, frames=2),
    "video_t": dict(scan_type="zzvideo_sst", L=32, layer=2, frames=2),
}


@pytest.mark.parametrize("name", list(MIXER_CASES))
def test_mamba2_mixer_matches_jax(name):
    c = dict(MIXER_CASES[name])
    L, frames = c.pop("L"), c.pop("frames", 0)
    perm = perm_rev = st = None
    if "layer" in c:
        side = 4
        p, pr, sts = jax_paths.build_layer_paths(
            c["scan_type"], 4, side, video_frames=frames)
        i = c.pop("layer")
        perm, perm_rev = p[i], pr[i]
        st = None if sts is None else sts[i]
    kw = dict(d_state=8, headdim=16, scan_type=c["scan_type"],
              ngroups=c.get("ngroups", 1), video_frames=frames, st=st)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, L, 32)).astype(np.float32)
    jmod = JaxMamba2(d_model=32, scan_chunk=8, perm=perm, perm_rev=perm_rev,
                     **kw)
    rng_p = np.random.default_rng(8)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng_p.standard_normal(a.shape)
        .astype(np.float32), jax.jit(jmod.init)(jax.random.PRNGKey(3), x))
    wy = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        o = jmod.apply(p, xx)
        return jnp.sum(o * wy), o

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    sd, gsd = {}, {}
    for tree, into in ((params, sd), (gp, gsd)):
        blk = {"norm_weight": np.ones(32, np.float32),
               "adaLN": {"kernel": np.zeros((32, 96), np.float32)},
               "mixer": jax.tree.map(np.asarray, tree["params"])}
        _block(into, "b", blk)
    mod = Mamba2(32, scan_chunk=8, perm=perm, perm_rev=perm_rev, device="cpu",
                 **kw)
    mod.load_state_dict({k[len("b.mixer."):]: v for k, v in sd.items()
                         if k.startswith("b.mixer.")})
    xt = _t(x, grad=True)
    out = mod(xt)
    assert _rel(out.detach(), np.asarray(ref)) <= TOL_FP32
    torch.sum(out * _t(wy)).backward()
    assert _rel(xt.grad, np.asarray(gx)) <= TOL_GRAD
    for n, p in mod.named_parameters():
        assert _rel(p.grad, gsd[f"b.mixer.{n}"].numpy()) <= TOL_GRAD, n
    if c["scan_type"] == "v2":
        assert {"conv1d_b.weight", "A_b_log", "dt_b_bias", "D_b"} <= set(
            dict(mod.named_parameters()))


def test_mamba2_refuses_parallelN_and_bad_widths():
    with pytest.raises(ValueError, match="parallelN"):
        Mamba2(32, headdim=16, scan_type="parallelN4", device="cpu")
    with pytest.raises(ValueError, match="headdim"):
        Mamba2(32, headdim=24, device="cpu")
    with pytest.raises(ValueError, match="ngroups"):
        Mamba2(32, headdim=16, ngroups=3, device="cpu")


SSM2 = dict(ssm_version=2, d_state=16, headdim=16)


def test_ssm2_model_forward_and_gradients_match_jax():
    """A tiny zigzagN8 ZigMa with Mamba-2 mixers, scan over layers (the
    stacked JAX layout) and remat off, forward and velocity-loss gradients
    against ``jax.grad``."""
    cfg = dict(in_channels=4, embed_dim=32, img_dim=8, patch_size=1, depth=2,
               scan_type="zigzagN8", use_pe=2, ssm_cfg=SSM2)
    rng = np.random.default_rng(3)
    x1, x0 = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in "ab")
    t = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    xt = t[:, None, None, None] * x1 + (1 - t[:, None, None, None]) * x0
    jmodel = JaxZigMa(**cfg, scan_layers=True)
    rng_p = np.random.default_rng(7)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng_p.standard_normal(a.shape)
        .astype(np.float32), jax.jit(jmodel.init)(jax.random.PRNGKey(0), x1, t))
    assert "blocks" in params["params"]

    def loss(p):
        o = jmodel.apply(p, xt, t)
        return jnp.mean((o - (x1 - x0)) ** 2), o

    (_, ref), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    gref = state_dict_from_jax(jax.tree.map(np.array, g))
    model = ZigMa(**cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    out = model(_t(xt), _t(t))
    ((out - _t(x1 - x0)) ** 2).mean().backward()
    assert np.max(np.abs(out.detach().numpy() - np.asarray(ref))) <= TOL_FWD
    for n, p in model.named_parameters():
        assert _rel(p.grad, gref[n].numpy()) <= TOL_GRAD, n
    assert isinstance(model.blocks[0].mixer, Mamba2)


SSM2_TINY = ["model=zigzag8_b1_pe2_ssm2", "data=synthetic",
             "model.params.depth=2", "model.params.embed_dim=32",
             "model.params.img_dim=8", "model.params.ssm_cfg.headdim=16",
             "model.params.ssm_cfg.d_state=16"]


def test_ssm2_train_and_sample_clis(tmp_path):
    res = train_cli.main([*SSM2_TINY, "data.batch_size=2",
                          "data.train_steps=2", "log_every=1",
                          f"results_dir={tmp_path}", "device=cpu"])
    assert [r["step"] for r in res["records"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in res["records"])
    assert isinstance(res["state"].model.blocks[0].mixer, Mamba2)
    out = sample_cli.main([
        f"ckpt={res['checkpoint']}", *SSM2_TINY, "sample_mode=ODE",
        "ode.sampling_method=euler", "ode.num_sampling_steps=3",
        "num_fid_samples=2", "offline_sample_local_bs=2",
        f"sample_dir={tmp_path}", "device=cpu"])
    assert out["n_nonfinite"] == 0 and out["model_calls"] == [2]
    assert sorted(os.listdir(out["out_dir"])) == ["000000.png", "000001.png"]
