"""Port ops vs the JAX package: scan paths, add_norm, causal_conv1d and the
decode steps (causal_conv1d_update, selective_state_update).

The same numpy inputs go through both packages.  Paths are compared
bit-for-bit; the float ops at fp32 max abs 1e-6 (one fp32 rounding of
unit-scale values), and the bf16-accumulating conv at one bf16 rounding.
The decode state update: fp32 outputs and states within 1e-6 of max |jax|
(summation order of the N-term dot product), a bf16 output within one bf16
rounding (2^-7 relative) of the same fp32 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.ops import paths as jax_paths
from zigma_tpu.ops.causal_conv1d import causal_conv1d as jax_conv
from zigma_tpu.ops.causal_conv1d import causal_conv1d_update as jax_conv_update
from zigma_tpu.ops.norms import add_norm as jax_add_norm
from zigma_tpu.ops.selective_scan import \
    selective_state_update as jax_state_update
from zigma_tpu_torch.ops import paths
from zigma_tpu_torch.ops.causal_conv1d import (causal_conv1d,
                                               causal_conv1d_update)
from zigma_tpu_torch.ops.norms import add_norm
from zigma_tpu_torch.ops.selective_scan import (selective_scan_ref,
                                                selective_state_update)

SCAN_TYPES = ["v1", "v2", "zigzagN8", "zigzagN2", "hilbertN8", "randomN4"]


@pytest.mark.parametrize("side", [4, 8, 16])
@pytest.mark.parametrize("scan_type", SCAN_TYPES)
def test_layer_paths_bit_equal(scan_type, side):
    p, pr, st = paths.build_layer_paths(scan_type, 10, side, seed=3)
    jp, jpr, jst = jax_paths.build_layer_paths(scan_type, 10, side, seed=3)
    assert st is None and jst is None
    for a, b in zip(p + pr, jp + jpr):
        if b is None:
            assert a is None
        else:
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("side", [4, 8, 16])
def test_curve_generators_bit_equal(side):
    for a, b in zip(paths.zigzag_path(side) + paths.hilbert_path(side),
                    jax_paths.zigzag_path(side) + jax_paths.hilbert_path(side)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(paths.reverse_permutation(a),
                                      jax_paths.reverse_permutation(b))


def test_later_slice_scan_types_raise():
    """parallelN and the video scans build now (their tables are held
    against JAX in test_torch_video.py); what JAX refuses, the port
    refuses too."""
    assert paths.build_layer_paths("parallelN4", 2, 4) == ([None] * 2,
                                                            [None] * 2, None)
    for scan_type in ("zzvideo_sst", "video_sst"):
        _, _, st = paths.build_layer_paths(scan_type, 4, 4, video_frames=2)
        assert st == "ssts"
        with pytest.raises(ValueError, match="video_frames > 0"):
            paths.build_layer_paths(scan_type, 2, 4)
    with pytest.raises(ValueError, match="'s'/'t'"):
        paths.build_layer_paths("zzvideo_sxt", 2, 4, video_frames=2)
    with pytest.raises(ValueError, match="zero paths"):
        paths.build_layer_paths("zigzagN0", 2, 4)
    with pytest.raises(ValueError, match="unknown scan_type"):
        paths.build_layer_paths("spiral", 2, 4)


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("prenorm", [True, False])
@pytest.mark.parametrize("with_residual", [True, False])
def test_add_norm_matches_jax(kind, prenorm, with_residual):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    res = rng.standard_normal((2, 7, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    b = (0.1 * rng.standard_normal(32)).astype(np.float32) if kind == "layer" else None
    out = add_norm(torch.from_numpy(x), torch.from_numpy(w),
                   None if b is None else torch.from_numpy(b),
                   torch.from_numpy(res) if with_residual else None,
                   kind=kind, prenorm=prenorm)
    ref = jax_add_norm(jnp.asarray(x), jnp.asarray(w),
                       None if b is None else jnp.asarray(b),
                       jnp.asarray(res) if with_residual else None,
                       kind=kind, prenorm=prenorm)
    outs, refs = (out, ref) if prenorm else ((out,), (ref,))
    for o, r in zip(outs, refs):
        assert o.dtype == torch.float32
        assert np.max(np.abs(o.numpy() - np.asarray(r))) <= 1e-6


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("accum", ["fp32", "bf16"])
def test_causal_conv1d_matches_jax(with_bias, accum):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = (0.5 * rng.standard_normal((24, 4))).astype(np.float32)
    b = (0.5 * rng.standard_normal(24)).astype(np.float32) if with_bias else None
    tb = None if b is None else torch.from_numpy(b)
    jb = None if b is None else jnp.asarray(b)
    if accum == "fp32":
        out = causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), tb)
        ref = jax_conv(jnp.asarray(x), jnp.asarray(w), jb)
        assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= 1e-6
    else:
        # bf16 activations accumulate their taps in bf16 (the JAX default);
        # the two frameworks may round the running sum at different places
        xb = torch.from_numpy(x).to(torch.bfloat16)
        out = causal_conv1d(xb, torch.from_numpy(w), tb)
        ref = jax_conv(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                       jnp.asarray(w), jb)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=2e-2)
        # and the fp32-tap escape hatch matches JAX's accum_dtype=float32
        out32 = causal_conv1d(xb, torch.from_numpy(w), tb,
                              accum_dtype=torch.float32)
        ref32 = jax_conv(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                         jnp.asarray(w), jb, accum_dtype=jnp.float32)
        np.testing.assert_array_equal(out32.float().numpy(),
                                      np.asarray(ref32, np.float32))


def _bf16_np(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_causal_conv1d_update_matches_jax_and_the_parallel_conv(dtype,
                                                                with_bias):
    """Steps from an empty fp32 window against JAX's steps, and against the
    port's parallel conv at every position: bit for bit before the silu
    (the same taps in the same order and dtype), within an fp32 rounding
    after it (torch's vectorised CPU silu rounds by the tensor's layout);
    the window ends as the last 4 inputs."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = (0.5 * rng.standard_normal((24, 4))).astype(np.float32)
    b = (0.5 * rng.standard_normal(24)).astype(np.float32) if with_bias else None
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    if dtype == "bf16":
        x = _bf16_np(x)
    xt = torch.from_numpy(x).to(tdt)
    tb = None if b is None else torch.from_numpy(b)
    state = torch.zeros(2, 4, 24)
    jstate = jnp.zeros((2, 4, 24), jnp.float32)
    ys = []
    for t in range(7):
        y, state = causal_conv1d_update(xt[:, t], state, torch.from_numpy(w), tb)
        jy, jstate = jax_conv_update(jnp.asarray(x[:, t], jdt), jstate,
                                     jnp.asarray(w),
                                     None if b is None else jnp.asarray(b))
        assert y.dtype == tdt and state.dtype == torch.float32
        if dtype == "fp32":
            assert np.max(np.abs(y.numpy() - np.asarray(jy))) <= 1e-6
        else:  # bf16 accumulation: the running sum may round elsewhere
            np.testing.assert_allclose(y.float().numpy(),
                                       np.asarray(jy, np.float32),
                                       rtol=2e-2, atol=2e-2)
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
        ys.append(y)
    par = causal_conv1d(xt, torch.from_numpy(w), tb)
    torch.testing.assert_close(torch.stack(ys, 1), par, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(state.numpy(), x[:, -4:])
    state, pre = torch.zeros(2, 4, 24), []
    for t in range(7):
        y, state = causal_conv1d_update(xt[:, t], state, torch.from_numpy(w),
                                        tb, activation=None)
        pre.append(y)
    assert torch.equal(torch.stack(pre, 1),
                       causal_conv1d(xt, torch.from_numpy(w), tb,
                                     activation=None))


def _state_inputs(dtype, seed=3, batch=2, d=24, N=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    d_ = dict(state=f(batch, d, N), x=f(batch, d), dt=0.5 * f(batch, d),
              A=-np.exp(0.5 * f(d, N)), B=f(batch, N), C=f(batch, N),
              D=f(d), z=f(batch, d), dt_bias=0.1 * f(d))
    if dtype == "bf16":  # activations in bf16; state, A, D and bias fp32
        for k in ("x", "dt", "B", "C", "z"):
            d_[k] = _bf16_np(d_[k])
    return d_


STATE_OPTS = {"D z bias softplus": ("D", "z", "dt_bias", "softplus"),
              "bare": (), "D softplus": ("D", "softplus"),
              "z bias": ("z", "dt_bias")}


@pytest.mark.parametrize("opts", list(STATE_OPTS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_selective_state_update_matches_jax(dtype, opts):
    d = _state_inputs(dtype)
    on = STATE_OPTS[opts]
    act = {"x", "dt", "B", "C", "z"}
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    targ = {k: torch.from_numpy(v).to(tdt if k in act else torch.float32)
            for k, v in d.items()}
    jarg = {k: jnp.asarray(v, jdt if k in act else jnp.float32)
            for k, v in d.items()}
    kw = lambda a: dict(D=a["D"] if "D" in on else None,
                        z=a["z"] if "z" in on else None,
                        dt_bias=a["dt_bias"] if "dt_bias" in on else None,
                        dt_softplus="softplus" in on)
    pos = ("state", "x", "dt", "A", "B", "C")
    y, st = selective_state_update(*(targ[k] for k in pos), **kw(targ))
    jy, jst = jax_state_update(*(jarg[k] for k in pos), **kw(jarg))
    assert y.dtype == tdt and st.dtype == torch.float32
    jst = np.asarray(jst)
    assert np.max(np.abs(st.numpy() - jst)) <= 1e-6 * np.abs(jst).max()
    jy = np.asarray(jy, np.float32)
    ulp = 0.0 if dtype == "fp32" else 2.0 ** -7
    over = np.abs(y.float().numpy() - jy) - ulp * np.abs(jy)
    assert over.max() <= 1e-6 * np.abs(jy).max()


def test_selective_state_update_steps_are_the_scan():
    """L steps from a zero state give the plain scan's outputs and final
    state (the recurrence the prefill runs), in fp32."""
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    batch, L, d, N = 2, 9, 16, 4
    u, delta, z = f(batch, L, d), 0.5 * f(batch, L, d), f(batch, L, d)
    A, B, C = -torch.exp(0.5 * f(d, N)), f(batch, L, N), f(batch, L, N)
    D, bias = f(d), 0.1 * f(d)
    out, _, x_last = selective_scan_ref(u, delta, A, B, C, D, z, bias, True)
    state, ys = torch.zeros(batch, d, N), []
    for t in range(L):
        y, state = selective_state_update(state, u[:, t], delta[:, t], A,
                                          B[:, t], C[:, t], D, z[:, t], bias,
                                          True)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(state, x_last.transpose(1, 2), atol=1e-5,
                               rtol=1e-5)


def test_selective_state_update_refuses_complex():
    """Complex A with real B / C and a real state, which an earlier slice
    refused, now steps in complex64 (the S4D-complex mode: y = 2 Re<state',
    C>): y and the complex state against the JAX step, within 1e-6 of max
    |jax|."""
    d = _state_inputs("fp32")
    rng = np.random.default_rng(4)
    d["A"] = (d["A"] + 1j * rng.standard_normal(d["A"].shape)).astype(
        np.complex64)
    y_j, s_j = jax_state_update(*(jnp.asarray(d[k]) for k in (
        "state", "x", "dt", "A", "B", "C", "D", "z", "dt_bias")),
        dt_softplus=True)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    y, state = selective_state_update(
        t["state"], t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], t["z"],
        t["dt_bias"], dt_softplus=True)
    assert state.dtype == torch.complex64 and y.dtype == torch.float32
    for got, ref in ((y, y_j), (state, s_j)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-6 * np.max(np.abs(ref))
