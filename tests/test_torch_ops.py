"""Port ops vs the JAX package: scan paths, add_norm, causal_conv1d.

The same numpy inputs go through both packages.  Paths are compared
bit-for-bit; the float ops at fp32 max abs 1e-6 (one fp32 rounding of
unit-scale values), and the bf16-accumulating conv at one bf16 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.ops import paths as jax_paths
from zigma_tpu.ops.causal_conv1d import causal_conv1d as jax_conv
from zigma_tpu.ops.norms import add_norm as jax_add_norm
from zigma_tpu_torch.ops import paths
from zigma_tpu_torch.ops.causal_conv1d import causal_conv1d
from zigma_tpu_torch.ops.norms import add_norm

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
