"""Sequence parallelism in the port vs the JAX package's unsharded scans.

- ``selective_scan_sharded`` / ``ssd_scan_sharded``: the two passes and
  ``prefix_states`` over 2 and 4 virtual shards in one process, against
  JAX ``selective_scan`` / ``ssd_scan`` on the whole sequence from the same
  numpy inputs: the output and the gradient of every input (u, delta, A,
  B, C, D, z, the bias).
- ``selective_scan_seq_parallel`` / ``ssd_seq_parallel`` in two gloo
  processes through the real all-gather (a worker that imports torch and
  the port only): each rank's output slice and the gradients, the
  replicated inputs' summed over the ranks, against the same JAX
  references.
- ``prefix_states`` with a decay strong enough that the masked entries'
  exponent would overflow: finite values and gradients equal to the
  direct sums.

Tolerance (fp32): each tensor within 2e-5 of its max |jax| (the sharded
scans sum the prefix in the log domain, the unsharded ones step by step;
measured below 3e-6).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.ops.selective_scan import selective_scan as jax_selective_scan
from zigma_tpu.ops.ssd import ssd_scan as jax_ssd_scan
from zigma_tpu_torch.parallel import (prefix_states, selective_scan_sharded,
                                      ssd_scan_sharded)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
SCAN_KEYS = ("u", "delta", "A", "B", "C", "D", "z", "bias")
SSD_KEYS = ("x", "dt", "A", "B", "C", "D", "z", "dt_bias")


def _scan_inputs(seed=0, batch=2, L=128, d=16, N=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    # dt = softplus(-4 + ...) about 0.02 and |A| about 1: each step keeps
    # about 98% of the state, so a shard's incoming state carries into the
    # next one (with decays near 0.5 it would be forgotten within a shard
    # and the prefix exchange would go untested)
    return dict(u=f(batch, L, d), delta=0.1 * f(batch, L, d) - 4.0,
                A=-np.exp(0.5 * f(d, N)), B=f(batch, L, N), C=f(batch, L, N),
                D=f(d), z=f(batch, L, d), bias=0.1 * f(d), w=f(batch, L, d))


def _ssd_inputs(seed=1, batch=2, L=128, H=4, P=8, G=2, N=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(batch, L, H, P), dt=0.1 * f(batch, L, H) - 4.0,
                A=-np.exp(0.5 * f(H)), B=f(batch, L, G, N),
                C=f(batch, L, G, N), D=f(H), z=f(batch, L, H, P),
                dt_bias=0.1 * f(H), w=f(batch, L, H, P))


def _jax_scan(d):
    def loss(*a):
        u, delta, A, B, C, D, z, bias = a
        y = jax_selective_scan(u, delta, A, B, C, D, z, bias,
                               delta_softplus=True)
        return jnp.sum(y * d["w"]), y

    (_, y), g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(8)), has_aux=True))(
        *(jnp.asarray(d[k]) for k in SCAN_KEYS))
    return np.asarray(y), [np.asarray(x) for x in g]


def _jax_ssd(d, chunk):
    def loss(*a):
        x, dt, A, B, C, D, z, dt_bias = a
        y = jax_ssd_scan(x, dt, A, B, C, D, z, dt_bias, dt_softplus=True,
                         chunk=chunk)
        return jnp.sum(y * d["w"]), y

    (_, y), g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(8)), has_aux=True))(
        *(jnp.asarray(d[k]) for k in SSD_KEYS))
    return np.asarray(y), [np.asarray(x) for x in g]


def _assert_close(name, got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.max(np.abs(got - ref))
    assert err <= TOL * np.max(np.abs(ref)), (name, err, np.max(np.abs(ref)))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_virtual_shards_match_the_jax_scan(n_shards):
    d = _scan_inputs()
    y_ref, g_ref = _jax_scan(d)
    t = {k: torch.tensor(d[k], requires_grad=True) for k in SCAN_KEYS}
    y = selective_scan_sharded(*(t[k] for k in SCAN_KEYS),
                               delta_softplus=True, n_shards=n_shards)
    (y * torch.from_numpy(d["w"])).sum().backward()
    _assert_close("y", y.detach(), y_ref)
    for k, r in zip(SCAN_KEYS, g_ref):
        _assert_close(k, t[k].grad, r)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_virtual_shards_match_the_jax_ssd(n_shards):
    d = _ssd_inputs()
    y_ref, g_ref = _jax_ssd(d, chunk=16)
    t = {k: torch.tensor(d[k], requires_grad=True) for k in SSD_KEYS}
    y = ssd_scan_sharded(*(t[k] for k in SSD_KEYS), dt_softplus=True,
                         n_shards=n_shards, chunk=16)
    (y * torch.from_numpy(d["w"])).sum().backward()
    _assert_close("y", y.detach(), y_ref)
    for k, r in zip(SSD_KEYS, g_ref):
        _assert_close(k, t[k].grad, r)


def test_prefix_states_under_strong_decay():
    """Shard decays of about -1e3 in the log domain: the unmasked
    exponents of r >= s would reach +3e3 and overflow; the masked form
    stays finite and equals the direct sums, gradients included."""
    rng = np.random.default_rng(2)
    log_as = torch.tensor(-1e3 * rng.uniform(0.5, 1.0, (4, 3)),
                          dtype=torch.float32, requires_grad=True)
    xs = torch.tensor(rng.standard_normal((4, 3)), dtype=torch.float32,
                      requires_grad=True)
    got = prefix_states(log_as, xs)
    ref = torch.stack([sum((torch.exp(log_as[r + 1:s].sum(0)) * xs[r]
                            for r in range(s)), torch.zeros(3))
                       for s in range(4)])
    w = torch.tensor(rng.standard_normal((4, 3)), dtype=torch.float32)
    g_got = torch.autograd.grad((got * w).sum(), (log_as, xs))
    g_ref = torch.autograd.grad((ref * w).sum(), (log_as, xs))
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-30)
    for a, b in zip(g_got, g_ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-30)
    # a mild decay reaches every earlier shard
    mild = prefix_states(torch.full((3, 1), -0.5), torch.ones(3, 1))
    torch.testing.assert_close(
        mild[:, 0], torch.tensor([0.0, 1.0, 1.0 + np.exp(-0.5)],
                                 dtype=torch.float32))


WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + io + "/store",
                            rank=rank, world_size=world)
    from zigma_tpu_torch.parallel import (selective_scan_seq_parallel,
                                          ssd_seq_parallel)
    setup = torch.load(io + "/setup.pt", weights_only=False)
    out = {{}}
    for name, fn, keys, seq_dims, kw in (
            ("scan", selective_scan_seq_parallel, {scan_keys!r},
             ("u", "delta", "B", "C", "z"), dict(delta_softplus=True)),
            ("ssd", ssd_seq_parallel, {ssd_keys!r},
             ("x", "dt", "B", "C", "z"), dict(dt_softplus=True, chunk=16))):
        d = setup[name]
        t = {{k: (v.chunk(world, 1)[rank] if k in seq_dims else v)
              .clone().requires_grad_() for k, v in d.items() if k != "w"}}
        y = fn(*(t[k] for k in keys), **kw)
        (y * d["w"].chunk(world, 1)[rank]).sum().backward()
        out[name] = dict(y=y.detach(), grads={{k: t[k].grad for k in keys}})
    torch.save(out, io + "/out%d.pt" % rank)
    dist.destroy_process_group()
""")


def test_two_processes_match_the_jax_scans(tmp_path):
    scan, ssd = _scan_inputs(3), _ssd_inputs(4)
    refs = {"scan": _jax_scan(scan), "ssd": _jax_ssd(ssd, chunk=16)}
    torch.save({"scan": {k: torch.from_numpy(v) for k, v in scan.items()},
                "ssd": {k: torch.from_numpy(v) for k, v in ssd.items()}},
               tmp_path / "setup.pt")
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, scan_keys=SCAN_KEYS,
                                    ssd_keys=SSD_KEYS))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    for p in procs:
        out = p.communicate(timeout=240)[0]
        assert p.returncode == 0, out[-4000:]
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    for name, keys, seq_dims in (
            ("scan", SCAN_KEYS, ("u", "delta", "B", "C", "z")),
            ("ssd", SSD_KEYS, ("x", "dt", "B", "C", "z"))):
        y_ref, g_ref = refs[name]
        _assert_close(name, torch.cat([o[name]["y"] for o in outs], 1),
                      y_ref)
        for k, r in zip(keys, g_ref):
            parts = [o[name]["grads"][k] for o in outs]
            got = torch.cat(parts, 1) if k in seq_dims else sum(parts)
            _assert_close(f"{name}.{k}", got, r)
