"""The port's parallelism across processes (gloo on the CPU) vs the JAX
package and the one-process port.

Worker processes import torch and the port only (the JAX side runs here,
in the test process) and meet through a ``FileStore`` in ``tmp_path``.  One
run of two processes holds:

- DDP: three steps of a tiny perturbed ZigMa, each rank on half of a batch
  of 4, against ``zigma_tpu.train.create_train_step`` on the whole batch
  (the same weights through ``state_dict_from_jax``, the JAX step's
  flow-matching ``(t, x0)`` recorded by ``jax.debug.callback`` and
  injected): the global loss and the global grad norm within 1e-5
  relative, parameters and EMA within 1e-6 (1 + |p|) (fp32: the mean of
  two half-batch gradients rounds otherwise than the whole batch's, and
  AdamW's normalised update carries that to a few ulps of p);
- FSDP2 (``fsdp_min_size`` 64, so the small parameters take the whole-
  tensor path): the same three steps within 1e-6 of DDP; its checkpoint
  has the one-process names and loads strict, and a one-process resume
  from it steps as the FSDP run does (1e-6);
- tensor parallelism at tp 2: forward and every gradient of a zigzagN8
  model (whose ``[x; z]`` ``in_proj`` would split into all-x / all-z under
  a contiguous shard), a text model with cross-attention and an ssm2 model
  against the JAX model (forward 1e-4 absolute as the model tests, each
  gradient within 1e-4 of its max |jax|) and the unsharded port (1e-5);
  ``tp_unshard`` of ``tp_shard`` is the identity; a tp that does not divide
  d_inner raises;
- the sampler: quotas of ceil(n / 2), seeds ``global_seed + rank`` (rank
  1's first sample is a one-process run's with seed 1), disjoint
  rank-interleaved file names.

A run of four processes trains each of those three models for two steps
under dp 2 x tp 2 (DDP; FSDP2 too for zigzagN8) against the one-process
port on the whole batch: loss and grad norm within 1e-5 relative,
parameters within 1e-6 (1 + |p|); the gathered state loads strict into a
one-process model.
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

from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.train import TrainState as JaxTrainState
from zigma_tpu.train import create_optimizer as jax_create_optimizer
from zigma_tpu.train import create_train_step
from zigma_tpu.train import make_diffusion_loss_fn as jax_loss_fn
from zigma_tpu.transport import create_transport as jax_create_transport
from zigma_tpu.transport.transport import Transport as JaxTransport
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.train import (LATENT_SCALE, TrainState,
                                   make_diffusion_loss_fn, restore_checkpoint,
                                   train_step)
from zigma_tpu_torch.transport import create_transport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(in_channels=4, embed_dim=32, depth=2, img_dim=8, patch_size=1,
           scan_type="zigzagN8", use_pe=2, drop_path_rate=0.0)
TP_CASES = {
    "zigzagN8": dict(CFG),
    "text": dict(CFG, scan_type="v2", use_pe=3, has_text=True, d_context=24,
                 n_context_token=5),
    "ssm2": dict(CFG, ssm_cfg=dict(ssm_version=2, d_state=16, headdim=16)),
}
N_STEPS = 3  # DDP / FSDP2 steps, then one more from the FSDP2 checkpoint

WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + io + "/store",
                            rank=rank, world_size=world)
    from zigma_tpu_torch.models import ZigMa
    from zigma_tpu_torch.parallel import (apply_tensor_parallel, make_mesh,
                                          parallelize, tp_shard, tp_unshard)
    from zigma_tpu_torch.train import (LATENT_SCALE, TrainState,
                                       make_diffusion_loss_fn,
                                       save_checkpoint, train_step)
    from zigma_tpu_torch.transport import create_transport

    setup = torch.load(io + "/setup.pt", weights_only=False)
    out = {{}}

    def build(cfg, sd):
        model = ZigMa(**cfg, device="cpu")
        model.load_state_dict(sd)
        return model

    def batch(case, rows=slice(None)):
        b = {{"x": case["x"][rows]}}
        if "y" in case:
            b["y"] = case["y"][rows]
        return b

    def run(case, tp, fsdp, steps, fsdp_min_size=64, ckpt=None, extra=0):
        # each data rank its rows of the batch; the records are global
        mesh = make_mesh(model=tp)
        per = case["x"].shape[0] // mesh["data"].size()
        rows = slice(mesh["data"].get_local_rank() * per,
                     (mesh["data"].get_local_rank() + 1) * per)
        model = build(case["cfg"], case["sd"])
        ema = build(case["cfg"], case["sd"])
        layout = parallelize(model, ema, mesh, tp > 1, fsdp, fsdp_min_size)
        state = TrainState.create(model, ema=ema, layout=layout)
        loss_fn = make_diffusion_loss_fn(state.train_module,
                                         create_transport(),
                                         latent_scale=LATENT_SCALE)
        recs = []
        for i in range(steps + extra):
            if ckpt and i == steps:
                save_checkpoint(ckpt, state)
            m = train_step(state, loss_fn, batch(case, rows),
                           t=case["t"][i][rows], x0=case["x0"][i][rows])
            loss = m["loss"].clone()
            dist.all_reduce(loss, group=layout.data_group)
            recs.append((float(loss) / mesh["data"].size(),
                         float(m["grad_norm"])))
        return dict(records=recs, model=layout.gather_state(state.model),
                    ema=layout.gather_state(state.ema))

    def one_process(case, steps):
        state = TrainState.create(build(case["cfg"], case["sd"]))
        loss_fn = make_diffusion_loss_fn(state.model, create_transport(),
                                         latent_scale=LATENT_SCALE)
        recs = []
        for i in range(steps):
            m = train_step(state, loss_fn, batch(case), t=case["t"][i],
                           x0=case["x0"][i])
            recs.append((float(m["loss"]), float(m["grad_norm"])))
        return dict(records=recs, model=state.model.state_dict())

    if world == 2:
        out["ddp"] = run(setup, 1, False, {n_steps})
        out["fsdp"] = run(setup, 1, True, {n_steps}, ckpt=io + "/ckpt",
                          extra=1)
        group = make_mesh(model=2)["model"].get_group()
        for name, case in setup["tp_cases"].items():
            model = build(case["cfg"], case["sd"])
            rules = apply_tensor_parallel(model, group)
            # this rank's rows of BOTH halves of a Mamba-1 in_proj
            w = case["sd"].get("blocks.0.mixer.in_proj.weight")
            if w is not None and name != "ssm2":
                d = w.shape[0] // 2
                mine = torch.cat([w[rank * d // 2:(rank + 1) * d // 2],
                                  w[d + rank * d // 2:d + (rank + 1) * d // 2]])
                assert torch.equal(model.blocks[0].mixer.in_proj.weight, mine)
            o = model(*case["inputs"])
            (o * case["w"]).sum().backward()
            grads = tp_unshard({{n: p.grad for n, p in
                                model.named_parameters()}}, rules, group)
            back = tp_unshard(tp_shard(case["sd"], rules, rank, 2), rules,
                              group)
            assert all(torch.equal(back[k], v) for k, v in case["sd"].items())
            out["tp_" + name] = dict(out=o.detach(), grads=grads,
                                     n_split=len(rules))
        odd = ZigMa(**dict(setup["cfg"], embed_dim=33,
                           ssm_cfg=dict(expand=1)), device="cpu")
        try:
            apply_tensor_parallel(odd, group)
        except ValueError as e:
            out["odd"] = str(e)
        from zigma_tpu_torch.cli import sample as sample_cli
        out["sample"] = sample_cli.main(setup["sample_argv"])
        out["sample"].pop("metric_suite")
    else:  # dp 2 x tp 2 against one process on the whole batch
        for name, case in setup["cases"].items():
            out[name] = dict(ref=one_process(case, 2))
            for fsdp in (False, True) if name == "zigzagN8" else (False,):
                out[name]["fsdp" if fsdp else "ddp"] = run(
                    case, 2, fsdp, 2, fsdp_min_size=0)
    if rank == 0:
        torch.save(out, io + "/out.pt")
    dist.destroy_process_group()
""")


def _run_workers(io, world, timeout=300):
    script = io / "worker.py"
    script.write_text(WORKER.format(repo=REPO, n_steps=N_STEPS))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(io)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return torch.load(io / "out.pt", weights_only=False)


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)


def _jax_train(params, x, n_steps):
    """The JAX train step on the whole batch, ``n_steps`` times; returns
    the records, the final params and EMA (port names) and the step's
    ``(t, x0)`` draws."""
    draws = []
    orig = JaxTransport.sample

    def sample(tr, rng, x1):
        t, x0, x1 = orig(tr, rng, x1)
        jax.debug.callback(lambda a, b: draws.append(
            (np.array(a), np.array(b))), t, x0, ordered=True)
        return t, x0, x1

    jmodel = JaxZigMa(**CFG, scan_layers=False)
    opt = jax_create_optimizer(lr=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTransport, "sample", sample)
        step = create_train_step(
            jax_loss_fn(jmodel, jax_create_transport(),
                        latent_scale=LATENT_SCALE), opt)
        state = JaxTrainState.create(jax.tree.map(jnp.asarray, params), opt)
        recs = []
        for i in range(n_steps):
            state, m = step(state, jax.random.PRNGKey(30 + i),
                            {"x": jnp.asarray(x)})
            jax.effects_barrier()
            recs.append((float(m["loss"]), float(m["grad_norm"])))
    conv = lambda tree: state_dict_from_jax(jax.tree.map(np.array, tree))
    return recs, conv(state.params), conv(state.ema_params), draws


def _jax_forward_grads(cfg, seed):
    """Inputs, the JAX model's output and the gradients of sum(out * w)
    (port names), and its perturbed weights as a port state dict."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    y = (rng.standard_normal((2, 5, 24)).astype(np.float32)
         if cfg.get("has_text") else None)
    w = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    jmodel = JaxZigMa(**cfg, scan_layers=cfg.get("use_pe") == 3)
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, t, y),
                      seed + 1)

    def loss(p):
        o = jmodel.apply(p, x, t, y)
        return jnp.sum(o * w), o

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    conv = lambda tree: state_dict_from_jax(jax.tree.map(np.array, tree))
    inputs = [torch.from_numpy(a) for a in (x, t)] + (
        [torch.from_numpy(y)] if y is not None else [])
    return dict(cfg=cfg, sd=conv(params), inputs=inputs,
                w=torch.from_numpy(w)), np.asarray(out), conv(g)


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    err = np.max(np.abs(np.asarray(got, np.float32) - ref))
    return err <= tol * max(np.max(np.abs(ref)), 1e-8)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    io = tmp_path_factory.mktemp("world2")
    rng = np.random.default_rng(11)
    jmodel = JaxZigMa(**CFG, scan_layers=False)
    x = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x,
                                           np.zeros(4)), 12)
    recs, jparams, jema, draws = _jax_train(params, x, N_STEPS)
    t = [torch.from_numpy(a) for a, _ in draws]
    x0 = [torch.from_numpy(b) for _, b in draws]
    # the step after the FSDP2 checkpoint draws anew (the port's own)
    g = torch.Generator().manual_seed(5)
    t.append(torch.rand(4, generator=g))
    x0.append(torch.randn(4, 4, 8, 8, generator=g))
    tp_cases, tp_refs = {}, {}
    for i, (name, cfg) in enumerate(TP_CASES.items()):
        tp_cases[name], *tp_refs[name] = _jax_forward_grads(cfg, 20 + i)
    sample_argv = ["model=zigzag8_b1_pe2", "data=synthetic",
                   "model.params.depth=2", "model.params.embed_dim=32",
                   "model.params.img_dim=8", f"ckpt={io / 'ckpt' / '0000003.pt'}",
                   "sample_mode=ODE", "ode.sampling_method=euler",
                   "ode.num_sampling_steps=2", "num_fid_samples=7",
                   "offline_sample_local_bs=2", f"sample_dir={io / 'samples'}",
                   "device=cpu"]
    torch.save(dict(cfg=CFG, sd=state_dict_from_jax(params),
                    x=torch.from_numpy(x), t=t, x0=x0, tp_cases=tp_cases,
                    sample_argv=sample_argv), io / "setup.pt")
    out = _run_workers(io, 2)
    return dict(out=out, jax=(recs, jparams, jema), tp_cases=tp_cases,
                tp_refs=tp_refs, io=io, t=t, x0=x0, x=x, argv=sample_argv)


def test_ddp_matches_the_jax_step_on_the_whole_batch(two_ranks):
    recs, jparams, jema = two_ranks["jax"]
    ddp = two_ranks["out"]["ddp"]
    for (loss, norm), (jl, jn) in zip(ddp["records"], recs):
        assert abs(loss - jl) <= 1e-5 * abs(jl)
        assert abs(norm - jn) <= 1e-5 * jn
    assert max(jn for _, jn in recs) > 2.0  # the clip acted
    for got, ref in ((ddp["model"], jparams), (ddp["ema"], jema)):
        assert set(got) == set(ref)
        for k in ref:
            r = ref[k].numpy()
            assert np.all(np.abs(got[k].numpy() - r)
                          <= 1e-6 * (1 + np.abs(r))), k


def test_fsdp_matches_ddp_and_resumes_in_one_process(two_ranks):
    out = two_ranks["out"]
    ddp, fsdp = out["ddp"], out["fsdp"]
    for (la, na), (lb, nb) in zip(ddp["records"], fsdp["records"]):
        assert abs(la - lb) <= 1e-6 * abs(la) and abs(na - nb) <= 1e-6 * na
    ck = torch.load(two_ranks["io"] / "ckpt" / "0000003.pt",
                    weights_only=False)
    assert ck["train_steps"] == N_STEPS
    for which in ("model", "ema"):
        one = ZigMa(**CFG, device="cpu")
        one.load_state_dict(ck[which], strict=True)
        for k, v in ddp[which].items():
            assert np.max(np.abs(ck[which][k].numpy() - v.numpy())) <= 1e-6
    # a one-process resume takes the FSDP run's fourth step
    state = TrainState.create(ZigMa(**CFG, device="cpu"))
    restore_checkpoint(str(two_ranks["io"] / "ckpt" / "0000003.pt"), state)
    assert state.step == N_STEPS
    loss_fn = make_diffusion_loss_fn(state.model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    m = train_step(state, loss_fn, {"x": torch.from_numpy(two_ranks["x"])},
                   t=two_ranks["t"][N_STEPS], x0=two_ranks["x0"][N_STEPS])
    loss, _ = fsdp["records"][N_STEPS]
    assert abs(float(m["loss"]) - loss) <= 1e-5 * abs(loss)
    for k, p in state.model.named_parameters():
        assert np.max(np.abs(p.detach().numpy()
                             - fsdp["model"][k].numpy())) <= 1e-6, k


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tensor_parallel_matches_jax_and_the_unsharded_port(two_ranks, name):
    got = two_ranks["out"][f"tp_{name}"]
    case = two_ranks["tp_cases"][name]
    ref_out, ref_grads = two_ranks["tp_refs"][name]
    assert got["n_split"] > 0
    assert np.max(np.abs(got["out"].numpy() - ref_out)) <= 1e-4
    model = ZigMa(**case["cfg"], device="cpu")
    model.load_state_dict(case["sd"])
    o = model(*case["inputs"])
    (o * case["w"]).sum().backward()
    assert _close(got["out"], o.detach(), 1e-5)
    assert set(got["grads"]) == set(ref_grads)
    for n, p in model.named_parameters():
        assert _close(got["grads"][n], ref_grads[n], 1e-4), n
        assert _close(got["grads"][n], p.grad, 1e-5), n


def test_tp_that_does_not_divide_raises(two_ranks):
    assert "does not divide" in two_ranks["out"]["odd"]
    assert "d_inner (33)" in two_ranks["out"]["odd"]


def test_sampler_splits_the_quota_over_ranks(two_ranks, tmp_path):
    res = two_ranks["out"]["sample"]  # rank 0's; rank 1's files beside
    assert len(res["model_calls"]) == 2  # ceil(7 / 2) = 4: two batches of 2
    files = sorted(os.listdir(res["out_dir"]))
    assert files == [f"{i:06d}.png" for i in range(8)]
    # rank 1 drew from global_seed + 1: its first batch (files 2 and 3) is a
    # one-process run's with that seed
    one = sample_cli.main([*two_ranks["argv"][:-2], "global_seed=1",
                           "num_fid_samples=2", f"sample_dir={tmp_path}",
                           "device=cpu"])
    from PIL import Image

    for i in (0, 1):
        a = np.asarray(Image.open(os.path.join(one["out_dir"],
                                               f"{i:06d}.png")))
        b = np.asarray(Image.open(os.path.join(res["out_dir"],
                                               f"{2 + i:06d}.png")))
        assert np.array_equal(a, b)
    c = np.asarray(Image.open(os.path.join(res["out_dir"], "000000.png")))
    assert not np.array_equal(c, np.asarray(Image.open(
        os.path.join(one["out_dir"], "000000.png"))))


@pytest.fixture(scope="module")
def dp_by_tp(tmp_path_factory):
    """Two steps of each TP case under dp 2 x tp 2 in four processes (DDP,
    and FSDP2 for zigzagN8) and in one, on a batch of 4 (2 a data rank)."""
    io = tmp_path_factory.mktemp("world4")
    g = torch.Generator().manual_seed(6)
    cases = {}
    for name, cfg in TP_CASES.items():
        model = ZigMa(**cfg, device="cpu", generator=g)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g))
        cases[name] = dict(cfg=cfg, sd=model.state_dict(),
                           x=torch.randn(4, 4, 8, 8, generator=g),
                           t=[torch.rand(4, generator=g) for _ in range(2)],
                           x0=[torch.randn(4, 4, 8, 8, generator=g)
                               for _ in range(2)])
        if cfg.get("has_text"):
            cases[name]["y"] = torch.randn(4, 5, 24, generator=g)
    torch.save(dict(cases=cases), io / "setup.pt")
    return _run_workers(io, 4)


@pytest.mark.parametrize("name,mode", [("zigzagN8", "ddp"),
                                       ("zigzagN8", "fsdp"), ("text", "ddp"),
                                       ("ssm2", "ddp")])
def test_dp_by_tp_trains_as_one_process(dp_by_tp, name, mode):
    ref, got = dp_by_tp[name]["ref"], dp_by_tp[name][mode]
    for (la, na), (lb, nb) in zip(ref["records"], got["records"]):
        assert abs(la - lb) <= 1e-5 * abs(la)
        assert abs(na - nb) <= 1e-5 * na
    model = ZigMa(**TP_CASES[name], device="cpu")
    model.load_state_dict(got["model"], strict=True)
    for k, v in ref["model"].items():
        assert np.all(np.abs(got["model"][k].numpy() - v.numpy())
                      <= 1e-6 * (1 + np.abs(v.numpy()))), k
