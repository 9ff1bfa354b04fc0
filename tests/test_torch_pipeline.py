"""The GPipe pipeline (``parallel/pipeline.py``) over gloo vs the JAX
package's ``zigma_pipelined_apply`` and the one-process port.

Worker processes import torch and the port only (the JAX references run
here, in the test process) and meet through a ``FileStore`` in
``tmp_path``.  A run of two processes (pp 2) holds:

- forward and every gradient of sum(out * w) for a zigzagN2 model and a
  text model (cross-attention: the caption tokens travel with their
  microbatch) at depth 4 in 2 microbatches, against JAX's pipelined apply
  on a 2-device ``pipe`` mesh (forward 1e-4 absolute, each gradient within
  1e-4 of its max |jax|, as the model tests) and the one-process port
  (1e-5);
- three training steps of a class-conditional model with the label drop
  (4 microbatches of 1) through ``pipeline_parallelize``, against one
  process on the whole batch: loss and grad norm within 1e-5 relative,
  parameters and EMA within 1e-6 (1 + |p|); the gathered checkpoint loads
  strict into a one-process model;
- JAX's refusals: a depth the stages do not divide, use_pe 3, stochastic
  depth in training, a batch the microbatches do not divide, tp with pp.

A run of four processes (dp 2 x pp 2) trains three steps on a batch of 4
(2 a data rank) against one process on the whole batch, and runs
``cli.train`` with ``parallel.pp=2``: the ranks of a pipe group read one
batch, vis and an eval run the EMA gathered into a whole model, and the
checkpoint loads strict into a one-process model.
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
from jax.sharding import Mesh

from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.parallel import zigma_pipelined_apply as jax_pipelined_apply
from zigma_tpu_torch.cli import train as train_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.train import (LATENT_SCALE, TrainState,
                                   make_diffusion_loss_fn, train_step)
from zigma_tpu_torch.transport import create_transport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(in_channels=4, embed_dim=32, depth=4, img_dim=8, patch_size=2,
            scan_type="zigzagN2", use_pe=2, drop_path_rate=0.0)
FWD_CASES = {"zigzagN2": dict(BASE),
             "text": dict(BASE, has_text=True, d_context=16,
                          n_context_token=3)}
TRAIN_CFG = dict(BASE, num_classes=5, class_dropout_prob=0.5,
                 use_checkpoint=True)
N_STEPS = 3

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
    from zigma_tpu_torch.parallel import (make_mesh, pipeline_parallelize,
                                          split_stage, zigma_pipelined_apply)
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

    def gathered(d):
        parts = [None] * world
        dist.all_gather_object(parts, d)
        return {{k: v for p in parts for k, v in p.items()}}

    def train(case, n_mb, ckpt=None):
        mesh = make_mesh(pipe=2)
        per = case["x"].shape[0] // mesh["data"].size()
        r = mesh["data"].get_local_rank()
        rows = slice(r * per, (r + 1) * per)
        model, ema = build(case["cfg"], case["sd"]), build(case["cfg"],
                                                           case["sd"])
        layout = pipeline_parallelize(model, ema, mesh, n_mb)
        state = TrainState.create(model, ema=ema, layout=layout)
        loss_fn = make_diffusion_loss_fn(state.train_module,
                                         create_transport(),
                                         latent_scale=LATENT_SCALE)
        gen = torch.Generator().manual_seed(case["seed"])
        recs = []
        for i in range({n_steps}):
            batch = {{k: case[k][rows] for k in ("x", "y") if k in case}}
            m = train_step(state, loss_fn, batch, gen, t=case["t"][i][rows],
                           x0=case["x0"][i][rows])
            loss = m["loss"].clone()
            dist.all_reduce(loss, group=layout.data_group)
            recs.append((float(loss) / mesh["data"].size(),
                         float(m["grad_norm"])))
        if ckpt:
            save_checkpoint(ckpt, state)
        return dict(records=recs, model=layout.gather_state(state.model),
                    ema=layout.gather_state(state.ema))

    if world == 2:
        group = make_mesh(pipe=2)["pipe"].get_group()
        for name, case in setup["fwd"].items():
            model = split_stage(build(case["cfg"], case["sd"]), rank, 2)
            o = zigma_pipelined_apply(model, *case["inputs"], group=group,
                                      n_microbatches=2)
            (o * case["w"]).sum().backward()
            out[name] = dict(out=o.detach(), grads=gathered(
                {{n: p.grad for n, p in model.named_parameters()}}))
        out["train"] = train(setup["train"], 4, ckpt=io + "/ckpt")
        errs = {{}}
        cfg = setup["train"]["cfg"]
        for what, kw in (("depth", dict(depth=3)), ("use_pe", dict(use_pe=3))):
            try:
                split_stage(ZigMa(**dict(cfg, **kw), device="cpu"), rank, 2)
            except ValueError as e:
                errs[what] = str(e)
        x, t = torch.zeros(4, 4, 8, 8), torch.full((4,), 0.5)
        y = torch.zeros(4, dtype=torch.long)
        dp = split_stage(ZigMa(**dict(cfg, drop_path_rate=0.1),
                               device="cpu"), rank, 2)
        for what, args, kw in (("drop_path", (dp, x, t, y), dict(train=True)),
                               ("batch", (dp, x[:3], t[:3], y[:3]), {{}})):
            try:
                zigma_pipelined_apply(*args, group=group, n_microbatches=2,
                                      **kw)
            except ValueError as e:
                errs[what] = str(e)
        try:
            m = ZigMa(**cfg, device="cpu")
            pipeline_parallelize(m, ZigMa(**cfg, device="cpu"),
                                 make_mesh(model=2, pipe=1))
        except ValueError as e:
            errs["tp"] = str(e)
        out["errors"] = errs
    else:  # dp 2 x pp 2 against one process on the whole batch
        out["train"] = train(setup["train"], None)
        from zigma_tpu_torch.cli import train as train_cli
        read = []
        real = train_cli.shard_batch

        def shard_batch(batch, mesh):
            read.append(batch["x"].clone())
            return real(batch, mesh)

        train_cli.shard_batch = shard_batch
        res = train_cli.main(setup["argv"])
        out["cli"] = dict(read=gathered({{rank: read}}),
                          records=res["records"], evals=res["evals"],
                          checkpoint=res["checkpoint"])
    if rank == 0:
        torch.save(out, io + "/out.pt")
    dist.destroy_process_group()
""")


def _run_workers(io, world, timeout=300):
    script = io / "worker.py"
    script.write_text(WORKER.format(repo=REPO, n_steps=N_STEPS))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", ZIGMA_DISTRIBUTED="1",
               TORCH_HOME=str(io / "torch_home"), HF_HOME=str(io / "hf"))
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


def _jax_case(cfg, seed):
    """Inputs, JAX's pipelined output and gradients of sum(out * w) (port
    names) and the perturbed weights as a port state dict."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (4,)).astype(np.float32)
    y = (rng.standard_normal((4, 3, 16)).astype(np.float32)
         if cfg.get("has_text") else None)
    w = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
    jmodel = JaxZigMa(**cfg, scan_layers=True)
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, t, y),
                      seed + 1)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pipe",))

    def loss(p):
        o = jax_pipelined_apply(jmodel, p, x, t, y, mesh=mesh,
                                n_microbatches=2, data_axis=None)
        return jnp.sum(o * w), o

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    conv = lambda tree: state_dict_from_jax(jax.tree.map(np.array, tree))
    inputs = [torch.from_numpy(a) for a in (x, t)] + (
        [torch.from_numpy(y)] if y is not None else [])
    return dict(cfg=cfg, sd=conv(params), inputs=inputs,
                w=torch.from_numpy(w)), np.asarray(out), conv(g)


def _train_case(cfg, seed, y=True):
    g = torch.Generator().manual_seed(seed)
    model = ZigMa(**cfg, device="cpu", generator=g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    case = dict(cfg=cfg, sd=model.state_dict(), seed=seed,
                x=torch.randn(4, 4, 8, 8, generator=g),
                t=[torch.rand(4, generator=g) for _ in range(N_STEPS)],
                x0=[torch.randn(4, 4, 8, 8, generator=g)
                    for _ in range(N_STEPS)])
    if y:
        case["y"] = torch.randint(0, 5, (4,), generator=g)
    return case


def _one_process(case):
    state = TrainState.create(ZigMa(**case["cfg"], device="cpu"))
    state.model.load_state_dict(case["sd"])
    state.ema.load_state_dict(case["sd"])
    loss_fn = make_diffusion_loss_fn(state.model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    gen = torch.Generator().manual_seed(case["seed"])
    recs = []
    for i in range(N_STEPS):
        batch = {k: case[k] for k in ("x", "y") if k in case}
        m = train_step(state, loss_fn, batch, gen, t=case["t"][i],
                       x0=case["x0"][i])
        recs.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(records=recs, model=state.model.state_dict(),
                ema=state.ema.state_dict())


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    err = np.max(np.abs(np.asarray(got, np.float32) - ref))
    return err <= tol * max(np.max(np.abs(ref)), 1e-8)


def _assert_trains_as_one_process(got, ref):
    for (la, na), (lb, nb) in zip(ref["records"], got["records"]):
        assert abs(la - lb) <= 1e-5 * abs(la)
        assert abs(na - nb) <= 1e-5 * na
    for which in ("model", "ema"):
        assert list(got[which]) == list(ref[which])
        for k, v in ref[which].items():
            assert np.all(np.abs(got[which][k].numpy() - v.numpy())
                          <= 1e-6 * (1 + np.abs(v.numpy()))), (which, k)


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    io = tmp_path_factory.mktemp("pp2")
    fwd, refs = {}, {}
    for i, (name, cfg) in enumerate(FWD_CASES.items()):
        fwd[name], *refs[name] = _jax_case(cfg, 30 + i)
    train = _train_case(TRAIN_CFG, 7)
    torch.save(dict(fwd=fwd, train=train), io / "setup.pt")
    return dict(out=_run_workers(io, 2), fwd=fwd, refs=refs, train=train,
                io=io)


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_pipeline_matches_jax_and_the_one_process_port(pp2, name):
    got, case = pp2["out"][name], pp2["fwd"][name]
    ref_out, ref_grads = pp2["refs"][name]
    assert np.max(np.abs(got["out"].numpy() - ref_out)) <= 1e-4
    model = ZigMa(**case["cfg"], device="cpu")
    model.load_state_dict(case["sd"])
    o = model(*case["inputs"])
    (o * case["w"]).sum().backward()
    assert _close(got["out"], o.detach(), 1e-5)
    assert set(got["grads"]) == set(ref_grads) == {
        n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        assert _close(got["grads"][n], ref_grads[n], 1e-4), n
        assert _close(got["grads"][n], p.grad, 1e-5), n


def test_pipeline_trains_as_one_process_and_checkpoints_whole(pp2):
    ref = _one_process(pp2["train"])
    _assert_trains_as_one_process(pp2["out"]["train"], ref)
    ck = torch.load(pp2["io"] / "ckpt" / f"{N_STEPS:07d}.pt",
                    weights_only=False)
    assert ck["train_steps"] == N_STEPS
    assert sorted(ck["opt"]["state"]) == list(range(len(ref["model"])))
    for which in ("model", "ema"):
        one = ZigMa(**TRAIN_CFG, device="cpu")
        one.load_state_dict(ck[which], strict=True)
        for k, v in pp2["out"]["train"][which].items():
            assert torch.equal(ck[which][k], v), k


@pytest.mark.parametrize("what,match", [
    ("depth", "not divisible by pipeline stages"),
    ("use_pe", "use_pe=3"),
    ("drop_path", "stochastic depth"),
    ("batch", "not divisible by n_microbatches"),
    ("tp", "cannot be combined")])
def test_pipeline_refusals(pp2, what, match):
    assert match in pp2["out"]["errors"][what]


@pytest.mark.parametrize("extra,match", [
    (["parallel.tp=2"], "cannot be combined"),
    (["parallel.fsdp=true"], "parallel.fsdp with parallel.pp"),
    (["model.params.drop_path_rate=0.1"], "stochastic depth")])
def test_train_cli_pipeline_refusals(tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        train_cli.main(["model=zigzag8_b1_pe2", "data=synthetic",
                        "model.params.depth=2", "model.params.embed_dim=32",
                        "model.params.img_dim=8", "parallel.pp=2",
                        "model.params.drop_path_rate=0", *extra,
                        f"results_dir={tmp_path}", "device=cpu"])
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def dp_pp(tmp_path_factory):
    io = tmp_path_factory.mktemp("dp_pp")
    train = _train_case(dict(BASE, use_checkpoint=True), 8, y=False)
    argv = ["model=zigzag8_b1_pe2", "data=synthetic", "data.num_classes=5",
            "model.params.class_dropout_prob=0.1", "model.params.depth=2",
            "model.params.embed_dim=32", "model.params.img_dim=8",
            "model.params.drop_path_rate=0", "data.batch_size=4",
            "data.train_steps=2", "log_every=1", "parallel.pp=2",
            "parallel.pp_microbatches=2", "sample_every=2",
            "data.sample_fid_n=4", "data.sample_fid_every=2",
            "data.sample_fid_bs=4", "eval_metrics=[fid]",
            "ode.sampling_method=euler", "ode.num_sampling_steps=2",
            "device=cpu", f"results_dir={io / 'out'}"]
    torch.save(dict(train=train, argv=argv), io / "setup.pt")
    return dict(out=_run_workers(io, 4), train=train, argv=argv)


def test_dp_by_pp_trains_as_one_process(dp_pp):
    _assert_trains_as_one_process(dp_pp["out"]["train"],
                                  _one_process(dp_pp["train"]))


def test_train_cli_pipeline_over_dp_by_pp(dp_pp):
    cli = dp_pp["out"]["cli"]
    read = cli["read"]
    # ranks 2d and 2d + 1 form the pipe group of data rank d
    for d in (0, 1):
        assert all(torch.equal(a, b)
                   for a, b in zip(read[2 * d], read[2 * d + 1]))
    assert not torch.equal(read[0][0], read[2][0])
    assert len(cli["records"]) == 2
    assert all(np.isfinite(r["loss"]) for r in cli["records"])
    (ev,) = cli["evals"]
    assert "error" not in ev and np.isfinite(ev["scores"]["fid"])
    assert os.path.exists(os.path.join(os.path.dirname(os.path.dirname(
        cli["checkpoint"])), "vis", "0000002.png"))
    ck = torch.load(cli["checkpoint"], weights_only=False)
    cfg = train_cli.load_config(train_cli.DEFAULT_CONFIG_DIR, "default",
                                dp_pp["argv"])
    for which in ("model", "ema"):
        one = train_cli.build_model(cfg, device="cpu")
        one.load_state_dict(ck[which], strict=True)
