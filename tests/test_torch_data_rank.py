"""Shards, draws, vis and eval follow the data rank under tensor parallelism.

Four gloo worker processes (torch and the port only, meeting through a
``FileStore`` in ``tmp_path``) run ``cli.train`` at dp 2 x tp 2 over eight
tiny class-labelled shards (``multinode``: split over the processes), four
steps of 4 with vis at step 4 and an eval of 8 samples a data rank.  Each
sample's latent carries its index, so the workers record which samples
each rank read (before ``shard_batch``) and trained on (after it), and the
labels every EMA forward of vis and eval got.  Held:

- the ranks of one model group read the same batches, and the samples
  trained on cover every shard (a split by global rank reads shards that
  ``shard_batch`` then throws away);
- vis and eval feed one label batch a model group (a tensor-parallel
  forward with different labels on its ranks mixes them);
- the eval's gathered features and moments count each sample once: the
  data ranks' samples, not every rank's.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from zigma_tpu_torch.cli.prepare_data import ShardWriter, _npy_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS, PER_SHARD, BATCH, STEPS, FID_N = 8, 4, 4, 4, 8

WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + io + "/store",
                            rank=rank, world_size=world)
    from zigma_tpu_torch.cli import train as train_cli
    from zigma_tpu_torch.models import ZigMa

    rec = dict(read=[], trained=[], labels=[])
    real_shard_batch = train_cli.shard_batch

    def shard_batch(batch, mesh):
        rec["read"].append(batch["x"][:, 0, 0, 0].round().long().tolist())
        out = real_shard_batch(batch, mesh)
        rec["trained"].append(out["x"][:, 0, 0, 0].round().long().tolist())
        return out

    train_cli.shard_batch = shard_batch
    real_forward = ZigMa.forward

    def forward(self, x, t, y=None, **kw):
        if not torch.is_grad_enabled() and y is not None:  # vis and eval
            rec["labels"].append(y.tolist())
        return real_forward(self, x, t, y, **kw)

    ZigMa.forward = forward
    res = train_cli.main(sys.argv[4:])
    image = res["metric_suite"].image
    rec["gathered"] = int(image._gather(image.real_feats).shape[0])
    rec["moments_n"] = int(image._merged(image.real_mom["main"]).n)
    rec["local"] = int(image.n_real)
    rec["evals"] = res["evals"]
    out = [None] * world
    dist.all_gather_object(out, rec)
    if rank == 0:
        torch.save(out, io + "/out.pt")
    dist.destroy_process_group()
""")


def _write_shards(root):
    """N_SHARDS shards of PER_SHARD samples: sample i's latent holds i at
    [0, 0, 0], its label is i % 5."""
    rng = np.random.default_rng(0)
    w = ShardWriter(str(root), shard_size=PER_SHARD)
    for i in range(N_SHARDS * PER_SHARD):
        lat = rng.standard_normal((4, 8, 8)).astype(np.float32)
        lat[0, 0, 0] = i
        w.write(f"{i:08d}", {"img_feature256.npy": _npy_bytes(lat),
                             "cls_id.cls": str(i % 5).encode()})
    w.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io = tmp_path_factory.mktemp("data_rank")
    _write_shards(io / "wds")
    shards = f"train-{{000000..{N_SHARDS - 1:06d}}}.tar"
    argv = ["model=zigzag8_b1_pe2", "data=churches256",
            f"data.tar_base={io / 'wds'}", f"data.train.shards={shards}",
            f"data.validation.shards={shards}", "data.multinode=true",
            "data.train.rename.cls_id=cls_id.cls",
            "data.validation.rename.cls_id=cls_id.cls",
            "data.num_classes=5", "model.params.class_dropout_prob=0.1",
            "model.params.embed_dim=32", "model.params.depth=2",
            "model.params.img_dim=8", "model.params.patch_size=2",
            f"data.batch_size={BATCH}", f"data.train_steps={STEPS}",
            f"data.sample_fid_n={FID_N}", f"data.sample_fid_every={STEPS}",
            "data.sample_fid_bs=4", "data.val_batch_size=4",
            "eval_metrics=[fid,kid]", f"sample_every={STEPS}",
            "ode.sampling_method=euler", "ode.num_sampling_steps=2",
            "log_every=1", "parallel.tp=2", "device=cpu",
            f"results_dir={io / 'out'}"]
    script = io / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for var in ("ZIGMA_INCEPTION_WEIGHTS", "ZIGMA_DINOV2_WEIGHTS",
                "ZIGMA_I3D_WEIGHTS", "ZIGMA_I3D_TORCHSCRIPT",
                "ZIGMA_VAE_WEIGHTS"):
        env.pop(var, None)
    env.update(OMP_NUM_THREADS="1", ZIGMA_DISTRIBUTED="1",
               TORCH_HOME=str(io / "torch_home"), HF_HOME=str(io / "hf"))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "4", str(io), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return torch.load(io / "out.pt", weights_only=False)


def test_model_group_reads_one_batch_and_training_covers_every_shard(runs):
    # ranks 2g and 2g + 1 form model group g (data rank g)
    for g in (0, 1):
        assert runs[2 * g]["read"] == runs[2 * g + 1]["read"]
    trained = {i for r in runs for b in r["trained"] for i in b}
    assert {i // PER_SHARD for i in trained} == set(range(N_SHARDS))
    # the two data ranks train on disjoint shards
    mine = [{i // PER_SHARD for b in runs[2 * g]["trained"] for i in b}
            for g in (0, 1)]
    assert not mine[0] & mine[1]


def test_vis_and_eval_feed_one_label_batch_a_model_group(runs):
    for g in (0, 1):
        a, b = runs[2 * g]["labels"], runs[2 * g + 1]["labels"]
        # vis (one forward a sampling step) and the eval's batches
        assert len(a) > 2 and a == b
    assert runs[0]["labels"] != runs[2]["labels"]


def test_eval_gathers_each_sample_once(runs):
    for r in runs:
        assert r["local"] == FID_N
        assert r["gathered"] == r["moments_n"] == 2 * FID_N
        (ev,) = r["evals"]
        assert "error" not in ev and np.isfinite(ev["scores"]["fid"])
