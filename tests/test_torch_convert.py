"""``cli.convert``: a reference-layout ``.pt`` to a port checkpoint that
``cli.train ckpt=`` fine-tunes from (counterpart of ``tests/test_cli.py``'s
``TestConvertCLI``).

The reference ``.pt`` is a tiny port model's random weights under the
reference's keys (``module.``-prefixed, as DDP saves them, with different
``ema`` and ``model`` weights).  The converted checkpoint holds the chosen
weights as model and EMA, a fresh optimizer, step 0 and a fresh run's
``best_fid``; two training steps resume from it.  A model the weights do
not fit -- a mis-shaped, missing or extra name -- exits with the list.
"""

import math

import pytest
import torch

from zigma_tpu_torch.cli import convert as convert_cli
from zigma_tpu_torch.cli import train as train_cli

MODEL = ["model=zigzag8_b1_pe2", "data=synthetic", "data.batch_size=2",
         "model.params.depth=2", "model.params.embed_dim=32",
         "model.params.img_dim=8", "model.params.patch_size=2",
         "mixed_precision=fp32", "device=cpu"]


def _reference_pt(tmp_path, edit=None):
    cfg = train_cli.load_config(train_cli.DEFAULT_CONFIG_DIR, "default",
                                MODEL)
    weights = {}
    for which, seed in (("ema", 1), ("model", 2)):
        model = train_cli.build_model(
            cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        weights[which] = model.state_dict()
    sd = {w: {f"module.{k}": v for k, v in d.items()}
          for w, d in weights.items()}
    if edit is not None:
        edit(sd["ema"])
    path = str(tmp_path / "ref_0001000.pt")
    torch.save({**sd, "opt": {}, "args": None, "train_steps": 1000,
                "best_fid": 12.5}, path)
    return path, weights


@pytest.mark.parametrize("which", ["ema", "model"])
def test_convert_then_finetune(tmp_path, capsys, which):
    pt, weights = _reference_pt(tmp_path)
    path = convert_cli.main([f"--ckpt={pt}", f"--out={tmp_path / 'conv'}",
                             f"--which={which}", *MODEL])
    assert path == str(tmp_path / "conv" / "0000000.pt")
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith(f"converted {pt} [{which}] (")
    assert lines[-1].startswith(f"fine-tune with: python -m "
                                f"zigma_tpu_torch.cli.train ckpt={path}")
    ck = torch.load(path, weights_only=False)
    assert ck["train_steps"] == 0 and ck["best_fid"] == math.inf
    assert ck["opt"]["state"] == {}
    for part in ("model", "ema"):
        assert list(ck[part]) == list(weights[which])
        assert all(torch.equal(ck[part][k], v)
                   for k, v in weights[which].items())
    res = train_cli.main([*MODEL, f"ckpt={path}", "data.train_steps=2",
                          "log_every=1", f"results_dir={tmp_path / 'out'}"])
    assert res["state"].step == 2 and len(res["records"]) == 2
    assert all(math.isfinite(r["loss"]) for r in res["records"])


@pytest.mark.parametrize("edit,listed", [
    (lambda sd: sd.update({"module.x_embedder.proj.weight":
                           torch.zeros(16, 4, 2, 2)}),
     "shape mismatch x_embedder.proj.weight"),
    (lambda sd: sd.pop("module.final_layer.linear.bias"),
     "missing in .pt: final_layer.linear.bias"),
    (lambda sd: sd.update({"module.extra.weight": torch.zeros(1)}),
     "unexpected in .pt: extra.weight")])
def test_convert_rejects_a_mismatched_model(tmp_path, edit, listed):
    pt, _ = _reference_pt(tmp_path, edit)
    with pytest.raises(SystemExit, match="mismatch") as e:
        convert_cli.main([f"--ckpt={pt}", f"--out={tmp_path / 'conv'}",
                          *MODEL])
    assert listed in str(e.value)
    assert not (tmp_path / "conv").exists()
