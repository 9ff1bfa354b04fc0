"""The port's inference server (``zigma_tpu_torch.cli.serve``).

Ported from the JAX server's tests (``tests/test_cli.py::TestServeCLI``):
the HTTP round trip on a tiny class-conditional ZigMa on the CPU (healthz,
PNGs, seeds, guidance, concurrent requests, every 400 / 404 / 503 and the
timeout), the submit-side validation without a model, and ``_generate``
against the JAX server's ``_generate`` with the same checkpoint (the same
reference-format ``.pt`` read by both) and the same noise: max abs 1e-4 on
fp32 samples of magnitude ~20 (the first run read 6.7e-6: summation order
through 3 Euler steps of 2 blocks).
"""

import base64
import http.client
import io
import json
import queue
import threading
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zigma_tpu.cli.serve import GenerationWorker as JaxGenerationWorker
from zigma_tpu.config import load_config as jax_load_config
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.cli.serve import (GenerationWorker, OverloadedError,
                                       _Request, make_handler)

BASE = ["data=synthetic", "data.num_classes=5",
        "model.params.class_dropout_prob=0.1", "model.params.embed_dim=32",
        "model.params.depth=2", "model.params.img_dim=8",
        "model.params.patch_size=2", "model.params.scan_type=zigzagN2",
        "sample_mode=ODE", "ode.sampling_method=euler",
        "ode.num_sampling_steps=3", "vae_kind=identity"]


def _cfg(*extra):
    return sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                  BASE + list(extra))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference-format ``.pt`` of the tiny model, perturbed off the DiT
    zero-init so every gate is open."""
    model = sample_cli.build_model(_cfg(), device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    sd = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
          for k, v in model.state_dict().items()}
    path = str(tmp_path_factory.mktemp("serve") / "tiny.pt")
    torch.save({"ema": {f"module.{k}": v for k, v in sd.items()}}, path)
    return path


class _Server:
    def __init__(self, worker, cfg):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         make_handler(worker, cfg))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def _png(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_generate_endpoint(ckpt):
    """Serve the tiny bf16 model -> POST /generate -> decodable PNGs."""
    cfg = _cfg(f"ckpt={ckpt}", "device=cpu")
    worker = GenerationWorker(cfg, max_batch=4)
    srv = _Server(worker, cfg)
    try:
        code, health = srv.request("GET", "/healthz")
        assert code == 200 and health["status"] == "ok"
        assert health["backend"] == "cpu" and health["max_batch"] == 4
        assert health["compile_s"] >= 0

        code, resp = srv.request("POST", "/generate",
                                 {"n": 2, "seed": 7, "cls": 1})
        assert code == 200 and len(resp["images"]) == 2 and resp["ms"] > 0
        img = _png(resp["images"][0])
        assert img.shape == (8, 8, 3) and img.dtype == np.uint8
        # same seed -> the same bytes; another seed or guidance -> others
        assert srv.request("POST", "/generate",
                           {"n": 2, "seed": 7, "cls": 1})[1]["images"] == \
            resp["images"]
        assert srv.request("POST", "/generate",
                           {"n": 2, "seed": 8, "cls": 1})[1]["images"] != \
            resp["images"]
        code, guided = srv.request("POST", "/generate", {
            "n": 2, "seed": 7, "cls": 1, "cfg_scale": 3.0})
        assert code == 200 and guided["images"] != resp["images"]

        # two clients at once ride the one worker, each gets its own answer
        out = {}

        def client(seed):
            out[seed] = srv.request("POST", "/generate",
                                    {"n": 3, "seed": seed, "cls": 2})

        threads = [threading.Thread(target=client, args=(s,)) for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert [out[s][0] for s in (1, 2)] == [200, 200]
        assert all(len(out[s][1]["images"]) == 3 for s in (1, 2))
        assert out[1][1]["images"] != out[2][1]["images"]

        for body, msg in (({"n": 99, "cls": 0}, "n must be"),
                          ({"n": 1}, "'cls' required"),
                          ({"n": 1, "cls": 5}, "cls must be in")):
            code, err = srv.request("POST", "/generate", body)
            assert code == 400 and msg in err["error"]
        assert srv.request("GET", "/nope")[0] == 404
        assert srv.request("POST", "/nope", {})[0] == 404
    finally:
        srv.close()
        worker.close()
    assert not worker.thread.is_alive()


def _bare_worker(*extra, max_batch=4, queue_max=1, dropout=0.1):
    """A worker without a model or a thread: the submit side alone."""
    w = object.__new__(GenerationWorker)
    w.max_batch, w.cfg, w.device = max_batch, _cfg(*extra), torch.device("cpu")
    w.model = SimpleNamespace(class_dropout_prob=dropout)
    w.queue = queue.Queue(maxsize=queue_max)
    w.compile_s = 0.0
    return w


def test_submit_validation_without_a_model():
    with pytest.raises(ValueError, match="class_dropout_prob > 0"):
        _bare_worker(dropout=0.0).submit(n=1, seed=0, cls=0, cfg_scale=2.0)
    with pytest.raises(ValueError, match="meaningless"):
        _bare_worker("data.num_classes=-1").submit(n=1, seed=0, cfg_scale=2.0)
    with pytest.raises(ValueError, match="n must be"):
        _bare_worker().submit(n=0, seed=0, cls=0)
    w = _bare_worker("data.num_classes=-1", "data.has_text=true",
                     "data.d_context=6", "data.n_context_token=3")
    with pytest.raises(ValueError, match="caption_feature"):
        w.submit(n=1, seed=0)
    # a (tokens, width) caption is broadcast over the batch; no worker
    # thread runs, so the request times out and is marked abandoned
    with pytest.raises(TimeoutError):
        w.submit(n=1, seed=3, caption=np.ones((3, 6)).tolist(),
                 cfg_scale=2.0, timeout=0.05)
    req = w.queue.get_nowait()
    assert req.abandoned.is_set() and req.seed == 3 and req.cfg_scale == 2.0
    assert tuple(req.y.shape) == (4, 3, 6) and req.y.dtype == torch.float32


def test_overload_503_and_timeout_over_http():
    """A full queue answers 503 after the one-second put timeout; a client
    timeout answers 400 and leaves its request abandoned for the worker."""
    w = _bare_worker()
    w.queue.put(_Request(1, 0, None, 1.0))  # full
    with pytest.raises(OverloadedError, match="queue full"):
        w.submit(n=1, seed=0, cls=0)
    srv = _Server(w, w.cfg)
    try:
        code, err = srv.request("POST", "/generate", {"n": 1, "cls": 0})
        assert code == 503 and "queue full" in err["error"]
        w.queue.get_nowait()
        original = w.submit
        w.submit = lambda **kw: original(**kw, timeout=0.05)
        code, err = srv.request("POST", "/generate", {"n": 1, "cls": 0})
        assert code == 400 and "timed out" in err["error"]
        assert w.queue.get_nowait().abandoned.is_set()
        assert srv.request("GET", "/healthz")[1]["backend"] == "cpu"
    finally:
        srv.close()


def test_generate_matches_the_jax_server(ckpt):
    """``_generate`` of both servers on the same checkpoint (fp32) and the
    same noise (the JAX server's PRNGKey draw, injected): unguided and
    guided, with the latent scale applied."""
    over = [f"ckpt={ckpt}", "mixed_precision=fp32"]
    jw = JaxGenerationWorker(jax_load_config(sample_cli.DEFAULT_CONFIG_DIR,
                                             "default", BASE + over),
                             max_batch=2)
    shape = (2, *jw.latent_shape)
    noise = lambda seed: torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape)))
    w = GenerationWorker(_cfg(*over, "device=cpu"), max_batch=2,
                         noise_fn=noise)
    try:
        for seed, cls, scale in ((4, 3, 1.0), (5, 0, 4.0)):
            y = jnp.full((2,), cls, jnp.int32)
            ref = np.asarray(jw._jit_generate(jw.params, seed, y,
                                              jnp.float32(scale), scale != 1))
            with torch.inference_mode():
                got = w._generate(seed, torch.full((2,), cls), scale,
                                  scale != 1).numpy()
            assert got.shape == ref.shape == (2, 4, 8, 8)
            assert np.max(np.abs(got - ref)) <= 1e-4
    finally:
        w.close()


def test_worker_refusals(ckpt, monkeypatch):
    with pytest.raises(ValueError, match="ckpt"):
        GenerationWorker(_cfg("device=cpu"))
    with pytest.raises(ValueError, match="sample_mode=ODE"):
        GenerationWorker(_cfg(f"ckpt={ckpt}", "device=cpu", "sample_mode=SDE"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            GenerationWorker(_cfg(f"ckpt={ckpt}"))

    def broken_noise(seed):
        raise ArithmeticError("no noise")

    # a warm-up failure on the worker thread reaches the constructor
    with pytest.raises(ArithmeticError, match="no noise"):
        GenerationWorker(_cfg(f"ckpt={ckpt}", "device=cpu"), max_batch=2,
                         noise_fn=broken_noise)
