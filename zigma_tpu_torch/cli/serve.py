"""Inference server: ``python -m zigma_tpu_torch.cli.serve model=... ckpt=... [port=8000]``

Counterpart of ``zigma_tpu/cli/serve.py``: a standard-library HTTP server
around one warm sampler.

- Every request runs at the fixed ``serve_batch`` (``max_batch``): a request
  for fewer images is padded to it and sliced, one request a device step.
- Concurrent requests wait in a bounded queue; when it stays full for a
  second the server answers 503 (backpressure).
- Per request: seed, class label or caption features, and ``cfg_scale``
  (classifier-free guidance through ``forward_with_cfg`` when it is not 1).
- Latents are decoded through the configured VAE codec when its weights are
  there (``vae_kind``), and stay latents otherwise.
- ``/healthz`` for load balancers.

API:
  GET  /healthz    -> {"status": "ok", "model": ..., "backend": "cuda" | "cpu",
                       "max_batch": ..., "compile_s": ...}
  POST /generate   body: {"n": 4, "seed": 1, "cls": 2, "cfg_scale": 3.0,
                          "caption_feature": [...]}
                   -> {"images": [<base64 PNG>, ...], "ms": 123.4}

The model runs in ONE worker thread; the HTTP threads only enqueue and
wait.  Grad mode is per thread in torch, so the worker enters
``torch.inference_mode()`` itself, in the warm-up and in its loop.  There is
nothing to compile: the warm-up runs, on the worker thread before it takes
requests, one request for each conditioning and guidance variant (decoded
when the codec decodes), which builds the kernels and sets up the thread's
cuBLAS / cuDNN handles and choices before the first real request; its
seconds are ``compile_s``.

The noise of a request comes from a ``torch.Generator`` seeded with its
seed, so it differs from the JAX server's ``PRNGKey(seed)`` draw;
``noise_fn`` replaces it (tests feed both servers the same noise).  Runs on
CUDA unless ``device=cpu`` is given.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from zigma_tpu_torch.cli.sample import (DEFAULT_CONFIG_DIR, build_model,
                                        build_sample_fn, load_state_dict)
from zigma_tpu_torch.config import load_config
from zigma_tpu_torch.data.vae import IdentityCodec, get_codec
from zigma_tpu_torch.device import resolve_device
from zigma_tpu_torch.metrics.facade import to_uint8_images
from zigma_tpu_torch.train.state import LATENT_SCALE
from zigma_tpu_torch.transport import Sampler, create_transport
from zigma_tpu_torch.utils.inference import cast_for_inference

__all__ = ["OverloadedError", "GenerationWorker", "make_handler", "main"]


class OverloadedError(RuntimeError):
    """Request queue full: HTTP 503 (backpressure)."""


class _Request:
    __slots__ = ("n", "seed", "y", "cfg_scale", "event", "result", "error",
                 "abandoned")

    def __init__(self, n, seed, y, cfg_scale):
        self.n, self.seed, self.y, self.cfg_scale = n, seed, y, cfg_scale
        self.event = threading.Event()
        self.result = None
        self.error = None
        # set by the HTTP thread when its client timed out: the worker skips
        # the request instead of spending a device step on it
        self.abandoned = threading.Event()


class GenerationWorker:
    """The device-owner thread: drains the queue, runs each request at
    ``max_batch`` and slices the answer.  ``noise_fn(seed)`` gives a
    request's starting noise, (max_batch, *latent_shape); None draws it
    from ``torch.Generator(device).manual_seed(seed)``."""

    def __init__(self, cfg, max_batch: int = 8,
                 noise_fn: Optional[Callable[[int], torch.Tensor]] = None):
        self.cfg = cfg
        self.max_batch = max_batch
        self.device = resolve_device(cfg.get("device"))
        path = cfg.get("ckpt")
        if not path:
            raise ValueError("serving requires ckpt=<path>")
        self.model = build_model(cfg, device=self.device)
        p = cfg.model.params
        self.latent_shape = (int(p["in_channels"]), int(p["img_dim"]),
                             int(p["img_dim"]))
        if cfg.data.get("video_frames", 0):
            self.latent_shape = (int(cfg.data["video_frames"]),
                                 *self.latent_shape)
        self.model.load_state_dict(load_state_dict(path))
        if self.model.dtype != torch.float32:
            cast_for_inference(self.model, self.model.dtype)
        self.model.eval().requires_grad_(False)
        mode, fn = build_sample_fn(cfg, Sampler(create_transport(
            cfg.train.get("path_type", "Linear"),
            cfg.train.get("prediction", "velocity"),
            cfg.train.get("loss_weight"),
            cfg.train.get("train_eps"), cfg.train.get("sample_eps"))))
        if mode != "ode":
            raise ValueError("serve supports sample_mode=ODE")
        self._ode = fn
        self.noise_fn = noise_fn or self._noise

        self.codec = get_codec(cfg.get("vae_kind", "auto"), device=self.device)
        self.is_latent = bool(cfg.get("is_latent", True)) and not isinstance(
            self.codec, IdentityCodec)

        self.queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=int(cfg.get("serve_queue_max", 64)))
        # the warm-up runs on the worker thread: cuBLAS and cuDNN keep their
        # handles per thread, so a warm-up elsewhere would leave the first
        # request to set them up
        self.compile_s, self._warmup_error = None, None
        ready = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(ready,),
                                       daemon=True)
        self.thread.start()
        ready.wait()
        if self._warmup_error is not None:
            raise self._warmup_error

    # -- device side -------------------------------------------------------

    def _noise(self, seed: int) -> torch.Tensor:
        gen = torch.Generator(self.device).manual_seed(seed)
        return torch.randn((self.max_batch, *self.latent_shape),
                           generator=gen, device=self.device)

    def _generate(self, seed, y, cfg_scale, use_cfg):
        """One request's samples at ``max_batch``: the conditional forward
        when ``use_cfg`` is false (half the compute of guidance), the
        guided one otherwise; latents divided by the latent scale."""
        z = torch.as_tensor(self.noise_fn(seed)).to(self.device,
                                                    torch.float32)
        if y is None or not use_cfg:
            model_fn = lambda x, t: self.model(x, t, y)
        else:
            model_fn = lambda x, t: self.model.forward_with_cfg(
                x, t, y, cfg_scale)
        out = self._ode(z, model_fn)[-1]
        if self.cfg.get("is_latent", True):
            out = out / LATENT_SCALE
        return out

    def _cfg_supported(self):
        data = self.cfg.data
        if data.get("num_classes", -1) > 0:
            return self.model.class_dropout_prob > 0
        return bool(data.get("has_text"))

    def _warmup(self):
        """One request of each variant the loop can run (each conditioning,
        unguided and, where the model allows it, guided), decoded as the
        loop decodes; returns seconds."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            for y in self._warmup_conditionings():
                variants = [(1.0, False)]
                if y is not None and self._cfg_supported():
                    variants.append((2.0, True))
                for scale, use_cfg in variants:
                    arr = self._generate(0, y, scale, use_cfg).float().cpu()
                    if self.is_latent:
                        self.codec.decode(arr.numpy())
        return round(time.perf_counter() - t0, 1)

    def _run(self, ready: threading.Event):
        try:
            self.compile_s = self._warmup()
        except BaseException as e:  # re-raised by the constructor
            self._warmup_error = e
            return
        finally:
            ready.set()
        self._loop()

    def _warmup_conditionings(self):
        data, dev = self.cfg.data, self.device
        if data.get("num_classes", -1) > 0:
            return [torch.zeros((self.max_batch,), dtype=torch.long,
                                device=dev)]
        if data.get("has_text"):
            return [torch.zeros((self.max_batch,
                                 int(data.get("n_context_token", 77)),
                                 int(data.get("d_context", 768))), device=dev)]
        return [None]

    def _loop(self):
        with torch.inference_mode():
            while True:
                req = self.queue.get()
                if req is None:  # close()
                    return
                if req.abandoned.is_set():
                    continue  # the client already timed out
                try:
                    arr = self._generate(req.seed, req.y, req.cfg_scale,
                                         req.cfg_scale != 1.0)[:req.n]
                    arr = arr.float().cpu().numpy()
                    if self.is_latent:
                        arr = self.codec.decode(arr)
                    req.result = arr
                except Exception as e:  # handed to the waiting HTTP thread
                    req.error = e
                req.event.set()

    def close(self, timeout: float = 60.0):
        """Stop the worker thread after the requests already queued."""
        self.queue.put(None)
        self.thread.join(timeout)

    # -- HTTP side ---------------------------------------------------------

    def submit(self, n, seed, cls=None, caption=None, cfg_scale=1.0,
               timeout=600.0):
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"n must be in [1, {self.max_batch}]")
        y = None
        data = self.cfg.data
        if data.get("num_classes", -1) > 0:
            if cls is None:
                raise ValueError("class-conditional model: 'cls' required")
            n_cls = int(data["num_classes"])
            if not 0 <= int(cls) < n_cls:
                # the last row of the label table is the CFG null class:
                # reject instead of serving it
                raise ValueError(f"cls must be in [0, {n_cls})")
            if cfg_scale != 1.0 and self.model.class_dropout_prob <= 0:
                raise ValueError(
                    "cfg_scale != 1 needs a model trained with "
                    "class_dropout_prob > 0 (no null-class row exists)")
            y = torch.full((self.max_batch,), int(cls), dtype=torch.long,
                           device=self.device)
        elif data.get("has_text"):
            if caption is None:
                raise ValueError(
                    "text-conditional model: 'caption_feature' required")
            cap = np.asarray(caption, np.float32)
            if cap.ndim == 2:
                cap = np.broadcast_to(cap[None], (self.max_batch, *cap.shape))
            y = torch.as_tensor(np.ascontiguousarray(cap), device=self.device)
        elif cfg_scale != 1.0:
            # the warm-up never runs a guided unconditional request, and
            # guidance means nothing without a condition: reject it
            raise ValueError(
                "cfg_scale != 1 is meaningless for an unconditional model")
        req = _Request(n, int(seed), y, float(cfg_scale))
        try:
            # a bounded queue is backpressure: under sustained overload the
            # server answers 503 at once instead of queueing work whose
            # clients will have timed out by the time it runs
            self.queue.put(req, timeout=1.0)
        except queue.Full:
            raise OverloadedError(
                f"request queue full ({self.queue.maxsize} pending)")
        if not req.event.wait(timeout):
            req.abandoned.set()
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result


def _to_png_b64(arr):
    """(C, H, W) or (T, C, H, W) in [-1, 1] -> base64 PNG (the first frame
    of a video; channel 0 as grey for fewer than 3 channels)."""
    from PIL import Image

    if arr.ndim == 4:
        arr = arr[0]
    u8 = to_uint8_images(arr[None])[0]
    if u8.shape[0] < 3:
        u8 = np.repeat(u8[:1], 3, axis=0)
    img = Image.fromarray(np.transpose(u8[:3], (1, 2, 0)))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_handler(worker: GenerationWorker, cfg):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "model": cfg.model.get("name"),
                    "backend": worker.device.type,
                    "max_batch": worker.max_batch,
                    "compile_s": worker.compile_s,
                })
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._send(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                t0 = time.time()
                arr = worker.submit(
                    n=int(body.get("n", 1)),
                    seed=int(body.get("seed", 0)),
                    cls=body.get("cls"),
                    caption=body.get("caption_feature"),
                    cfg_scale=body.get("cfg_scale", 1.0))
                self._send(200, {
                    "images": [_to_png_b64(a) for a in arr],
                    "ms": round((time.time() - t0) * 1e3, 1),
                })
            except OverloadedError as e:
                self._send(503, {"error": str(e)})
            except (ValueError, TimeoutError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # the server keeps running
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet access log
            del a

    return Handler


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = DEFAULT_CONFIG_DIR
    if argv and argv[0].startswith("--config-dir="):
        config_dir = argv.pop(0).split("=", 1)[1]
    cfg = load_config(config_dir, "default", argv)
    port = int(cfg.get("port", 8000))
    max_batch = int(cfg.get("serve_batch", 8))

    print(f"loading + warming up (max_batch={max_batch}) ...", flush=True)
    worker = GenerationWorker(cfg, max_batch=max_batch)
    print(f"warm in {worker.compile_s}s; serving on :{port}", flush=True)

    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(worker, cfg))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        worker.close()
    return server


if __name__ == "__main__":
    main()
