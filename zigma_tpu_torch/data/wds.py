"""WebDataset-compatible tar-shard input pipeline (no external deps).

Own copy of ``zigma_tpu/data/wds.py`` (the reference's webdataset stack,
datasets/wds_dataloader.py:15-190, in stdlib ``tarfile`` + PIL + numpy),
yielding numpy batches that the CLIs move to the device:

    shards -> split_by_host -> shard shuffle -> tar samples -> decode ->
    transforms -> rename -> shuffle buffer -> batch(partial=False) -> prefetch

Key semantics preserved:
- samples are files grouped by basename prefix within each tar
  (webdataset convention);
- ``split_by_host``: each process reads a disjoint shard subset
  (replaces ``wds.shardlists.split_by_node``, wds_dataloader.py:140-144);
  rank and world come from ``torch.distributed`` when it is initialised;
- corrupt members are skipped with a warning (``warn_and_continue``,
  wds_dataloader.py:153-165);
- default image transform: to float [0,1], resize, CHW, scale to [-1,1]
  (wds_dataloader.py:89-103);
- ``dict_collation_fn`` stacking semantics (wds_dataloader.py:15-43) with
  numpy instead of torch tensors;
- ``.batched(bs, partial=False)``: trailing partial batches are dropped.

Local shards are read by the port's native indexed reader
(``zigma_tpu_torch/native``) when it builds, else by ``tarfile``;
``tar_samples.served`` counts the shards each route served.
"""

from __future__ import annotations

import io
import json
import logging
import os
import queue
import random
import re
import tarfile
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np

__all__ = [
    "brace_expand",
    "is_remote",
    "open_shard",
    "list_shards",
    "split_by_host",
    "tar_samples",
    "default_decoder",
    "make_image_transform",
    "dict_collation_fn",
    "WebDatasetReader",
    "WebDataModuleFromConfig",
]

log = logging.getLogger(__name__)

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")
_SCHEME_RE = re.compile(r"^(pipe:|https?://|gs://)")


def is_remote(url: str) -> bool:
    """Whether a shard spec is a stream URL rather than a local path."""
    return bool(_SCHEME_RE.match(url))


class _PipeStream:
    """Binary read stream over a subprocess's stdout that reaps the child
    on close (the webdataset ``pipe:`` convention — e.g.
    ``pipe:gsutil cat gs://bucket/shard-{0000..0099}.tar``)."""

    def __init__(self, argv, shell: bool = False):
        import subprocess

        self._proc = subprocess.Popen(
            argv, shell=shell, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)
        self.read = self._proc.stdout.read

    def close(self):
        self._proc.stdout.close()
        if self._proc.poll() is None:
            self._proc.terminate()
        rc = self._proc.wait()
        # accepted: clean exit, -SIGTERM (we cut the stream short), and
        # SIGPIPE deaths (-13 direct, 141 = 128+13 via shell=True) — closing
        # stdout while the child is still writing SIGPIPEs it before our
        # terminate() lands, which is a healthy early-terminated stream,
        # not a failure
        if rc not in (0, None, -15, -13, 141):
            raise OSError(f"pipe command exited with {rc}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.close()
        except OSError:
            if exc[0] is None:
                raise


def open_shard(url: str, timeout: float = 60.0):
    """Open a shard as a binary stream.

    Accepts local paths plus the remote URL kinds the reference's
    webdataset stack handles (datasets/wds_dataloader.py:138-160 passes
    shard URL specs straight to ``wds.WebDataset``): ``pipe:CMD`` shell
    commands, ``http(s)://`` (stdlib urllib), and ``gs://`` (via gsutil /
    gcloud storage cat) — required for multi-host runs reading from GCS.
    """
    if url.startswith("pipe:"):
        return _PipeStream(url[len("pipe:"):], shell=True)
    if url.startswith(("http://", "https://")):
        import urllib.request

        return urllib.request.urlopen(url, timeout=timeout)
    if url.startswith("gs://"):
        import shutil as _shutil

        for tool in (["gsutil", "cat"], ["gcloud", "storage", "cat"]):
            if _shutil.which(tool[0]):
                return _PipeStream(tool + [url])
        raise OSError(
            f"gs:// shard {url!r} needs gsutil or gcloud on PATH "
            "(or use a pipe: command)")
    return open(url, "rb")


def brace_expand(pattern: str) -> list[str]:
    """Expand '{00000..00012}' ranges like webdataset shard specs."""
    m = _BRACE_RE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        head = pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
        out.extend(brace_expand(head))
    return out


def list_shards(tar_base: str, shards: str) -> list[str]:
    """Resolve a shard spec (brace ranges or glob) under tar_base.

    Remote specs (pipe:/http(s)/gs) expand brace ranges but never glob —
    an absolute-URL ``shards`` ignores ``tar_base``."""
    if is_remote(shards):
        spec = shards
    elif is_remote(tar_base):
        spec = tar_base.rstrip("/") + "/" + shards
    else:
        spec = os.path.join(tar_base, shards)
    urls = brace_expand(spec)
    if (not is_remote(spec) and len(urls) == 1
            and any(ch in spec for ch in "*?[")):
        import glob

        urls = sorted(glob.glob(spec))
    return urls


def split_by_host(urls: list[str], process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> list[str]:
    """Disjoint per-host shard subset (wds split_by_node equivalent): by
    default this process's data rank and the data ranks' count without a
    mesh (``parallel.mesh.data_rank``: the process group's rank and
    size)."""
    if process_index is None or process_count is None:
        from zigma_tpu_torch.parallel.mesh import data_rank

        process_index, process_count = data_rank()
    if process_count <= 1:
        return urls
    return urls[process_index::process_count]


# ---------------------------------------------------------------------------
# tar iteration + decoding
# ---------------------------------------------------------------------------


def tar_samples(url: str, handler: str = "warn") -> Iterator[dict]:
    """Yield {'__key__': ..., '<ext>': bytes, ...} sample dicts from one tar.

    Files sharing a basename prefix (up to the first dot) form one sample,
    in tar order — the webdataset grouping rule.  Uses the native C++
    indexed reader (zigma_tpu_torch/native/zt_tar.cc) when it builds, falling
    back to Python tarfile; each shard that yields is counted in
    ``tar_samples.served`` under "native" or "tarfile".
    """
    stream = None
    if is_remote(url):
        # remote shards stream through tarfile's non-seeking mode; the
        # native indexed reader needs a local file (pread)
        try:
            stream = open_shard(url)
            tf = tarfile.open(fileobj=stream, mode="r|*")
        except (OSError, tarfile.TarError) as e:
            if stream is not None:
                try:
                    stream.close()
                except OSError:
                    pass
            if handler == "warn":
                log.warning("skipping unreadable shard %s: %s", url, e)
                return
            raise
    else:
        from zigma_tpu_torch.native.tar_reader import (available,
                                                       native_tar_samples)

        if available():
            try:
                samples = native_tar_samples(url)
                first = next(samples, None)  # opens and indexes the shard
                _count_served("native")
                if first is not None:
                    yield first
                    yield from samples
                return
            except OSError as e:
                if handler == "warn":
                    log.warning(
                        "native reader failed on %s (%s); tarfile fallback",
                        url, e)
                else:
                    raise
        try:
            tf = tarfile.open(url, mode="r|*")
        except (OSError, tarfile.TarError) as e:
            if handler == "warn":
                log.warning("skipping unreadable shard %s: %s", url, e)
                return
            raise
    _count_served("tarfile")
    current_key, sample = None, {}
    try:
        for member in tf:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            if "." not in base:
                key, ext = base, ""
            else:
                key, ext = base.split(".", 1)
            key = os.path.join(os.path.dirname(member.name), key)
            if key != current_key:
                if sample:
                    yield sample
                current_key, sample = key, {"__key__": key}
            try:
                sample[ext] = tf.extractfile(member).read()
            except (OSError, tarfile.TarError) as e:
                if handler == "warn":
                    log.warning("skipping corrupt member %s: %s", member.name, e)
                    continue
                raise
        if sample:
            yield sample
    except (OSError, tarfile.TarError) as e:
        # mid-stream failure (truncated remote transfer, dropped pipe)
        if handler == "warn":
            log.warning("shard %s truncated: %s", url, e)
        else:
            raise
    finally:
        tf.close()
        if stream is not None:
            try:
                stream.close()
            except OSError as e:
                if handler == "warn":
                    log.warning("closing shard %s: %s", url, e)
                else:
                    raise


_served_lock = threading.Lock()


def _count_served(route: str):
    with _served_lock:
        tar_samples.served[route] += 1


tar_samples.served = {"native": 0, "tarfile": 0}

_IMAGE_EXTS = ("png", "jpg", "jpeg", "webp", "ppm", "bmp")


def default_decoder(ext: str, data: bytes) -> Any:
    """Decode a member by extension: npy/npz/cls/txt/json/images.

    Images decode to float32 RGB in [0, 1], HWC — the reference's
    ``decode("rgb")`` (wds_dataloader.py:160-163).
    """
    last = ext.lower().rsplit(".", 1)[-1]  # wds exts are multi-part: 'cls_id.cls'
    if last == "npy":
        return np.load(io.BytesIO(data), allow_pickle=False)
    if last == "npz":
        return dict(np.load(io.BytesIO(data), allow_pickle=False))
    if last in ("cls", "cls2", "index"):
        return int(data)
    if last in ("txt", "text", "caption"):
        return data.decode("utf-8")
    if last == "json":
        return json.loads(data)
    ext = last
    if any(ext.endswith(e) for e in _IMAGE_EXTS):
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGB")
        return np.asarray(img, np.float32) / 255.0
    return data  # raw bytes passthrough


def make_image_transform(image_size: int, channel_last: bool = False):
    """[0,1] HWC -> resize -> [-1,1] CHW (or HWC), float32
    (wds_dataloader.py:89-103)."""

    def transform(img: np.ndarray) -> np.ndarray:
        from PIL import Image

        h, w = img.shape[:2]
        if min(h, w) != image_size:
            # torchvision Resize(size) semantics: short side -> size
            scale = image_size / min(h, w)
            new_w, new_h = round(w * scale), round(h * scale)
            pil = Image.fromarray((img * 255).astype(np.uint8))
            pil = pil.resize((new_w, new_h), Image.BILINEAR)
            img = np.asarray(pil, np.float32) / 255.0
        img = img * 2.0 - 1.0
        if not channel_last:
            img = np.transpose(img, (2, 0, 1))
        return img.astype(np.float32)

    return transform


def dict_collation_fn(samples: list[dict]) -> dict:
    """Batch a list of dict samples, key-wise (wds_dataloader.py:15-43).
    Keys not present in every sample are dropped (set intersection)."""
    keys = set.intersection(*[set(s.keys()) for s in samples])
    out = {}
    for key in keys:
        vals = [s[key] for s in samples]
        v0 = vals[0]
        if isinstance(v0, (int, float)):
            out[key] = np.asarray(vals)
        elif isinstance(v0, np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


# ---------------------------------------------------------------------------
# the composed reader
# ---------------------------------------------------------------------------


class WebDatasetReader:
    """Composable shard reader: shuffle, decode, transform, rename, batch.

    Mirrors the reference's ``make_loader`` pipeline
    (wds_dataloader.py:88-180) as one iterator class.
    """

    def __init__(
        self,
        urls: list[str],
        *,
        batch_size: int,
        shuffle: int = 0,
        repeat: bool = True,
        decoder: Callable = default_decoder,
        transforms: Optional[dict] = None,   # per-key callables
        rename: Optional[dict] = None,       # new_key -> old_key(s) ('a|b')
        postprocess: Optional[Callable] = None,
        partial: bool = False,
        seed: int = 0,
        prefetch: int = 2,
    ):
        if not urls:
            raise ValueError("no shards to read")
        self.urls = list(urls)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.repeat = repeat
        self.decoder = decoder
        self.transforms = transforms or {}
        self.rename = rename
        self.postprocess = postprocess
        self.partial = partial
        self.seed = seed
        self.prefetch = prefetch

    # -- sample stream ------------------------------------------------------

    def _samples(self) -> Iterator[dict]:
        rng = random.Random(self.seed)
        epoch = 0
        while True:
            urls = list(self.urls)
            if self.shuffle > 0:
                rng.shuffle(urls)
            buf: list[dict] = []
            n_prepared = 0
            for url in urls:
                for raw in tar_samples(url):
                    try:
                        sample = self._prepare(raw)
                    except Exception as e:  # warn_and_continue semantics
                        log.warning("skipping sample %s: %s",
                                    raw.get("__key__"), e)
                        continue
                    n_prepared += 1
                    if self.shuffle > 1:
                        buf.append(sample)
                        if len(buf) >= self.shuffle:
                            idx = rng.randrange(len(buf))
                            buf[idx], buf[-1] = buf[-1], buf[idx]
                            yield buf.pop()
                    else:
                        yield sample
            rng.shuffle(buf)
            yield from buf
            epoch += 1
            if not self.repeat:
                return
            if n_prepared == 0:  # repeating an empty epoch would spin forever
                raise RuntimeError(
                    f"no readable sample in {len(urls)} shard(s), e.g. "
                    f"{urls[0]}")

    def _prepare(self, raw: dict) -> dict:
        sample = {"__key__": raw["__key__"]}
        for ext, data in raw.items():
            if ext == "__key__":
                continue
            sample[ext] = self.decoder(ext, data)
        for key, fn in self.transforms.items():
            if key in sample and fn is not None:
                sample[key] = fn(sample[key])
        if self.rename:
            renamed = {"__key__": sample["__key__"]}
            for new_key, old_spec in self.rename.items():
                for old in str(old_spec).split("|"):
                    if old in sample:
                        renamed[new_key] = sample[old]
                        break
            sample = renamed
        if self.postprocess is not None:
            sample = self.postprocess(sample)
        return sample

    # -- batching + prefetch --------------------------------------------------

    def _batches(self) -> Iterator[dict]:
        buf = []
        for sample in self._samples():
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield dict_collation_fn(buf)
                buf = []
        if buf and self.partial:
            yield dict_collation_fn(buf)

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _END = object()

        def worker():
            # propagate pipeline errors to the consumer: a repeat=True
            # stream that silently "ends" would make a crash look like
            # normal completion to the train loop
            try:
                for b in self._batches():
                    q.put(b)
                q.put(_END)
            except BaseException as e:  # noqa: BLE001
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


class WebDataModuleFromConfig:
    """Config-level API parity with the reference DataModule
    (wds_dataloader.py:46-190): ``WebDataModuleFromConfig(**cfg.data)
    .train_dataloader()``."""

    def __init__(self, tar_base: str, batch_size: int, image_size: int,
                 train: Optional[dict] = None, validation: Optional[dict] = None,
                 test: Optional[dict] = None, num_workers: int = 0,
                 multinode: bool = True, is_video: bool = False,
                 video_frames: int = 0, channel_last: bool = False,
                 val_batch_size: Optional[int] = None,
                 host_split: Optional[tuple] = None, **kwargs):
        self.tar_base = tar_base
        self.batch_size = batch_size
        self.image_size = image_size
        self.train = train
        self.validation = validation
        self.test = test
        self.multinode = multinode
        self.is_video = is_video
        self.video_frames = video_frames
        self.channel_last = channel_last
        self.val_batch_size = val_batch_size or batch_size
        # (index, count) of this process's share of the shards under
        # multinode: its data rank, so that the ranks training on one batch
        # read the same shards (default: split_by_host's)
        self.host_split = host_split or (None, None)

    def make_loader(self, cfg: dict, train: bool = True) -> WebDatasetReader:
        urls = list_shards(self.tar_base, cfg["shards"])
        if self.multinode:
            urls = split_by_host(urls, *self.host_split)
        transforms = dict(cfg.get("transforms", {}))
        img_key = cfg.get("image_key", "image.png")
        # the image key gets the standard [-1,1] CHW transform unless video
        # (wds_dataloader.py:119-126: transform_dict[img_key] = image_transforms)
        if not self.is_video:
            transforms.setdefault(
                img_key, make_image_transform(self.image_size, self.channel_last))
        return WebDatasetReader(
            urls,
            batch_size=self.batch_size if train else self.val_batch_size,
            shuffle=int(cfg.get("shuffle", 0)),
            transforms=transforms,
            rename=cfg.get("rename"),
            postprocess=cfg.get("postprocess"),
            # val/test are finite single passes (an eval loop must see
            # StopIteration) and keep the partial tail batch; the train
            # stream loops forever with full batches only (the reference's
            # .batched(bs, partial=False), wds_dataloader.py:151)
            repeat=train,
            partial=not train,
        )

    def train_dataloader(self):
        return self.make_loader(self.train)

    def val_dataloader(self):
        return self.make_loader(self.validation, train=False)

    def test_dataloader(self):
        return self.make_loader(self.test, train=False)
