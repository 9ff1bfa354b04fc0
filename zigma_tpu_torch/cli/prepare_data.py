"""Offline feature preparation: images -> webdataset latent shards.

Counterpart of ``zigma_tpu/cli/prepare_data.py``.  The reference consumes
shards that already hold VAE latents (``img_feature256.npy`` /
``frame_feature256.npy``) and CLIP caption features; this CLI makes that
step explicit:

    python -m zigma_tpu_torch.cli.prepare_data \
        --images /path/to/images --out ./data/my_wds --image-size 256 \
        --shard-size 1000 [--captions captions.json] [--codec sd-vae] \
        [--keep-jpeg] [--device cpu]

Writes ``train-{000000..NNNNNN}.tar`` shards readable by
``WebDataModuleFromConfig`` with the reference's key names: the center-cropped
image through the codec as ``img_feature{size}.npy`` (``identity`` stores the
[-1, 1] pixels; ``sd-vae`` a posterior sample of the VAE on the card, or on
the CPU with ``--device cpu``), ``caption.txt`` and, when the CLIP tokenizer
and weights are cached, ``caption_clip_feature.npy``, and ``image.jpg``
with ``--keep-jpeg``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tarfile

import numpy as np

from zigma_tpu_torch.data import get_codec, get_transforms_image


def _iter_images(root: str):
    exts = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(exts):
                yield os.path.join(dirpath, f)


class ShardWriter:
    """Sequential tar-shard writer (webdataset layout)."""

    def __init__(self, out_dir: str, prefix: str = "train",
                 shard_size: int = 1000):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.prefix = prefix
        self.shard_size = shard_size
        self.shard_idx = -1
        self.count_in_shard = 0
        self.total = 0
        self._tar = None  # opened lazily: no empty shard for empty input

    def _next_shard(self):
        if self._tar is not None:
            self._tar.close()
        self.shard_idx += 1
        self.count_in_shard = 0
        path = os.path.join(self.out_dir,
                            f"{self.prefix}-{self.shard_idx:06d}.tar")
        self._tar = tarfile.open(path, "w")

    def write(self, key: str, members: dict):
        if self._tar is None or self.count_in_shard >= self.shard_size:
            self._next_shard()
        for ext, data in members.items():
            info = tarfile.TarInfo(f"{key}.{ext}")
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
        self.count_in_shard += 1
        self.total += 1

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return buf.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", required=True, help="image directory")
    ap.add_argument("--out", required=True, help="output shard directory")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--shard-size", type=int, default=1000)
    ap.add_argument("--codec", default="identity",
                    choices=["identity", "sd-vae", "auto"],
                    help="latent codec; identity stores pixel arrays")
    ap.add_argument("--captions", default=None,
                    help="json {filename: caption}; stores caption.txt and, "
                         "if CLIP weights are cached, caption_clip_feature.npy")
    ap.add_argument("--keep-jpeg", action="store_true",
                    help="also store the resized image as image.jpg")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="where the VAE and CLIP run (default: cuda)")
    args = ap.parse_args(argv)

    from PIL import Image

    codec = get_codec(args.codec, device=args.device)
    # no random flip: augmentation baked into precomputed latents would be
    # frozen and make shards nondeterministic
    transform = get_transforms_image(args.image_size, flip=False)
    captions = json.load(open(args.captions)) if args.captions else None
    clip = None
    if captions is not None:
        try:
            from zigma_tpu_torch.data.text import FrozenCLIPEmbedder

            clip = FrozenCLIPEmbedder(device=args.device)
        except (RuntimeError, ImportError) as e:
            # RuntimeError: no cached tokenizer or weights (or no card);
            # ImportError: no transformers for the tokenizer
            print(f"note: captions stored as text only ({e})")

    writer = ShardWriter(args.out, shard_size=args.shard_size)
    batch_imgs, batch_meta = [], []

    def flush():
        if not batch_imgs:
            return
        latents = codec.encode(np.stack(batch_imgs))
        feats = (clip([m["caption"] for m in batch_meta])
                 if clip is not None else None)
        feature_key = f"img_feature{args.image_size}.npy"
        for i, meta in enumerate(batch_meta):
            members = {feature_key: _npy_bytes(latents[i])}
            if meta.get("jpeg") is not None:
                members["image.jpg"] = meta["jpeg"]
            if meta.get("caption") is not None:
                members["caption.txt"] = meta["caption"].encode()
                if feats is not None:
                    members["caption_clip_feature.npy"] = _npy_bytes(feats[i])
            writer.write(meta["key"], members)
        batch_imgs.clear()
        batch_meta.clear()

    for idx, path in enumerate(_iter_images(args.images)):
        img = Image.open(path).convert("RGB")
        arr = transform(img)  # (C, H, W) in [-1, 1]
        meta = {"key": f"{idx:08d}"}
        if captions is not None:
            rel = os.path.relpath(path, args.images)
            cap = captions.get(rel, captions.get(os.path.basename(path)))
            if cap is None:
                print(f"warning: no caption for {rel}; storing empty string")
                cap = ""
            meta["caption"] = cap
        if args.keep_jpeg:
            buf = io.BytesIO()
            Image.fromarray(
                (np.transpose(arr, (1, 2, 0)) * 127.5 + 127.5).astype(np.uint8)
            ).save(buf, format="JPEG", quality=95)
            meta["jpeg"] = buf.getvalue()
        batch_imgs.append(arr)
        batch_meta.append(meta)
        if len(batch_imgs) >= args.batch_size:
            flush()
    flush()
    writer.close()
    print(f"wrote {writer.total} samples in {writer.shard_idx + 1} shards "
          f"to {args.out}")
    return writer.total


if __name__ == "__main__":
    main()
