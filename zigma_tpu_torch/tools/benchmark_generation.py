"""Mamba-LM generation throughput benchmark.

    python -m zigma_tpu_torch.tools.benchmark_generation \
        --d-model 768 --n-layer 24 --promptlen 128 --genlen 128 --batch 8

Counterpart of ``benchmarks/benchmark_generation.py`` with the same flags
and defaults: an LM of d_model 768, 24 layers, vocabulary 50277 padded to a
multiple of 8, RMSNorm, ``residual_in_fp32``, computing in bf16, with random
weights from seed 0; prompt ids ``i`` for the i-th call; greedy unless
``--temperature`` > 0.  Each call is ``models.lm.generate``: the prompt
through K1 (the prefill), then ``--genlen`` decode steps.  One warm-up
call, then ``--repeats`` timed calls, by CUDA events on the card (host
clock on the CPU, ``--device cpu``).  Prints the model, the device and the
time a call with the new and total tokens a second; ``main`` returns them.
"""

from __future__ import annotations

import argparse
import time

import torch

from zigma_tpu_torch.device import resolve_device
from zigma_tpu_torch.models.lm import MambaLMHeadModel, generate


def _elapsed_ms(fn, dev) -> float:
    """Milliseconds ``fn()`` takes on ``dev``: CUDA events on the card."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--n-layer", type=int, default=24)
    ap.add_argument("--vocab-size", type=int, default=50277)
    ap.add_argument("--promptlen", type=int, default=128)
    ap.add_argument("--genlen", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = MambaLMHeadModel(
        d_model=args.d_model, n_layer=args.n_layer,
        vocab_size=args.vocab_size, rms_norm=True, residual_in_fp32=True,
        pad_vocab_size_multiple=8, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator(dev).manual_seed(0)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.zeros((args.batch, args.promptlen), dtype=torch.long,
                         device=dev)
    gen = (None if args.temperature == 0
           else torch.Generator(dev).manual_seed(1))

    def run(i):
        return generate(model, prompt + i, args.genlen, generator=gen,
                        temperature=args.temperature or 1.0)

    run(0)  # builds the kernels, settles the library choices
    ms = _elapsed_ms(lambda: [run(i) for i in range(1, args.repeats + 1)],
                     dev) / args.repeats
    new_tokens = args.batch * args.genlen
    total_tokens = args.batch * (args.promptlen + args.genlen)
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    print(f"model: d_model={args.d_model} n_layer={args.n_layer} "
          f"({n_params / 1e6:.1f}M params) on {device_name}")
    print(f"prompt {args.promptlen} + gen {args.genlen} x batch "
          f"{args.batch}: {ms:.1f} ms -> {new_tokens / ms * 1e3:.1f} new "
          f"tok/s ({total_tokens / ms * 1e3:.1f} total tok/s incl. prefill)")
    return dict(ms=ms, new_tok_per_s=new_tokens / ms * 1e3,
                total_tok_per_s=total_tokens / ms * 1e3, device=device_name,
                n_params=n_params)


if __name__ == "__main__":
    main()
