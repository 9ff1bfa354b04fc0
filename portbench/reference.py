"""Plain PyTorch reference of a ZigMa forward, training step and Euler sampler.

The yardstick that decides ``correct``.  It imports torch, numpy and the
standard library only: nothing of the program under test.  It computes in
float32 with TF32 off (``fp32_matmuls``), from the weights, noise and
batches the benchmark made, and works out again everything the program
derives from them: the zigzag scan paths, the video folds and frame orders,
the position tables, the drop-path and label-drop masks (drawn from a
generator set to the program's state, in the order the model draws them).

The equations (one block; x the block input, r the residual stream):

    x = drop_path(x);  r = x + r;  h = rms_norm(r) * w
    shift, scale, gate = linear(silu(c))
    x = h + gate * Mamba(h * (1 + scale) + shift)

    Mamba(v): v = v[:, perm];  xi, z = in_proj(v)
              xc = silu(causal_conv4(xi));  dt, B, C = x_proj(xc)
              delta = softplus(dt_proj(dt) + bias);  A = -exp(A_log)
              s_t = exp(delta_t A) s_{t-1} + delta_t xc_t B_t
              y_t = (<C_t, s_t> + D xc_t) * silu(z_t)
              out = out_proj(y)[:, perm_after]

with video layers folding (b, (t k), d) into frames ('s') or tokens ('t')
first.  ``precision="fp8"`` is the control: every GEMM and convolution
operand rounded to float8 e4m3 with a per-tensor scale, the rest float32.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["layer_paths", "forward", "training_loss", "train_steps",
           "euler_sample", "drop_masks", "fp32_matmuls"]

LATENT_SCALE = 0.18215  # SD-VAE latent scale (the published constant)
FP8_MAX = 448.0  # largest float8 e4m3 value
SCAN_CHUNK = 64  # time steps whose decays are formed at once


@contextmanager
def fp32_matmuls():
    """float32 GEMMs and convolutions without TF32 while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------- scan paths

def _zigzag(n: int) -> list:
    """The 8 serpentine orderings of an n x n grid (row- and column-major
    from each corner), ``path[s]`` = the row-major cell visited at step s."""
    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    out = []
    for r0, c0, dr, dc in ((0, 0, 1, 1), (0, n - 1, 1, -1), (n - 1, 0, -1, 1),
                           (n - 1, n - 1, -1, -1)):
        col = np.where(i % 2 == 0, j, n - 1 - j)
        out.append(((r0 + dr * i) * n + c0 + dc * col).reshape(-1))
        row = np.where(i % 2 == 0, j, n - 1 - j)  # i: column, j: step in it
        out.append(((r0 + dr * row) * n + c0 + dc * i).reshape(-1))
    return out


def layer_paths(scan_type: str, depth: int, side: int, frames: int = 0):
    """Per layer ``(fold, before, after)``: the video fold ('s', 't' or None)
    and the index tables applied to the folded sequence before ``in_proj``
    and after ``out_proj``.  zigzagN{k}: layer i scans path i mod k and
    inverts it after.  zzvideo_{pattern}: the pattern tiled over depth; the
    j-th spatial layer scans zigzag path j mod 8 within each frame; the j-th
    temporal layer reads the frames forward for even j and reversed for odd
    j, and writes its output in the other of the two orders (the published
    model's pairing, not an inverse)."""
    if scan_type.startswith("zigzagN"):
        base = _zigzag(side)[:int(scan_type[len("zigzagN"):])]
        return [(None, base[i % len(base)], np.argsort(base[i % len(base)]))
                for i in range(depth)]
    if scan_type.startswith("zzvideo_"):
        pattern = scan_type[len("zzvideo_"):]
        spatial, fwd = _zigzag(side), np.arange(frames)
        out, n_s, n_t = [], 0, 0
        for ch in (pattern * depth)[:depth]:
            if ch == "s":
                p = spatial[n_s % 8]
                out.append(("s", p, np.argsort(p)))
                n_s += 1
            else:
                a, b = (fwd, fwd[::-1]) if n_t % 2 == 0 else (fwd[::-1], fwd)
                out.append(("t", a.copy(), b.copy()))
                n_t += 1
        return out
    raise ValueError(f"the reference knows no scan_type {scan_type!r}")


# ------------------------------------------------------------------- pieces

def _q8(t):
    """Round to float8 e4m3 with a per-tensor scale (the control)."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t).detach()  # the rounding passes the gradient through


def _op(t, precision):
    return _q8(t) if precision == "fp8" else t


def _linear(x, w, b, precision):
    return F.linear(_op(x, precision), _op(w, precision), b)


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _layer_norm(x, eps):
    mu = x.mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True)
                                  + eps)


def _scan(u, delta, A, B, C):
    """The selective recurrence step by step: s_t = exp(delta_t A) s_{t-1} +
    delta_t u_t B_t, y_t = <C_t, s_t>.  u, delta (b, L, d); A (d, N); B, C
    (b, L, N).  The decays and inputs are formed SCAN_CHUNK steps at once;
    the state advances one step a time, in float32."""
    b, L, d = u.shape
    s = u.new_zeros(b, d, A.shape[1])
    ys = []
    for t0 in range(0, L, SCAN_CHUNK):
        sl = slice(t0, min(L, t0 + SCAN_CHUNK))
        decay = torch.exp(delta[:, sl, :, None] * A)
        inp = (delta[:, sl] * u[:, sl])[..., None] * B[:, sl, None, :]
        states = []
        # unbind: one backward for the chunk, where a step's index would
        # make a full-chunk gradient each
        for inp_t, decay_t in zip(inp.unbind(1), decay.unbind(1)):
            s = torch.addcmul(inp_t, decay_t, s)
            states.append(s)
        ys.append((torch.stack(states, 1) * C[:, sl, None, :]).sum(-1))
    return torch.cat(ys, 1)


def _mamba(v, p, pre, path, frames, precision):
    fold, before, after = path
    b0, Lt, E = v.shape
    if fold == "s":
        v = v.reshape(b0 * frames, Lt // frames, E)
    elif fold == "t":
        v = v.reshape(b0, frames, Lt // frames, E).transpose(1, 2).reshape(
            b0 * (Lt // frames), frames, E)
    v = v.index_select(1, torch.as_tensor(before, device=v.device))
    w_in = p[pre + "in_proj.weight"]
    xi, z = _linear(v, w_in, p.get(pre + "in_proj.bias"), precision).chunk(2, -1)
    cw = p[pre + "conv1d.weight"]  # (d, 1, W)
    W = cw.shape[-1]
    xc = F.conv1d(F.pad(_op(xi, precision).transpose(1, 2), (W - 1, 0)),
                  _op(cw, precision), p[pre + "conv1d.bias"],
                  groups=cw.shape[0]).transpose(1, 2)
    xc = F.silu(xc)
    N = p[pre + "A_log"].shape[1]
    R = p[pre + "dt_proj.weight"].shape[1]
    dt, Bv, Cv = _linear(xc, p[pre + "x_proj.weight"], None,
                         precision).split([R, N, N], -1)
    delta = F.softplus(_linear(dt, p[pre + "dt_proj.weight"], None, precision)
                       + p[pre + "dt_proj.bias"])
    y = _scan(xc, delta, -torch.exp(p[pre + "A_log"]), Bv, Cv)
    y = (y + xc * p[pre + "D"]) * F.silu(z)
    out = _linear(y, p[pre + "out_proj.weight"], p.get(pre + "out_proj.bias"),
                  precision)
    out = out.index_select(1, torch.as_tensor(after, device=out.device))
    if fold == "s":
        out = out.reshape(b0, Lt, E)
    elif fold == "t":
        out = out.reshape(b0, Lt // frames, frames, E).transpose(1, 2).reshape(
            b0, Lt, E)
    return out


def _block(x, r, c, keep, rate, p, i, path, cfg, precision):
    pre = f"blocks.{i}."
    if keep is not None:
        x = torch.where(keep[:, None, None], x, 0.0) / max(1.0 - rate, 1e-6)
    r = x if r is None else x + r
    h = _rms_norm(r, p[pre + "norm.weight"], cfg.get("norm_epsilon", 1e-5))
    mod = _linear(F.silu(c), p[pre + "adaLN_modulation.1.weight"],
                  p[pre + "adaLN_modulation.1.bias"], precision)
    shift, scale, gate = mod.chunk(3, -1)
    m = _mamba(h * (1 + scale[:, None]) + shift[:, None], p, pre + "mixer.",
               path, cfg.get("video_frames", 0), precision)
    return h + gate[:, None] * m, r


def _rates(cfg):
    rate, depth = cfg.get("drop_path_rate", 0.1), cfg["depth"]
    return [*np.concatenate([[0.0], np.linspace(0, rate, depth)])[:depth],
            rate]


def drop_masks(cfg, batch: int, generator, device):
    """What the model draws from its generator in a training forward, in
    its order: the label drop (class-conditional models with a drop
    probability) then one uniform row a block and one for the final
    drop-path.  Returns (label_drop or None, keep masks (depth + 1, batch)
    or None)."""
    drop = None
    if cfg.get("num_classes", -1) > 0 and cfg.get("class_dropout_prob", 0) > 0:
        drop = torch.rand((batch,), generator=generator,
                          device=device) < cfg["class_dropout_prob"]
    keep = None
    if cfg.get("drop_path_rate", 0.1) > 0:
        rates = _rates(cfg)
        u = torch.rand((len(rates), batch), generator=generator,
                       device=device)
        keep = u < torch.tensor([1.0 - r for r in rates],
                                device=device)[:, None]
    return drop, keep


def forward(p, x, t, y, cfg, keep=None, label_drop=None, precision="fp32",
            remat=False):
    """The model at (x, t, y): x (B, C, H, W) or (B, T, C, H, W) latents, t
    (B,) in [0, 1], y (B,) labels or None.  ``keep``: the drop-path keep
    masks (depth + 1, B) of a training forward, ``label_drop`` its label
    drop (B,); ``remat`` recomputes each block in the backward (memory)."""
    frames, ps = cfg.get("video_frames", 0), cfg["patch_size"]
    E, depth = cfg["embed_dim"], cfg["depth"]
    B = x.shape[0]
    xf = x.reshape(B * frames, *x.shape[2:]) if frames else x
    h = F.conv2d(_op(xf, precision), _op(p["x_embedder.proj.weight"], precision),
                 p["x_embedder.proj.bias"], stride=ps)
    h = h.flatten(2).transpose(1, 2).reshape(B, -1, E)
    half = 128  # a 256-wide frequency embedding
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    args = (t.float() * 1000.0)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], -1)
    c = _linear(F.silu(_linear(emb, p["t_embedder.mlp.0.weight"],
                               p["t_embedder.mlp.0.bias"], precision)),
                p["t_embedder.mlp.2.weight"], p["t_embedder.mlp.2.bias"],
                precision)
    if cfg.get("num_classes", -1) > 0:
        labels = y if label_drop is None else torch.where(
            label_drop, cfg["num_classes"], y)
        c = c + p["y_embedder.embedding_table.weight"][labels]
    if cfg.get("use_pe") == 2:
        h = h + p["pos_embed"]
    if frames and cfg.get("tpe"):
        h = (h.reshape(B, frames, -1, E)
             + p["temporal_pos_embedding"][:, :, None]).reshape(B, -1, E)
    side = cfg["img_dim"] // ps
    paths = layer_paths(cfg["scan_type"], depth, side, frames)
    rates = _rates(cfg)
    r = None
    for i in range(depth):
        keep_i = None if keep is None else keep[i]
        args_i = (keep_i, rates[i], p, i, paths[i], cfg, precision)
        if remat:
            h, r = torch.utils.checkpoint.checkpoint(
                lambda a, b, cc, *rest: _block(a, b, cc, *rest), h, r, c,
                *args_i, use_reentrant=False)
        else:
            h, r = _block(h, r, c, *args_i)
    if keep is not None:
        h = torch.where(keep[depth][:, None, None], h, 0.0) / max(
            1.0 - rates[depth], 1e-6)
    h = _rms_norm(h + r, p["norm_f.weight"], cfg.get("norm_epsilon", 1e-5))
    h = _linear(_layer_norm(h, 1e-6), p["final_layer.linear.weight"],
                p["final_layer.linear.bias"], precision)
    C = cfg["in_channels"]
    n = side
    if frames:
        h = h.reshape(B, frames, n, n, ps, ps, C)
        return torch.einsum("nthwpqc->ntchpwq", h).reshape(
            B, frames, C, n * ps, n * ps)
    h = h.reshape(B, n, n, ps, ps, C)
    return torch.einsum("nhwpqc->nchpwq", h).reshape(B, C, n * ps, n * ps)


def training_loss(p, batch, cfg, keep, label_drop, precision="fp32",
                  rows=None):
    """The flow-matching loss of a batch {x, y?, t, x0}: x1 = x * latent
    scale, xt = t x1 + (1 - t) x0, the mean over the batch of the mean
    squared error of the model's velocity against x1 - x0.  The gradient is
    accumulated ``rows`` samples a backward pass (each pass's share of the
    mean), so a large batch fits; returns the loss as a float."""
    n = batch["x"].shape[0]
    rows = rows or n
    total = 0.0
    for a in range(0, n, rows):
        sl = slice(a, min(n, a + rows))
        x1 = batch["x"][sl] * LATENT_SCALE
        x0, t = batch["x0"][sl], batch["t"][sl]
        tt = t.reshape(-1, *([1] * (x1.dim() - 1)))
        xt = tt * x1 + (1 - tt) * x0
        out = forward(p, xt, t, None if "y" not in batch else batch["y"][sl],
                      cfg, None if keep is None else keep[:, sl],
                      None if label_drop is None else label_drop[sl],
                      precision, remat=True)
        err = (out - (x1 - x0)).square()
        loss = err.reshape(err.shape[0], -1).mean(1).sum() / n
        loss.backward()
        total += loss.item()
    return total


def train_steps(weights: dict, batches, cfg, device, gen_state,
                precision="fp32", lr=1e-4, max_grad_norm=2.0, rows=None,
                ema_decay=0.9999):
    """Training steps from ``weights`` on ``batches`` (one a step), the
    steps' masks drawn in turn from a generator set to ``gen_state``: loss,
    backward, the global-norm clip at ``max_grad_norm``, AdamW (betas
    0.9 / 0.999, eps 1e-8, no weight decay), then the EMA
    ``e = decay * e + (1 - decay) * p`` from ``e = weights``, in float64.
    Returns (losses, the first step's clipped gradients, the parameters
    after the last step, the EMA after the last step), the tensors on the
    CPU."""
    params = {k: v.to(device).float().clone().requires_grad_(True)
              for k, v in weights.items()}
    ema = {k: v.to(device, torch.float64, copy=True)
           for k, v in weights.items()}
    opt = torch.optim.AdamW(params.values(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0, foreach=False)
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    losses, first_grads = [], None
    with fp32_matmuls():
        for i, batch in enumerate(batches):
            batch = {k: v.to(device) for k, v in batch.items()}
            label_drop, keep = drop_masks(cfg, batch["x"].shape[0], gen,
                                          device)
            opt.zero_grad(set_to_none=True)
            losses.append(training_loss(params, batch, cfg, keep, label_drop,
                                        precision, rows))
            grads = [q.grad for q in params.values()]
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            coef = torch.clamp(max_grad_norm / (norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(coef)
            if i == 0:
                first_grads = {k: q.grad.detach().cpu()
                               for k, q in params.items()}
            opt.step()
            with torch.no_grad():
                for k, q in params.items():
                    ema[k].mul_(ema_decay).add_(q.double(),
                                                alpha=1.0 - ema_decay)
    last = {k: q.detach().cpu() for k, q in params.items()}
    return losses, first_grads, last, {k: e.cpu() for k, e in ema.items()}


@torch.no_grad()
def euler_sample(weights: dict, z, y, cfg, num_steps: int, precision="fp32"):
    """The Euler probability-flow ODE of a velocity model from noise z at
    t = 0 to data at t = 1 over ``num_steps`` points (num_steps - 1 model
    calls): x <- x + (t_{i+1} - t_i) v(x, t_i)."""
    p = {k: v.to(z.device).float() for k, v in weights.items()}
    ts = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32)
    x = z.float()
    with fp32_matmuls():
        for i in range(num_steps - 1):
            t = torch.full((x.shape[0],), float(ts[i]), device=x.device)
            x = x + float(ts[i + 1] - ts[i]) * forward(p, x, t, y, cfg,
                                                        precision=precision)
    return x
