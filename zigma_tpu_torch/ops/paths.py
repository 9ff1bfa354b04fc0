"""Space-filling-curve scan-path generators (numpy; own copy).

Counterpart of ``zigma_tpu/ops/paths.py``, kept bit-equal to it (the tests
compare every image scan type).  The port keeps its own copy because
importing the JAX package's module loads its ``ops`` package, and with it
JAX and Pallas.

Conventions (those of the reference, for checkpoint parity):

- ``zigzag_path(N)`` returns 8 orderings where ``path[s]`` is the row-major
  token index visited at scan step ``s``.
- ``hilbert_path(N)`` returns 8 orderings from the generalized-Hilbert
  ("gilbert") curve; the reference flattens the curve-index matrix, so these
  follow the inverse convention, ``path[cell] = scan step of that cell``.
  Each path is paired with its own inverse at the use site.
- Video models tile an 's'/'t' pattern over depth: spatial layers take the
  zigzag paths in turn, temporal layers alternate the forward and reversed
  frame orders.  A temporal layer's paired "inverse" is the *other* frame
  order (the reference's pairing, kept for checkpoint parity), so there
  perm and perm_rev are not inverses of each other.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "zigzag_path",
    "hilbert_path",
    "gilbert_order",
    "random_paths",
    "reverse_permutation",
    "video_time_paths",
    "build_layer_paths",
    "parallel_scan_perms",
]


def reverse_permutation(perm: np.ndarray) -> np.ndarray:
    """Inverse permutation: out[perm[i]] = i."""
    perm = np.asarray(perm)
    out = np.empty_like(perm)
    out[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return out


def _zigzag_rowmajor(N: int, start_row: int, start_col: int, dr: int, dc: int) -> np.ndarray:
    """Serpentine row-major walk from a given corner/direction."""
    i = np.arange(N)[:, None]
    j = np.arange(N)[None, :]
    col = np.where(i % 2 == 0, j, N - 1 - j)
    flat = (start_row + dr * i) * N + start_col + dc * col
    return flat.reshape(-1).astype(np.int64)


def _zigzag_colmajor(N: int, start_row: int, start_col: int, dr: int, dc: int) -> np.ndarray:
    """Serpentine column-major walk from a given corner/direction."""
    j = np.arange(N)[:, None]
    i = np.arange(N)[None, :]
    row = np.where(j % 2 == 0, i, N - 1 - i)
    flat = (start_row + dr * row) * N + start_col + dc * j
    return flat.reshape(-1).astype(np.int64)


_ZIGZAG_CORNERS = (
    (0, 0, 1, 1),  # top-left, forward
    (0, -1, 1, -1),  # top-right, mirrored cols
    (-1, 0, -1, 1),  # bottom-left, mirrored rows
    (-1, -1, -1, -1),  # bottom-right, both mirrored
)


def zigzag_path(N: int) -> list[np.ndarray]:
    """The 8 zigzag orderings of an N x N grid: {row-major, col-major} x 4
    corner/direction combos, in the reference's order."""
    paths = []
    for sr, sc, dr, dc in _ZIGZAG_CORNERS:
        sr_, sc_ = (N - 1 if sr == -1 else 0), (N - 1 if sc == -1 else 0)
        paths.append(_zigzag_rowmajor(N, sr_, sc_, dr, dc))
        paths.append(_zigzag_colmajor(N, sr_, sc_, dr, dc))
    return paths


# Generative form of the public gilbert algorithm (jakubcerveny/gilbert,
# BSD-2-Clause): walk the curve once, emitting grid coordinates in order.


def _sgn(v: int) -> int:
    return (v > 0) - (v < 0)


def _gilbert_walk(x, y, ax, ay, bx, by):
    w, h = abs(ax + ay), abs(bx + by)
    dax, day = _sgn(ax), _sgn(ay)  # unit major direction
    dbx, dby = _sgn(bx), _sgn(by)  # unit orthogonal direction

    if h == 1:  # single row: march along the major axis
        for _ in range(w):
            yield x, y
            x, y = x + dax, y + day
        return
    if w == 1:  # single column: march along the orthogonal axis
        for _ in range(h):
            yield x, y
            x, y = x + dbx, y + dby
        return

    ax2, ay2 = ax // 2, ay // 2
    bx2, by2 = bx // 2, by // 2
    w2, h2 = abs(ax2 + ay2), abs(bx2 + by2)

    if 2 * w > 3 * h:
        if (w2 % 2) and (w > 2):
            ax2, ay2 = ax2 + dax, ay2 + day  # prefer even steps
        # long case: split into two halves along the major axis
        yield from _gilbert_walk(x, y, ax2, ay2, bx, by)
        yield from _gilbert_walk(x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by)
    else:
        if (h2 % 2) and (h > 2):
            bx2, by2 = bx2 + dbx, by2 + dby
        # standard case: one step up, one long horizontal, one step down
        yield from _gilbert_walk(x, y, bx2, by2, ax2, ay2)
        yield from _gilbert_walk(x + bx2, y + by2, ax, ay, bx - bx2, by - by2)
        yield from _gilbert_walk(
            x + (ax - dax) + (bx2 - dbx),
            y + (ay - day) + (by2 - dby),
            -bx2,
            -by2,
            -(ax - ax2),
            -(ay - ay2),
        )


def gilbert_order(width: int, height: int) -> np.ndarray:
    """Curve-index matrix M with M[x, y] = scan step of cell (x, y)."""
    order = np.empty((width, height), dtype=np.int64)
    if width >= height:
        walk = _gilbert_walk(0, 0, width, 0, 0, height)
    else:
        walk = _gilbert_walk(0, 0, 0, height, width, 0)
    for step, (px, py) in enumerate(walk):
        order[px, py] = step
    return order


def hilbert_path(N: int) -> list[np.ndarray]:
    """8 gilbert orderings: base curve-index matrix plus transpose/rot90
    variants, flattened, in the reference's order."""
    base = gilbert_order(N, N)
    mats = []
    for k in range(4):
        rot = np.rot90(base, k) if k else base
        mats.append(rot)
        mats.append(rot.T)
    return [m.reshape(-1).copy() for m in mats]


def random_paths(N: int, num: int, seed: int = 0) -> list[np.ndarray]:
    """``num`` random permutations of the N x N grid from an explicit seed."""
    rng = np.random.default_rng(seed)
    return [rng.permutation(N * N).astype(np.int64) for _ in range(num)]


def video_time_paths(T: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward and reversed frame orders of the temporal video layers."""
    fwd = np.arange(T, dtype=np.int64)
    return fwd, fwd[::-1].copy()


def build_layer_paths(scan_type: str, depth: int, patch_side: int,
                      video_frames: int = 0, seed: int = 0):
    """Per-layer permutation tables for a ZigMa stack.

    Returns ``(paths, paths_rev, st_order)``: ``paths[i]`` is applied before
    layer ``i``'s scan and ``paths_rev[i]`` after it (both None for v1, v2
    and parallelN, whose branches carry their own paths,
    ``parallel_scan_perms``); ``st_order`` is None for image models, else
    the per-layer string of 's' / 't'.
    ``zigzagN{k}`` / ``hilbertN{k}`` / ``randomN{k}``: layer i uses path
    ``i mod k``.  ``zzvideo_{pattern}`` / ``video_{pattern}``: the pattern
    tiled over depth; the j-th spatial layer takes zigzag path ``j mod 8``,
    the j-th temporal layer the forward frame order for even j, the
    reversed one for odd j, each paired with the other order.
    """
    if scan_type in ("v1", "v2") or scan_type.startswith("parallelN"):
        return [None] * depth, [None] * depth, None
    if scan_type.startswith(("zigzagN", "hilbertN", "randomN")):
        if scan_type.startswith("zigzagN"):
            k = int(scan_type[len("zigzagN"):])
            base = zigzag_path(patch_side)[:k]
        elif scan_type.startswith("hilbertN"):
            k = int(scan_type[len("hilbertN"):])
            base = hilbert_path(patch_side)[:k]
        else:
            k = int(scan_type[len("randomN"):])
            base = random_paths(patch_side, k, seed=seed)
        if len(base) == 0:
            raise ValueError(f"scan_type {scan_type!r} selects zero paths")
        base_rev = [reverse_permutation(p) for p in base]
        paths = [base[i % len(base)] for i in range(depth)]
        paths_rev = [base_rev[i % len(base)] for i in range(depth)]
        return paths, paths_rev, None
    if scan_type.startswith(("zzvideo_", "video_")):
        pattern = scan_type.split("_", 1)[1]
        if not pattern or set(pattern) - {"s", "t"}:
            raise ValueError(f"video scan pattern must be 's'/'t', got "
                             f"{pattern!r}")
        if video_frames <= 0:
            raise ValueError("video scan types require video_frames > 0")
        st_order = (pattern * depth)[:depth]
        spatial = zigzag_path(patch_side)
        spatial_rev = [reverse_permutation(p) for p in spatial]
        t_fwd, t_bwd = video_time_paths(video_frames)
        paths, paths_rev = [], []
        n_s = n_t = 0
        for ch in st_order:
            if ch == "s":
                paths.append(spatial[n_s % 8])
                paths_rev.append(spatial_rev[n_s % 8])
                n_s += 1
            else:  # the other frame order as the pair, not the inverse
                paths.append(t_fwd if n_t % 2 == 0 else t_bwd)
                paths_rev.append(t_bwd if n_t % 2 == 0 else t_fwd)
                n_t += 1
        return paths, paths_rev, st_order
    raise ValueError(f"unknown scan_type: {scan_type!r}")


def parallel_scan_perms(scan_type: str, patch_side: int) -> tuple:
    """``(perm, perm_rev)`` pairs of a ``parallelN{k}`` mixer's k extra
    branches: branch i scans zigzag path ``i mod 8``."""
    k = int(scan_type[len("parallelN"):])
    base = zigzag_path(patch_side)
    return tuple((base[i % 8], reverse_permutation(base[i % 8]))
                 for i in range(k))
