// Causal depthwise conv1d (+ bias, + SiLU) for Hopper (sm_90a), forward and
// backward, bound through a plain C entry point and loaded with ctypes by
// zigma_tpu_torch/ops/conv_cuda.py.
//
// Replaces no TPU kernel: the JAX package runs zigma_tpu/ops/causal_conv1d.py
// as jnp ops that XLA fuses into one pass.  Without a kernel the port ran the
// taps as plain torch ops, about fifteen passes over a (tokens, d_inner)
// tensor forward and some thirty more in autograd's backward, the largest
// single share of the "elementwise" device time of a ZigMa step.  The
// ZigMa reference ships the same function in CUDA (causal_conv1d_fwd / _bwd).
//
// Per token t of a sequence of length L and channel c, with W taps (W <= 4)
// and the W - 1 inputs before the sequence taken from initial_state (zeros
// without one):
//
//   pre_t = sum_k w[c, k] * x[t - (W - 1) + k]  (+ bias[c])
//   y_t   = silu(pre_t)                             (or pre_t)
//
// The forward is bit-equal to ops/causal_conv1d.py's plain version on the
// card: the weight, bias and inputs are rounded to the accumulation dtype
// first (x's dtype, or float32 with accum_fp32), each product and each
// running sum is rounded to it in the plain version's order (tap 0 first,
// then the bias), no multiply-add is contracted (__fmul_rn / __fadd_rn), and
// SiLU is x / (1 + expf(-x)) in float, as torch computes it, rounded once.
//
// The backward recomputes pre_t from x (nothing else is saved) and gives,
// in float32, dpre_t = dy_t * silu'(pre_t),
//   dx_t       = sum_k w[c, k] * dpre_{t + W - 1 - k}   (within the sequence)
//   dw[c, k]   = sum_t dpre_t * x[t - (W - 1) + k]      (the padded input)
//   dbias[c]   = sum_t dpre_t
//   dinit[j]   = sum_{k <= j} w[c, k] * dpre_{j - k}    (j < W - 1)
// dx rounded once to x's dtype; dw and dbias as fp32 partial sums a block,
// summed by a second kernel over the blocks in a fixed order (no atomics:
// the same inputs give the same bits in every run).
//
// What bounds it on an H100: bytes, with the instructions close behind.
// At the flagship's (16, 1024, 1536) in bf16 the forward reads x and writes
// y, 100.7 MB, >= 0.030 ms at 3.35 TB/s; the backward reads x and dy and
// writes dx, 151.0 MB, >= 0.045 ms.  The bit-exact bf16 taps round every
// product and every sum, and SiLU is an accurate expf and an IEEE division:
// done in float with a conversion for each rounding, that is some 90
// instructions an element, and a first version of this kernel ran at a
// fifth of the bound with its time following the instruction count, not
// the bytes or the rows in flight.  What the design does about it:
// - The models' case (bf16 x accumulated in bf16, SiLU, no left context,
//   rows 8-byte aligned, d % 4 == 0) has kernels of its own that keep x,
//   the taps and the bias as bf16x2 pairs and run the taps in packed bf16
//   arithmetic (mul.rn / add.rn .bf16x2), one instruction a tap and a
//   channel, rounding as the plain version does (see above them); the
//   backward's SiLU derivative, which no plain rounding pins, uses the fast
//   exp and reciprocal.  Every other mode (float32, conv_fp32_taps, a left
//   context, an unaligned or odd width) runs general kernels that round in
//   float, two channels a thread.
// - Each thread owns a group of channels (4 in the bf16 kernels: 8 bytes of
//   a token's row) and walks a tile of consecutive tokens over the
//   flattened (batch x L) axis, keeping the last W - 1 inputs (and backward
//   the next W - 1 dpre) in registers, so each input is read once; only a
//   tile's W - 1 halo rows are read twice, by the neighbouring tile, from
//   L2.  A warp reads 32 neighbouring groups of a row.  A tile that crosses
//   a sequence start resets its window to the sequence's pad, so the
//   video's temporal layers (5120 sequences of 16), its spatial ones
//   (320 x 256) and the flagship (16 x 1024) take the same launch.
// - In the bf16 kernels a thread loads 8 token rows at once forward (4 of x
//   and 4 of dy backward) before it computes them.
// - x is read in place, with any row stride (a slice of in_proj's output
//   (batch, L, 2 d_inner)); in the general kernels a group whose address is
//   not aligned, or the ragged last group of an odd width, is read one
//   element at a time.
// - Tiles follow from (tokens x channel groups), the SM count and the
//   instance's resident blocks (the occupancy API): 16 to 1024 tokens, about
//   one wave; the grid's token axis is capped at one wave of blocks, each
//   walking several tiles where there are more, so the backward's fp32
//   partials stay small (about a MB at the flagship).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kGroupsX = 32;  // channel groups a block row (one warp)
constexpr int kTilesY = 4;    // tiles a block column
constexpr int kThreads = kGroupsX * kTilesY;
constexpr int kMinTile = 16, kMaxTile = 1024;
constexpr int kMaxWidth = 4;
constexpr int kFwdRows = 8;   // token rows a bf16 kernel's thread loads at once, forward
constexpr int kBwdRows = 4;   // and backward (of x and of dy each)

struct Args {
  const void* x;      // (batch, L, d), tokens x_row elements apart
  const void* w;      // (d, W) contiguous
  const void* bias;   // (d,) or null
  const void* init;   // (batch, W - 1, d) contiguous, or null
  const void* dy;     // backward: (batch, L, d), tokens dy_row apart
  void* out;          // forward y / backward dx: (batch, L, d) contiguous
  void* dinit;        // backward: (batch, W - 1, d) contiguous, or null
  float* partials;    // backward: (gridDim.x, W + 1, d) fp32
  long long n_tokens, x_row, dy_row, n_tiles;
  int L, d, tile;
  int w_bf16, bias_bf16, init_bf16, dinit_bf16, acc_bf16, silu;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the accumulation dtype (bf16 round-to-nearest-even, as a
// torch cast), kept in a float register
__device__ __forceinline__ float rnd(float v, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// two values rounded to bf16 by one packed conversion
__device__ __forceinline__ void rnd2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

__device__ __forceinline__ float load_any(const void* p, long long i, bool bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, long long i, float v, bool bf) {
  if (bf) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(p)[i] = v;
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

// V channels of one row from element `off` as floats; `n` of them valid.
// One vector load where the group is whole and its address aligned.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* p, long long off, int n, float (&o)[V]) {
  const T* a = p + off;
  if (n == V && (reinterpret_cast<uintptr_t>(a) % sizeof(Pack<T, V>)) == 0) {
    const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(a);
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = to_f(pk.v[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = v < n ? to_f(a[v]) : 0.f;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* p, long long off, int n, const float (&o)[V]) {
  T* a = p + off;
  if (n == V && (reinterpret_cast<uintptr_t>(a) % sizeof(Pack<T, V>)) == 0) {
    Pack<T, V> pk;
#pragma unroll
    for (int v = 0; v < V; ++v) pk.v[v] = from_f<T>(o[v]);
    *reinterpret_cast<Pack<T, V>*>(a) = pk;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < n) a[v] = from_f<T>(o[v]);
  }
}

// row r (0 .. W-2) of sequence b's left context, rounded to the accumulation
// dtype: initial_state's, or zeros
template <int W, int V>
__device__ __forceinline__ void pad_row(const Args& a, long long b, int r, int c0, int n,
                                        float (&o)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    o[v] = (a.init != nullptr && v < n)
               ? rnd(load_any(a.init, (b * (W - 1) + r) * a.d + c0 + v, a.init_bf16),
                     a.acc_bf16)
               : 0.f;
  }
}

// the taps and bias of a thread's channels, rounded to the accumulation dtype
template <int W, int V>
__device__ __forceinline__ void load_params(const Args& a, int c0, int n, float (&wk)[W][V],
                                            float (&bs)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool ok = v < n;
#pragma unroll
    for (int k = 0; k < W; ++k)
      wk[k][v] = ok ? rnd(load_any(a.w, (long long)(c0 + v) * W + k, a.w_bf16), a.acc_bf16) : 0.f;
    bs[v] = (ok && a.bias != nullptr) ? rnd(load_any(a.bias, c0 + v, a.bias_bf16), a.acc_bf16)
                                      : 0.f;
  }
}

// the pre-activation of the window's last token, in the plain version's
// order and roundings (in bf16, two channels a conversion; V is even)
template <int W, int V>
__device__ __forceinline__ void pre_act(const Args& a, const float (&xw)[W][V],
                                        const float (&wk)[W][V], const float (&bs)[V],
                                        float (&o)[V]) {
  static_assert(V % 2 == 0, "channel pairs");
  const bool has_bias = a.bias != nullptr;
  if (a.acc_bf16) {
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        float p0 = __fmul_rn(xw[k][v], wk[k][v]), p1 = __fmul_rn(xw[k][v + 1], wk[k][v + 1]);
        rnd2(p0, p1);
        s0 = __fadd_rn(s0, p0);
        s1 = __fadd_rn(s1, p1);
        rnd2(s0, s1);
      }
      if (has_bias) {
        s0 = __fadd_rn(s0, bs[v]);
        s1 = __fadd_rn(s1, bs[v + 1]);
        rnd2(s0, s1);
      }
      o[v] = s0;
      o[v + 1] = s1;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) s = __fadd_rn(s, __fmul_rn(xw[k][v], wk[k][v]));
      if (has_bias) s = __fadd_rn(s, bs[v]);
      o[v] = s;
    }
  }
}

// SiLU as torch computes it: x / (1 + expf(-x)) in float, then rounded to
// the accumulation dtype
template <int V>
__device__ __forceinline__ void silu_rows(bool acc_bf16, float (&o)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) o[v] = __fdiv_rn(o[v], __fadd_rn(1.f, expf(-o[v])));
  if (acc_bf16) {
#pragma unroll
    for (int v = 0; v < V; v += 2) rnd2(o[v], o[v + 1]);
  }
}

// the window of a tile's first token: the W - 1 inputs before n0, from x
// or, before the sequence's start, from its pad
template <typename T, int W, int V>
__device__ __forceinline__ void start_window(const Args& a, long long n0, long long b, int t,
                                             int c0, int n, float (&xw)[W][V]) {
  const T* x = static_cast<const T*>(a.x);
#pragma unroll
  for (int j = 0; j < W - 1; ++j) {
    const int tq = t + j - (W - 1);
    if (tq >= 0) {
      load_row<T, V>(x, (n0 + j - (W - 1)) * a.x_row + c0, n, xw[j]);
#pragma unroll
      for (int v = 0; v < V; ++v) xw[j][v] = rnd(xw[j][v], a.acc_bf16);
    } else {
      pad_row<W, V>(a, b, tq + W - 1, c0, n, xw[j]);
    }
  }
}

template <typename T, int W, int V>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_fwd_kernel(Args a) {
  const int c0 = (blockIdx.y * kGroupsX + threadIdx.x) * V;
  if (c0 >= a.d) return;
  const int n = min(V, a.d - c0);
  float wk[W][V], bs[V];
  load_params<W, V>(a, c0, n, wk, bs);
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.out);
  for (long long tile = (long long)blockIdx.x * kTilesY + threadIdx.y; tile < a.n_tiles;
       tile += (long long)gridDim.x * kTilesY) {
    const long long n0 = tile * a.tile;
    const long long n1 = min(n0 + a.tile, a.n_tokens);
    long long b = n0 / a.L;
    int t = (int)(n0 - b * a.L);
    float xw[W][V];
    start_window<T, W, V>(a, n0, b, t, c0, n, xw);
    for (long long p = n0; p < n1; ++p) {
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < W - 1; ++j) pad_row<W, V>(a, b, j, c0, n, xw[j]);
      }
      load_row<T, V>(x, p * a.x_row + c0, n, xw[W - 1]);
#pragma unroll
      for (int v = 0; v < V; ++v) xw[W - 1][v] = rnd(xw[W - 1][v], a.acc_bf16);
      float o[V];
      pre_act<W, V>(a, xw, wk, bs, o);
      if (a.silu) silu_rows<V>(a.acc_bf16, o);
      store_row<T, V>(y, p * a.d + c0, n, o);
#pragma unroll
      for (int j = 0; j < W - 1; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) xw[j][v] = xw[j + 1][v];
      if (++t == a.L) { t = 0; ++b; }
    }
  }
}

template <typename T, int W, int V, bool INIT>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_bwd_kernel(Args a) {
  constexpr int kE = (W + 1) * V;  // a thread's dw and dbias sums
  constexpr int kP = W - 1;
  __shared__ float red[kTilesY][kE][kGroupsX];
  const int c0 = (blockIdx.y * kGroupsX + threadIdx.x) * V;
  const bool active = c0 < a.d;
  const int n = active ? min(V, a.d - c0) : 0;
  float wk[W][V], bs[V], dw[W][V], db[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    db[v] = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) dw[k][v] = 0.f;
  }
  if (active) load_params<W, V>(a, c0, n, wk, bs);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.out);
  const int flush_t = min(W - 2, a.L - 1);  // a sequence's last pad-reaching token
  for (long long tile = (long long)blockIdx.x * kTilesY + threadIdx.y; active && tile < a.n_tiles;
       tile += (long long)gridDim.x * kTilesY) {
    const long long n0 = tile * a.tile;
    const long long n1 = min(n0 + a.tile, a.n_tokens);
    const long long pend = min(n1 + W - 1, a.n_tokens);  // tokens whose dpre is needed
    long long b = n0 / a.L;
    int t = (int)(n0 - b * a.L), tn = t;
    float xw[W][V], dwin[W][V], dpad[kP][V];
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) dwin[j][v] = 0.f;
#pragma unroll
    for (int j = 0; j < kP; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) dpad[j][v] = 0.f;
    start_window<T, W, V>(a, n0, b, t, c0, n, xw);
    for (long long p = n0; p < n1 + W - 1; ++p) {
      float dp[V];
      if (p < pend) {
        if (t == 0) {
#pragma unroll
          for (int j = 0; j < W - 1; ++j) pad_row<W, V>(a, b, j, c0, n, xw[j]);
        }
        float g[V];
        load_row<T, V>(x, p * a.x_row + c0, n, xw[W - 1]);
        load_row<T, V>(dy, p * a.dy_row + c0, n, g);
#pragma unroll
        for (int v = 0; v < V; ++v) xw[W - 1][v] = rnd(xw[W - 1][v], a.acc_bf16);
        float pre[V];
        pre_act<W, V>(a, xw, wk, bs, pre);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (a.silu) {
            const float s = __fdividef(1.f, 1.f + expf(-pre[v]));
            dp[v] = g[v] * (s * (1.f + pre[v] * (1.f - s)));
          } else {
            dp[v] = g[v];
          }
        }
        if (p < n1) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            db[v] += dp[v];
#pragma unroll
            for (int k = 0; k < W; ++k) dw[k][v] = fmaf(dp[v], xw[k][v], dw[k][v]);
          }
        }
        if (INIT && t <= W - 2 && p - t >= n0 && p - t < n1) {
          // the left context's cotangent of a sequence this tile starts
#pragma unroll
          for (int j = 0; j < kP; ++j) {
            const int k = j - t;  // the tap reaching pad row j from token t
            if (k >= 0) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                if (t == 0) dpad[j][v] = 0.f;
                dpad[j][v] = fmaf(wk[k][v], dp[v], dpad[j][v]);
              }
            }
          }
          if (t == flush_t) {
#pragma unroll
            for (int j = 0; j < kP; ++j)
#pragma unroll
              for (int v = 0; v < V; ++v)
                if (v < n)
                  store_any(a.dinit, (b * (W - 1) + j) * a.d + c0 + v, dpad[j][v],
                            a.dinit_bf16);
          }
        }
#pragma unroll
        for (int j = 0; j < W - 1; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v) xw[j][v] = xw[j + 1][v];
        if (++t == a.L) { t = 0; ++b; }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) dp[v] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < W - 1; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) dwin[j][v] = dwin[j + 1][v];
#pragma unroll
      for (int v = 0; v < V; ++v) dwin[W - 1][v] = dp[v];
      if (p >= n0 + W - 1) {  // dwin[j] holds dpre of token p - (W - 1) + j
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = 0.f;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          if (tn + j < a.L) {
#pragma unroll
            for (int v = 0; v < V; ++v) o[v] = fmaf(wk[W - 1 - j][v], dwin[j][v], o[v]);
          }
        }
        store_row<T, V>(dx, (p - (W - 1)) * a.d + c0, n, o);
        if (++tn == a.L) tn = 0;
      }
    }
  }
  // the block's dw / dbias partials: its tile rows summed in order
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int k = 0; k < W; ++k) red[threadIdx.y][k * V + v][threadIdx.x] = dw[k][v];
    red[threadIdx.y][W * V + v][threadIdx.x] = db[v];
  }
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    for (int e = 0; e < kE; ++e) {
      const int k = e / V, v = e % V;
      if (v >= n) continue;
      float s = red[0][e][threadIdx.x];
#pragma unroll
      for (int r = 1; r < kTilesY; ++r) s += red[r][e][threadIdx.x];
      a.partials[((long long)blockIdx.x * (W + 1) + k) * a.d + c0 + v] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// The models' case: bf16 x accumulated in bf16, SiLU, no left context, every
// row 8-byte aligned and d a multiple of 4.  Four channels a thread, as two
// bf16x2 pairs: the taps and the bias in packed bf16 arithmetic (mul.rn /
// add.rn .bf16x2, each product and sum rounded once to bf16 -- what the
// plain version's float op and cast give, the float result of two bf16
// operands' product being exact, and of their sum exact or too far from a
// tie to round differently), so a tap costs one instruction a channel.

__device__ __forceinline__ __nv_bfloat162 as_pair(unsigned int u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ unsigned int as_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned int*>(&h);
}

template <int W>
__device__ __forceinline__ void load_pairs(const Args& a, int c0, __nv_bfloat162 (&wk)[W][2],
                                           __nv_bfloat162 (&bs)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = c0 + 2 * j;
#pragma unroll
    for (int k = 0; k < W; ++k)
      wk[k][j] = __floats2bfloat162_rn(load_any(a.w, (long long)c * W + k, a.w_bf16),
                                       load_any(a.w, (long long)(c + 1) * W + k, a.w_bf16));
    bs[j] = a.bias != nullptr ? __floats2bfloat162_rn(load_any(a.bias, c, a.bias_bf16),
                                                      load_any(a.bias, c + 1, a.bias_bf16))
                              : __floats2bfloat162_rn(0.f, 0.f);
  }
}

// the pre-activation of the window's last token, two channels
template <int W>
__device__ __forceinline__ __nv_bfloat162 pre_pair(const __nv_bfloat162 (&xw)[W][2],
                                                   const __nv_bfloat162 (&wk)[W][2],
                                                   __nv_bfloat162 bs, bool has_bias, int j) {
  __nv_bfloat162 s = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < W; ++k) s = __hadd2_rn(s, __hmul2_rn(xw[k][j], wk[k][j]));
  return has_bias ? __hadd2_rn(s, bs) : s;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_fwd_bf16_kernel(Args a) {
  constexpr int U = kFwdRows;
  const int c0 = (blockIdx.y * kGroupsX + threadIdx.x) * 4;
  if (c0 >= a.d) return;
  __nv_bfloat162 wk[W][2], bs[2];
  load_pairs<W>(a, c0, wk, bs);
  const bool has_bias = a.bias != nullptr;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  const long long xs = a.x_row / 4, ys = a.d / 4;  // rows apart, in 8-byte packs
  for (long long tile = (long long)blockIdx.x * kTilesY + threadIdx.y; tile < a.n_tiles;
       tile += (long long)gridDim.x * kTilesY) {
    const long long n0 = tile * a.tile;
    const int len = (int)(min(n0 + a.tile, a.n_tokens) - n0);
    int t = (int)(n0 % a.L);
    const uint2* xp = reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(a.x) +
                                                     n0 * a.x_row + c0);
    uint2* yp = reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + n0 * a.d + c0);
    __nv_bfloat162 xw[W][2];
#pragma unroll
    for (int j = 0; j < W - 1; ++j) {
      const bool in_seq = t + j - (W - 1) >= 0;
      const uint2 r = in_seq ? xp[(j - (W - 1)) * xs] : make_uint2(0u, 0u);
      xw[j][0] = as_pair(r.x);
      xw[j][1] = as_pair(r.y);
    }
    for (int i0 = 0; i0 < len; i0 += U) {
      uint2 rows[U];  // U rows in flight at once
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u < len) rows[u] = xp[(i0 + u) * xs];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u >= len) break;
        if (t == 0) {
#pragma unroll
          for (int j = 0; j < W - 1; ++j) xw[j][0] = xw[j][1] = zero;
        }
        xw[W - 1][0] = as_pair(rows[u].x);
        xw[W - 1][1] = as_pair(rows[u].y);
        unsigned int out[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float2 f = __bfloat1622float2(pre_pair<W>(xw, wk, bs[j], has_bias, j));
          f.x = __fdiv_rn(f.x, __fadd_rn(1.f, expf(-f.x)));
          f.y = __fdiv_rn(f.y, __fadd_rn(1.f, expf(-f.y)));
          out[j] = as_bits(__floats2bfloat162_rn(f.x, f.y));
        }
        yp[(i0 + u) * ys] = make_uint2(out[0], out[1]);
#pragma unroll
        for (int j = 0; j < W - 1; ++j) {
          xw[j][0] = xw[j + 1][0];
          xw[j][1] = xw[j + 1][1];
        }
        if (++t == a.L) t = 0;
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_bwd_bf16_kernel(Args a) {
  constexpr int U = kBwdRows;
  constexpr int V = 4, kE = (W + 1) * V;
  __shared__ float red[kTilesY][kE][kGroupsX];
  const int c0 = (blockIdx.y * kGroupsX + threadIdx.x) * V;
  const bool active = c0 < a.d;
  __nv_bfloat162 wk[W][2], bs[2];
  float wf[W][V], dw[W][V], db[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    db[v] = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) dw[k][v] = 0.f;
  }
  if (active) {
    load_pairs<W>(a, c0, wk, bs);
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 f = __bfloat1622float2(wk[k][j]);
        wf[k][2 * j] = f.x;
        wf[k][2 * j + 1] = f.y;
      }
    }
  }
  const bool has_bias = a.bias != nullptr;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  const long long xs = a.x_row / 4, gs = a.dy_row / 4, ds = a.d / 4;
  for (long long tile = (long long)blockIdx.x * kTilesY + threadIdx.y; active && tile < a.n_tiles;
       tile += (long long)gridDim.x * kTilesY) {
    const long long n0 = tile * a.tile;
    const int len = (int)(min(n0 + a.tile, a.n_tokens) - n0);
    const int need = (int)(min(n0 + a.tile + W - 1, a.n_tokens) - n0);  // tokens with a dpre
    int t = (int)(n0 % a.L), tn = t;
    const uint2* xp = reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(a.x) +
                                                     n0 * a.x_row + c0);
    const uint2* gp = reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(a.dy) +
                                                     n0 * a.dy_row + c0);
    uint2* dxp = reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + n0 * a.d + c0);
    __nv_bfloat162 xw[W][2];
    float dwin[W][V];
#pragma unroll
    for (int j = 0; j < W; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) dwin[j][v] = 0.f;
#pragma unroll
    for (int j = 0; j < W - 1; ++j) {
      const bool in_seq = t + j - (W - 1) >= 0;
      const uint2 r = in_seq ? xp[(j - (W - 1)) * xs] : make_uint2(0u, 0u);
      xw[j][0] = as_pair(r.x);
      xw[j][1] = as_pair(r.y);
    }
    for (int i0 = 0; i0 < len + W - 1; i0 += U) {
      uint2 xr[U], gr[U];  // U rows of x and of dy in flight at once
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < need) {
          xr[u] = xp[(i0 + u) * xs];
          gr[u] = gp[(i0 + u) * gs];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        if (i >= len + W - 1) break;
        float dp[V];
        if (i < need) {
          if (t == 0) {
#pragma unroll
            for (int j = 0; j < W - 1; ++j) xw[j][0] = xw[j][1] = zero;
          }
          xw[W - 1][0] = as_pair(xr[u].x);
          xw[W - 1][1] = as_pair(xr[u].y);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 pre = __bfloat1622float2(pre_pair<W>(xw, wk, bs[j], has_bias, j));
            const float2 g = __bfloat1622float2(as_pair(j == 0 ? gr[u].x : gr[u].y));
            const float s0 = __fdividef(1.f, 1.f + __expf(-pre.x));
            const float s1 = __fdividef(1.f, 1.f + __expf(-pre.y));
            dp[2 * j] = g.x * (s0 * (1.f + pre.x * (1.f - s0)));
            dp[2 * j + 1] = g.y * (s1 * (1.f + pre.y * (1.f - s1)));
          }
          if (i < len) {
#pragma unroll
            for (int k = 0; k < W; ++k) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float2 xv = __bfloat1622float2(xw[k][j]);
                dw[k][2 * j] = fmaf(dp[2 * j], xv.x, dw[k][2 * j]);
                dw[k][2 * j + 1] = fmaf(dp[2 * j + 1], xv.y, dw[k][2 * j + 1]);
              }
            }
#pragma unroll
            for (int v = 0; v < V; ++v) db[v] += dp[v];
          }
#pragma unroll
          for (int j = 0; j < W - 1; ++j) {
            xw[j][0] = xw[j + 1][0];
            xw[j][1] = xw[j + 1][1];
          }
          if (++t == a.L) t = 0;
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) dp[v] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < W - 1; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v) dwin[j][v] = dwin[j + 1][v];
#pragma unroll
        for (int v = 0; v < V; ++v) dwin[W - 1][v] = dp[v];
        if (i >= W - 1) {  // dwin[j] holds dpre of token i - (W - 1) + j
          float o[V];
#pragma unroll
          for (int v = 0; v < V; ++v) o[v] = 0.f;
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (tn + j < a.L) {
#pragma unroll
              for (int v = 0; v < V; ++v) o[v] = fmaf(wf[W - 1 - j][v], dwin[j][v], o[v]);
            }
          }
          dxp[(i - (W - 1)) * ds] = make_uint2(as_bits(__floats2bfloat162_rn(o[0], o[1])),
                                               as_bits(__floats2bfloat162_rn(o[2], o[3])));
          if (++tn == a.L) tn = 0;
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int k = 0; k < W; ++k) red[threadIdx.y][k * V + v][threadIdx.x] = dw[k][v];
    red[threadIdx.y][W * V + v][threadIdx.x] = db[v];
  }
  __syncthreads();
  if (threadIdx.y == 0 && active) {
    for (int e = 0; e < kE; ++e) {
      const int k = e / V, v = e % V;
      float s = red[0][e][threadIdx.x];
#pragma unroll
      for (int r = 1; r < kTilesY; ++r) s += red[r][e][threadIdx.x];
      a.partials[((long long)blockIdx.x * (W + 1) + k) * a.d + c0 + v] = s;
    }
  }
}

// dw (d, W) and dbias (d,) from the blocks' partials, each summed over the
// blocks in their order
__global__ void causal_conv1d_bwd_sum_kernel(const float* partials, int rows, int d, int W,
                                             void* dw, int dw_bf16, void* dbias, int db_bf16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(W + 1) * d) return;
  const int k = (int)(i / d), c = (int)(i % d);
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partials[((long long)r * (W + 1) + k) * d + c];
  if (k < W) store_any(dw, (long long)c * W + k, s, dw_bf16);
  else if (dbias != nullptr) store_any(dbias, c, s, db_bf16);
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
      sms = 132;
    cached[dev] = sms;
  }
  return cached[dev];
}

// resident blocks an SM of a kernel instance (its registers decide)
int resident(const void* fn) {
  int got = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, fn, kThreads, 0) != cudaSuccess ||
      got < 1)
    got = 1;
  return got;
}

struct Plan {
  int tile, grid_y;
  long long n_tiles, grid_x;
};

// tiles of kMinTile .. kMaxTile tokens (a multiple of 8) so that the card's
// resident threads take about one wave; the grid's x axis at most one wave
// of blocks, each block walking several tiles where there are more
Plan plan(long long n_tokens, int d, int V, int blocks_per_sm) {
  Plan p;
  const long long groups = (d + V - 1) / V;
  p.grid_y = (int)((groups + kGroupsX - 1) / kGroupsX);
  const long long slots = (long long)sm_count() * blocks_per_sm * kThreads;
  long long tile = (n_tokens * groups + slots - 1) / slots;
  tile = (tile + 7) / 8 * 8;
  tile = tile < kMinTile ? kMinTile : (tile > kMaxTile ? kMaxTile : tile);
  p.tile = (int)tile;
  p.n_tiles = (n_tokens + tile - 1) / tile;
  p.grid_x = (p.n_tiles + kTilesY - 1) / kTilesY;
  const long long cap = ((long long)sm_count() * blocks_per_sm + p.grid_y - 1) / p.grid_y;
  if (p.grid_x > cap) p.grid_x = cap;
  return p;
}

constexpr int kVec = 2;  // channels a thread in the general kernels

bool aligned8(const void* p, long long row) {
  return (reinterpret_cast<uintptr_t>(p) % 8) == 0 && (row % 4) == 0;
}

// One launch's kernel choice and plan: the bf16 kernels for the models'
// case, else the general ones.
struct Launch {
  const void* fn;
  int V;
  Plan p;
};

template <int W>
Launch pick_fwd(const Args& a, int x_bf16) {
  const bool fast = x_bf16 && a.acc_bf16 && a.silu && a.init == nullptr && a.d % 4 == 0 &&
                    aligned8(a.x, a.x_row) && aligned8(a.out, a.d);
  // each instance asks the occupancy once (a function-local static per
  // template instance)
  static const int b_fast = resident((const void*)causal_conv1d_fwd_bf16_kernel<W>);
  static const int b_bf = resident((const void*)causal_conv1d_fwd_kernel<__nv_bfloat16, W, kVec>);
  static const int b_f = resident((const void*)causal_conv1d_fwd_kernel<float, W, kVec>);
  if (fast) return {(const void*)causal_conv1d_fwd_bf16_kernel<W>, 4, plan(a.n_tokens, a.d, 4, b_fast)};
  if (x_bf16)
    return {(const void*)causal_conv1d_fwd_kernel<__nv_bfloat16, W, kVec>, kVec,
            plan(a.n_tokens, a.d, kVec, b_bf)};
  return {(const void*)causal_conv1d_fwd_kernel<float, W, kVec>, kVec,
          plan(a.n_tokens, a.d, kVec, b_f)};
}

template <int W>
Launch pick_bwd(const Args& a, int x_bf16) {
  const bool init = a.init != nullptr;
  const bool fast = x_bf16 && a.acc_bf16 && a.silu && !init && a.d % 4 == 0 &&
                    aligned8(a.x, a.x_row) && aligned8(a.dy, a.dy_row) && aligned8(a.out, a.d);
  static const int b_fast = resident((const void*)causal_conv1d_bwd_bf16_kernel<W>);
  static const int b_bf0 =
      resident((const void*)causal_conv1d_bwd_kernel<__nv_bfloat16, W, kVec, false>);
  static const int b_bf1 =
      resident((const void*)causal_conv1d_bwd_kernel<__nv_bfloat16, W, kVec, true>);
  static const int b_f0 = resident((const void*)causal_conv1d_bwd_kernel<float, W, kVec, false>);
  static const int b_f1 = resident((const void*)causal_conv1d_bwd_kernel<float, W, kVec, true>);
  if (fast) return {(const void*)causal_conv1d_bwd_bf16_kernel<W>, 4, plan(a.n_tokens, a.d, 4, b_fast)};
  const void* fn;
  int b;
  if (x_bf16) {
    fn = init ? (const void*)causal_conv1d_bwd_kernel<__nv_bfloat16, W, kVec, true>
              : (const void*)causal_conv1d_bwd_kernel<__nv_bfloat16, W, kVec, false>;
    b = init ? b_bf1 : b_bf0;
  } else {
    fn = init ? (const void*)causal_conv1d_bwd_kernel<float, W, kVec, true>
              : (const void*)causal_conv1d_bwd_kernel<float, W, kVec, false>;
    b = init ? b_f1 : b_f0;
  }
  return {fn, kVec, plan(a.n_tokens, a.d, kVec, b)};
}

template <int W>
Launch pick(const Args& a, int x_bf16, bool backward) {
  return backward ? pick_bwd<W>(a, x_bf16) : pick_fwd<W>(a, x_bf16);
}

Launch pick_any(const Args& a, int W, int x_bf16, bool backward) {
  switch (W) {
    case 2: return pick<2>(a, x_bf16, backward);
    case 3: return pick<3>(a, x_bf16, backward);
    default: return pick<4>(a, x_bf16, backward);
  }
}

int run(const Launch& l, Args a, cudaStream_t s) {
  a.tile = l.p.tile;
  a.n_tiles = l.p.n_tiles;
  void* args[] = {&a};
  return (int)cudaLaunchKernel(l.fn, dim3((unsigned)l.p.grid_x, (unsigned)l.p.grid_y),
                               dim3(kGroupsX, kTilesY), args, 0, s);
}

bool valid(long long batch, int L, int d, int W) {
  return batch >= 1 && L >= 1 && d >= 1 && W >= 2 && W <= kMaxWidth;
}

}  // namespace

// Forward.  y (batch, L, d) contiguous in x's dtype.  dtype flags: 1 bf16,
// 0 float32; acc_bf16: accumulate in bf16 (else float32).
extern "C" int zt_causal_conv1d_fwd(const void* x, const void* w, const void* bias,
                                    const void* init, void* y, long long batch, int L, int d,
                                    int W, long long x_row, int x_bf16, int w_bf16,
                                    int bias_bf16, int init_bf16, int acc_bf16, int silu,
                                    void* stream) {
  if (!valid(batch, L, d, W)) return (int)cudaErrorInvalidValue;
  const Args a{x, w, bias, init, nullptr, y, nullptr, nullptr, batch * L, x_row, 0, 0,
               L, d, 0, w_bf16, bias_bf16, init_bf16, 0, acc_bf16, silu};
  int err = run(pick_any(a, W, x_bf16, false), a, static_cast<cudaStream_t>(stream));
  return err != 0 ? err : (int)cudaGetLastError();
}

// Rows of the backward's fp32 partials, (rows, W + 1, d), for the call
// zt_causal_conv1d_bwd gets with the same inputs: the blocks along the
// token axis of its grid on the current card.
extern "C" long long zt_causal_conv1d_bwd_rows(const void* x, const void* init, const void* dy,
                                               const void* dx, long long batch, int L, int d,
                                               int W, long long x_row, long long dy_row,
                                               int x_bf16, int acc_bf16, int silu) {
  if (!valid(batch, L, d, W)) return -1;
  Args a{x, nullptr, nullptr, init, dy, const_cast<void*>(dx), nullptr, nullptr, batch * L, x_row,
         dy_row, 0, L, d, 0, 0, 0, 0, 0, acc_bf16, silu};
  return pick_any(a, W, x_bf16, true).p.grid_x;
}

// Backward.  dx (batch, L, d) contiguous in x's dtype; dw (d, W) and dbias
// (d,) in their own dtypes; dinit (batch, W - 1, d) contiguous, written only
// with init; partials (rows, W + 1, d) fp32, rows from
// zt_causal_conv1d_bwd_rows.
extern "C" int zt_causal_conv1d_bwd(const void* x, const void* w, const void* bias,
                                    const void* init, const void* dy, void* dx, void* dw,
                                    void* dbias, void* dinit, float* partials, long long batch,
                                    int L, int d, int W, long long x_row, long long dy_row,
                                    int x_bf16, int w_bf16, int bias_bf16, int init_bf16,
                                    int dinit_bf16, int acc_bf16, int silu, void* stream) {
  if (!valid(batch, L, d, W)) return (int)cudaErrorInvalidValue;
  const Args a{x, w, bias, init, dy, dx, dinit, partials, batch * L, x_row, dy_row, 0,
               L, d, 0, w_bf16, bias_bf16, init_bf16, dinit_bf16, acc_bf16, silu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Launch l = pick_any(a, W, x_bf16, true);
  int err = run(l, a, s);
  if (err != 0) return err;
  const long long total = (long long)(W + 1) * d;
  causal_conv1d_bwd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      partials, (int)l.p.grid_x, d, W, dw, w_bf16, dbias, bias_bf16);
  return (int)cudaGetLastError();
}

// The W = 4 instances the models run (bf16, SiLU: the packed kernels; float32:
// the general ones) on the current card: registers and spill bytes a thread,
// resident blocks an SM, for the forward (which 0) or backward (1).
// info: 3 ints.
extern "C" int zt_causal_conv1d_info(int which, int x_bf16, int* info) {
  const void* fn;
  if (which == 0)
    fn = x_bf16 ? (const void*)causal_conv1d_fwd_bf16_kernel<4>
                : (const void*)causal_conv1d_fwd_kernel<float, 4, kVec>;
  else
    fn = x_bf16 ? (const void*)causal_conv1d_bwd_bf16_kernel<4>
                : (const void*)causal_conv1d_bwd_kernel<float, 4, kVec, false>;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (err != 0) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = blocks;
  return 0;
}
