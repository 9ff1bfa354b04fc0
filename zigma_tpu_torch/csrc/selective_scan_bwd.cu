// Selective-scan backward for Hopper (sm_90a), bound through a plain C entry
// point and loaded with ctypes by zigma_tpu_torch/ops/scan_cuda.py.
//
// Replaces the TPU kernel zigma_tpu/ops/scan_pallas.py::_scan_bwd_kernel
// (launched by scan_core_bwd_pallas).  Per (batch b, channel d), with the
// forward's chunk-start states (B, ceil(L/128), N, D) as input:
//
//   g_t   = gy_t * C_t + exp(dt_{t+1} A) g_{t+1}     adjoint of x_t, (N,) fp32
//                                                   (seeded by g_last)
//   dla_t = g_t * exp(dt_t A) * x_{t-1}             d loss / d (dt_t A)
//   du_t  = dt_t * <g_t, B_t>        (+ gy_t * Dskip under the fused gate)
//   ddelta_t = (<dla_t, A> + u_t <g_t, B_t>) * sigmoid(delta_t + bias)
//   dB_t  = sum_d g_t dt_t u_t,  dC_t = sum_d gy_t x_t,  dA = sum_{b,t} dla dt
//   dx0   = exp(dt_0 A) g_0
//
// Under the fused gate (Dskip and z given) gy is the cotangent of
// (y + u Dskip) silu(z); the kernel recomputes y = <C_t, x_t> and emits
// dz = g_out (y + u Dskip) sig(z) (1 + z (1 - sig(z))) and per-batch dD.
//
// Outputs, all written once, no atomics (two launches on the same inputs
// give bit-equal results): du, ddelta, dz (B, L, D) in the input dtype;
// per-block dB / dC partials (B, ceil(D / channels a block), L, N) fp32;
// per-batch dA partials and dx0 (B, N, D) fp32; per-batch dD partials (B, D)
// fp32.  The wrapper sums the partials with torch.sum, as
// scan_core_bwd_pallas does with jnp.sum.
//
// What bounds it on an H100.  At the flagship shape (16, 1024, 1536, 16),
// bf16, fused, the least time for the function is set by operations: the
// fp32 work (the JAX cost estimate, 25 B L D N = 10.1 GFLOP, 0.150 ms at
// 67 TFLOP/s) ahead of the special-function units (one exp per state and
// step plus four per channel and step, 5.0e8, 0.120 ms) and the bytes (the
// inputs read and the gradients written once, 369 MB, 0.110 ms at
// 3.35 TB/s).  Any kernel that recomputes the states from the 128-step
// chunk starts pays the state's exponential at least twice (once to find
// each window's start, once in the window itself).
//
// Design.  One block owns (batch row, a slab of CPB channels) and walks all
// of L in reverse; the adjoint g of each state stays in registers from the
// last step to the first.  NL lanes of a warp share a channel, NPT = 4
// states a lane (8 above d_state 128; NL = 1 ... 32), 128 threads a block:
// at d_state 16, 4 lanes and 32 channels a block.  The reverse walk needs
// x_{t-1} at every step, and running the recurrence backwards would divide
// by exp(dt A), which underflows, so the states are recomputed forward from
// K1's chunk starts in two levels: a forward pass over each 128-step chunk
// stores the state at every KS = 8 steps in shared memory; then, window by
// window from the last, the window's KS states are recomputed into
// registers and walked in reverse.  The decays are recomputed in the walk
// (one more exponential) rather than held: holding them spills at 128
// registers and was slower on the card.
//
// Every input is staged: per tile of TC steps (16 at the flagship; the
// longest of 8 ... 64 the shared-memory budget of three blocks an SM
// allows) the block copies the u, delta, gy, z (TC x CPB) and B, C
// (TC x NPAD) tiles into shared memory with 16-byte cp.async copies (8, 4
// bytes or plain 2-byte loads where rows are less aligned:
// zt::stage_tile), double-buffered: the next tile's copy is issued before
// this one's pre-pass.  A chunk is staged twice, forward for the pass that
// stores the window starts (u, delta, B, in tiles of 2 TC steps) and in
// reverse for the walk (all six); the second read mostly hits the L2.  A
// pre-pass (one (step, channel) a thread at a time) turns each tile into
// fp32 once per (step, channel): dt = softplus(delta + bias), dt u, its
// derivative sigmoid(delta + bias), gyr = g_out silu(z) and the gate
// factor, with accurate expf / log1pf as in K1, packed so that the walk
// reads (dt, dt u, gyr) with one 16-byte load.  The decay is one
// ex2.approx of dt * (A log2 e) everywhere (zt::exp2_approx), the
// expression K1 uses, so the recomputed states agree with K1's chunk
// starts to rounding.
//
// The walk touches only registers and shared memory.  Per step, the
// channel's <g, B>, <dla, A> and y are reduce-scattered over its NL lanes
// (one store a lane), and dB / dC over the warp's channels (each shuffle
// halves the values a lane carries); per tile, after one barrier, a tiled
// epilogue writes du, ddelta, dz with 8-byte (bf16) or 16-byte (fp32)
// stores and the block's dB / dC partials with a fixed-order sum over the
// warps (float4 stores).  dA and dx0 stay in registers over the whole walk,
// dD in a per-thread shared slot (summed in a fixed order at the end).
// The ragged ends of L and D are masked, never padded.
//
// What the first version lost, and what this design does about each:
// 194 registers a thread (8 warps an SM): here 128 and 12 warps; each input
// loaded from global memory in three serial passes with 2-byte loads: here
// staged tiles; softplus and the sigmoids on every lane in every pass: here
// once per (step, channel) and pass; two accurate expf per state and step:
// here one ex2.approx per state and pass; the dB / dC sum over warps every
// 8 steps with two barriers: here once a tile.  The measured times,
// registers and occupancy (chip_smoke.py, tools/k2_variants.py), the share
// of each phase, and what holds it back now are in PERF.md.

#include "scan_common.cuh"

// Phase marks: empty here; zigma_tpu_torch/tools/k2_variants.py defines them
// in an instrumented copy that sums clock64 intervals of each block's first
// thread by phase.
#ifndef ZT_PHASE_START
#define ZT_PHASE_START
#define ZT_PHASE(i)
#define ZT_PHASE_END
#endif

namespace {

using namespace zt;

constexpr int kThreads = 128;        // threads a block
constexpr int kRegBlocks = 4;        // blocks an SM the register cap allows (128 registers)
constexpr int kNPT = 4;              // states a lane up to d_state 128 (8 above)
constexpr int kCarryEvery = 128;     // chunk-start state period (Pallas block_l)
constexpr int KS = 8;                // steps a register window
constexpr int kNSub = kCarryEvery / KS;  // window starts stored a chunk
constexpr int kMinTile = 8;          // steps staged a tile: 8 ... 64, each a
constexpr int kMaxTile = 64;         // multiple of KS and a divisor of 128
constexpr size_t kSmemBudget = 75 * 1024;  // three blocks an SM
constexpr size_t kSmemMax = 232448;        // the most a block may have
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kVec = 4;              // channels an epilogue thread takes at once

__host__ __device__ constexpr int channels_per_block(int nl) { return kThreads / nl; }

struct Params {
  const void* u; const void* delta; const float* A; const float* bias;
  const void* Bm; const void* Cm; const float* carries; const void* gy;
  const float* g_last; const float* Dskip; const void* z;
  void* du; void* ddelta; void* dz;
  float* dBp; float* dCp; float* dAp; float* dx0; float* dDp;
  int batch, L, D, N;
  long long u_row, delta_row, b_row, c_row, z_row;  // elements between tokens
  int t_tile;                                        // TC, steps a tile
  int vec_u, vec_delta, vec_b, vec_c, vec_z, vec_gy; // elements a copy
  int out_aligned;                                   // du, ddelta, dz rows aligned to kVec elements
};

// Shared memory of one block, for TC steps a tile: fp32 window starts
// (kNSub x NPT x kThreads); per (step, channel) dt, dt*u, gyr, sigmoid,
// gate, <g, B>, <dla, A>, y (8 x TC x CPB); B, C (TC x NPAD); the dB / dC
// of each warp (warps x TC x 2 NPAD); bias and Dskip (CPB); dD a thread
// (kThreads x kVec); then two buffers of the staged inputs in their
// own type: u, delta, gy, z (TC x CPB), B, C (TC x NPAD).  Every part is a
// multiple of 16 bytes.
__host__ __device__ constexpr size_t smem_bytes(int tc, int npt, int cpb, int npad, int elt) {
  return ((size_t)kNSub * npt * kThreads + 8 * (size_t)tc * cpb + 2 * (size_t)tc * npad +
          (kThreads / 32) * (size_t)tc * 2 * npad + 2 * (size_t)cpb +
          (size_t)kThreads * kVec) * 4 +
         2 * (size_t)(4 * tc * cpb + 2 * tc * npad) * elt;
}

// Sums v[0 .. V) over the lanes that differ only in lane bits LO, 2 LO, ...
// below HI, as a reduce-scatter: each shuffle level halves the values a
// lane carries (send one half, keep the other); once one is left, plain
// butterflies.  Afterwards a lane where `writer` holds the totals of values
// base .. base + nv - 1 in v[0 .. nv).  nv is a constant once unrolled.
template <int V, int LO, int HI>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane, int& base, int& nv,
                                               bool& writer) {
  base = 0;
  nv = V;
  writer = true;
#pragma unroll
  for (int o = LO; o < HI; o <<= 1) {
    const bool hi = (lane & o) != 0;
    if (nv > 1) {
      const int h = nv / 2;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < h) {
          const float send = hi ? v[i] : v[i + h];
          const float keep = hi ? v[i + h] : v[i];
          v[i] = keep + __shfl_xor_sync(kFull, send, o);
        }
      }
      base += hi ? h : 0;
      nv = h;
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], o);
      writer = writer && !hi;
    }
  }
}

// NPT consecutive fp32 values (16-byte aligned) as float4 loads
template <int NPT>
__device__ __forceinline__ void load_states(const float* p, float (&v)[NPT]) {
#pragma unroll
  for (int i = 0; i < NPT; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + i);
    v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
  }
}

__device__ __forceinline__ float sigmoid(float v) { return __frcp_rn(1.f + expf(-v)); }

// zt::stage_tile out of line: the rarely taken path stays out of the hot
// code (inlined at six call sites it measured 2.5% slower on the card)
template <typename E>
__device__ __noinline__ void stage_tile_call(E* s, const E* g, long long row, int rows, int cols,
                                             int rows_ok, int cols_ok, int vec) {
  stage_tile(s, g, row, rows, cols, rows_ok, cols_ok, vec);
}

// zt::stage_tile for a rows x COLS tile, with a fast path for rows whose
// copies can all be 16 bytes (vec elements of 16 / sizeof(E), as the
// model's tensors allow): the tile's geometry is then known at compile time
// and a copy costs a few instructions.
template <int COLS, typename E>
__device__ __forceinline__ void stage_any(E* s, const E* g, long long row, int rows, int rows_ok,
                                          int cols_ok, int vec) {
  constexpr int kV = 16 / sizeof(E);
  if constexpr (COLS >= kV) {
    if (vec == kV) {
      constexpr int kPerRow = COLS / kV;
      for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
        const int r = i / kPerRow, c = (i % kPerRow) * kV;
        const int ok = r < rows_ok ? max(0, min(kV, cols_ok - c)) : 0;
        cp_async(s + r * COLS + c, ok > 0 ? g + r * row + c : g, 16,
                 ok * static_cast<int>(sizeof(E)));
      }
      return;
    }
  }
  stage_tile_call(s, g, row, rows, COLS, rows_ok, cols_ok, vec);
}

template <typename E, int NPT, int NL>
__global__ void __launch_bounds__(kThreads, NPT == 4 ? kRegBlocks : 1)
selective_scan_bwd_kernel(Params p) {
  constexpr int CPB = channels_per_block(NL);
  constexpr int NPAD = NL * NPT;
  constexpr int NWARPS = kThreads / 32;
  constexpr int VE = kVec;
  constexpr int V = 2 * NPT;           // dB and dC values a lane and step
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc = p.t_tile;
  float* snap = reinterpret_cast<float*>(smem);
  // per (step, channel): (dt, dt u, gyr, sigmoid) in a reverse job, one
  // float4 load in the walk; (dt, dt u) in a forward one
  float* wv = snap + kNSub * NPT * kThreads;
  const float4* w4 = reinterpret_cast<const float4*>(wv);
  const float2* w2 = reinterpret_cast<const float2*>(wv);
  float* gates = wv + 4 * tc * CPB;
  float* sums = gates + tc * CPB;  // <g, B>, <dla, A>, y: 3 x TC x CPB
  float* Bf = sums + 3 * tc * CPB;
  float* Cf = Bf + tc * NPAD;
  float* red = Cf + tc * NPAD;
  float* bias_s = red + NWARPS * tc * 2 * NPAD;
  float* D_s = bias_s + CPB;
  float* dD_s = D_s + CPB;
  E* raw = reinterpret_cast<E*>(dD_s + kThreads * VE);
  const int raw_len = 4 * tc * CPB + 2 * tc * NPAD;  // one buffer
  const int off_gy = 2 * tc * CPB, off_z = 3 * tc * CPB,
            off_B = 4 * tc * CPB, off_C = 4 * tc * CPB + tc * NPAD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * CPB;
  const int b = blockIdx.y;
  const int nD = gridDim.x;
  const int cols_ok = min(CPB, p.D - d0);
  const int ch = tid / NL;   // channel within the block
  const int sub = tid % NL;  // which NPT states of it
  const int d = d0 + ch;
  const bool active = ch < cols_ok;
  const bool fused = p.z != nullptr;
  const int L = p.L, N = p.N, Dm = p.D;
  const long long row0 = (long long)b * L;
  const int n_chunks = (L + kCarryEvery - 1) / kCarryEvery;

  const E* u = static_cast<const E*>(p.u);
  const E* dl = static_cast<const E*>(p.delta);
  const E* Bm = static_cast<const E*>(p.Bm);
  const E* Cm = static_cast<const E*>(p.Cm);
  const E* gy = static_cast<const E*>(p.gy);
  const E* z = static_cast<const E*>(p.z);

  // A job is one tile of chunk k, walked forward (window starts) or in
  // reverse (the adjoint).  The forward pass stages u, delta, B in tiles of
  // 2 TC steps, the reverse one all six in tiles of TC: both fit the same
  // buffers (u at 0, delta after TJ x CPB, B at off_B), and the forward
  // pass, which does little per step, pays its fixed costs half as often.
  auto stage = [&](int k, int tile, bool fwd, int buf_i) {
    const int tj = fwd ? 2 * tc : tc;
    const int l0 = k * kCarryEvery + tile * tj;
    const long long r0 = row0 + l0;
    const int rows_ok = min(tj, L - l0);
    E* buf = raw + buf_i * raw_len;
    stage_any<CPB>(buf, u + r0 * p.u_row + d0, p.u_row, tj, rows_ok, cols_ok, p.vec_u);
    stage_any<CPB>(buf + tj * CPB, dl + r0 * p.delta_row + d0, p.delta_row, tj, rows_ok,
                   cols_ok, p.vec_delta);
    stage_any<NPAD>(buf + off_B, Bm + r0 * p.b_row, p.b_row, tj, rows_ok, N, p.vec_b);
    if (!fwd) {
      stage_any<CPB>(buf + off_gy, gy + r0 * Dm + d0, (long long)Dm, tc, rows_ok, cols_ok,
                     p.vec_gy);
      if (fused)
        stage_any<CPB>(buf + off_z, z + r0 * p.z_row + d0, p.z_row, tc, rows_ok, cols_ok,
                       p.vec_z);
      stage_any<NPAD>(buf + off_C, Cm + r0 * p.c_row, p.c_row, tc, rows_ok, N, p.vec_c);
    }
    cp_async_commit();
  };
  auto tiles_of = [&](int k, int tj) {
    return (min(kCarryEvery, L - k * kCarryEvery) + tj - 1) / tj;
  };

  int k = n_chunks - 1, tile = 0, bi = 0;
  bool fwd = true;
  stage(k, tile, fwd, 0);
  for (int i = tid; i < CPB; i += kThreads) {
    const bool ok = i < cols_ok;
    bias_s[i] = ok ? p.bias[d0 + i] : 0.f;
    D_s[i] = ok && fused ? p.Dskip[d0 + i] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < VE; ++e) dD_s[tid * VE + e] = 0.f;
  // padded states (n >= N) and inactive channels keep A = 0, B = C = 0 and
  // x = g = 0: they stay 0 and add nothing
  float A2[NPT], c[NPT], dA[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = sub * NPT + i;
    const bool ok = active && n < N;
    A2[i] = ok ? p.A[(size_t)d * N + n] * kLog2e : 0.f;
    c[i] = ok && p.g_last ? p.g_last[((size_t)b * N + n) * Dm + d] : 0.f;
    dA[i] = 0.f;
  }
  ZT_PHASE_START

  // Per job: wait for its tile (barrier), start the next job's copy,
  // pre-pass the tile (barrier), then walk; a reverse job ends with a
  // barrier and its epilogue.  The next job's pre-pass writes the fp32
  // arrays only after the barrier that follows this job's last reads.
  for (;;) {
    const int tj = fwd ? 2 * tc : tc;            // steps a tile of this job
    const int l0 = k * kCarryEvery + tile * tj;  // first step of the tile
    const int tlen = min(tj, L - l0);
    const E* buf = raw + bi * raw_len;
    cp_async_wait_all();
    __syncthreads();
    ZT_PHASE(0)

    // the next job: the chunk's tiles forward, then the same tiles in
    // reverse, then the chunk before.  Its copy goes to the other buffer,
    // whose last reader (the epilogue before) passed the barrier above.
    int nk = k, ntile = tile;
    bool nfwd = fwd, more = true;
    if (fwd) {
      if (tile + 1 < tiles_of(k, tj)) ++ntile; else { nfwd = false; ntile = tiles_of(k, tc) - 1; }
    } else if (tile > 0) {
      --ntile;
    } else if (k > 0) {
      --nk; ntile = 0; nfwd = true;
    } else {
      more = false;
    }
    if (more) stage(nk, ntile, nfwd, bi ^ 1);  // in flight while this job runs
    ZT_PHASE(3)

    // pre-pass, once per (step, channel), one a thread at a time: a loop of
    // one element keeps the code short (the SM's instruction cache also
    // holds the walk), and measured as fast as four at a time
#pragma unroll 1
    for (int i = tid; i < tlen * CPB; i += kThreads) {
      const float pre = to_f32(buf[tj * CPB + i]) + bias_s[i % CPB];
      const float ex = expf(pre);
      const float dt = pre <= 20.f ? log1pf(ex) : pre;  // zt::softplus, as K1
      const float dtu = dt * to_f32(buf[i]);
      if (fwd) {
        reinterpret_cast<float2*>(wv)[i] = make_float2(dt, dtu);
      } else {
        const float sg = pre <= 20.f ? ex * __frcp_rn(1.f + ex) : 1.f;  // 1 in fp32 above 17
        const float g_out = to_f32(buf[off_gy + i]);
        float gyr = g_out;
        if (fused) {
          const float zz = to_f32(buf[off_z + i]), sz = sigmoid(zz);
          gyr = g_out * zz * sz;
          gates[i] = g_out * (sz * (1.f + zz * (1.f - sz)));
        }
        reinterpret_cast<float4*>(wv)[i] = make_float4(dt, dtu, gyr, sg);
      }
    }
    for (int i = 4 * tid; i < tlen * NPAD; i += 4 * kThreads) {  // B, C in fp32
      float v[4];
      load4(buf + off_B + i, v);
      store4(Bf + i, v);
      if (!fwd) {
        load4(buf + off_C + i, v);
        store4(Cf + i, v);
      }
    }
    ZT_PHASE(1)
    __syncthreads();
    ZT_PHASE(2)

    if (fwd) {
      // forward from the chunk's start state (or where the tile before
      // stopped): store each window's start
      const int s0 = tile * tj / KS;
      float x[NPT];
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int n = sub * NPT + i;
        if (tile == 0) {
          x[i] = active && n < N
              ? p.carries[(((size_t)b * n_chunks + k) * N + n) * Dm + d] : 0.f;
          snap[i * kThreads + tid] = x[i];
        } else {
          x[i] = snap[(s0 * NPT + i) * kThreads + tid];
        }
      }
#pragma unroll 1
      for (int w = 0; w < tlen; w += KS) {
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const int t = w + j;
          if (t < tlen) {
            const float2 wt = w2[t * CPB + ch];
            const float dt = wt.x, dtu = wt.y;
            float bv[NPT];
            load_states<NPT>(Bf + t * NPAD + sub * NPT, bv);
#pragma unroll
            for (int i = 0; i < NPT; ++i) x[i] = fmaf(exp2_approx(dt * A2[i]), x[i], dtu * bv[i]);
          }
        }
        const int s = s0 + w / KS + 1;  // the next window's start
        if (s < kNSub) {
#pragma unroll
          for (int i = 0; i < NPT; ++i) snap[(s * NPT + i) * kThreads + tid] = x[i];
        }
      }
      ZT_PHASE(4)
    } else {
      // windows from the last: recompute KS states into registers from the
      // window's start, then walk them in reverse (the decays recomputed)
#pragma unroll 1
      for (int w = (tlen - 1) / KS * KS; w >= 0; w -= KS) {
        const int s = (tile * tc + w) / KS;
        float x0[NPT], xs[KS][NPT];
#pragma unroll
        for (int i = 0; i < NPT; ++i) x0[i] = snap[(s * NPT + i) * kThreads + tid];
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const int t = w + j;
          if (t < tlen) {
            const float4 wt = w4[t * CPB + ch];
            const float dt = wt.x, dtu = wt.y;
            float bv[NPT];
            load_states<NPT>(Bf + t * NPAD + sub * NPT, bv);
#pragma unroll
            for (int i = 0; i < NPT; ++i)
              xs[j][i] = fmaf(exp2_approx(dt * A2[i]), j > 0 ? xs[j - 1][i] : x0[i], dtu * bv[i]);
          }
        }

#pragma unroll
        for (int j = KS - 1; j >= 0; --j) {
          const int t = w + j;
          if (t >= tlen) continue;  // uniform over the block
          const float4 wt = w4[t * CPB + ch];
          const float dt = wt.x, dtu = wt.y, gyr = wt.z;
          float bv[NPT], cv[NPT], v[V];
          load_states<NPT>(Bf + t * NPAD + sub * NPT, bv);
          load_states<NPT>(Cf + t * NPAD + sub * NPT, cv);
          float gB = 0.f, sdla = 0.f, y = 0.f;
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            const float xt = xs[j][i];
            const float xp = j > 0 ? xs[j - 1][i] : x0[i];
            const float e = exp2_approx(dt * A2[i]);
            const float g = fmaf(gyr, cv[i], c[i]);
            const float gd = g * e;   // the adjoint of x_{t-1}
            const float dla = gd * xp;
            gB = fmaf(g, bv[i], gB);
            sdla = fmaf(dla, A2[i], sdla);
            y = fmaf(cv[i], xt, y);
            dA[i] = fmaf(dla, dt, dA[i]);
            v[i] = g * dtu;
            v[NPT + i] = gyr * xt;
            c[i] = gd;
          }
          // the channel's sums over its NL lanes, scattered: one store a lane
          {
            float q[4] = {gB, sdla, y, 0.f};
            int qb, qn;
            bool qw;
            reduce_scatter<4, 1, NL>(q, lane, qb, qn, qw);
            if (qw) {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (i < qn && qb + i < 3) sums[(qb + i) * tc * CPB + t * CPB + ch] = q[i];
            }
          }

          // dB, dC: v summed over the warp's channels (lane bits NL .. 16)
          int base, nv;
          bool writer;
          reduce_scatter<V, NL, 32>(v, lane, base, nv, writer);
          if (writer) {
            float* r = red + (warp * tc + t) * 2 * NPAD;
#pragma unroll
            for (int i = 0; i < V; ++i) {
              if (i < nv) {
                const int idx = base + i;  // which (dB 0 / dC 1) * NPT + state
                r[(idx / NPT) * NPAD + sub * NPT + idx % NPT] = v[i];
              }
            }
          }
        }
      }
      ZT_PHASE(5)
      __syncthreads();
      ZT_PHASE(6)

      // epilogue: du, ddelta, dz, VE channels a thread (a thread keeps the
      // same channels, so its dD slot sums one channel group in step order)
      E* du_o = static_cast<E*>(p.du) + (row0 + l0) * Dm + d0;
      E* dd_o = static_cast<E*>(p.ddelta) + (row0 + l0) * Dm + d0;
      E* dz_o = fused ? static_cast<E*>(p.dz) + (row0 + l0) * Dm + d0 : nullptr;
      for (int i = tid; i < tlen * (CPB / VE); i += kThreads) {
        const int kk = VE * i, r = kk / CPB, c0 = kk % CPB;
        float gb[VE], sd[VE], uv[VE], du[VE], dd[VE];
        float4 wt[VE];
        load4(sums + kk, gb);
        load4(sums + tc * CPB + kk, sd);
        load4(buf + kk, uv);
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          wt[e] = w4[kk + e];  // (dt, dt u, gyr, sigmoid)
          du[e] = wt[e].x * gb[e];
          dd[e] = fmaf(sd[e], kLn2, gb[e] * uv[e]) * wt[e].w;
        }
        float dz[VE];
        if (fused) {
          float yv[VE], gate[VE], Dv[VE];
          load4(sums + 2 * tc * CPB + kk, yv);
          load4(gates + kk, gate);
          load4(D_s + c0, Dv);
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            du[e] = fmaf(wt[e].z, Dv[e], du[e]);
            dz[e] = gate[e] * fmaf(uv[e], Dv[e], yv[e]);
            dD_s[tid * VE + e] = fmaf(wt[e].z, uv[e], dD_s[tid * VE + e]);
          }
        }
        const long long o = (long long)r * Dm + c0;
        if (p.out_aligned && c0 + VE <= cols_ok) {
          store4(du_o + o, du);
          store4(dd_o + o, dd);
          if (fused) store4(dz_o + o, dz);
          continue;
        }
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          if (c0 + e < cols_ok) {
            store(du_o + o + e, du[e]);
            store(dd_o + o + e, dd[e]);
            if (fused) store(dz_o + o + e, dz[e]);
          }
        }
      }
      // the block's dB / dC partials for the tile, warps summed in order
      float* dB_o = p.dBp + (((size_t)b * nD + blockIdx.x) * L + l0) * N;
      float* dC_o = p.dCp + (((size_t)b * nD + blockIdx.x) * L + l0) * N;
      for (int i = tid; i < tlen * 2 * NPAD / 4; i += kThreads) {
        const int q = 4 * i, t = q / (2 * NPAD), rr = q % (2 * NPAD), n = rr % NPAD;
        if (n >= N) continue;
        float4 acc = *reinterpret_cast<const float4*>(red + t * 2 * NPAD + rr);
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) {
          const float4 a = *reinterpret_cast<const float4*>(red + (w * tc + t) * 2 * NPAD + rr);
          acc.x += a.x; acc.y += a.y; acc.z += a.z; acc.w += a.w;
        }
        float* dst = (rr < NPAD ? dB_o : dC_o) + (size_t)t * N + n;
        if ((N & 3) == 0) {
          *reinterpret_cast<float4*>(dst) = acc;
        } else {
          const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) dst[e] = a4[e];
        }
      }
      ZT_PHASE(7)
      if (!more) break;
    }
    k = nk; tile = ntile; fwd = nfwd; bi ^= 1;
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int n = sub * NPT + i;
      if (n < N) {
        const size_t o = ((size_t)b * N + n) * Dm + d;
        p.dAp[o] = dA[i];
        p.dx0[o] = c[i];
      }
    }
  }
  ZT_PHASE_END
  if (fused) {  // dD: the threads of each channel group, in thread order
    __syncthreads();
    for (int t = tid; t < cols_ok; t += kThreads) {
      float acc = 0.f;
      for (int s = t / VE; s < kThreads; s += CPB / VE) acc += dD_s[s * VE + t % VE];
      p.dDp[(size_t)b * Dm + d0 + t] = acc;
    }
  }
}

struct Config {
  int npt, nl, cpb, t_tile;
  size_t smem;
  const void* fn;
};

// states a lane and lanes a channel for d_state N
void layout_for(int N, int* npt, int* nl) {
  *npt = N > 128 ? 8 : kNPT;
  *nl = 1;
  while (*nl * *npt < N) *nl *= 2;
}

template <typename E>
const void* kernel_for(int npt, int nl) {
  if (npt != kNPT) return reinterpret_cast<const void*>(selective_scan_bwd_kernel<E, 8, 32>);
  switch (nl) {
    case 1: return reinterpret_cast<const void*>(selective_scan_bwd_kernel<E, kNPT, 1>);
    case 2: return reinterpret_cast<const void*>(selective_scan_bwd_kernel<E, kNPT, 2>);
    case 4: return reinterpret_cast<const void*>(selective_scan_bwd_kernel<E, kNPT, 4>);
    case 8: return reinterpret_cast<const void*>(selective_scan_bwd_kernel<E, kNPT, 8>);
    case 16: return reinterpret_cast<const void*>(selective_scan_bwd_kernel<E, kNPT, 16>);
    case 32: return reinterpret_cast<const void*>(selective_scan_bwd_kernel<E, kNPT, 32>);
  }
  return nullptr;
}

// The launch shape for d_state N and length L: the layout, CPB channels a
// block, and the longest tile (8 ... 64 steps, no longer than L needs)
// whose shared memory fits the budget (the shortest where none does).
// Also allows the kernel that much dynamic shared memory.
int pick(int N, int L, int dtype, Config* c) {
  if (N < 1 || N > 256 || L < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  layout_for(N, &c->npt, &c->nl);
  c->cpb = channels_per_block(c->nl);
  const int elt = dtype == 0 ? 4 : 2;
  const int npad = c->nl * c->npt;
  c->t_tile = kMinTile;
  while (c->t_tile < kMaxTile && c->t_tile < L &&
         smem_bytes(2 * c->t_tile, c->npt, c->cpb, npad, elt) <= kSmemBudget)
    c->t_tile *= 2;
  c->smem = smem_bytes(c->t_tile, c->npt, c->cpb, npad, elt);
  if (c->smem > kSmemMax) return (int)cudaErrorInvalidValue;
  c->fn = dtype == 0 ? kernel_for<float>(c->npt, c->nl)
                     : kernel_for<__nv_bfloat16>(c->npt, c->nl);
  return (int)cudaFuncSetAttribute(c->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)c->smem);
}

}  // namespace

// Channels one block covers for a given d_state: the wrapper allocates the
// dB / dC partials as (batch, ceil(D / this), L, N).
extern "C" int zt_selective_scan_bwd_channels_per_block(int N) {
  int npt, nl;
  layout_for(N, &npt, &nl);
  return channels_per_block(nl);
}

// dtype: 0 = float32, 1 = bfloat16 (u, delta, B, C, gy, z, du, ddelta and dz
// share it).  g_last and Dskip/z/dz/dDp may be null (no fused gate).  gy, du,
// ddelta, dz and every fp32 tensor are contiguous.  Any batch: more than
// kMaxGridY sequences are launched in slices of that many (every output and
// partial is per sequence, so the slices write disjoint rows).  Returns the
// first failing launch's cudaGetLastError().
extern "C" int zt_selective_scan_bwd(
    const void* u, const void* delta, const float* A, const float* bias,
    const void* Bm, const void* Cm, const float* carries, const void* gy,
    const float* g_last, const float* Dskip, const void* z,
    void* du, void* ddelta, void* dz, float* dBp, float* dCp, float* dAp,
    float* dx0, float* dDp,
    int batch, int L, int D, int N,
    long long u_row, long long delta_row, long long b_row, long long c_row,
    long long z_row, int dtype, void* stream) {
  if (D < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  if ((Dskip == nullptr) != (z == nullptr) || (z != nullptr && (dz == nullptr || dDp == nullptr)))
    return (int)cudaErrorInvalidValue;
  Config c;
  int err = pick(N, L, dtype, &c);
  if (err != 0) return err;
  const int elt = dtype == 0 ? 4 : 2;
  const int npad = c.nl * c.npt;
  const long long n_chunks = (L + kCarryEvery - 1) / kCarryEvery;
  const long long n_blocks = (D + c.cpb - 1) / c.cpb;
  // the copy widths of the first slice hold for every slice: each is
  // advanced by whole rows
  Params p{u, delta, A, bias, Bm, Cm, carries, gy, g_last, Dskip, z,
           du, ddelta, dz, dBp, dCp, dAp, dx0, dDp,
           batch, L, D, N, u_row, delta_row, b_row, c_row, z_row, c.t_tile,
           vec_elems(u, u_row, elt, c.cpb), vec_elems(delta, delta_row, elt, c.cpb),
           vec_elems(Bm, b_row, elt, npad), vec_elems(Cm, c_row, elt, npad),
           z ? vec_elems(z, z_row, elt, c.cpb) : 1, vec_elems(gy, D, elt, c.cpb),
           vec_elems(du, D, elt, kVec) == kVec && vec_elems(ddelta, D, elt, kVec) == kVec &&
               (dz == nullptr || vec_elems(dz, D, elt, kVec) == kVec)};
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const long long rows = (long long)b0 * L, states = (long long)b0 * N * D;
    Params q = p;
    q.batch = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    q.u = advance(u, rows * u_row, elt);
    q.delta = advance(delta, rows * delta_row, elt);
    q.Bm = advance(Bm, rows * b_row, elt);
    q.Cm = advance(Cm, rows * c_row, elt);
    q.z = advance(z, rows * z_row, elt);
    q.gy = advance(gy, rows * D, elt);
    q.du = advance(du, rows * D, elt);
    q.ddelta = advance(ddelta, rows * D, elt);
    q.dz = advance(dz, rows * D, elt);
    q.carries = advance(carries, n_chunks * states, 4);
    q.g_last = advance(g_last, states, 4);
    q.dBp = advance(dBp, n_blocks * rows * N, 4);
    q.dCp = advance(dCp, n_blocks * rows * N, 4);
    q.dAp = advance(dAp, states, 4);
    q.dx0 = advance(dx0, states, 4);
    q.dDp = advance(dDp, (long long)b0 * D, 4);
    void* args[] = {&q};
    dim3 grid((unsigned)n_blocks, q.batch);
    err = (int)cudaLaunchKernel(c.fn, grid, dim3(kThreads), args, c.smem,
                                static_cast<cudaStream_t>(stream));
    const int last = (int)cudaGetLastError();
    if (err != 0 || last != 0) return err != 0 ? err : last;
  }
  return 0;
}

// The launch shape and occupancy of the kernel instance for (N, L, dtype):
// info = {registers a thread, spill (local) bytes a thread, resident blocks
// an SM, threads a block, channels a block, steps a tile, dynamic shared
// bytes a block}.
extern "C" int zt_selective_scan_bwd_info(int N, int L, int dtype, int* info) {
  Config c;
  int err = pick(N, L, dtype, &c);
  if (err != 0) return err;
  cudaFuncAttributes a;
  err = (int)cudaFuncGetAttributes(&a, c.fn);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.fn, kThreads, c.smem);
  if (err != 0) return err;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = blocks;
  info[3] = kThreads;
  info[4] = c.cpb;
  info[5] = c.t_tile;
  info[6] = (int)c.smem;
  return 0;
}
