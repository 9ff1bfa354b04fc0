// Selective-scan forward for Hopper (sm_90a), bound through a plain C entry
// point and loaded with ctypes by zigma_tpu_torch/ops/scan_cuda.py.
//
// Replaces the TPU kernel zigma_tpu/ops/scan_pallas.py::_scan_kernel
// (launched by scan_core_fwd_pallas).  Per (batch b, channel d):
//
//   dt_t = softplus(delta_t + bias)          (dt_t kept as-is above 20), or
//   dt_t = delta_t + bias                    without softplus (the Pallas
//                                            kernel's static `softplus`)
//   x_t  = exp(dt_t * A) * x_{t-1} + dt_t * u_t * B_t      state (N,), fp32
//   y_t  = sum_n C_t[n] * x_t[n]
//   out  = y                                  or, fused,
//   out  = (y + u_t * Dskip) * silu(z_t)
//
// B and C are (B, L, N), or grouped (B, L, G, N): group g serves the D / G
// consecutive channels [g H, (g + 1) H), H = D / G (the JAX package vmaps
// the Pallas kernel over the groups; here the grid's x axis runs over
// G x ceil(H / channels a block) blocks, so no block straddles two groups,
// and a group's tail block masks its channels against H).  A group's B / C
// start g * b_grp elements in (0 for a tensor shared by every group).
//
// Outputs: out (B, L, D) in the input dtype, optional chunk-START states
// (B, ceil(L/128), N, D) fp32 (the state before steps 0, 128, 256, ...;
// 128 is the Pallas block_l, so they compare one-to-one with the TPU
// kernel's carries; K2 recomputes from them), and the final state (B, N, D)
// fp32.  Optional seed state x0 (B, N, D) fp32.  u, delta, z, B and C may be
// row-strided (z a slice of xz, B and C slices of x_dbl); the ragged ends of
// L and D are masked, never padded.  No atomics.
//
// What bounds it on an H100.  Every (b, l, d, n) needs one exp: at the
// flagship shape (16, 1024, 1536, 16) that is 4.0e8 exps plus 3 more
// transcendentals per (b, l, d) (softplus's exp and log1p, the gate's exp),
// 4.8e8 in all, on the special-function units: 16 per clock per SM x 132
// SMs x 1.98 GHz, so >= 0.114 ms.  The bytes (u, delta, z, out in bf16, B, C,
// the final state: 204 MB) take >= 0.061 ms at 3.35 TB/s.
//
// What held the first version (one thread a channel) back, and what this
// design does about each:
// - Too few warps: 64-thread blocks, one thread holding all 16 states of a
//   channel, about 6 warps an SM.  Here NL lanes of a warp share a channel,
//   8 states a lane (kNPT; NL = 1 ... 32 covers d_state 1 ... 256), and y is
//   a __shfl_xor_sync butterfly over the NL lanes.  The flagship runs 384
//   blocks of 64 channels x 2 lanes, all resident at once.  Measured on the
//   card, 2 lanes x 8 states beat 4 lanes x 4 (twice the warps, but more
//   instructions per state: loads, shuffles and the y store are per lane)
//   and 1 lane x 16 (too few warps).
// - The accurate expf on every state and step (about 7 FP32 instructions
//   around one MUFU op): A is pre-scaled by log2(e) once, and the decay is
//   one ex2.approx per state and step (exp2_approx).  The accurate expf also
//   ends in ex2.approx, so the error is of the same size (chip_smoke.py holds
//   it against a float64 truth, with a long-memory case).  Softplus and the
//   gate's sigmoid stay accurate (log1pf, expf) and run once per (step,
//   channel), not once per lane.
// - Serial 2-byte global loads of u, delta and z one step ahead: per chunk
//   of TC steps (TC divides 128) the whole block copies the u, delta, z
//   (TC x channels) and B, C (TC x N) tiles into shared memory with 16-byte
//   cp.async copies (8 or 4 bytes, or plain 2-byte loads, where rows are
//   less aligned), double-buffered: chunk c + 1's copy is in flight while
//   chunk c is walked.  A cooperative pre-pass turns delta into dt and dt*u
//   (fp32, 8 channels a thread) and B, C into fp32 once a chunk, so the
//   serial walk touches only shared memory and registers; it loads step
//   t+1's operands before it stores step t's y.
// - Scalar strided B/C staging with a '/' and a '%' per element: the tiles
//   above, with power-of-two tile widths.
// - 2-byte output stores per thread and step: y is collected in shared
//   memory per chunk, and a tiled epilogue applies (y + u*Dskip)*silu(z) and
//   writes the TC x channels tile with 16-byte stores.
// What holds it back now: the three blocks on an SM run their phases in
// lockstep (stage, pre-pass, epilogue, walk), so the ALU-heavy per-channel
// phases and the copies' issue do not overlap another block's walk;
// producer warps that stage and pre-pass beside the walking warps are the
// next step.  The measured times, registers and occupancy (chip_smoke.py)
// are in PERF.md.

#include "scan_common.cuh"

namespace {

using namespace zt;

constexpr int kMaxThreads = 256;
constexpr int kNPT = 8;              // states a lane
constexpr int kCarryEvery = 128;     // chunk-start state period (Pallas block_l)
constexpr int kMinChunk = 8;         // steps staged per chunk: 8 ... 64,
constexpr int kMaxChunk = 64;        // each a divisor of kCarryEvery
constexpr size_t kSmemBudget = 64 * 1024;  // per block: three blocks an SM
constexpr unsigned kFull = 0xffffffffu;

// channels a block: 64 up to 4 lanes a channel, then 256 threads a block
__host__ __device__ constexpr int channels_per_block(int nl) {
  return nl <= 4 ? 64 : kMaxThreads / nl;
}

struct Params {
  const void* u; const void* delta; const void* Bm; const void* Cm; const void* z;
  const float* A; const float* bias; const float* x0; const float* Dskip;
  void* out; float* carries; float* x_last;
  int batch, L, D, N;
  long long u_row, delta_row, b_row, c_row, z_row;  // elements between tokens
  long long b_grp, c_grp;                            // elements between groups of B, C
  int H, blocks_per_group;                           // channels a group, blocks a group
  int softplus;                                      // dt = softplus(delta + bias), or not
  int t_chunk;                                       // TC, steps a chunk
  int vec_u, vec_delta, vec_b, vec_c, vec_z;         // elements a copy
  int out_aligned;                                   // rows of out 16-byte aligned
};

// Shared memory of one block, for TC steps a chunk: fp32 dt, dt*u and y
// (TC x CPB), B and C (TC x NPAD), bias and Dskip (CPB); then two buffers of
// the staged inputs in their own type: u, delta, z (TC x CPB), B, C
// (TC x NPAD).  Every part is a multiple of 16 bytes.
__host__ __device__ constexpr size_t smem_bytes(int tc, int cpb, int npad, int elt) {
  return (size_t)(3 * tc * cpb + 2 * tc * npad + 2 * cpb) * 4 +
         2 * (size_t)(3 * tc * cpb + 2 * tc * npad) * elt;
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

template <typename E, int NL>
__global__ void __launch_bounds__(kMaxThreads) selective_scan_fwd_kernel(Params p) {
  constexpr int NPT = kNPT;
  constexpr int CPB = channels_per_block(NL);
  constexpr int NPAD = NL * NPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc = p.t_chunk;
  float* dts = reinterpret_cast<float*>(smem);
  float* dtus = dts + tc * CPB;
  float* ys = dtus + tc * CPB;
  float* Bf = ys + tc * CPB;
  float* Cf = Bf + tc * NPAD;
  float* bias_s = Cf + tc * NPAD;
  float* D_s = bias_s + CPB;
  E* raw = reinterpret_cast<E*>(D_s + CPB);
  const int raw_len = 3 * tc * CPB + 2 * tc * NPAD;  // one buffer
  const int off_delta = tc * CPB, off_z = 2 * tc * CPB, off_B = 3 * tc * CPB,
            off_C = 3 * tc * CPB + tc * NPAD;

  const int g = blockIdx.x / p.blocks_per_group;  // B / C group
  const int d0 = g * p.H + (blockIdx.x - g * p.blocks_per_group) * CPB;
  const int b = blockIdx.y;
  const int cols_ok = min(CPB, (g + 1) * p.H - d0);
  const int ch = threadIdx.x / NL;   // channel within the block
  const int sub = threadIdx.x % NL;  // which NPT states of it
  const int d = d0 + ch;
  const bool active = ch < cols_ok;
  const bool fused = p.z != nullptr;
  const long long row0 = (long long)b * p.L;

  const E* u = static_cast<const E*>(p.u);
  const E* dl = static_cast<const E*>(p.delta);
  const E* z = static_cast<const E*>(p.z);
  const E* Bm = static_cast<const E*>(p.Bm);
  const E* Cm = static_cast<const E*>(p.Cm);
  E* out = static_cast<E*>(p.out);

  auto stage = [&](int chunk) {
    const long long r0 = row0 + (long long)chunk * tc;
    const int rows_ok = min(tc, p.L - chunk * tc);
    E* buf = raw + (chunk & 1) * raw_len;
    stage_tile(buf, u + r0 * p.u_row + d0, p.u_row, tc, CPB, rows_ok, cols_ok, p.vec_u);
    stage_tile(buf + off_delta, dl + r0 * p.delta_row + d0, p.delta_row, tc, CPB, rows_ok,
               cols_ok, p.vec_delta);
    if (fused)
      stage_tile(buf + off_z, z + r0 * p.z_row + d0, p.z_row, tc, CPB, rows_ok, cols_ok,
                 p.vec_z);
    // the group's B / C, offset here (not in Bm, Cm) so that no pointer of
    // the group stays in registers over the walk
    stage_tile(buf + off_B, Bm + (r0 * p.b_row + g * p.b_grp), p.b_row, tc, NPAD, rows_ok, p.N,
               p.vec_b);
    stage_tile(buf + off_C, Cm + (r0 * p.c_row + g * p.c_grp), p.c_row, tc, NPAD, rows_ok, p.N,
               p.vec_c);
    cp_async_commit();
  };

  stage(0);
  for (int i = threadIdx.x; i < CPB; i += blockDim.x) {
    const bool ok = i < cols_ok;
    bias_s[i] = ok ? p.bias[d0 + i] : 0.f;
    D_s[i] = ok && fused ? p.Dskip[d0 + i] : 0.f;
  }
  // padded states (n >= N) and inactive channels keep A = 0, B = C = 0 and
  // x = 0: they stay 0 and add nothing
  float A2[NPT], x[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = sub * NPT + i;
    const bool ok = active && n < p.N;
    A2[i] = ok ? p.A[(size_t)d * p.N + n] * kLog2e : 0.f;
    x[i] = ok && p.x0 ? p.x0[((size_t)b * p.N + n) * p.D + d] : 0.f;
  }

  const int n_chunks = (p.L + tc - 1) / tc;
  const int n_carry = (p.L + kCarryEvery - 1) / kCarryEvery;
  // Two barriers a chunk.  Phase A of iteration c writes chunk c-1's outputs
  // (from ys and its buffer) and runs chunk c's pre-pass (from its buffer,
  // into dts, dtus, Bf, Cf); phase B stages chunk c+1 into chunk c-1's
  // buffer, then walks chunk c (from dts, dtus, Bf, Cf, into ys).
  for (int c = 0; c <= n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c staged; walk c-1 done with dts and into ys

    if (c > 0) {  // epilogue of chunk c-1: 8 channels a thread, 16-byte accesses
      const int l0 = (c - 1) * tc, tlen = min(tc, p.L - l0);
      const E* buf = raw + ((c - 1) & 1) * raw_len;
      E* orow = out + (row0 + l0) * p.D + d0;
      for (int i = threadIdx.x; i < tlen * (CPB / 8); i += blockDim.x) {
        const int k = 8 * i, r = k / CPB, c0 = k % CPB;
        float v[8];
        load8(ys + k, v);
        if (fused) {
          float uv[8], zv[8], Dv[8];
          load8(buf + k, uv);
          load8(buf + off_z + k, zv);
          load8(D_s + c0, Dv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = (v[e] + uv[e] * Dv[e]) * silu(zv[e]);
        }
        E* dst = orow + (long long)r * p.D + c0;
        if (p.out_aligned && c0 + 8 <= cols_ok) {
          store8(dst, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c0 + e < cols_ok) store(dst + e, v[e]);
        }
      }
    }
    if (c == n_chunks) break;

    const int l0 = c * tc, tlen = min(tc, p.L - l0);
    {  // pre-pass of chunk c, once per (step, channel): dt and dt*u; B, C in fp32
      const E* buf = raw + (c & 1) * raw_len;
      for (int i = threadIdx.x; i < tlen * (CPB / 8); i += blockDim.x) {
        const int k = 8 * i;  // 8 channels of one step
        float dv[8], uv[8], bv[8], dt[8], du[8];
        load8(buf + off_delta + k, dv);
        load8(buf + k, uv);
        load8(bias_s + k % CPB, bv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dt[e] = p.softplus ? softplus(dv[e] + bv[e]) : dv[e] + bv[e];
          du[e] = dt[e] * uv[e];
        }
        store8(dts + k, dt);
        store8(dtus + k, du);
      }
      for (int i = threadIdx.x; i < tlen * NPAD; i += blockDim.x) {
        Bf[i] = to_f32(buf[off_B + i]);
        Cf[i] = to_f32(buf[off_C + i]);
      }
    }
    __syncthreads();  // pre-pass done; epilogue c-1 done with ys and its buffer
    if (c + 1 < n_chunks) stage(c + 1);  // in flight while chunk c is walked

    if (p.carries && active && l0 % kCarryEvery == 0) {
      float* cr = p.carries + ((size_t)(b * n_carry + l0 / kCarryEvery) * p.N) * p.D + d;
#pragma unroll
      for (int i = 0; i < NPT; ++i)
        if (sub * NPT + i < p.N) cr[(size_t)(sub * NPT + i) * p.D] = x[i];
    }

    // the serial walk: shared memory and registers only.  Step t+1's operands
    // are loaded before step t's y is stored, so no load waits on that store.
    const float* bp = Bf + sub * NPT;
    const float* cp = Cf + sub * NPT;
    float dt_n = dts[ch], du_n = dtus[ch], b_n[NPT], c_n[NPT];
    load_states<NPT>(bp, b_n);
    load_states<NPT>(cp, c_n);
#pragma unroll 4
    for (int t = 0; t < tlen; ++t) {
      const float dt = dt_n, du = du_n;
      float bv[NPT], cv[NPT];
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        bv[i] = b_n[i];
        cv[i] = c_n[i];
      }
      const int tn = min(t + 1, tlen - 1);
      dt_n = dts[tn * CPB + ch];
      du_n = dtus[tn * CPB + ch];
      load_states<NPT>(bp + tn * NPAD, b_n);
      load_states<NPT>(cp + tn * NPAD, c_n);
      float y = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        x[i] = fmaf(exp2_approx(dt * A2[i]), x[i], du * bv[i]);
        y = fmaf(cv[i], x[i], y);
      }
#pragma unroll
      for (int off = NL / 2; off > 0; off >>= 1) y += __shfl_xor_sync(kFull, y, off);
      if (sub == 0) ys[t * CPB + ch] = y;
    }
  }

  if (p.x_last && active) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int n = sub * NPT + i;
      if (n < p.N) p.x_last[((size_t)b * p.N + n) * p.D + d] = x[i];
    }
  }
}

struct Config {
  int nl, cpb, threads, t_chunk;
  size_t smem;
  const void* fn;
};

template <typename E>
const void* kernel_for(int nl) {
  switch (nl) {
    case 1: return reinterpret_cast<const void*>(selective_scan_fwd_kernel<E, 1>);
    case 2: return reinterpret_cast<const void*>(selective_scan_fwd_kernel<E, 2>);
    case 4: return reinterpret_cast<const void*>(selective_scan_fwd_kernel<E, 4>);
    case 8: return reinterpret_cast<const void*>(selective_scan_fwd_kernel<E, 8>);
    case 16: return reinterpret_cast<const void*>(selective_scan_fwd_kernel<E, 16>);
    case 32: return reinterpret_cast<const void*>(selective_scan_fwd_kernel<E, 32>);
  }
  return nullptr;
}

// The launch shape for d_state N and length L: NL lanes a channel (kNPT
// states each), CPB channels a block, and the longest chunk (8 ... 64 steps, no
// longer than L needs) whose shared memory fits the budget.  Also allows
// the kernel that much dynamic shared memory.
int pick(int N, int L, int dtype, Config* c) {
  if (N < 1 || N > 256 || L < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  c->nl = 1;
  while (c->nl * kNPT < N) c->nl *= 2;
  c->cpb = channels_per_block(c->nl);
  c->threads = c->cpb * c->nl;
  const int elt = dtype == 0 ? 4 : 2;
  const int npad = c->nl * kNPT;
  c->t_chunk = kMinChunk;
  while (c->t_chunk < kMaxChunk && c->t_chunk < L &&
         smem_bytes(2 * c->t_chunk, c->cpb, npad, elt) <= kSmemBudget)
    c->t_chunk *= 2;
  c->smem = smem_bytes(c->t_chunk, c->cpb, npad, elt);
  c->fn = dtype == 0 ? kernel_for<float>(c->nl) : kernel_for<__nv_bfloat16>(c->nl);
  return (int)cudaFuncSetAttribute(c->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemBudget);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (u, delta, B, C, z and out share it).
// x0, Dskip/z, carries and x_last may be null.  G groups of B / C (G divides
// D; 1 for (B, L, N)), group g's B at Bm + g * b_grp.  softplus: 1 for
// dt = softplus(delta + bias), 0 for dt = delta + bias.  Any batch: more
// than kMaxGridY sequences are launched in slices of that many.  Returns
// the first failing launch's cudaGetLastError().
extern "C" int zt_selective_scan_fwd(
    const void* u, const void* delta, const float* A, const float* bias,
    const void* Bm, const void* Cm, const float* x0, const float* Dskip,
    const void* z, void* out, float* carries, float* x_last,
    int batch, int L, int D, int N,
    long long u_row, long long delta_row, long long b_row, long long c_row,
    long long z_row, long long b_grp, long long c_grp, int G, int softplus,
    int dtype, void* stream) {
  if (D < 1 || batch < 1 || G < 1 || D % G != 0) return (int)cudaErrorInvalidValue;
  Config c;
  int err = pick(N, L, dtype, &c);
  if (err != 0) return err;
  const int elt = dtype == 0 ? 4 : 2;
  const int npad = c.nl * kNPT;
  const long long n_carry = (L + kCarryEvery - 1) / kCarryEvery;
  const int H = D / G, per_group = (H + c.cpb - 1) / c.cpb;
  // a block's channels start at a multiple of H (and of the channels a
  // block), its B / C at a multiple of b_grp / c_grp: with one group, at
  // multiples of the channels a block only
  const long long off = G > 1 ? H : 0, bg = G > 1 ? b_grp : 0, cg = G > 1 ? c_grp : 0;
  // the copy widths of the first slice hold for every slice: each is
  // advanced by whole rows
  Params p{u, delta, Bm, Cm, z, A, bias, x0, Dskip, out, carries, x_last,
           batch, L, D, N, u_row, delta_row, b_row, c_row, z_row, bg, cg, H, per_group,
           softplus != 0, c.t_chunk,
           vec_elems(u, u_row, elt, c.cpb, off), vec_elems(delta, delta_row, elt, c.cpb, off),
           vec_elems(Bm, b_row, elt, npad, bg), vec_elems(Cm, c_row, elt, npad, cg),
           z ? vec_elems(z, z_row, elt, c.cpb, off) : 1,
           vec_elems(out, D, elt, 8, off) * elt == 16};
  for (int b0 = 0; b0 < batch; b0 += kMaxGridY) {
    const long long rows = (long long)b0 * L, states = (long long)b0 * N * D;
    Params q = p;
    q.batch = batch - b0 < kMaxGridY ? batch - b0 : kMaxGridY;
    q.u = advance(u, rows * u_row, elt);
    q.delta = advance(delta, rows * delta_row, elt);
    q.Bm = advance(Bm, rows * b_row, elt);
    q.Cm = advance(Cm, rows * c_row, elt);
    q.z = advance(z, rows * z_row, elt);
    q.out = advance(out, rows * D, elt);
    q.x0 = advance(x0, states, 4);
    q.carries = advance(carries, n_carry * states, 4);
    q.x_last = advance(x_last, states, 4);
    void* args[] = {&q};
    dim3 grid(G * per_group, q.batch);
    err = (int)cudaLaunchKernel(c.fn, grid, dim3(c.threads), args, c.smem,
                                static_cast<cudaStream_t>(stream));
    const int last = (int)cudaGetLastError();
    if (err != 0 || last != 0) return err != 0 ? err : last;
  }
  return 0;
}

// The launch shape and occupancy of the kernel instance for (N, L, dtype):
// info = {registers a thread, spill (local) bytes a thread, resident blocks
// an SM, threads a block, channels a block, steps a chunk, dynamic shared
// bytes a block}.
extern "C" int zt_selective_scan_fwd_info(int N, int L, int dtype, int* info) {
  Config c;
  int err = pick(N, L, dtype, &c);
  if (err != 0) return err;
  cudaFuncAttributes a;
  err = (int)cudaFuncGetAttributes(&a, c.fn);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.fn, c.threads, c.smem);
  if (err != 0) return err;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = blocks;
  info[3] = c.threads;
  info[4] = c.cpb;
  info[5] = c.t_chunk;
  info[6] = (int)c.smem;
  return 0;
}
