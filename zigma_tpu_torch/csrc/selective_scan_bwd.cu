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
// per-d-block dB / dC partials (B, nD, L, N) fp32; per-batch dA partials and
// dx0 (B, N, D) fp32; per-batch dD partials (B, D) fp32.  The wrapper sums
// the partials with torch.sum, as scan_core_bwd_pallas does with jnp.sum.
//
// Design.  The TPU kernel walks a sequential grid of chunks in reverse and
// carries the adjoint in VMEM; blocks on Hopper run in no order, so here one
// block owns (batch row, a slab of channels) and walks all of L in reverse
// itself: the adjoint g of each state stays in registers from the last step
// to the first.  A thread holds NPT states of one channel (NPT = 4 for
// d_state <= 128, 8 up to 256); NL lanes of a warp share a channel, and the
// sums over N (<g, B>, <dla, A>, y) are butterflies over those lanes.
//
// The reverse walk needs x_{t-1} at every step.  Running the recurrence
// backwards would divide by exp(dt A), which underflows (A = -16, dt ~ 5), so
// the states are recomputed forward instead, in two levels: for each
// 128-step chunk (from its carry) a first pass stores the state at the start
// of every KS-step sub-chunk in shared memory; then, sub-chunk by sub-chunk
// from the last, KS steps are recomputed into registers (the states and their
// decays, KS * NPT = 32 values each, fully unrolled) and walked in reverse.
// Two exps per state and step in all; the decays are not recomputed.
//
// dB and dC reduce over D inside the block: a reduce-scatter over the
// channel lanes of a warp (each shuffle halves the values a lane carries, so
// 2*NPT values over 8 channels take 7 shuffles, not 24), then a fixed-order
// sum over the block's warps through shared memory, once per sub-chunk.  dA
// and dD accumulate in registers over the block's whole walk.  The ragged
// tail of L is masked (uniform branches), never padded.
//
// What bounds it on an H100.  At the flagship shape (16, 1024, 1536, 16),
// bf16, fused, the least time for the function is set by operations: the
// fp32 work (the JAX cost estimate, 25 B L D N = 10.1 GFLOP, 0.150 ms at
// 67 TFLOP/s) ahead of the special-function units (one exp per state and
// step plus four per channel and step, 5.0e8, 0.120 ms) and the bytes (the
// inputs read and the gradients written once, 369 MB, 0.110 ms at
// 3.35 TB/s).  This kernel does more than that: two exps per state and step,
// the per-channel softplus / sigmoids once in each of its three passes and
// on each of a channel's NL lanes, and the dB / dC partials (100 MB more).
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W): 6.18 ms at that
// shape, 41x the 0.150 ms bound.  ptxas gives the flagship instance
// (bf16, NPT 4, NL 4) 194 registers and no spills, so two 128-thread blocks
// (8 warps) fit on an SM: too few to hide the latency of the exp -> FMA
// chains and the shuffles; by instruction count the warp schedulers alone
// would allow about 1 ms.  This first version keeps the math simple and
// right; the times are in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // threads per block
constexpr int kCarryEvery = 128;   // chunk-start state period (Pallas block_l)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* u; const void* delta; const float* A; const float* bias;
  const void* Bm; const void* Cm; const float* carries; const void* gy;
  const float* g_last; const float* Dskip; const void* z;
  void* du; void* ddelta; void* dz;
  float* dBp; float* dCp; float* dAp; float* dx0; float* dDp;
  int batch, L, D, N;
  long long u_row, delta_row, b_row, c_row, z_row;  // elements between tokens
};

// sum over the NL lanes that share a channel (every lane gets the total)
template <int NL>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < NL; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// dt = softplus(delta + bias) (kept as-is above 20) and its derivative
__device__ __forceinline__ void softplus_fwd(float pre, float& dt, float& sig) {
  dt = pre <= 20.f ? log1pf(expf(pre)) : pre;
  sig = 1.f / (1.f + expf(-pre));
}

template <typename T, int NPT, int NL>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(Params p) {
  constexpr int KS = 32 / NPT;              // steps per register sub-chunk
  constexpr int NSUB = kCarryEvery / KS;    // sub-chunks per chunk
  constexpr int CH = kThreads / NL;         // channels per block
  constexpr int NPAD = NL * NPT;            // padded d_state
  constexpr int NWARPS = kThreads / 32;
  constexpr int V = 2 * NPT;                // dB and dC values per lane and step
  extern __shared__ float smem[];
  float* ck = smem;                          // [NSUB][NPT][kThreads]
  float* red = smem + NSUB * NPT * kThreads; // [NWARPS][KS][2 * NPAD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % NL;
  const int d = blockIdx.x * CH + tid / NL;
  const int b = blockIdx.y;
  const int nD = gridDim.x;
  const bool active = d < p.D;
  const int n0 = sub * NPT;
  const int N = p.N, L = p.L, Dm = p.D;

  const T* u = static_cast<const T*>(p.u);
  const T* dl = static_cast<const T*>(p.delta);
  const T* Bm = static_cast<const T*>(p.Bm);
  const T* Cm = static_cast<const T*>(p.Cm);
  const T* gy = static_cast<const T*>(p.gy);
  const T* z = static_cast<const T*>(p.z);
  const bool fused = z != nullptr;

  float A[NPT], c[NPT], dA[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = n0 + i;
    const bool ok = active && n < N;
    // padded states keep A = 0 and B = C = 0: their x and g stay 0
    A[i] = ok ? p.A[(size_t)d * N + n] : 0.f;
    c[i] = (ok && p.g_last) ? p.g_last[((size_t)b * N + n) * Dm + d] : 0.f;
    dA[i] = 0.f;
  }
  const float bias = active ? p.bias[d] : 0.f;
  const float Dd = (active && fused) ? p.Dskip[d] : 0.f;
  float dD = 0.f;

  const size_t row0 = (size_t)b * L;
  const int n_chunks = (L + kCarryEvery - 1) / kCarryEvery;

  // per-step loads; inactive channels and padded states read as 0
  auto load_b = [&](const T* M, long long row, int l, float (&out)[NPT]) {
#pragma unroll
    for (int i = 0; i < NPT; ++i)
      out[i] = (n0 + i < N) ? to_f32(M[(row0 + l) * row + n0 + i]) : 0.f;
  };
  auto load_ch = [&](const T* M, long long row, int l) {
    return active ? to_f32(M[(row0 + l) * row + d]) : 0.f;
  };

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int l0 = k * kCarryEvery;
    const int clen = min(kCarryEvery, L - l0);

    // 1. forward from the chunk's carry: the state at each sub-chunk start
    float x[NPT];
#pragma unroll
    for (int i = 0; i < NPT; ++i)
      x[i] = (active && n0 + i < N)
          ? p.carries[(((size_t)b * n_chunks + k) * N + n0 + i) * Dm + d] : 0.f;
#pragma unroll 1
    for (int s = 0; s * KS < clen; ++s) {
#pragma unroll
      for (int i = 0; i < NPT; ++i) ck[(s * NPT + i) * kThreads + tid] = x[i];
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int l = l0 + s * KS + j;
        if (l - l0 < clen) {
          float dt, sig, Bv[NPT];
          softplus_fwd(load_ch(dl, p.delta_row, l) + bias, dt, sig);
          const float dtu = dt * load_ch(u, p.u_row, l);
          load_b(Bm, p.b_row, l, Bv);
#pragma unroll
          for (int i = 0; i < NPT; ++i) x[i] = expf(dt * A[i]) * x[i] + dtu * Bv[i];
        }
      }
    }

    // 2. sub-chunks from the last: recompute into registers, walk in reverse
#pragma unroll 1
    for (int s = (clen - 1) / KS; s >= 0; --s) {
      float xs[KS + 1][NPT], dec[KS][NPT];
#pragma unroll
      for (int i = 0; i < NPT; ++i) xs[0][i] = ck[(s * NPT + i) * kThreads + tid];
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int l = l0 + s * KS + j;
        if (l - l0 < clen) {
          float dt, sig, Bv[NPT];
          softplus_fwd(load_ch(dl, p.delta_row, l) + bias, dt, sig);
          const float dtu = dt * load_ch(u, p.u_row, l);
          load_b(Bm, p.b_row, l, Bv);
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            dec[j][i] = expf(dt * A[i]);
            xs[j + 1][i] = dec[j][i] * xs[j][i] + dtu * Bv[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < NPT; ++i) { dec[j][i] = 1.f; xs[j + 1][i] = xs[j][i]; }
        }
      }

#pragma unroll
      for (int j = KS - 1; j >= 0; --j) {
        const int l = l0 + s * KS + j;
        float v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.f;
        if (l - l0 < clen) {
          float dt, sig, Bv[NPT], Cv[NPT];
          softplus_fwd(load_ch(dl, p.delta_row, l) + bias, dt, sig);
          const float uu = load_ch(u, p.u_row, l);
          const float g_out = load_ch(gy, Dm, l);
          const float zz = fused ? load_ch(z, p.z_row, l) : 0.f;
          const float sig_z = 1.f / (1.f + expf(-zz));
          const float gyr = fused ? g_out * zz * sig_z : g_out;
          const float dtu = dt * uu;
          load_b(Bm, p.b_row, l, Bv);
          load_b(Cm, p.c_row, l, Cv);
          float gB = 0.f, sdla = 0.f, y = 0.f;
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            const float g = gyr * Cv[i] + c[i];
            const float dla = g * dec[j][i] * xs[j][i];
            gB += g * Bv[i];
            sdla += dla * A[i];
            y += Cv[i] * xs[j + 1][i];
            dA[i] += dla * dt;
            v[i] = g * dtu;
            v[NPT + i] = gyr * xs[j + 1][i];
            c[i] = dec[j][i] * g;
          }
          gB = lane_sum<NL>(gB);
          sdla = lane_sum<NL>(sdla);
          if (fused) y = lane_sum<NL>(y);
          if (active && sub == 0) {
            const size_t o = (row0 + l) * Dm + d;
            float du = dt * gB;
            if (fused) {
              du += gyr * Dd;
              store(static_cast<T*>(p.dz) + o,
                    g_out * (y + uu * Dd) * (sig_z * (1.f + zz * (1.f - sig_z))));
              dD += gyr * uu;
            }
            store(static_cast<T*>(p.du) + o, du);
            store(static_cast<T*>(p.ddelta) + o, (sdla + gB * uu) * sig);
          }
        }

        // reduce-scatter v over the warp's channel lanes (lane bits NL..16):
        // each level halves the values a lane carries; once one is left,
        // plain butterflies, and only the lane with those bits 0 writes
        int base = 0;
        bool writer = true;
        int nv = V;
#pragma unroll
        for (int o = NL; o < 32; o <<= 1) {
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
        if (writer) {
          float* r = red + (warp * KS + j) * 2 * NPAD;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if (i < nv) {
              const int idx = base + i;  // which (dB 0 / dC 1) * NPT + state
              r[(idx / NPT) * NPAD + sub * NPT + idx % NPT] = v[i];
            }
          }
        }
      }
      __syncthreads();
      // the block's dB / dC partials for this sub-chunk, warps summed in order
      for (int e = tid; e < KS * 2 * NPAD; e += kThreads) {
        const int j = e / (2 * NPAD), rr = e % (2 * NPAD);
        const int n = rr % NPAD, l = l0 + s * KS + j;
        if (l - l0 < clen && n < N) {
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < NWARPS; ++w) acc += red[(w * KS + j) * 2 * NPAD + rr];
          float* out = rr < NPAD ? p.dBp : p.dCp;
          out[(((size_t)b * nD + blockIdx.x) * L + l) * N + n] = acc;
        }
      }
      __syncthreads();
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      if (n0 + i < N) {
        const size_t o = ((size_t)b * N + n0 + i) * Dm + d;
        p.dAp[o] = dA[i];
        p.dx0[o] = c[i];
      }
    }
    if (fused && sub == 0) p.dDp[(size_t)b * Dm + d] = dD;
  }
}

// lanes per channel: NPT = 4 states a lane up to d_state 128 (at least 4
// lanes), NPT = 8 above
int lanes_for(int N) {
  if (N > 128) return 32;
  int nl = 4;
  while (nl * 4 < N) nl *= 2;
  return nl;
}

template <typename T, int NPT, int NL>
int launch(const Params& p, cudaStream_t s) {
  constexpr int KS = 32 / NPT;
  const size_t smem = sizeof(float) *
      ((size_t)(kCarryEvery / KS) * NPT * kThreads + (kThreads / 32) * KS * 2 * NL * NPT);
  auto kern = selective_scan_bwd_kernel<T, NPT, NL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.D + kThreads / NL - 1) / (kThreads / NL), p.batch);
  kern<<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t s) {
  switch (lanes_for(p.N)) {
    case 4: return launch<T, 4, 4>(p, s);
    case 8: return launch<T, 4, 8>(p, s);
    case 16: return launch<T, 4, 16>(p, s);
    default: return p.N <= 128 ? launch<T, 4, 32>(p, s) : launch<T, 8, 32>(p, s);
  }
}

}  // namespace

// Channels one block covers for a given d_state: the wrapper allocates the
// dB / dC partials as (batch, ceil(D / this), L, N).
extern "C" int zt_selective_scan_bwd_channels_per_block(int N) {
  return kThreads / lanes_for(N);
}

// dtype: 0 = float32, 1 = bfloat16 (u, delta, B, C, gy, z, du, ddelta and dz
// share it).  g_last and Dskip/z/dz/dDp may be null (no fused gate).  gy, du,
// ddelta, dz and every fp32 tensor are contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int zt_selective_scan_bwd(
    const void* u, const void* delta, const float* A, const float* bias,
    const void* Bm, const void* Cm, const float* carries, const void* gy,
    const float* g_last, const float* Dskip, const void* z,
    void* du, void* ddelta, void* dz, float* dBp, float* dCp, float* dAp,
    float* dx0, float* dDp,
    int batch, int L, int D, int N,
    long long u_row, long long delta_row, long long b_row, long long c_row,
    long long z_row, int dtype, void* stream) {
  if (N < 1 || N > 256 || L < 1 || D < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  if ((Dskip == nullptr) != (z == nullptr) || (z != nullptr && (dz == nullptr || dDp == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{u, delta, A, bias, Bm, Cm, carries, gy, g_last, Dskip, z,
           du, ddelta, dz, dBp, dCp, dAp, dx0, dDp,
           batch, L, D, N, u_row, delta_row, b_row, c_row, z_row};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
