// Selective-scan forward for Hopper (sm_90a), bound through a plain C entry
// point and loaded with ctypes by zigma_tpu_torch/ops/scan_cuda.py.
//
// Replaces the TPU kernel zigma_tpu/ops/scan_pallas.py::_scan_kernel
// (launched by scan_core_fwd_pallas).  Per (batch b, channel d):
//
//   dt_t = softplus(delta_t + bias)          (dt_t kept as-is above 20)
//   x_t  = exp(dt_t * A) * x_{t-1} + dt_t * u_t * B_t      state (N,), fp32
//   y_t  = sum_n C_t[n] * x_t[n]
//   out  = y                                  or, fused,
//   out  = (y + u_t * Dskip) * silu(z_t)
//
// Outputs: out (B, L, D) in the input dtype, optional chunk-START states
// (B, ceil(L/128), N, D) fp32 (the state before steps 0, 128, 256, ...;
// 128 is the Pallas block_l, so they compare one-to-one with the TPU
// kernel's carries), and the final state (B, N, D) fp32.
//
// Design.  The TPU kernel carries the state across a sequential grid in
// VMEM scratch.  Blocks on Hopper run in no order, so here the whole L loop
// lives inside one block and the state never leaves registers.  One block
// covers (batch, a slab of channels); threads map to channels, so the loads
// of u, delta and z and the store of out are coalesced along D.  B_t / C_t
// are shared by every channel of a batch row: each block stages a chunk of
// them in shared memory as fp32.  N is split across NL lanes of one warp
// (NPT = 16 states per lane, NL in {1,2,4,8,16}, so d_state <= 256 fits in
// registers) and y is reduced over those lanes with __shfl_xor_sync.  The
// ragged tail of L is masked, never padded.  expf / log1pf are the accurate
// library versions.
//
// What bounds it on an H100.  Every (b, l, d, n) needs one exp: at the
// flagship shape (16, 1024, 1536, 16) that is 4.0e8 exps plus 3 more
// transcendentals per (b, l, d) (softplus exp + log1p, the silu gate), about
// 4.8e8 in all, on the special-function units: 16 per clock per SM x 132
// SMs x ~1.98 GHz = 4.2e12 per second, so >= 0.115 ms.  The bytes it must
// move in bf16 with the fused gate are u, delta, z, out (4 x 50.3 MB) plus
// B, C and the final state, about 204 MB, >= 0.061 ms at 3.35 TB/s.  So the
// special-function unit, not memory, bounds it; the accurate expf also costs
// ~7 FP32 instructions around its MUFU op, so issue slots are the next limit.
// What the design does about it: every exp feeds one state update that stays
// in registers, and B/C are converted to fp32 once per block in shared
// memory, so no instruction goes to re-reading or re-converting operands.
// This first version keeps the math simple and right.  At the flagship shape
// it launches only 384 blocks of 64 threads (one thread per channel, 16
// states each): about 6 warps per SM, too few to hide the latency of the
// serial exp -> FMA chain, so it runs well above that bound (the measured
// times, from chip_smoke.py, are in PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;       // threads per block
constexpr int kNPT = 16;           // states per thread
constexpr int kCarryEvery = 128;   // chunk-start state period (Pallas block_l)
constexpr int kSmemFloats = 4096;  // per staged array (B or C): 16 KB each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const void* u; const void* delta; const float* A; const float* bias;
  const void* Bm; const void* Cm; const float* x0; const float* Dskip;
  const void* z;
  void* out; float* carries; float* x_last;
  int batch, L, D, N;
  long long u_row, delta_row, b_row, c_row, z_row;  // elements between tokens
  int nl;       // lanes per channel
  int t_chunk;  // steps of B/C staged per pass (divides kCarryEvery)
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(Params p) {
  __shared__ float Bs[kSmemFloats];
  __shared__ float Cs[kSmemFloats];

  const int nl = p.nl;
  const int npad = nl * kNPT;
  const int sub = threadIdx.x % nl;                  // which slice of N
  const int ch_per_block = kThreads / nl;
  const int d = blockIdx.x * ch_per_block + threadIdx.x / nl;
  const int b = blockIdx.y;
  const bool active = d < p.D;
  const int n0 = sub * kNPT;

  const T* u = static_cast<const T*>(p.u);
  const T* dl = static_cast<const T*>(p.delta);
  const T* Bm = static_cast<const T*>(p.Bm);
  const T* Cm = static_cast<const T*>(p.Cm);
  const T* z = static_cast<const T*>(p.z);
  T* out = static_cast<T*>(p.out);
  const bool fused = z != nullptr;

  float A[kNPT], x[kNPT];
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    const int n = n0 + i;
    const bool ok = active && n < p.N;
    // padded states keep A = 0 and B = C = 0: they stay 0 and add nothing
    A[i] = ok ? p.A[(size_t)d * p.N + n] : 0.f;
    x[i] = (ok && p.x0) ? p.x0[((size_t)b * p.N + n) * p.D + d] : 0.f;
  }
  const float bias = active ? p.bias[d] : 0.f;
  const float Dd = (active && fused) ? p.Dskip[d] : 0.f;

  const size_t row0 = (size_t)b * p.L;
  const int n_carry = (p.L + kCarryEvery - 1) / kCarryEvery;

  for (int l0 = 0; l0 < p.L; l0 += p.t_chunk) {
    const int tlen = min(p.t_chunk, p.L - l0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < p.t_chunk * npad; i += kThreads) {
      const int t = i / npad, n = i % npad;
      const bool ok = t < tlen && n < p.N;
      const size_t r = row0 + l0 + t;
      Bs[i] = ok ? to_f32(Bm[r * p.b_row + n]) : 0.f;
      Cs[i] = ok ? to_f32(Cm[r * p.c_row + n]) : 0.f;
    }
    __syncthreads();

    if (p.carries && active && l0 % kCarryEvery == 0) {
      float* c = p.carries + (((size_t)b * n_carry + l0 / kCarryEvery) * p.N) * p.D + d;
#pragma unroll
      for (int i = 0; i < kNPT; ++i)
        if (n0 + i < p.N) c[(size_t)(n0 + i) * p.D] = x[i];
    }

    // register prefetch of the next step's per-channel inputs
    float u_nx = 0.f, d_nx = 0.f, z_nx = 0.f;
    if (active) {
      const size_t r = row0 + l0;
      u_nx = to_f32(u[r * p.u_row + d]);
      d_nx = to_f32(dl[r * p.delta_row + d]);
      if (fused) z_nx = to_f32(z[r * p.z_row + d]);
    }
    for (int t = 0; t < tlen; ++t) {
      const float uu = u_nx, zz = z_nx;
      float dt = d_nx + bias;
      if (active && t + 1 < tlen) {
        const size_t r = row0 + l0 + t + 1;
        u_nx = to_f32(u[r * p.u_row + d]);
        d_nx = to_f32(dl[r * p.delta_row + d]);
        if (fused) z_nx = to_f32(z[r * p.z_row + d]);
      }
      dt = dt <= 20.f ? log1pf(expf(dt)) : dt;
      const float du = dt * uu;
      const float* bs = Bs + t * npad + n0;
      const float* cs = Cs + t * npad + n0;
      float y = 0.f;
#pragma unroll
      for (int i = 0; i < kNPT; ++i) {
        x[i] = expf(dt * A[i]) * x[i] + du * bs[i];
        y += cs[i] * x[i];
      }
      for (int off = nl >> 1; off > 0; off >>= 1)
        y += __shfl_xor_sync(0xffffffffu, y, off);
      if (active && sub == 0) {
        if (fused) y = (y + uu * Dd) * (zz / (1.f + expf(-zz)));
        store(out + (row0 + l0 + t) * p.D + d, y);
      }
    }
  }

  if (p.x_last && active) {
#pragma unroll
    for (int i = 0; i < kNPT; ++i)
      if (n0 + i < p.N) p.x_last[((size_t)b * p.N + n0 + i) * p.D + d] = x[i];
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (u, delta, B, C, z and out share it).
// x0, Dskip/z, carries and x_last may be null.  Returns cudaGetLastError().
extern "C" int zt_selective_scan_fwd(
    const void* u, const void* delta, const float* A, const float* bias,
    const void* Bm, const void* Cm, const float* x0, const float* Dskip,
    const void* z, void* out, float* carries, float* x_last,
    int batch, int L, int D, int N,
    long long u_row, long long delta_row, long long b_row, long long c_row,
    long long z_row, int dtype, void* stream) {
  if (N < 1 || N > 256 || L < 1 || D < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  int nl = 1;
  while (nl * kNPT < N) nl *= 2;
  Params p{u, delta, A, bias, Bm, Cm, x0, Dskip, z, out, carries, x_last,
           batch, L, D, N, u_row, delta_row, b_row, c_row, z_row, nl, 0};
  p.t_chunk = kCarryEvery;
  while (p.t_chunk * nl * kNPT > kSmemFloats) p.t_chunk /= 2;
  const int ch_per_block = kThreads / nl;
  dim3 grid((D + ch_per_block - 1) / ch_per_block, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    selective_scan_fwd_kernel<float><<<grid, kThreads, 0, s>>>(p);
  else if (dtype == 1)
    selective_scan_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
