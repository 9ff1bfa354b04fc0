// Helpers of the selective-scan kernels: the input types, the decay's
// exponential on the special-function unit, the per-channel softplus and
// gate, the asynchronous staging of a (tokens x channels) tile of a strided
// tensor into shared memory, and (host side) the width of its copies and the
// slicing of a batch past the grid's limit.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace zt {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* p) { *p = __float2bfloat16(0.f); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  unsigned r;
  memcpy(&r, &h, sizeof(r));
  return r;
}

// 8 consecutive values to fp32, and 8 fp32 values stored (as fp32, or as
// bf16 rounded to nearest even like __float2bfloat16 and torch's
// .to(bfloat16)), as 16-byte accesses: p is 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the top half of an fp32
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// 4 consecutive values to fp32, and 4 fp32 values stored, as 16-byte (fp32)
// or 8-byte (bf16) accesses: p is aligned to that
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(w.x << 16); v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16); v[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// 2^v as one MUFU.EX2 instruction (ex2.approx: at most 2 ulp; results below
// 2^-126 flush to 0).  exp(dt * A) is exp2_approx(dt * (A * log2(e))).
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// softplus with torch's (and the JAX kernel's) threshold: identity above 20
__device__ __forceinline__ float softplus(float v) { return v <= 20.f ? log1pf(expf(v)) : v; }
// v * sigmoid(v), the reciprocal correctly rounded (__frcp_rn)
__device__ __forceinline__ float silu(float v) { return v * __frcp_rn(1.f + expf(-v)); }

// cp.async of `bytes` (4, 8 or 16, the alignment of dst and src) from global
// to shared memory; reads the first `src_bytes` (0..bytes), zero-fills the rest
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage a rows x cols tile into shared memory s (row-major, leading dimension
// cols) from g, the tile's first element in a tensor whose rows lie `row`
// elements apart.  Rows from rows_ok on and columns from cols_ok on are
// zero.  The whole block takes part; each copy moves `vec` elements (cols
// and vec powers of two, vec <= cols): as cp.async when that is 4 bytes or
// more (the caller checked that g and the row pitch are aligned to it),
// else -- rows only 2-byte aligned -- as a plain load and store.  The caller
// commits and waits.
template <typename E>
__device__ __forceinline__ void stage_tile(E* s, const E* g, long long row, int rows, int cols,
                                           int rows_ok, int cols_ok, int vec) {
  const int per_row = cols / vec;  // a power of two, as cols and vec are
  const int shift = __ffs(per_row) - 1;
  const int bytes = vec * static_cast<int>(sizeof(E));
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i >> shift, c = (i & (per_row - 1)) * vec;
    const int ok = r < rows_ok ? max(0, min(vec, cols_ok - c)) : 0;
    E* dst = s + r * cols + c;
    const E* src = ok > 0 ? g + r * row + c : g;  // nothing is read when ok == 0
    if (bytes >= 4)
      cp_async(dst, src, bytes, ok * static_cast<int>(sizeof(E)));
    else if (ok > 0)
      *dst = *src;
    else
      set_zero(dst);
  }
}

// Host side: elements a copy for rows starting at p + k * off (the blocks'
// offsets past the channels a block covers: a group's first channel, or its
// slice of grouped B / C), `row` elements apart: the widest of 16, 8, 4
// bytes (or one element) all are aligned to, at most `cols`
inline int vec_elems(const void* p, long long row, int elt, int cols, long long off = 0) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(row * elt) |
                      static_cast<uintptr_t>(off * elt);
  int bytes = 16;
  while (bytes > elt && a % bytes != 0) bytes >>= 1;
  return bytes / elt < cols ? bytes / elt : cols;
}

// Host side: CUDA's limit on gridDim.y, where both kernels put the batch.
// Their entry points launch a larger batch in slices of at most this many
// sequences, each slice's pointers advanced past the sequences before it.
constexpr int kMaxGridY = 65535;

// Host side: p advanced by `elems` elements of `elt` bytes (null stays null)
template <typename T>
inline T* advance(T* p, long long elems, int elt) {
  if (p == nullptr) return p;
  using Byte = typename std::conditional<std::is_const<T>::value, const char, char>::type;
  return reinterpret_cast<T*>(reinterpret_cast<Byte*>(p) + elems * elt);
}

}  // namespace zt
