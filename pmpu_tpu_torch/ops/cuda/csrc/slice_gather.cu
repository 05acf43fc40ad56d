// Plane gather + per-plane max normalization for Hopper (sm_90a).
//
// Replaces the TPU kernel pmpu_tpu/ops/pallas/slice_gather.py::_pallas_gather_planes
// (pallas_call at :70, body _kernel :40). For each output b it reads plane
// ids[b] of a (P, S, S) stack, divides it by its own max (by 1 when the max
// is 0) and copies the matching label plane when labels are given:
//
//   img_out[b] = img[ids[b]] / (m == 0 ? 1 : m),  m = max(img[ids[b]])
//   lbl_out[b] = lbl[ids[b]]
//
// The division is IEEE division (__fdiv_rn, not a multiply by the
// reciprocal), as in the JAX package, so the result is bit-equal to it; a
// zero is passed through as the division would give it (div_scale). The
// max propagates NaN, as jnp.max does. An id outside [0, P) yields a NaN
// image plane and a -1 label plane instead of reading out of bounds.
//
// What bounds it on this card: bytes (one read and one write of every
// element, a couple of operations each). One 256-thread block per output
// plane. A plane of up to kFastMax floats whose size is a multiple of 4
// (128² on the inference path) is read once: each thread holds its share,
// up to 16 float4, in registers, loaded with 16-byte loads that are all in
// flight together; the NaN-propagating max is reduced by shuffles and then
// across warps in shared memory; each register is divided by the
// block-uniform scale and leaves through 16-byte stores. Three blocks fit an
// SM (at most 85 registers a thread), so the 384 planes of a 3-view slab
// are resident in one wave on 132 SMs. Labels are copied 16 bytes at a time.
// Other planes (a size not a multiple of 4, larger than kFastMax, or
// pointers not 16-byte aligned) take the general path of the same kernel: a
// read for the max, then a second read, from L2, to divide and write.
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.0208 ms for the 384
// planes of 128² of a 3-view slab, 72 % of its 0.0150 ms bound; 0.0400 ms
// for the 768 of a 6-view one, 75 % of 0.0301 ms. The exact zeros of those
// slabs pass through div_scale, not __fdiv_rn's slow path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;                           // float4 a thread on the fast path
constexpr int kFastMax = kThreads * kVec * 4;      // floats: 16384 = 128²

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// x / scale as __fdiv_rn gives it. A plane holding a zero has a max of at
// least 0, so its scale is positive or NaN, and a zero x divides to itself:
// returned directly, it skips __fdiv_rn's slow path, which every zero takes.
__device__ __forceinline__ float div_scale(float x, float scale) {
  return x == 0.f && scale == scale ? x : __fdiv_rn(x, scale);
}

// The block's NaN-propagating max of each thread's m.
__device__ __forceinline__ float block_max(float m, float* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) warp_max[kThreads / 32] = m;
  }
  __syncthreads();
  return warp_max[kThreads / 32];
}

__global__ void __launch_bounds__(kThreads, 3)
gather_normalize_kernel(const float* __restrict__ img, const int32_t* __restrict__ lbl,
                        const int64_t* __restrict__ ids, float* __restrict__ img_out,
                        int32_t* __restrict__ lbl_out, int plane, int64_t n_planes, bool fast) {
  __shared__ float warp_max[kThreads / 32 + 1];
  const int64_t b = blockIdx.x;
  const int64_t id = ids[b];
  float* dst = img_out + b * plane;
  int32_t* ldst = lbl_out ? lbl_out + b * plane : nullptr;
  const int t = threadIdx.x;
  if (id < 0 || id >= n_planes) {
    const float nan = __int_as_float(0x7fc00000);
    for (int i = t; i < plane; i += kThreads) {
      dst[i] = nan;
      if (ldst) ldst[i] = -1;
    }
    return;
  }
  const float* src = img + id * plane;
  if (fast) {
    const int n4 = plane >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int j = t + k * kThreads;
      v[k] = j < n4 ? __ldg(s4 + j) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      m = nanmax(m, nanmax(nanmax(v[k].x, v[k].y), nanmax(v[k].z, v[k].w)));
    m = block_max(m, warp_max);
    const float scale = m == 0.f ? 1.f : m;
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int j = t + k * kThreads;
      if (j < n4)
        d4[j] = make_float4(div_scale(v[k].x, scale), div_scale(v[k].y, scale),
                            div_scale(v[k].z, scale), div_scale(v[k].w, scale));
    }
    if (ldst) {
      const int4* l4 = reinterpret_cast<const int4*>(lbl + id * plane);
      for (int j = t; j < n4; j += kThreads) reinterpret_cast<int4*>(ldst)[j] = __ldg(l4 + j);
    }
    return;
  }
  float m = -INFINITY;
  for (int i = t; i < plane; i += kThreads) m = nanmax(m, src[i]);
  m = block_max(m, warp_max);
  const float scale = m == 0.f ? 1.f : m;
  for (int i = t; i < plane; i += kThreads) dst[i] = div_scale(src[i], scale);
  if (ldst) {
    const int32_t* lsrc = lbl + id * plane;
    for (int i = t; i < plane; i += kThreads) ldst[i] = lsrc[i];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// img (n_planes, plane) f32; lbl (n_planes, plane) int32 or NULL; ids (b,)
// int64; img_out (b, plane) f32; lbl_out (b, plane) int32 or NULL (NULL
// exactly when lbl is); plane < 2^31. Returns a cudaError_t code.
int pmpu_gather_normalize(const void* img, const void* lbl, const void* ids, void* img_out,
                          void* lbl_out, int b, long long plane, long long n_planes,
                          void* stream) {
  if (b <= 0 || plane <= 0) return (int)cudaSuccess;
  if (plane > INT32_MAX) return (int)cudaErrorInvalidValue;
  const bool fast = plane % 4 == 0 && plane <= kFastMax && aligned16(img) && aligned16(img_out)
                    && (!lbl || (aligned16(lbl) && aligned16(lbl_out)));
  gather_normalize_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int32_t*>(lbl),
      static_cast<const int64_t*>(ids), static_cast<float*>(img_out),
      static_cast<int32_t*>(lbl_out), (int)plane, (int64_t)n_planes, fast);
  return (int)cudaGetLastError();
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
