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
// The division is IEEE division (not a multiply by the reciprocal), as in
// the JAX package, so the result is bit-equal to it. The max propagates NaN,
// as jnp.max does. An id outside [0, P) yields a NaN image plane and a -1
// label plane instead of reading out of bounds.
//
// What bounds it on this card: bytes (one read and one write of every
// element, a couple of operations each). One block per output plane: a
// grid-stride read for the max (warp shuffles, then shared memory across
// warps), then a second read, which hits L2, to divide and write. A
// reduction plus an elementwise pass would suit Triton as well; it is CUDA
// C++ so that both kernels of the inference path share one build route.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
gather_normalize_kernel(const float* __restrict__ img, const int32_t* __restrict__ lbl,
                        const int64_t* __restrict__ ids, float* __restrict__ img_out,
                        int32_t* __restrict__ lbl_out, int64_t plane, int64_t n_planes) {
  __shared__ float warp_max[kThreads / 32];
  const int64_t b = blockIdx.x;
  const int64_t id = ids[b];
  float* dst = img_out + b * plane;
  int32_t* ldst = lbl_out ? lbl_out + b * plane : nullptr;
  if (id < 0 || id >= n_planes) {
    for (int64_t i = threadIdx.x; i < plane; i += kThreads) {
      dst[i] = __int_as_float(0x7fc00000);
      if (ldst) ldst[i] = -1;
    }
    return;
  }
  const float* src = img + id * plane;
  float m = -INFINITY;
  for (int64_t i = threadIdx.x; i < plane; i += kThreads) m = nanmax(m, src[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) warp_max[0] = m;
  }
  __syncthreads();
  m = warp_max[0];
  const float scale = m == 0.f ? 1.f : m;
  for (int64_t i = threadIdx.x; i < plane; i += kThreads) dst[i] = __fdiv_rn(src[i], scale);
  if (ldst) {
    const int32_t* lsrc = lbl + id * plane;
    for (int64_t i = threadIdx.x; i < plane; i += kThreads) ldst[i] = lsrc[i];
  }
}

}  // namespace

extern "C" {

// img (n_planes, plane) f32; lbl (n_planes, plane) int32 or NULL; ids (b,)
// int64; img_out (b, plane) f32; lbl_out (b, plane) int32 or NULL (NULL
// exactly when lbl is). Returns a cudaError_t code.
int pmpu_gather_normalize(const void* img, const void* lbl, const void* ids, void* img_out,
                          void* lbl_out, int b, long long plane, long long n_planes,
                          void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  gather_normalize_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int32_t*>(lbl),
      static_cast<const int64_t*>(ids), static_cast<float*>(img_out),
      static_cast<int32_t*>(lbl_out), (int64_t)plane, (int64_t)n_planes);
  return (int)cudaGetLastError();
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
