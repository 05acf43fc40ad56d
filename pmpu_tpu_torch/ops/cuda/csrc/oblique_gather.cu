// Oblique plane stack (8-corner trilinear gather) for Hopper (sm_90a).
//
// Replaces the TPU kernel pmpu_tpu/ops/pallas/oblique_gather.py::oblique_plane_pallas
// (pallas_call at :93, body _oblique_plane_kernel :52), which samples one
// S x S plane per call. This kernel writes every plane of V views in one
// launch, straight into the (V*S, S, S) slab that the model reads: plane
// v*S + i of view v sits at offset i - (S-1)/2 along bases[v] row 2, as
// pmpu_tpu/inference/fusion.py::oblique_slabs stacks it. For output (a, b)
// of that plane, with c = (S-1)/2, u = a - c, w = b - c, off = i - c:
//
//   p   = ((c + u*B[0]) + w*B[1]) + off*B[2]            per axis, f32
//   f   = p - floor(p)
//   out = sum over corners (dx,dy,dz) = 000..111 of ((wx*wy)*wz) * vol[corner]
//
// with wx = dx ? fx : 1 - fx, a corner outside the cube contributing 0 and
// its index clamped before the read. Every step is one correctly rounded
// f32 operation (__fmul_rn/__fadd_rn/__fsub_rn, so nvcc cannot contract to
// FMA), in the order of the plain version (oblique_plane in
// pmpu_tpu_torch/data/sampler.py): the two agree bit for bit. The texture
// unit's trilinear filtering is not used: its weights are 9-bit fixed point.
//
// What bounds it on this card: bytes. At 128^3 x 6 views it writes 50 MB
// and reads the 8.4 MB volume, about 56 f32 operations per output (0.018 ms
// of HBM time against 0.011 ms of f32 issue at the published peaks). One
// thread per output voxel, consecutive threads along the last in-plane axis,
// so the stores coalesce; the eight corner reads of neighbouring threads are
// neighbouring voxels of the volume, which stays resident in the 50 MB L2
// and is read through the read-only path (__ldg). The bases (V x 9 floats)
// are staged in shared memory once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
oblique_planes_kernel(const float* __restrict__ vol, const float* __restrict__ bases,
                      float* __restrict__ out, int s, int n_views) {
  extern __shared__ float sb[];  // (n_views, 3, 3)
  for (int t = threadIdx.x; t < n_views * 9; t += kThreads) sb[t] = bases[t];
  __syncthreads();

  const int64_t plane = (int64_t)s * s;
  const int64_t total = (int64_t)n_views * s * plane;
  const int64_t o = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int b = (int)(o % s);
  const int a = (int)((o / s) % s);
  const int64_t p = o / plane;  // v * s + i
  const int i = (int)(p % s);
  const float* B = sb + (p / s) * 9;

  const float c = (float)(s - 1) * 0.5f;
  const float u = __fsub_rn((float)a, c);
  const float w = __fsub_rn((float)b, c);
  const float off = __fsub_rn((float)i, c);

  float f[3];
  int k0[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float x = __fadd_rn(__fadd_rn(__fadd_rn(c, __fmul_rn(u, B[ax])), __fmul_rn(w, B[3 + ax])),
                              __fmul_rn(off, B[6 + ax]));
    const float fl = floorf(x);
    f[ax] = __fsub_rn(x, fl);
    k0[ax] = (int)fl;
  }

  float acc = 0.f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int jx = k0[0] + dx, jy = k0[1] + dy, jz = k0[2] + dz;
        const bool valid = jx >= 0 && jx < s && jy >= 0 && jy < s && jz >= 0 && jz < s;
        const int cx = min(max(jx, 0), s - 1), cy = min(max(jy, 0), s - 1),
                  cz = min(max(jz, 0), s - 1);
        const float val = valid ? __ldg(vol + ((int64_t)cx * s + cy) * s + cz) : 0.f;
        const float wx = dx ? f[0] : __fsub_rn(1.f, f[0]);
        const float wy = dy ? f[1] : __fsub_rn(1.f, f[1]);
        const float wz = dz ? f[2] : __fsub_rn(1.f, f[2]);
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__fmul_rn(wx, wy), wz), val));
      }
    }
  }
  out[o] = acc;
}

}  // namespace

extern "C" {

// vol (s, s, s) f32; bases (n_views, 3, 3) f32; out (n_views * s, s, s) f32.
// Returns a cudaError_t code.
int pmpu_oblique_planes(const void* vol, const void* bases, void* out, int s, int n_views,
                        void* stream) {
  if (s <= 0 || n_views <= 0) return (int)cudaSuccess;
  const int64_t total = (int64_t)n_views * s * s * s;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const size_t smem = (size_t)n_views * 9 * sizeof(float);
  oblique_planes_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(bases), static_cast<float*>(out),
      s, n_views);
  return (int)cudaGetLastError();
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
