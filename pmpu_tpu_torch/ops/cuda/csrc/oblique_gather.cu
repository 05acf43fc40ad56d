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
// What bounds it on this card: bytes, by the published peaks. At 128^3 x 6
// views it writes 50 MB and reads the 8.4 MB volume, about 56 f32
// operations an output: 0.0175 ms. Each output reads 8 scattered corners,
// which L1 serves (the volume stays in L2). A block covers 8 columns
// x 8 rows x 32 planes of one view (3-D grid: column tile, row tile, view x
// plane tile). A warp samples 8 columns x 2 rows x 2 planes: its stores fill
// whole 32-byte sectors and its corners stay within a few voxels of each
// other. Each thread writes 8 outputs of one (a, b), 4 planes apart,
// sharing the partial sum (c + u*B[0]) + w*B[1]. Index arithmetic is 32-bit
// (the wrapper refuses 2^31 outputs or more). Measured (chip_smoke.py, H100
// 80GB HBM3 at 700 W): 0.107 ms at 128^3 x 6 views, 16 % of the bound.
// The volume is read through L1, not staged in shared memory: staging was
// measured slower (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;      // columns and rows of a block
constexpr int kPlanes = 32;   // planes of a block
constexpr int kThreads = 256;
constexpr int kLayer = kThreads / (kTile * kTile);  // planes the block covers at once: 4
// A warp's tile of planes, rows, columns; the block's warps tile one layer.
constexpr int kWI = 2, kWA = 2, kWB = 8;
constexpr int kNWB = kTile / kWB, kNWA = kTile / kWA;
static_assert(kWI * kWA * kWB == 32 && (kLayer / kWI) * kNWA * kNWB == kThreads / 32,
              "the warps' tiles must cover a layer");

// Trilinear sample at p from the volume (device memory, via L1): each
// corner clamped into the cube for its read and masked to 0 outside it.
__device__ __forceinline__ float sample(const float* __restrict__ vol, int s, const float (&p)[3]) {
  float f[3];
  int k0[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float fl = floorf(p[ax]);
    f[ax] = __fsub_rn(p[ax], fl);
    k0[ax] = (int)fl;
  }
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int jx = k0[0] + (d >> 2), jy = k0[1] + ((d >> 1) & 1), jz = k0[2] + (d & 1);
    const bool valid = jx >= 0 && jx < s && jy >= 0 && jy < s && jz >= 0 && jz < s;
    const int cx = min(max(jx, 0), s - 1), cy = min(max(jy, 0), s - 1), cz = min(max(jz, 0), s - 1);
    const float val = valid ? __ldg(vol + (cx * s + cy) * s + cz) : 0.f;
    const float wx = d & 4 ? f[0] : __fsub_rn(1.f, f[0]);
    const float wy = d & 2 ? f[1] : __fsub_rn(1.f, f[1]);
    const float wz = d & 1 ? f[2] : __fsub_rn(1.f, f[2]);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__fmul_rn(wx, wy), wz), val));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
oblique_planes_kernel(const float* __restrict__ vol, const float* __restrict__ bases,
                      float* __restrict__ out, int s, int plane_tiles) {
  const int v = blockIdx.z / plane_tiles;
  const int i0 = (blockIdx.z - v * plane_tiles) * kPlanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kTile + (warp % kNWB) * kWB + lane % kWB;
  const int a = blockIdx.y * kTile + (warp / kNWB % kNWA) * kWA + lane / kWB % kWA;
  const int iq = warp / (kNWB * kNWA) * kWI + lane / (kWB * kWA);
  if (a >= s || b >= s) return;

  float B[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) B[k] = __ldg(bases + v * 9 + k);
  const float c = (float)(s - 1) * 0.5f;
  const float u = __fsub_rn((float)a, c);
  const float w = __fsub_rn((float)b, c);
  float uw[3];  // (c + u*B[0]) + w*B[1], shared by this thread's planes
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    uw[ax] = __fadd_rn(__fadd_rn(c, __fmul_rn(u, B[ax])), __fmul_rn(w, B[3 + ax]));

#pragma unroll 4
  for (int k = 0; k < kPlanes / kLayer; ++k) {
    const int i = i0 + iq + k * kLayer;
    if (i >= s) break;
    const float off = __fsub_rn((float)i, c);
    float p[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) p[ax] = __fadd_rn(uw[ax], __fmul_rn(off, B[6 + ax]));
    out[((v * s + i) * s + a) * s + b] = sample(vol, s, p);
  }
}

}  // namespace

extern "C" {

// vol (s, s, s) f32; bases (n_views, 3, 3) f32; out (n_views * s, s, s) f32,
// fewer than 2^31 values. Returns a cudaError_t code.
int pmpu_oblique_planes(const void* vol, const void* bases, void* out, int s, int n_views,
                        void* stream) {
  if (s <= 0 || n_views <= 0) return (int)cudaSuccess;
  const int tiles = (s + kTile - 1) / kTile;
  const int plane_tiles = (s + kPlanes - 1) / kPlanes;
  if ((int64_t)n_views * s * s * s > INT32_MAX || (int64_t)plane_tiles * n_views > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles, tiles, plane_tiles * n_views);
  oblique_planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol), static_cast<const float*>(bases), static_cast<float*>(out),
      s, plane_tiles);
  return (int)cudaGetLastError();
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
