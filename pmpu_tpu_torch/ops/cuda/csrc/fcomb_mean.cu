// Fused fcomb multi-sample mean-decode for Hopper (sm_90a).
//
// Replaces the TPU kernel pmpu_tpu/ops/pallas/fcomb_mean.py::fcomb_mean_decode
// (pallas_call at :140, body _kernel :42). Per pixel it computes the mean over
// S prior samples of the probabilistic U-Net's fcomb decode:
//
//   fh      = rnd(feats @ k0f)                      once per pixel
//   per sample s, in order:
//     h     = relu(rnd(fh + zh[s]))                 z half of layer 0 (given)
//     h     = relu(rnd(rnd(h @ W_l) + b_l))         each hidden 1x1 layer
//     y     = f32(rnd(rnd(h @ W_head) + b_head))    class head
//     acc  += y                                     f32, sample order
//   out     = acc / S
//
// rnd() rounds to the compute dtype (bf16 with __float2bfloat16_rn, identity
// for f32); every matmul accumulates in f32. This is the rounding of the JAX
// package's decode_samples followed by mean(axis=0).
//
// What bounds it on this card: ~1.9e11 FLOP against ~0.29 GB moved per
// 128-slice chunk at full width (f0 = 64), so operations, not bytes. This
// first version keeps every per-sample activation in shared memory (only the
// (pixels, C) f32 mean is written) and runs the 1x1 layers as register-tiled
// f32 FMA matmuls (4 pixels x 4 channels per thread) on the CUDA cores;
// tensor cores (mma / wgmma) are the next step. The Pallas kernel's
// block-diagonal packing of sample pairs only filled the TPU's 128-lane MXU
// and is not carried over.
//
// Layout: one block = one tile of TM pixels of one slice. Shared memory holds
// the tile's activations k-major ([channel][pixel], row stride TM+4) in three
// buffers (feature half, ping, pong) and a staging buffer for 32 rows of the
// current layer's weights, which stream from global memory (L2-resident).
// TM is the largest multiple of 4 up to 128 with TM * max(f0, C) <= 8192, so
// each of the 256 threads owns at most two 4x4 output tiles of a layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 2;                          // 4x4 tiles per thread
constexpr int kTileElems = kThreads * kMaxTiles * 16;  // TM * Np bound
constexpr int kKC = 32;                               // weight rows per stage

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

struct Plan {
  int tm, tms, f0p, cp, arows, npmax;
  size_t smem_floats;
};

__host__ __device__ inline Plan make_plan(int cf, int f0, int c) {
  Plan p;
  p.f0p = round4(f0);
  p.cp = round4(c);
  p.npmax = imax(p.f0p, p.cp);
  p.tm = imin(128, (kTileElems / p.npmax) & ~3);
  p.tms = p.tm + 4;
  p.arows = imax(cf, p.f0p);
  p.smem_floats = (size_t)(2 * p.f0p + p.arows) * p.tms + (size_t)kKC * p.npmax;
  return p;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// relu that keeps NaN, as torch.relu and jax.nn.relu do
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// acc[t][i][j] = sum_k act[k][pt*4+i] * W[k][ct*4+j] for the thread's tiles.
// act: shared, k-major, row stride tms. W: global (K, N) row-major in T,
// staged kKC rows at a time into wbuf as f32 (row stride Np, zero past N).
template <typename T>
__device__ __forceinline__ void gemm(const float* __restrict__ act, int tms, int tm,
                                     const T* __restrict__ w, int K, int N, int Np,
                                     float* __restrict__ wbuf,
                                     float (&acc)[kMaxTiles][4][4]) {
  const int tid = threadIdx.x;
  const int ptiles = tm >> 2;
  const int ntiles = ptiles * (Np >> 2);
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kn = imin(kKC, K - k0);
    __syncthreads();  // earlier writers of act and readers of wbuf are done
    for (int idx = threadIdx.x; idx < kn * Np; idx += kThreads) {
      const int kk = idx / Np, j = idx - kk * Np;
      wbuf[idx] = j < N ? to_f32(w[(size_t)(k0 + kk) * N + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      const int tile = tid + t * kThreads;
      if (tile < ntiles) {
        const int pt = tile % ptiles, ct = tile / ptiles;
        const float* a_ptr = act + (size_t)k0 * tms + pt * 4;
        const float* w_ptr = wbuf + ct * 4;
        for (int kk = 0; kk < kn; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(a_ptr + (size_t)kk * tms);
          const float4 b = *reinterpret_cast<const float4*>(w_ptr + kk * Np);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[t][i][j] = fmaf(av[i], bv[j], acc[t][i][j]);
        }
      }
    }
  }
}

// Epilogues. mode 0: dst = rnd(acc) (feature half). mode 1: dst =
// relu(rnd(rnd(acc) + bias[j])) (hidden layer). dst is k-major like act.
template <typename T>
__device__ __forceinline__ void store_tiles(const float (&acc)[kMaxTiles][4][4], float* dst,
                                            int tms, int tm, int Np, const T* bias, int N,
                                            bool hidden) {
  const int ptiles = tm >> 2;
  const int ntiles = ptiles * (Np >> 2);
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    const int tile = threadIdx.x + t * kThreads;
    if (tile < ntiles) {
      const int pt = tile % ptiles, ct = tile / ptiles;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = ct * 4 + jj;
        float v[4];
        if (hidden) {
          const float b = j < N ? to_f32(bias[j]) : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = relu(rnd<T>(rnd<T>(acc[t][i][jj]) + b));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = rnd<T>(acc[t][i][jj]);
        }
        *reinterpret_cast<float4*>(dst + (size_t)j * tms + pt * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fcomb_mean_kernel(const T* __restrict__ feats, const T* __restrict__ zh,
                  const T* __restrict__ k0f, const T* __restrict__ wh,
                  const T* __restrict__ bh, const T* __restrict__ wl,
                  const T* __restrict__ bl, float* __restrict__ out, int n, int hw,
                  int cf, int f0, int n_hidden, int c, int s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan pl = make_plan(cf, f0, c);
  const int tm = pl.tm, tms = pl.tms, f0p = pl.f0p, cp = pl.cp;
  float* fh = smem;
  float* buf_a = fh + (size_t)f0p * tms;
  float* buf_b = buf_a + (size_t)pl.arows * tms;
  float* wbuf = buf_b + (size_t)f0p * tms;

  const int img = blockIdx.y;
  const int p0 = blockIdx.x * tm;
  const int valid = imin(tm, hw - p0);
  const int tid = threadIdx.x;

  // the feature tile, k-major, zero past the last pixel (coalesced reads)
  const T* fsrc = feats + ((size_t)img * hw + p0) * cf;
  for (int idx = tid; idx < tm * cf; idx += kThreads) {
    const int p = idx / cf, k = idx - p * cf;
    buf_a[(size_t)k * tms + p] = p < valid ? to_f32(fsrc[idx]) : 0.f;
  }

  float acc[kMaxTiles][4][4];
  float macc[kMaxTiles][4][4];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) macc[t][i][j] = 0.f;

  // feature half of layer 0, once for all samples
  gemm<T>(buf_a, tms, tm, k0f, cf, f0, f0p, wbuf, acc);
  store_tiles<T>(acc, fh, tms, tm, f0p, nullptr, f0, false);

  const int ptiles = tm >> 2;
  const int htiles = ptiles * (cp >> 2);
  for (int si = 0; si < s; ++si) {
    __syncthreads();  // fh complete; the previous sample's readers are done
    const T* z = zh + ((size_t)si * n + img) * f0;
    for (int idx = tid; idx < f0p * tm; idx += kThreads) {
      const int j = idx / tm, p = idx - j * tm;
      const float zj = j < f0 ? to_f32(z[j]) : 0.f;
      buf_a[(size_t)j * tms + p] = relu(rnd<T>(fh[(size_t)j * tms + p] + zj));
    }
    float* cur = buf_a;
    float* nxt = buf_b;
    for (int l = 0; l < n_hidden; ++l) {
      gemm<T>(cur, tms, tm, wh + (size_t)l * f0 * f0, f0, f0, f0p, wbuf, acc);
      store_tiles<T>(acc, nxt, tms, tm, f0p, bh + (size_t)l * f0, f0, true);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    gemm<T>(cur, tms, tm, wl, f0, c, cp, wbuf, acc);
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      const int tile = tid + t * kThreads;
      if (tile < htiles) {
        const int ct = tile / ptiles;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = ct * 4 + jj;
          const float b = j < c ? to_f32(bl[j]) : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) macc[t][i][jj] += rnd<T>(rnd<T>(acc[t][i][jj]) + b);
        }
      }
    }
  }

  const float fs = (float)s;
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    const int tile = tid + t * kThreads;
    if (tile < htiles) {
      const int pt = tile % ptiles, ct = tile / ptiles;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = pt * 4 + i;
        if (p >= valid) continue;
        float* dst = out + ((size_t)img * hw + p0 + p) * c;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = ct * 4 + jj;
          if (j < c) dst[j] = macc[t][i][jj] / fs;
        }
      }
    }
  }
}

template <typename T>
int launch(const void* feats, const void* zh, const void* k0f, const void* wh,
           const void* bh, const void* wl, const void* bl, void* out, int n, int hw,
           int cf, int f0, int n_hidden, int c, int s, cudaStream_t stream) {
  const Plan pl = make_plan(cf, f0, c);
  if (pl.tm < 4) return (int)cudaErrorInvalidValue;
  const size_t bytes = pl.smem_floats * sizeof(float);
  int dev = 0, max_optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(fcomb_mean_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((hw + pl.tm - 1) / pl.tm, n);
  fcomb_mean_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(zh), static_cast<const T*>(k0f),
      static_cast<const T*>(wh), static_cast<const T*>(bh), static_cast<const T*>(wl),
      static_cast<const T*>(bl), static_cast<float*>(out), n, hw, cf, f0, n_hidden, c, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feats (n, hw, cf), zh (s, n, f0), k0f (cf, f0), wh (n_hidden, f0, f0),
// bh (n_hidden, f0), wl (f0, c), bl (c): compute dtype (bf16 if is_bf16,
// else f32), contiguous. out (n, hw, c) f32. Returns a cudaError_t code.
int pmpu_fcomb_mean_decode(const void* feats, const void* zh, const void* k0f,
                           const void* wh, const void* bh, const void* wl, const void* bl,
                           void* out, int n, int hw, int cf, int f0, int n_hidden, int c,
                           int s, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(feats, zh, k0f, wh, bh, wl, bl, out, n, hw, cf, f0,
                                 n_hidden, c, s, st);
  return launch<float>(feats, zh, k0f, wh, bh, wl, bl, out, n, hw, cf, f0, n_hidden, c, s,
                       st);
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
