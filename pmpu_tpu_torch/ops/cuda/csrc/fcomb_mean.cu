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
// What bounds it on this card: operations. At the main path's shape (one
// 128-slice chunk of 128^2, Cf = f0 = 64, C = 3, S = 5, two hidden layers)
// it does 1.93e11 FLOP against 0.29 GB moved: 0.195 ms at the bf16
// tensor-core peak, 0.088 ms at the HBM rate. The Pallas kernel's
// block-diagonal packing of sample pairs only filled the TPU's 128-lane MXU
// and is not carried over. Two routes, chosen by the wrapper from dtype and
// shape (fcomb_mean.py::fcomb_route):
//
// Tensor-core route (bf16, Cf % 8 == 0, Cf <= 128, f0 <= 128, C <= 8),
// pmpu_fcomb_mean_decode_tc. Every product is mma.sync m16n8k16 bf16 -> f32.
//  - The accumulator fragment of m16n8k16, packed pairwise to bf16x2, is the
//    A fragment of the next layer's k16 step, so one sample's whole chain
//    (z add, hidden layers, head) stays in registers; fh = rnd(feats @ k0f)
//    is computed once per tile and kept as bf16 A fragments.
//  - The epilogue runs in packed bf16x2: round the f32 pair once, __hadd2 the
//    bias, NaN-keeping relu (__hmax2_nan). A bf16 sum rounded once equals the
//    f32 sum of the same operands rounded to bf16 (exact in f32 unless the
//    exponents differ by more than 16, and then both return the larger), so
//    this is the plain version's rounding; only the f32 order inside each
//    product differs.
//  - All weights and biases sit in shared memory once per block, transposed to
//    [out][in] and zero-padded (Cf to a multiple of 16, f0 to a power of two
//    >= 16, C to 8; padded channels stay relu(rnd(0 + 0)) = 0), with a row
//    stride of in + 8 so that ldmatrix's 8 rows fall in 8 distinct bank
//    groups. The wrapper packs that image once per set of weights.
//  - Persistent blocks (SM count x occupancy) of 4 independent warps, at most
//    168 registers a thread so that 3 blocks fit an SM (faster than 2 blocks
//    with more registers, 8 warps a block, or 16-pixel items). A warp
//    walks over (slice, 32-pixel tile) items (16 at f0 > 64, to bound
//    registers); a tile never spans two slices, the ragged last one is
//    zero-filled and masked. Its feature rows arrive through a 2-stage
//    cp.async ring (row stride Cf + 8), so the next item's load overlaps this
//    item's chain. The (pixels, C) f32 mean is written straight from the
//    accumulator fragments.
//
// CUDA-core route (f32, and bf16 outside the range above),
// pmpu_fcomb_mean_decode: the tensor cores have no exact f32 product (TF32
// keeps ~3 digits; f32 is held to 1e-5 of the output scale), so this body
// runs the 1x1 layers as register-tiled f32 FMA matmuls (4 pixels x 4
// channels per thread) and keeps every per-sample activation in shared
// memory. One block = one tile of TM pixels of one slice. Shared memory holds
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

// ---------------------------------------------------------------------------
// Tensor-core route

namespace tc {

constexpr int kWarps = 4;      // independent warps per block, sharing the weights
constexpr int kMinBlocks = 3;  // per SM: caps registers at 168 (f0 = 64 spills a few bytes)
constexpr int kStages = 2;     // feature ring depth per warp
constexpr int kHeadRows = 8;

__host__ __device__ constexpr int m_tiles(int f0p) { return f0p <= 64 ? 2 : 1; }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The packed weight image, offsets in bf16 elements; fcomb_mean.py::tc_layout
// computes the same. k0f^T [f0p][ldk], hidden^T [n_hidden][f0p][ldf], head^T
// [8][ldf], hidden biases [n_hidden][f0p], head bias [8].
struct Layout {
  int cfp, ldk, ldf, hidden, head, bias, head_bias, total;
};

__host__ __device__ inline Layout layout(int cf, int f0p, int n_hidden) {
  Layout L;
  L.cfp = round_up(cf, 16);
  L.ldk = L.cfp + 8;
  L.ldf = f0p + 8;
  L.hidden = f0p * L.ldk;
  L.head = L.hidden + n_hidden * f0p * L.ldf;
  L.bias = L.head + kHeadRows * L.ldf;
  L.head_bias = L.bias + n_hidden * f0p;
  L.total = round_up(L.head_bias + kHeadRows, 8);
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(const void* p, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// (lo, hi) f32 -> bf16x2, each rounded to nearest even
__device__ __forceinline__ __nv_bfloat162 rnd2(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}

// relu(x + y) in bf16x2, the sum rounded once; relu keeps NaN as torch.relu does
__device__ __forceinline__ uint32_t add_relu(__nv_bfloat162 x, uint32_t y) {
  return as_u32(__hmax2_nan(__hadd2(x, as_bf2(y)), __float2bfloat162_rn(0.f)));
}

// One hidden 1x1 layer on a warp's MT m-tiles: act <- relu(rnd(rnd(act @ W) + b)).
// W^T is [F0P][ldf] in shared memory, b [F0P].
template <int F0P, int MT>
__device__ __forceinline__ void hidden_layer(uint32_t (&act)[MT][F0P / 16][4],
                                             const __nv_bfloat16* w, int ldf,
                                             const __nv_bfloat16* bias, int lane) {
  constexpr int NT = F0P / 8, KT = F0P / 16;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  // lanes 0-7 / 8-15 / 16-23 / 24-31 address the 8x8 matrices (n 0-7, k 0-7),
  // (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) of an n-tile pair
  const __nv_bfloat16* wl = w + ((lane >> 4) * 8 + (lane & 7)) * ldf + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(wl + np * 16 * ldf + kt * 16, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(acc[mt][2 * np], act[mt][kt], b[0], b[1]);
        mma(acc[mt][2 * np + 1], act[mt][kt], b[2], b[3]);
      }
    }
  // accumulator n-tiles 2kt and 2kt+1 are the next A fragment's k-step kt
  const uint32_t* b2 = reinterpret_cast<const uint32_t*>(bias) + (lane & 3);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t b0 = b2[8 * kt], b1 = b2[8 * kt + 4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      act[mt][kt][0] = add_relu(rnd2(acc[mt][2 * kt][0], acc[mt][2 * kt][1]), b0);
      act[mt][kt][1] = add_relu(rnd2(acc[mt][2 * kt][2], acc[mt][2 * kt][3]), b0);
      act[mt][kt][2] = add_relu(rnd2(acc[mt][2 * kt + 1][0], acc[mt][2 * kt + 1][1]), b1);
      act[mt][kt][3] = add_relu(rnd2(acc[mt][2 * kt + 1][2], acc[mt][2 * kt + 1][3]), b1);
    }
  }
}

// feats (n, hw, cf) bf16; zh (s, n, F0P) bf16, zero past f0; wpack the
// Layout image; out (n, hw, c) f32.
template <int F0P>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
fcomb_mean_tc_kernel(const __nv_bfloat16* __restrict__ feats,
                     const __nv_bfloat16* __restrict__ zh, const uint4* __restrict__ wpack,
                     float* __restrict__ out, int n, int hw, int cf, int n_hidden, int c,
                     int s) {
  constexpr int MT = m_tiles(F0P);
  constexpr int WT = 16 * MT;  // pixels per work item
  constexpr int NT = F0P / 8, KT = F0P / 16;
  extern __shared__ uint4 smem[];
  const Layout L = layout(cf, F0P, n_hidden);
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + L.total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the weight image once per block; the rings zeroed, so that the feature
  // columns past Cf stay 0
  for (int i = tid; i < L.total / 8; i += blockDim.x) smem[i] = wpack[i];
  const int ring_words = kWarps * kStages * WT * L.ldk / 8;
  for (int i = tid; i < ring_words; i += blockDim.x) smem[L.total / 8 + i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int tiles = (hw + WT - 1) / WT;
  const long long items = (long long)n * tiles;
  const long long stride = (long long)gridDim.x * kWarps;
  __nv_bfloat16* my_ring = ring + (size_t)warp * kStages * WT * L.ldk;
  const int chunks = cf / 8;  // 16-byte chunks per feature row

  auto load = [&](long long item, int stage) {
    const int img = (int)(item / tiles), p0 = (int)(item % tiles) * WT;
    const int valid = imin(WT, hw - p0);
    const __nv_bfloat16* src = feats + ((size_t)img * hw + p0) * cf;
    __nv_bfloat16* dst = my_ring + stage * WT * L.ldk;
    for (int q = lane; q < WT * chunks; q += 32) {
      const int row = q / chunks, ch = q - row * chunks;
      const bool ok = row < valid;
      cp_async16(dst + row * L.ldk + ch * 8, ok ? src + (size_t)row * cf + ch * 8 : feats,
                 ok ? 16 : 0);
    }
  };

  long long item = (long long)blockIdx.x * kWarps + warp;
  if (item < items) load(item, 0);
  cp_async_commit();
  const float fs = (float)s;
  // A-fragment addresses: lanes 0-15 rows 0-15 at k 0, lanes 16-31 at k 8
  const int a_off = (lane & 15) * L.ldk + (lane >> 4) * 8;
  const __nv_bfloat16* k0f = w + ((lane >> 4) * 8 + (lane & 7)) * L.ldk + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* head = w + L.head + (lane & 7) * L.ldf + ((lane >> 3) & 1) * 8;
  const uint32_t hb = reinterpret_cast<const uint32_t*>(w + L.head_bias)[t];

  for (int stage = 0; item < items; item += stride, stage ^= 1) {
    if (item + stride < items) load(item + stride, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this item's rows have landed
    __syncwarp();
    const int img = (int)(item / tiles), p0 = (int)(item % tiles) * WT;
    const __nv_bfloat16* a_tile = my_ring + stage * WT * L.ldk + a_off;

    // feature half, once for all samples: fh = rnd(feats @ k0f)
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    for (int kt = 0; kt < L.cfp / 16; ++kt) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(a_tile + mt * 16 * L.ldk + kt * 16, a[mt]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(k0f + np * 16 * L.ldk + kt * 16, b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncwarp();  // every lane has read the stage before it is refilled
    __nv_bfloat162 fh[MT][KT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        fh[mt][kt][0] = rnd2(acc[mt][2 * kt][0], acc[mt][2 * kt][1]);
        fh[mt][kt][1] = rnd2(acc[mt][2 * kt][2], acc[mt][2 * kt][3]);
        fh[mt][kt][2] = rnd2(acc[mt][2 * kt + 1][0], acc[mt][2 * kt + 1][1]);
        fh[mt][kt][3] = rnd2(acc[mt][2 * kt + 1][2], acc[mt][2 * kt + 1][3]);
      }

    float sum[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][e] = 0.f;
    for (int si = 0; si < s; ++si) {
      // h = relu(rnd(fh + zh[s])), the z half a per-(sample, slice) row
      const uint32_t* z = reinterpret_cast<const uint32_t*>(zh + ((size_t)si * n + img) * F0P) + t;
      uint32_t act[MT][KT][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t z0 = __ldg(z + 8 * kt), z1 = __ldg(z + 8 * kt + 4);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          act[mt][kt][0] = add_relu(fh[mt][kt][0], z0);
          act[mt][kt][1] = add_relu(fh[mt][kt][1], z0);
          act[mt][kt][2] = add_relu(fh[mt][kt][2], z1);
          act[mt][kt][3] = add_relu(fh[mt][kt][3], z1);
        }
      }
      for (int l = 0; l < n_hidden; ++l)
        hidden_layer<F0P, MT>(act, w + L.hidden + l * F0P * L.ldf, L.ldf, w + L.bias + l * F0P,
                              lane);
      // head: y = f32(rnd(rnd(h @ W_head) + b_head)); acc += y in sample order
      float y[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[mt][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t b0, b1;
        ldsm_x2(head + kt * 16, b0, b1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma(y[mt], act[mt][kt], b0, b1);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat162 lo = __hadd2(rnd2(y[mt][0], y[mt][1]), as_bf2(hb));
        const __nv_bfloat162 hi = __hadd2(rnd2(y[mt][2], y[mt][3]), as_bf2(hb));
        sum[mt][0] += __low2float(lo);
        sum[mt][1] += __high2float(lo);
        sum[mt][2] += __low2float(hi);
        sum[mt][3] += __high2float(hi);
      }
    }

    // rows g and g+8 of each m-tile, columns 2t and 2t+1
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + mt * 16 + g + 8 * half;
        if (p >= hw) continue;
        float* dst = out + ((size_t)img * hw + p) * c;
        if (2 * t < c) dst[2 * t] = sum[mt][2 * half] / fs;
        if (2 * t + 1 < c) dst[2 * t + 1] = sum[mt][2 * half + 1] / fs;
      }
  }
  cp_async_wait<0>();
}

template <int F0P>
int launch(const void* feats, const void* zh, const void* wpack, void* out, int n, int hw,
           int cf, int n_hidden, int c, int s, cudaStream_t stream) {
  constexpr int WT = 16 * m_tiles(F0P);
  const Layout L = layout(cf, F0P, n_hidden);
  const size_t bytes = ((size_t)L.total + (size_t)kWarps * kStages * WT * L.ldk) * 2;
  int dev = 0, max_optin = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fcomb_mean_tc_kernel<F0P>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fcomb_mean_tc_kernel<F0P>,
                                                    kWarps * 32, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)n * ((hw + WT - 1) / WT);
  const long long blocks = (items + kWarps - 1) / kWarps;
  const int grid = (int)(blocks < (long long)sms * per_sm ? blocks : (long long)sms * per_sm);
  fcomb_mean_tc_kernel<F0P><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(zh),
      static_cast<const uint4*>(wpack), static_cast<float*>(out), n, hw, cf, n_hidden, c, s);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// The tensor-core route, bf16 only. feats (n, hw, cf) with cf % 8 == 0 and
// cf <= 128, 16-byte aligned; zh (s, n, f0p) zero past f0; wpack the packed
// weight image of tc::layout(cf, f0p, n_hidden); f0p in {16, 32, 64, 128};
// c <= 8. out (n, hw, c) f32. Returns a cudaError_t code.
int pmpu_fcomb_mean_decode_tc(const void* feats, const void* zh, const void* wpack, void* out,
                              int n, int hw, int cf, int f0p, int n_hidden, int c, int s,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cf < 8 || cf > 128 || cf % 8 || c < 1 || c > tc::kHeadRows || n_hidden < 0 || s < 1 ||
      n < 1 || hw < 1)
    return (int)cudaErrorInvalidValue;
  switch (f0p) {
    case 16: return tc::launch<16>(feats, zh, wpack, out, n, hw, cf, n_hidden, c, s, st);
    case 32: return tc::launch<32>(feats, zh, wpack, out, n, hw, cf, n_hidden, c, s, st);
    case 64: return tc::launch<64>(feats, zh, wpack, out, n, hw, cf, n_hidden, c, s, st);
    case 128: return tc::launch<128>(feats, zh, wpack, out, n, hw, cf, n_hidden, c, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
