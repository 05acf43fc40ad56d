// Fused int8 conv chain for Hopper (sm_90a).
//
// Replaces the TPU kernels pmpu_tpu/ops/pallas/qconv.py::_fused_qchain_tiled
// (pallas_call at :196) and ::_fused_qchain (pallas_call at :230), one function
// with two launch forms: row stripes, and the whole image as a single stripe.
// For each layer of an L-layer chain (L <= 4) of stride-1 SAME 3x3 or 1x1 convs:
//
//   q   = clip(rint(cur / xs), -127, 127)              int8 (IEEE divide)
//   acc = sum over taps and input channels of q * w     int32 (exact)
//   y   = relu(float(acc) * (xs * ws[c]) + b[c])        f32, each step one
//                                                       correctly rounded op
//
// Layer 0 may take two int8 inputs at their own scales (a split input: the
// U-Net decoder's conv over concat(skip, up)); each half then has its own
// int32 sum and y = (float(acc0) * sv0 + float(acc1) * sv1) + b. The last
// layer writes f32, bf16 or int8 requantized at out_xs, optionally without
// the relu. The arithmetic is that of the plain version (chain_reference in
// ../qconv.py): no FMA contraction in the epilogue, round half to even.
//
// What bounds it on this card: at the main path's shapes each chain is 1.6e11
// to 4.6e11 int8 operations against 0.03 to 0.55 GB, so operations (1,979
// TOP/s int8 dense). This first version runs the convs as implicit GEMMs on
// the tensor cores with mma.sync m16n8k32 (s8 x s8 -> s32): every warp owns
// a tile of 64 output pixels x 32 output channels (32 x 32 for the split
// layer, which also keeps f32 partial sums), A fragments come from shared
// memory by ldmatrix, B fragments from L2 as one 8-byte load per lane, and
// the next two steps' fragments load while a step's mma run. The chain's
// int8 activations stay in shared memory: one block owns a stripe of TH
// output rows of one image plus a halo of one row per 3x3 layer on each side
// (the recompute-halo scheme of qconv.py:103-128; layer k computes only the
// rows that layer k+1 still reads), stored [row][col + 1][channel] with zero
// border columns and a 16-byte pad per pixel (conflict-free ldmatrix). Rows
// outside the image are never computed and stay exactly zero. Weights stream
// from L2 ((ntap, cout_pad, cin_pad) int8, 9.4 MB at most): the activation
// buffers leave little of the SM's memory to L1, and each warp fetches its
// own B fragments. Staging weights in shared memory once per block, wgmma
// and TMA are for a later version; so is a cheaper epilogue, which is what
// limits the 128² chains (short reductions, 64 output channels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPad = 16;  // bytes after each pixel's channels in shared memory

enum Kind { kF32 = 0, kBF16 = 1, kS8 = 2 };

struct Layer {
  const int8_t* w;   // (ntap, cout_pad, cin_pad), zero-padded
  const float* ws;   // (cout) weight scales
  const float* b;    // (cout) folded bias
  const float* xs;   // scale of the input (channel group 0)
  const float* xs1;  // scale of channel group 1 (split input), or null
  int ntap, cin_pad, k_split, cout, cout_pad;
};

struct Chain {
  Layer layer[kMaxLayers];
  const void* x0;      // (n, h, w, c0) f32 | bf16 | int8
  const int8_t* x1;    // (n, h, w, c1) int8, or null
  void* out;           // (n, h, w, cout_last) f32 | bf16 | int8
  const float* out_xs;  // scale of an int8 output
  int n_layers, n, h, w, c0, c1, in_kind, out_kind, relu_last, th, halo;
  int buf_bytes[2];
};

// clip(round_half_even(v / xs), -127, 127): clipping first changes nothing
// (the bounds are integers), and adding 1.5 * 2^23 rounds |q| <= 127 to an
// integer, half to even, in the low bits of the sum.
__device__ __forceinline__ int8_t quant(float v, float xs) {
  const float q = fminf(fmaxf(__fdiv_rn(v, xs), -127.f), 127.f);
  return (int8_t)(__float_as_int(__fadd_rn(q, 12582912.f)) - 0x4B400000);
}

// relu that keeps NaN, as torch.relu does
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// Four 8x8 b16 matrices from shared memory: the A fragment of one m16n8k32
// s8 mma when lane l points at row (l & 7) + 8 * ((l >> 3) & 1), byte 16 * (l >> 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ void zero_smem(int8_t* p, int bytes) {
  int4* q = reinterpret_cast<int4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) q[i] = make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ float ld_f32(const void* src, int kind, size_t i) {
  return kind == kF32 ? static_cast<const float*>(src)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(src)[i]);
}

// Stripe rows [r_lo, r_hi) of one input tensor into channels [koff, koff + c)
// of the layer-0 buffer, quantized at xs unless already int8. Vector units:
// 16 int8 channels, or 4 float channels, when c allows.
__device__ void load_group(const Chain& a, const void* src, int kind, int c, int koff, float xs,
                           int8_t* buf, int img, int g0, int r_lo, int r_hi) {
  const int W = a.w, stride = a.layer[0].cin_pad + kPixPad;
  const int vec = kind == kS8 ? (c % 16 ? 1 : 16) : (c % 4 ? 1 : 4);
  const int cu = c / vec;  // units per pixel
  const int total = (r_hi - r_lo) * W * cu;
  const size_t base = ((size_t)img * a.h + (g0 + r_lo)) * W * c;
  constexpr int kBatch = 4;  // units per thread in flight
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
    int4 v16[kBatch];
    float v4[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // all loads first
      const int idx = i0 + u * kThreads;
      if (idx >= total) break;
      const size_t i = base + (size_t)idx * vec;
      if (kind == kS8) {
        if (vec == 16)
          v16[u] = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(src) + i);
        else
          v16[u].x = static_cast<const int8_t*>(src)[i];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v4[u][e] = e < vec ? ld_f32(src, kind, i + e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx >= total) break;
      const int pix = idx / cu, ch = (idx - pix * cu) * vec;
      const int rr = pix / W, col = pix - rr * W;
      int8_t* dst = buf + ((size_t)(r_lo + rr) * (W + 2) + col + 1) * stride + koff + ch;
      if (kind == kS8) {
        if (vec == 16)
          *reinterpret_cast<int4*>(dst) = v16[u];
        else
          *dst = (int8_t)v16[u].x;
      } else if (vec == 4) {
        uint32_t packed = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) packed |= (uint32_t)(uint8_t)quant(v4[u][e], xs) << (8 * e);
        *reinterpret_cast<uint32_t*>(dst) = packed;
      } else {
        *dst = quant(v4[u][0], xs);
      }
    }
  }
}

// Layer li over stripe rows [lo, hi): reads `in` (stripe row in_row0 is its
// row 0), writes the next layer's int8 input into `dst` (stripe row out_row0
// is its row 0) or, for the last layer, the output tensor. A warp owns
// MT x 16 pixels x 32 output channels; SPLIT (two input channel groups)
// keeps the first group's f32 partial sums beside the int32 ones, so it
// takes MT = 2 to stay within the register budget.
template <int MT, bool SPLIT>
__device__ __forceinline__ void run_layer(const Chain& a, int li, const int8_t* in, int in_row0,
                                          int lo, int hi, int8_t* dst, int out_row0, int img,
                                          int g0) {
  const Layer& L = a.layer[li];
  const int W = a.w, W2 = W + 2;
  const int M = (hi - lo) * W;
  if (M <= 0) return;
  const int in_stride = L.cin_pad + kPixPad;
  const int out_stride = dst ? a.layer[li + 1].cin_pad + kPixPad : 0;
  const float next_xs = dst ? *a.layer[li + 1].xs : (a.out_kind == kS8 ? *a.out_xs : 1.f);
  const bool do_relu = dst != nullptr || a.relu_last;
  const float sx0 = *L.xs, sx1 = SPLIT ? *L.xs1 : 0.f;
  constexpr int TM = 16 * MT;
  const int mtiles = (M + TM - 1) / TM, ntiles = (L.cout_pad + 31) >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row within each m16 block, and its byte offset
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lk = 16 * (lane >> 4);

  for (int tile = warp; tile < mtiles * ntiles; tile += kWarps) {
    const int mt = tile % mtiles, nt = tile / mtiles;
    // shared-memory offset of this lane's ldmatrix row in each m16 block;
    // rows past M read pixel M-1 (their results are never stored)
    int off[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int p = min(mt * TM + i * 16 + lrow, M - 1);
      const int rr = p / W, col = p - rr * W;
      off[i] = ((lo + rr - in_row0) * W2 + col + 1) * in_stride + lk;
    }
    float y[SPLIT ? MT : 1][4][4];
    int acc[MT][4][4];
#pragma unroll
    for (int grp = 0; grp < (SPLIT ? 2 : 1); ++grp) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0;
      // one step = one tap x 32 input channels; the next two steps'
      // fragments load while this step's mma run (weights come from L2:
      // the activation buffers leave little of the SM's memory to L1)
      const int k_lo = grp ? L.k_split : 0;
      const int nk = ((grp ? L.cin_pad : L.k_split) - k_lo) >> 5;
      const int nsteps = L.ntap * nk;
      const int8_t* wbase = L.w + ((size_t)nt * 32 + g) * L.cin_pad + t * 8 + k_lo;
      uint32_t a0[MT][4], a1[MT][4], a2[MT][4];
      uint2 b0[4], b1[4], b2[4];
      auto load = [&](int step, uint32_t (&A)[MT][4], uint2 (&B)[4]) {
        const int tap = step / nk, k0 = (step - tap * nk) * 32;
        const int dy = L.ntap == 9 ? tap / 3 - 1 : 0, dx = L.ntap == 9 ? tap % 3 - 1 : 0;
        const int aoff = (dy * W2 + dx) * in_stride + k_lo + k0;
#pragma unroll
        for (int i = 0; i < MT; ++i) ldmatrix_x4(A[i], in + (off[i] + aoff));
        // 32-channel weight chunks are stored so that lane t's two B
        // registers (k 4t..4t+3 and 16+4t..16+4t+3) are the 8 bytes at 8t
        const int8_t* wp = wbase + (size_t)tap * L.cout_pad * L.cin_pad + k0;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          B[jn] = nt * 32 + jn * 8 < L.cout_pad
                      ? __ldg(reinterpret_cast<const uint2*>(wp + (size_t)jn * 8 * L.cin_pad))
                      : make_uint2(0u, 0u);
      };
      auto mma = [&](const uint32_t (&A)[MT][4], const uint2 (&B)[4]) {
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_s8(acc[i][jn], A[i], B[jn].x, B[jn].y);
      };
      // three register buffers, two steps in flight (unrolled: static indices)
      load(0, a0, b0);
      if (nsteps > 1) load(1, a1, b1);
      for (int step = 0; step < nsteps; step += 3) {
        if (step + 2 < nsteps) load(step + 2, a2, b2);
        mma(a0, b0);
        if (step + 1 >= nsteps) break;
        if (step + 3 < nsteps) load(step + 3, a0, b0);
        mma(a1, b1);
        if (step + 2 >= nsteps) break;
        if (step + 4 < nsteps) load(step + 4, a1, b1);
        mma(a2, b2);
      }
      if (SPLIT) {  // y = float(acc) * (xs * ws), summed over the groups in order
        const float sx = grp ? sx1 : sx0;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = nt * 32 + jn * 8 + t * 2 + (e & 1);
            const float sv = n < L.cout ? __fmul_rn(sx, __ldg(L.ws + n)) : 0.f;
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const float v = __fmul_rn(__int2float_rn(acc[i][jn][e]), sv);
              y[SPLIT ? i : 0][jn][e] = grp ? __fadd_rn(y[SPLIT ? i : 0][jn][e], v) : v;
            }
          }
      }
    }
    // epilogue: + b, relu, then requantize into shared memory or store;
    // lane t owns channels n0 + 2t, n0 + 2t + 1 of each 8-channel block jn
    float sv[4][2], bias[4][2];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 32 + jn * 8 + t * 2 + e;
        sv[jn][e] = n < L.cout && !SPLIT ? __fmul_rn(sx0, __ldg(L.ws + n)) : 0.f;
        bias[jn][e] = n < L.cout ? __ldg(L.b + n) : 0.f;
      }
#pragma unroll
    for (int s = 0; s < 2 * MT; ++s) {
      const int i = s >> 1, eh = (s & 1) * 2;
      const int p = mt * TM + i * 16 + (s & 1) * 8 + g;
      if (p >= M) continue;
      const int rr = p / W, col = p - rr * W;
      const int r = lo + rr;
      int8_t* drow = dst ? dst + ((size_t)(r - out_row0) * W2 + col + 1) * out_stride : nullptr;
      const size_t orow = (((size_t)img * a.h + g0 + r) * W + col) * L.cout;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int n = nt * 32 + jn * 8 + t * 2;
        if (n >= L.cout) continue;
        const bool two = n + 1 < L.cout;
        float v0, v1;
        if (SPLIT) {
          v0 = y[SPLIT ? i : 0][jn][eh];
          v1 = y[SPLIT ? i : 0][jn][eh + 1];
        } else {
          v0 = __fmul_rn(__int2float_rn(acc[i][jn][eh]), sv[jn][0]);
          v1 = __fmul_rn(__int2float_rn(acc[i][jn][eh + 1]), sv[jn][1]);
        }
        v0 = __fadd_rn(v0, bias[jn][0]);
        v1 = __fadd_rn(v1, bias[jn][1]);
        if (do_relu) {
          v0 = relu(v0);
          v1 = relu(v1);
        }
        if (drow) {
          drow[n] = quant(v0, next_xs);
          if (two) drow[n + 1] = quant(v1, next_xs);
        } else if (a.out_kind == kF32) {
          float* q = static_cast<float*>(a.out) + orow + n;
          q[0] = v0;
          if (two) q[1] = v1;
        } else if (a.out_kind == kBF16) {
          __nv_bfloat16* q = static_cast<__nv_bfloat16*>(a.out) + orow + n;
          q[0] = __float2bfloat16_rn(v0);
          if (two) q[1] = __float2bfloat16_rn(v1);
        } else {
          int8_t* q = static_cast<int8_t*>(a.out) + orow + n;
          q[0] = quant(v0, next_xs);
          if (two) q[1] = quant(v1, next_xs);
        }
      }
    }
  }
}

// One block = one stripe (blockIdx.x) of one image (blockIdx.y).
__global__ void __launch_bounds__(kThreads, 1) qchain_kernel(const __grid_constant__ Chain a) {
  extern __shared__ int4 smem4[];
  int8_t* const buf0 = reinterpret_cast<int8_t*>(smem4);
  int8_t* const buf1 = buf0 + a.buf_bytes[0];
  const int img = blockIdx.y;
  const int sh = a.th + 2 * a.halo;
  const int g0 = blockIdx.x * a.th - a.halo;  // image row of stripe row 0
  const int r_img_lo = max(0, -g0), r_img_hi = min(sh, a.h - g0);

  zero_smem(buf0, a.buf_bytes[0]);
  __syncthreads();
  load_group(a, a.x0, a.in_kind, a.c0, 0, *a.layer[0].xs, buf0, img, g0, r_img_lo, r_img_hi);
  if (a.x1)
    load_group(a, a.x1, kS8, a.c1, a.layer[0].k_split, 0.f, buf0, img, g0, r_img_lo, r_img_hi);
  int c = 0;  // 3x3 layers so far: layer li reads stripe rows [c, sh - c)
  for (int li = 0; li < a.n_layers; ++li) {
    const int in_row0 = c;
    if (a.layer[li].ntap == 9) ++c;
    const bool last = li + 1 == a.n_layers;
    int8_t* dst = last ? nullptr : ((li & 1) ? buf0 : buf1);
    if (!last) zero_smem(dst, a.buf_bytes[(li + 1) & 1]);
    __syncthreads();
    const int8_t* in = (li & 1) ? buf1 : buf0;
    const int lo = max(c, r_img_lo), hi = min(sh - c, r_img_hi);
    if (a.layer[li].xs1)
      run_layer<2, true>(a, li, in, in_row0, lo, hi, dst, c, img, g0);
    else
      run_layer<4, false>(a, li, in, in_row0, lo, hi, dst, c, img, g0);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// x0 (n, h, w, c0) of kind in_kind; x1 (n, h, w, c1) int8 or null; out
// (n, h, w, cout_last) of kind out_kind; out_xs: f32 scalar (int8 out) or null.
// lptr: per layer {w, ws, b, xs, xs1}; lint: per layer {ntap, cin_pad, k_split,
// cout, cout_pad}; dims: {n, h, w, c0, c1, in_kind, out_kind, relu_last, th,
// halo, buf_bytes0, buf_bytes1}. All device pointers, contiguous. Returns a
// cudaError_t code.
int pmpu_qconv_chain(const void* x0, const void* x1, void* out, const void* out_xs,
                     void* const* lptr, const int* lint, int n_layers, const int* dims,
                     void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  Chain a = {};
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = a.layer[l];
    L.w = static_cast<const int8_t*>(lptr[5 * l]);
    L.ws = static_cast<const float*>(lptr[5 * l + 1]);
    L.b = static_cast<const float*>(lptr[5 * l + 2]);
    L.xs = static_cast<const float*>(lptr[5 * l + 3]);
    L.xs1 = static_cast<const float*>(lptr[5 * l + 4]);
    L.ntap = lint[5 * l];
    L.cin_pad = lint[5 * l + 1];
    L.k_split = lint[5 * l + 2];
    L.cout = lint[5 * l + 3];
    L.cout_pad = lint[5 * l + 4];
    if ((L.ntap != 1 && L.ntap != 9) || L.cin_pad <= 0 || L.cin_pad % 32 || L.k_split % 32 ||
        L.k_split <= 0 || L.k_split > L.cin_pad || L.cout <= 0 || L.cout_pad % 8 ||
        L.cout_pad < L.cout || !L.w || !L.ws || !L.b || !L.xs || (l > 0 && L.xs1))
      return (int)cudaErrorInvalidValue;
  }
  a.x0 = x0;
  a.x1 = static_cast<const int8_t*>(x1);
  a.out = out;
  a.out_xs = static_cast<const float*>(out_xs);
  a.n_layers = n_layers;
  a.n = dims[0];
  a.h = dims[1];
  a.w = dims[2];
  a.c0 = dims[3];
  a.c1 = dims[4];
  a.in_kind = dims[5];
  a.out_kind = dims[6];
  a.relu_last = dims[7];
  a.th = dims[8];
  a.halo = dims[9];
  a.buf_bytes[0] = dims[10];
  a.buf_bytes[1] = dims[11];
  if (a.n <= 0 || a.n > 65535 || a.h <= 0 || a.w <= 0 || a.th <= 0 || a.c0 <= 0 ||
      a.buf_bytes[0] % 16 || a.buf_bytes[1] % 16 || (a.out_kind == kS8 && !a.out_xs) ||
      (a.x1 && !a.layer[0].xs1) || (!a.x1 && a.layer[0].xs1))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)a.buf_bytes[0] + a.buf_bytes[1];
  int dev = 0, max_optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(qchain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.h + a.th - 1) / a.th, a.n);
  qchain_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
