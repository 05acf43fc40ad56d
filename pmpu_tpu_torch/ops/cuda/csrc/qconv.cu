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
// TOP/s int8 dense). The convs run as implicit GEMMs on the tensor cores with
// mma.sync m16n8k32 (s8 x s8 -> s32, A fragments by ldmatrix): a warp owns a
// tile of 64 output pixels x 32 output channels. The chain's int8
// activations stay in shared memory: one block owns a stripe of TH output
// rows of one image plus a halo of one row per 3x3 layer on each side (the
// recompute-halo scheme of qconv.py:103-128; layer k computes only the rows
// that layer k+1 still reads), stored [row][col + 1][channel] with zero
// border columns and a 16-byte pad per pixel (conflict-free ldmatrix). Rows
// outside the image are never computed and stay exactly zero.
//
// Phase clocks (-DPMPU_QCONV_CLOCKS, read by python3 -m
// pmpu_tpu_torch.tools.qconv_sweep; H100 80GB HBM3, 700 W) showed the first
// version spending 43-70 % of the cycles of its 128² to 32² encoder chains
// (15-40 % of the decoder ones) in the epilogue: each IEEE divide of the
// requantization carries a slow-path branch, so no two of them overlap, and
// every field of the launch was re-read after each byte store (an int8
// store may alias the parameter block). Its MMA loop recomputed its
// addresses with an integer division every step. This version:
//   - stages the weights once per block: the 8 warps take their tiles in
//     rounds (at most 8 tiles and as many n-tiles as the ring holds) and walk
//     K in step; for each K-step the B slices of the n-tiles the round spans
//     (1 KB each: 32 output x 32 input channels, laid out by the wrapper so
//     that the copy is contiguous and a lane reads the four B registers of
//     two 8-channel blocks as one conflict-free 16-byte shared load) go from
//     device memory into a 4-stage ring by 16-byte cp.async, two steps ahead
//     of the MMAs, one barrier a step; the next step's A and B fragments load
//     while a step's MMAs run, and the loop keeps running offsets (no
//     division);
//   - requantizes through the reciprocal (quant_rcp: branch-free, so the
//     compiler overlaps many; the epilogue is one branch-free pass compiled
//     for each output kind), and by quant only the rare pair that lies
//     within 2^-13 of a half-integer step: bit for bit quant's result;
//   - keeps every field the loops read in registers;
//   - writes the next layer's int8 input as packed channel pairs, and stages
//     the last layer's tile in the activation buffer that is dead during the
//     last layer, from where it leaves in 16-byte coalesced stores;
//   - loads float stripes 8 channels (16 or 32 bytes) at a time.
// The MMA loop now runs at about 600 cycles a step of 8 warps x 16 mma.sync
// at every width (about 1,800 int8 ops a cycle an SM, a quarter of the
// dense peak): the rate of mma.sync on this card. What is left for later
// versions: wgmma with TMA (needs the activations in a channel-blocked
// layout), a persistent kernel that loads stripe i + 1 while it computes
// stripe i, and a tap-packed first layer for Cin = 1. A variant that frees
// the warps from the per-step barrier (full/empty mbarriers per stage, a
// rotating producer warp) was timed slower by the sweep and is not kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPad = 16;       // bytes after each pixel's channels in shared memory
constexpr int kStages = 4;        // weight ring stages (K-steps) in shared memory
constexpr int kMaxSlots = 8;      // n-tiles a stage holds at most (a round spans <= 8)
constexpr int kSlotBytes = 1024;  // one n-tile's B slice of one K-step: 32 x 32 int8
constexpr int kTileM = 64;        // output pixels of a warp's tile (x 32 output channels)

enum Kind { kF32 = 0, kBF16 = 1, kS8 = 2 };
template <int K>
struct KindTag {
  static constexpr int value = K;
};

#ifdef PMPU_QCONV_EXACT_EPILOGUE  // a variant that requantizes every value by quant
constexpr bool kExactEpilogue = true;
#else
constexpr bool kExactEpilogue = false;
#endif

// Phase clocks (built only with -DPMPU_QCONV_CLOCKS, as the library
// qconv_clocks): each warp adds the clock64() cycles it spends in each phase,
// and lane 0 adds them into a global array of kClockSlots sums at the end:
// 0 zeroing shared memory, 1 stripe load, then per layer l 2 + 3l the MMA
// loop, 3 + 3l the epilogue, 4 + 3l barrier waits; 15 the warp's whole run.
constexpr int kClockSlots = 16;
enum Slot { kClkZero = 0, kClkLoad = 1, kClkTotal = 15 };
__host__ __device__ constexpr int clk_mma(int l) { return 2 + 3 * l; }
__host__ __device__ constexpr int clk_epi(int l) { return 3 + 3 * l; }
__host__ __device__ constexpr int clk_wait(int l) { return 4 + 3 * l; }

struct Clock {
#ifdef PMPU_QCONV_CLOCKS
  long long t, t0, acc[kClockSlots];
  __device__ void start() {
    for (int i = 0; i < kClockSlots; ++i) acc[i] = 0;
    t = t0 = clock64();
  }
  __device__ void tick(int slot) {
    const long long now = clock64();
    acc[slot] += now - t;
    t = now;
  }
  __device__ void flush(unsigned long long* out) {
    acc[kClkTotal] = clock64() - t0;
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < kClockSlots; ++i) atomicAdd(out + i, (unsigned long long)acc[i]);
  }
#else
  __device__ void start() {}
  __device__ void tick(int) {}
  __device__ void flush(unsigned long long*) {}
#endif
};

struct Layer {
  // (ntap, cin_pad / 32, cout_pad / 32, 1024) int8, zero-padded: the B slice
  // of one tap, 32 input and 32 output channels, as the ring holds it
  const int8_t* w;
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
  int ring_slots;              // n-tiles one stage of the weight ring holds
  unsigned long long* clocks;  // kClockSlots sums (clock build), else null
};

// clip(round_half_even(v / xs), -127, 127): clipping first changes nothing
// (the bounds are integers), and adding 1.5 * 2^23 rounds |q| <= 127 to an
// integer, half to even, in the low bits of the sum.
__device__ __forceinline__ int8_t quant(float v, float xs) {
  const float q = fminf(fmaxf(__fdiv_rn(v, xs), -127.f), 127.f);
  return (int8_t)(__float_as_int(__fadd_rn(q, 12582912.f)) - 0x4B400000);
}

// quant through the reciprocal: with rxs = RN(1 / xs), q = RN(v * rxs) is
// within |v / xs| * 2^-23 of v / xs, and RN(v / xs) within 2^-17 of it when
// |v / xs| < 256. So unless q lies within 2^-13 of a half-integer (below
// |q| = 200; above, both clip to +-127), q, v / xs and RN(v / xs) all round
// to the same integer, and this equals quant(v, xs). `near` is set where it
// may not; the caller then takes quant. NaN, infinities, zeros and tiny
// values give quant's results (xs normal, as the caller checks). A branch-free
// sequence, so that the compiler overlaps many of them (the IEEE divide's
// slow-path branch keeps quant's from overlapping).
__device__ __forceinline__ int8_t quant_rcp(float v, float rxs, bool& near) {
  const float q = __fmul_rn(v, rxs);
  near |= fabsf(__fsub_rn(__fsub_rn(q, floorf(q)), 0.5f)) <= 0x1p-13f && fabsf(q) < 200.f;
  const float c = fminf(fmaxf(q, -127.f), 127.f);
  return (int8_t)(__float_as_int(__fadd_rn(c, 12582912.f)) - 0x4B400000);
}

// the reciprocal quant_rcp takes, or 0 where it may not be used (xs not
// a normal number in [2^-100, 2^100]: then the callers set `near` for every
// value, so that quant gives them all)
__device__ __forceinline__ float rcp_scale(float xs) {
  return xs >= 0x1p-100f && xs <= 0x1p100f ? __frcp_rn(xs) : 0.f;
}

// two quantized values in the low 16 bits, v0 in the low byte
__device__ __forceinline__ uint32_t quant_pair(float v0, float v1, float xs) {
  return (uint32_t)(uint8_t)quant(v0, xs) | ((uint32_t)(uint8_t)quant(v1, xs) << 8);
}
__device__ __forceinline__ uint32_t quant_pair_rcp(float v0, float v1, float rxs, bool& near) {
  return (uint32_t)(uint8_t)quant_rcp(v0, rxs, near) |
         ((uint32_t)(uint8_t)quant_rcp(v1, rxs, near) << 8);
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

__device__ __forceinline__ void cp_async16(int8_t* smem, const int8_t* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


__device__ void zero_smem(int8_t* p, int bytes) {
  int4* q = reinterpret_cast<int4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads) q[i] = make_int4(0, 0, 0, 0);
}

__device__ __forceinline__ float ld_f32(const void* src, int kind, size_t i) {
  return kind == kF32 ? static_cast<const float*>(src)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(src)[i]);
}

// Stripe rows [r_lo, r_hi) of one input tensor (element `base` is the first
// one loaded) into channels [koff, koff + c) of the layer-0 buffer (pixel
// pitch `stride`), quantized at xs unless already int8. Vector units, when c
// and the tensor's alignment allow: 16 int8 channels, or 8 float channels
// (one 16-byte load of bf16, two of f32), quantized as in the epilogue.
__device__ void load_group(const void* __restrict__ src, int kind, int c, int koff, float xs,
                           int8_t* __restrict__ buf, int stride, int W, size_t base, int r_lo,
                           int r_hi) {
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int vec = kind == kS8 ? (c % 16 || !aligned ? 1 : 16) : (c % 8 || !aligned ? 1 : 8);
  const int cu = c / vec;  // units per pixel
  const float rxs = kind == kS8 ? 0.f : rcp_scale(xs);
  const int total = (r_hi - r_lo) * W * cu;
  constexpr int kBatch = 4;  // units per thread in flight
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
    uint4 raw[kBatch];  // int8 units as loaded, float units quantized
#pragma unroll
    for (int u = 0; u < kBatch; ++u) raw[u] = make_uint4(0u, 0u, 0u, 0u);
    if (kind == kS8) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = i0 + u * kThreads;
        if (idx >= total) break;
        const int8_t* p = static_cast<const int8_t*>(src) + base + (size_t)idx * vec;
        if (vec == 16)
          raw[u] = *reinterpret_cast<const uint4*>(p);
        else
          raw[u].x = (uint8_t)*p;
      }
    } else {
      float v[kBatch][8];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // all loads first
        const int idx = i0 + u * kThreads;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = 0.f;  // past the end: quantized, never stored
        if (idx >= total) continue;
        const size_t i = base + (size_t)idx * vec;
        if (vec == 1) {
          v[u][0] = ld_f32(src, kind, i);
        } else if (kind == kBF16) {
          const uint4 r = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(src) + i);
          const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // bf16 -> f32 is exact: the high half of the bits
            v[u][2 * e] = __uint_as_float(w[e] << 16);
            v[u][2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
          }
        } else {
          const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(src) + i);
          const float4 lo4 = q[0], hi4 = q[1];
          v[u][0] = lo4.x; v[u][1] = lo4.y; v[u][2] = lo4.z; v[u][3] = lo4.w;
          v[u][4] = hi4.x; v[u][5] = hi4.y; v[u][6] = hi4.z; v[u][7] = hi4.w;
        }
      }
      // by quant_rcp; where a value may round otherwise, this thread's
      // batch again by quant
      bool near = rxs == 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        raw[u].x = quant_pair_rcp(v[u][0], v[u][1], rxs, near) |
                   (quant_pair_rcp(v[u][2], v[u][3], rxs, near) << 16);
        raw[u].y = quant_pair_rcp(v[u][4], v[u][5], rxs, near) |
                   (quant_pair_rcp(v[u][6], v[u][7], rxs, near) << 16);
      }
      if (near) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          raw[u].x = quant_pair(v[u][0], v[u][1], xs) | (quant_pair(v[u][2], v[u][3], xs) << 16);
          raw[u].y = quant_pair(v[u][4], v[u][5], xs) | (quant_pair(v[u][6], v[u][7], xs) << 16);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx >= total) break;
      const int pix = idx / cu, ch = (idx - pix * cu) * vec;
      const int rr = pix / W, col = pix - rr * W;
      int8_t* dst = buf + ((size_t)(r_lo + rr) * (W + 2) + col + 1) * stride + koff + ch;
      if (vec == 16)
        *reinterpret_cast<uint4*>(dst) = raw[u];
      else if (vec == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(raw[u].x, raw[u].y);
      else
        *dst = (int8_t)raw[u].x;
    }
  }
}

// Layer li over stripe rows [lo, hi): reads `in` (stripe row in_row0 is its
// row 0), writes the next layer's int8 input into `dst` (stripe row out_row0
// is its row 0) or, for the last layer (dst null), the output tensor through
// `stage`, the activation buffer that is dead during the last layer. A warp
// owns MT x 16 = 64 pixels x 32 output channels; SPLIT (two input channel
// groups) keeps the first group's f32 partial sums beside the int32 ones
// (ptxas then spills a few registers; the sweep timed that faster than
// 32-pixel tiles for the split layer). `ring`: kStages stages of ring_slots
// weight slices.
template <bool SPLIT>
__device__ __forceinline__ void run_layer(const Chain& a, int li, const int8_t* __restrict__ in,
                                          int in_row0, int lo, int hi, int8_t* __restrict__ dst,
                                          int out_row0, int img, int g0,
                                          int8_t* __restrict__ ring,
                                          int8_t* __restrict__ stage, Clock& clk) {
  // every field the loops read, in registers (a store through an int8
  // pointer could alias the parameter block, which would then be re-read)
  const Layer& L = a.layer[li];
  const int W = a.w, W2 = W + 2;
  const int M = (hi - lo) * W;
  if (M <= 0) return;  // the same in every thread of the block
  const int ntap = L.ntap, cin_pad = L.cin_pad, k_split = L.k_split, cout = L.cout;
  const int8_t* const __restrict__ wimg = L.w;
  const float* const __restrict__ wsc = L.ws;
  const float* const __restrict__ bias_v = L.b;
  const int in_stride = cin_pad + kPixPad;
  const int out_stride = dst ? a.layer[li + 1].cin_pad + kPixPad : 0;
  const int out_kind = a.out_kind;
  const float next_xs = dst ? *a.layer[li + 1].xs : (out_kind == kS8 ? *a.out_xs : 1.f);
  const float next_rxs = rcp_scale(next_xs);
  const bool do_relu = dst != nullptr || a.relu_last;
  const float sx0 = *L.xs, sx1 = SPLIT ? *L.xs1 : 0.f;
  const int osz = out_kind == kF32 ? 4 : out_kind == kBF16 ? 2 : 1;
  // staging pitch: 32 channels and a pad that keeps the fragment stores
  // conflict-free (f32 160, bf16 80, int8 48 bytes)
  const int spitch = 32 * osz + (out_kind == kF32 ? 32 : 16);
  int8_t* const gout = static_cast<int8_t*>(a.out) +
                       ((size_t)img * a.h + g0 + lo) * W * (size_t)cout * osz;
  const int ring_slots = a.ring_slots, slot_stride = ring_slots * kSlotBytes;
  const int nkc = cin_pad >> 5;
  constexpr int MT = kTileM / 16, TM = kTileM;
  const int mtiles = (M + TM - 1) / TM, ntiles = L.cout_pad >> 5;
  const int total = mtiles * ntiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row within each m16 block, and its byte offset
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lk = 16 * (lane >> 4);

  // one round: tiles [r0, r1), at most kWarps of them and at most
  // ring_slots n-tiles (tile = mt + nt * mtiles)
  for (int r0 = 0, r1; r0 < total; r0 = r1) {
    const int nt_lo = r0 / mtiles;
    r1 = min(min(total, r0 + kWarps), (nt_lo + ring_slots) * mtiles);
    const int tile = r0 + warp;
    const bool active = tile < r1;
    const int mt = tile % mtiles, nt = tile / mtiles;
    const int span = (r1 - 1) / mtiles - nt_lo + 1;
    // this lane's B registers in a slot: output channel jn * 8 + g, jn = 2jp + e,
    // as the 16 bytes at jp * 512 + (g * 4 + t) * 16, e = 0 in the low 8
    const int boff = (nt - nt_lo) * kSlotBytes + (g * 4 + t) * 16;
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
      // one step = one tap x 32 input channels, taps outer; the loop keeps
      // running offsets (two cursors: the step whose fragments load next,
      // and the step copied next), no division
      const int k_lo = grp ? k_split : 0;
      const int nk = ((grp ? cin_pad : k_split) - k_lo) >> 5;
      const int nsteps = ntap * nk;
      const size_t tile_bytes = (size_t)ntiles * kSlotBytes;  // one K-step of the image
      const int8_t* const wsrc = wimg + (size_t)(k_lo >> 5) * tile_bytes + nt_lo * kSlotBytes;
      const int copy_units = span * (kSlotBytes / 16);
      // A byte offset of a tap's first step (3x3: dy = tap / 3 - 1, dx = tap % 3 - 1)
      auto tap_off = [&](int tap) {
        const int dy = (tap * 11 >> 5) - 1, dx = tap - 3 * (dy + 1) - 1;  // tap < 9
        return (ntap == 9 ? (dy * W2 + dx) * in_stride : 0) + k_lo;
      };
      int ctap = 0, ckc = 0;  // the step copied next
      const int8_t* csrc = wsrc;
      // the round's B slices of step s (the step copied next), one
      // contiguous run of span KB, into stage s % kStages; every thread
      // commits a group, empty or not
      auto copy = [&](int s) {
        if (s < nsteps) {
          int8_t* d = ring + (s % kStages) * slot_stride;
#pragma unroll
          for (int j = 0; j < kMaxSlots * (kSlotBytes / 16) / kThreads; ++j) {
            const int u = threadIdx.x + j * kThreads;
            if (u < copy_units) cp_async16(d + 16 * u, csrc + 16 * u);
          }
          csrc += tile_bytes;
          if (++ckc == nk) {
            ckc = 0;
            csrc = wsrc + (size_t)(++ctap) * nkc * tile_bytes;
          }
        }
        cp_async_commit();
      };
      int ltap = 0, lkc = 0, aoff = tap_off(0);  // the step whose fragments load next
      uint32_t a0[MT][4], a1[MT][4];
      uint4 b0[2], b1[2];
      auto load = [&](int s, uint32_t (&A)[MT][4], uint4 (&B)[2]) {
        if (active) {
#pragma unroll
          for (int i = 0; i < MT; ++i) ldmatrix_x4(A[i], in + (off[i] + aoff));
          const int8_t* bp = ring + (s % kStages) * slot_stride + boff;
          B[0] = *reinterpret_cast<const uint4*>(bp);
          B[1] = *reinterpret_cast<const uint4*>(bp + 512);
        }
        aoff += 32;
        if (++lkc == nk) {
          lkc = 0;
          aoff = tap_off(++ltap);
        }
      };
      auto mma = [&](const uint32_t (&A)[MT][4], const uint4 (&B)[2]) {
        if (!active) return;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8(acc[i][0], A[i], B[0].x, B[0].y);
          mma_s8(acc[i][1], A[i], B[0].z, B[0].w);
          mma_s8(acc[i][2], A[i], B[1].x, B[1].y);
          mma_s8(acc[i][3], A[i], B[1].z, B[1].w);
        }
      };
      // step s: wait until steps s and s+1 are in the ring (this thread's
      // copies, then everyone's), refill the stage of step s-1 (read before
      // this barrier), load step s+1's fragments, run step s's mma
      auto step = [&](int s, const uint32_t (&A)[MT][4], const uint4 (&B)[2],
                      uint32_t (&An)[MT][4], uint4 (&Bn)[2]) {
        clk.tick(clk_mma(li));
        cp_async_wait<kStages - 3>();
        __syncthreads();
        clk.tick(clk_wait(li));
        copy(s + kStages - 1);
        if (s + 1 < nsteps) load(s + 1, An, Bn);
        mma(A, B);
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) copy(s);
      clk.tick(clk_mma(li));
      cp_async_wait<kStages - 2>();
      __syncthreads();
      clk.tick(clk_wait(li));
      load(0, a0, b0);
      for (int s = 0; s < nsteps; s += 2) {  // two register sets, static indices
        step(s, a0, b0, a1, b1);
        if (s + 1 >= nsteps) break;
        step(s + 1, a1, b1, a0, b0);
      }
      cp_async_wait<0>();  // only empty groups are left
      if (SPLIT) {  // y = float(acc) * (xs * ws), summed over the groups in order
        const float sx = grp ? sx1 : sx0;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = nt * 32 + jn * 8 + t * 2 + (e & 1);
            const float sv = active && n < cout ? __fmul_rn(sx, __ldg(wsc + n)) : 0.f;
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const float v = __fmul_rn(__int2float_rn(acc[i][jn][e]), sv);
              y[SPLIT ? i : 0][jn][e] = grp ? __fadd_rn(y[SPLIT ? i : 0][jn][e], v) : v;
            }
          }
      }
    }
    clk.tick(clk_mma(li));
    if (!active) continue;  // nothing else of the round touches the ring
    // epilogue: + b, relu, then requantize into shared memory or stage;
    // lane t owns channels n0 + 2t, n0 + 2t + 1 of each 8-channel block jn
    float sv[4][2], bias[4][2];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 32 + jn * 8 + t * 2 + e;
        sv[jn][e] = n < cout && !SPLIT ? __fmul_rn(sx0, __ldg(wsc + n)) : 0.f;
        bias[jn][e] = n < cout ? __ldg(bias_v + n) : 0.f;
      }
    int8_t* const wstage = stage + warp * TM * spitch;
    // this lane's channel pair of row s (rows g, g + 8 of each m16 block) in
    // 8-channel block jn: + b, relu
    auto pair = [&](int s, int jn, float& v0, float& v1) {
      const int i = s >> 1, eh = (s & 1) * 2;
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
    };
    // where row s goes: the pixel of the next layer's input, or the row of
    // the staged tile. Rows past M read pixel M-1's inputs, so their values
    // are pixel M-1's: they are written there again, the same bytes.
    auto row_ptr = [&](int s) -> int8_t* {
      const int prow = (s >> 1) * 16 + (s & 1) * 8 + g;  // pixel row within the tile
      if (!dst) return wstage + prow * spitch;
      const int p = min(mt * TM + prow, M - 1);
      const int rr = p / W, col = p - rr * W;
      return dst + ((size_t)(lo + rr - out_row0) * W2 + col + 1) * out_stride + nt * 32;
    };
    // The tile's values in one branch-free pass for the output's kind
    // (requantized, f32 or bf16); channels past cout come out exactly zero
    // (zero weights, scale and bias): the next layer's padding channels, or
    // staged and not stored. Returns the requantized pairs that quant_rcp
    // may have rounded otherwise: bit s * 4 + jn.
    auto pass = [&](auto kind) {
      constexpr int K = decltype(kind)::value;
      uint32_t redo = 0;
#pragma unroll
      for (int s = 0; s < 2 * MT; ++s) {
        int8_t* const row = row_ptr(s);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int nl = jn * 8 + t * 2;  // channel within the tile
          float v0, v1;
          pair(s, jn, v0, v1);
          if constexpr (K == kS8) {
            bool near = kExactEpilogue || next_rxs == 0.f;
            *reinterpret_cast<uint16_t*>(row + nl) =
                (uint16_t)quant_pair_rcp(v0, v1, next_rxs, near);
            redo |= (uint32_t)near << (s * 4 + jn);
          } else if constexpr (K == kF32) {
            *reinterpret_cast<float2*>(row + nl * 4) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(row + nl * 2) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      return redo;
    };
    const uint32_t redo = dst || out_kind == kS8 ? pass(KindTag<kS8>{})
                          : out_kind == kF32     ? pass(KindTag<kF32>{})
                                                 : pass(KindTag<kBF16>{});
    // rarely (a value within 2^-13 of a half-integer step: about one pair
    // in 2,000) a pair is requantized by quant, into the same place
    if (__any_sync(0xffffffffu, redo != 0)) {
#pragma unroll
      for (int s = 0; s < 2 * MT; ++s)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          if ((redo >> (s * 4 + jn)) & 1) {
            float v0, v1;
            pair(s, jn, v0, v1);
            *reinterpret_cast<uint16_t*>(row_ptr(s) + jn * 8 + t * 2) =
                (uint16_t)quant_pair(v0, v1, next_xs);
          }
    }
    if (!dst) {  // the staged tile leaves in 16-byte stores, pixel after pixel
      __syncwarp();
      const int npix = min(TM, M - mt * TM), nc = min(32, cout - nt * 32);
      const int pitch = cout * osz;  // bytes per output pixel
      int8_t* const gtile = gout + (size_t)mt * TM * pitch + nt * 32 * osz;
      if (pitch % 16 == 0) {
        const int cpp = nc * osz / 16;  // 16-byte chunks per pixel
        for (int c = lane; c < npix * cpp; c += 32) {
          const int px = c / cpp, part = c - px * cpp;
          *reinterpret_cast<int4*>(gtile + (size_t)px * pitch + part * 16) =
              *reinterpret_cast<const int4*>(wstage + px * spitch + part * 16);
        }
      } else {  // a channel count that 16-byte chunks do not divide
        for (int e = lane; e < npix * nc; e += 32) {
          const int px = e / nc, ch = e - px * nc;
          const int8_t* s = wstage + px * spitch + ch * osz;
          int8_t* d = gtile + (size_t)px * pitch + ch * osz;
          for (int b = 0; b < osz; ++b) d[b] = s[b];
        }
      }
      __syncwarp();
    }
    clk.tick(clk_epi(li));
  }
}

// One block = one stripe (blockIdx.x) of one image (blockIdx.y). Shared
// memory: the two activation buffers, then the weight ring.
__global__ void __launch_bounds__(kThreads, 1) qchain_kernel(const __grid_constant__ Chain a) {
  extern __shared__ int4 smem4[];
  int8_t* const buf0 = reinterpret_cast<int8_t*>(smem4);
  int8_t* const buf1 = buf0 + a.buf_bytes[0];
  int8_t* const ring = buf1 + a.buf_bytes[1];
  const int img = blockIdx.y;
  const int sh = a.th + 2 * a.halo;
  const int g0 = blockIdx.x * a.th - a.halo;  // image row of stripe row 0
  const int r_img_lo = max(0, -g0), r_img_hi = min(sh, a.h - g0);
  Clock clk;
  clk.start();

  zero_smem(buf0, a.buf_bytes[0]);
  __syncthreads();
  clk.tick(kClkZero);
  const int stride0 = a.layer[0].cin_pad + kPixPad;
  const size_t px0 = ((size_t)img * a.h + g0 + r_img_lo) * a.w;  // first pixel loaded
  load_group(a.x0, a.in_kind, a.c0, 0, *a.layer[0].xs, buf0, stride0, a.w, px0 * a.c0, r_img_lo,
             r_img_hi);
  if (a.x1)
    load_group(a.x1, kS8, a.c1, a.layer[0].k_split, 0.f, buf0, stride0, a.w, px0 * a.c1,
               r_img_lo, r_img_hi);
  clk.tick(kClkLoad);
  int c = 0;  // 3x3 layers so far: layer li reads stripe rows [c, sh - c)
  for (int li = 0; li < a.n_layers; ++li) {
    const int in_row0 = c;
    if (a.layer[li].ntap == 9) ++c;
    const bool last = li + 1 == a.n_layers;
    int8_t* const other = (li & 1) ? buf0 : buf1;  // the next input; dead in the last layer
    if (!last) zero_smem(other, a.buf_bytes[(li + 1) & 1]);
    clk.tick(kClkZero);
    __syncthreads();
    clk.tick(clk_wait(li));
    const int8_t* in = (li & 1) ? buf1 : buf0;
    const int lo = max(c, r_img_lo), hi = min(sh - c, r_img_hi);
    int8_t* const dst = last ? nullptr : other;
    if (a.layer[li].xs1)
      run_layer<true>(a, li, in, in_row0, lo, hi, dst, c, img, g0, ring, other, clk);
    else
      run_layer<false>(a, li, in, in_row0, lo, hi, dst, c, img, g0, ring, other, clk);
    __syncthreads();
    clk.tick(clk_wait(li));
  }
  clk.flush(a.clocks);
}

}  // namespace

extern "C" {

// x0 (n, h, w, c0) of kind in_kind; x1 (n, h, w, c1) int8 or null; out
// (n, h, w, cout_last) of kind out_kind, 16-byte aligned; out_xs: f32 scalar
// (int8 out) or null. lptr: per layer {w, ws, b, xs, xs1}, w the wrapper's
// weight image (16-byte aligned); lint: per layer {ntap, cin_pad, k_split,
// cout, cout_pad}; dims: {n, h, w, c0, c1, in_kind, out_kind, relu_last, th,
// halo, buf_bytes0, buf_bytes1, ring_slots (1..8)}, the buffer holding the last
// layer's input's partner large enough to stage 8 warps' output tiles;
// clocks: kClockSlots zeroed u64 sums in the clock build, null in the normal
// one. All device pointers, contiguous. Returns a cudaError_t code.
int pmpu_qconv_chain(const void* x0, const void* x1, void* out, const void* out_xs,
                     void* const* lptr, const int* lint, int n_layers, const int* dims,
                     void* stream, void* clocks) {
#ifdef PMPU_QCONV_CLOCKS
  if (!clocks) return (int)cudaErrorInvalidValue;
#else
  if (clocks) return (int)cudaErrorInvalidValue;
#endif
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
        L.k_split <= 0 || L.k_split > L.cin_pad || L.cout <= 0 || L.cout_pad % 32 ||
        L.cout_pad < L.cout || !L.w || !L.ws || !L.b || !L.xs || (l > 0 && L.xs1) ||
        (l > 0 && L.cin_pad != a.layer[l - 1].cout_pad) ||
        reinterpret_cast<uintptr_t>(L.w) % 16)
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
  a.ring_slots = dims[12];
  a.clocks = static_cast<unsigned long long*>(clocks);
  if (a.n <= 0 || a.n > 65535 || a.h <= 0 || a.w <= 0 || a.th <= 0 || a.c0 <= 0 ||
      a.buf_bytes[0] % 16 || a.buf_bytes[1] % 16 || a.ring_slots <= 0 ||
      a.ring_slots > kMaxSlots ||
      (a.out_kind == kS8 && !a.out_xs) || (a.x1 && !a.layer[0].xs1) ||
      (!a.x1 && a.layer[0].xs1) || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      (size_t)a.buf_bytes[0] + a.buf_bytes[1] + (size_t)kStages * a.ring_slots * kSlotBytes;
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
