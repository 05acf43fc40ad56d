// Conv bias + eval-mode BatchNorm + ReLU, in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package XLA fuses this work into the
// conv's output (pmpu_tpu/models/unet.py, conv -> BatchNorm -> relu). In the
// port cuDNN computes the conv and ATen then ran three passes over its bf16
// output: the conv bias (Convolution.cpp adds it after cuDNN's conv), the
// eval BatchNorm (batch_norm_transform_input_channels_last_kernel) and ReLU
// (clamp_min). This kernel does the three in one read and one write of the
// activation, with every rounding point where the three passes put it, so
// its output is bit-equal to theirs:
//
//   t = bf16(float(y) + float(bf16(conv_bias[c])))          ATen's add_
//   u = bf16(w[c] * (float(t) - mean[c]) * inv[c] + shift[c])  Normalization.cuh
//       inv[c] = rsqrtf(var[c] + eps), f32                   batch_norm_calc_invstd
//   out = isnan(u) ? u : bf16(fmaxf(float(u), 0))             clamp_min
//
// ATen's eval inverse std is rsqrtf, not 1 / sqrtf: on the card it equals
// torch.rsqrt(var + eps) in every one of 2^20 values, where IEEE 1 / sqrt
// differs in 36 % of them, and that moves near-tie roundings of the output.
// BatchNorm's expression is written as ATen writes it and compiled with the
// same defaults (no fast math, FMA contraction on), so the compiler contracts
// it as it contracts ATen's. NaN passes through ReLU as clamp_min passes it.
//
// What bounds it on this card: bytes. A launch reads and writes 10-190 MB of
// bf16 activation (a few dozen operations per 16 bytes), so the least time
// is 2 x bytes / 3.35 TB/s. The design follows from that:
// - the activation is channels_last, (M, C) with C % 8 == 0: a thread moves
//   8 channels of one pixel with one 16-byte load and one 16-byte store,
//   neighbouring threads on neighbouring addresses;
// - a block holds a multiple of C/8 threads and the grid strides by a
//   multiple of it too, so each thread's 8 channels never change: it reads
//   their 5 parameters once into registers and computes inv once, and the
//   loop touches no memory but the activation;
// - kUnroll 16-byte loads are in flight a thread before any is used;
// - one wave of resident blocks fills all SMs (the occupancy API, cached per
//   block size) and strides over the tensor, so no tail wave idles SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;           // bf16 channels a 16-byte vector
constexpr int kUnroll = 4;        // 16-byte loads in flight a thread
constexpr int kMaxThreads = 256;  // a block; C / 8 at most this
constexpr int kMaxDevices = 64;

struct Params {
  float b[kVec], m[kVec], w[kVec], inv[kVec], s[kVec];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ __nv_bfloat16 one(__nv_bfloat16 y, const Params& p, int k) {
  const float t = round_bf16(__bfloat162float(y) + p.b[k]);
  const __nv_bfloat16 u = __float2bfloat16(p.w[k] * (t - p.m[k]) * p.inv[k] + p.s[k]);
  const float uf = __bfloat162float(u);
  return uf != uf ? u : __float2bfloat16(fmaxf(uf, 0.f));
}

__device__ __forceinline__ uint32_t two(uint32_t bits, const Params& p, int k) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&bits);
  h.x = one(h.x, p, k);
  h.y = one(h.y, p, k + 1);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 apply(uint4 v, const Params& p) {
  return make_uint4(two(v.x, p, 0), two(v.y, p, 2), two(v.z, p, 4), two(v.w, p, 6));
}

__global__ void __launch_bounds__(kMaxThreads)
bias_bn_relu_kernel(uint4* __restrict__ y, int n_vec, int groups,
                    const float* __restrict__ conv_bias, const float* __restrict__ mean,
                    const float* __restrict__ var, const float* __restrict__ weight,
                    const float* __restrict__ shift, float eps) {
  // blockDim.x and the grid's stride are multiples of groups: the vectors
  // this thread visits all hold channels [8g, 8g + 8)
  const int g = threadIdx.x % groups;
  Params p;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = g * kVec + k;
    p.b[k] = round_bf16(__ldg(conv_bias + c));
    p.m[k] = __ldg(mean + c);
    p.w[k] = __ldg(weight + c);
    p.inv[k] = rsqrtf(__ldg(var + c) + eps);
    p.s[k] = __ldg(shift + c);
  }
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = y[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[i + u * stride] = apply(v[u], p);
  }
  for (; i < n_vec; i += stride) y[i] = apply(y[i], p);
}

// Resident blocks an SM of each block size, and SMs of each device, found
// once (0: not yet asked).
int g_per_sm[kMaxThreads + 1];
int g_sms[kMaxDevices];

}  // namespace

extern "C" {

// y (n_vec * 8) bf16 channels_last activations, 16-byte aligned, of C =
// groups * 8 channels, 1 <= groups <= 256; conv_bias, mean, var, weight,
// shift (C,) f32: the conv's bias, BatchNorm's running statistics and affine
// parameters. Writes the result over y. Returns a cudaError_t code.
int pmpu_bias_bn_relu(void* y, long long n_vec, int groups, const void* conv_bias,
                      const void* mean, const void* var, const void* weight, const void* shift,
                      float eps, void* stream) {
  if (n_vec <= 0) return (int)cudaSuccess;
  if (groups < 1 || groups > kMaxThreads || n_vec % groups || n_vec > INT32_MAX / kVec)
    return (int)cudaErrorInvalidValue;
  const int threads = kMaxThreads / groups * groups;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (g_per_sm[threads] == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_per_sm[threads], bias_bn_relu_kernel,
                                                      threads, 0);
    if (e != cudaSuccess) return (int)e;
    if (g_per_sm[threads] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long blocks = (n_vec + threads - 1) / threads;
  const long long wave = (long long)g_sms[dev] * g_per_sm[threads];
  bias_bn_relu_kernel<<<(int)(blocks < wave ? blocks : wave), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(y), (int)n_vec, groups, static_cast<const float*>(conv_bias),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(weight), static_cast<const float*>(shift), eps);
  return (int)cudaGetLastError();
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
