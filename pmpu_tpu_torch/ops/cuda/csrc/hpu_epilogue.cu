// The epilogue of each conv of the HPU-Net's residual blocks, for Hopper
// (sm_90a): the conv bias and ReLU after each 3x3 conv, in place; the conv
// bias, the skip's bias, the residual add and the next block's ReLU after
// each block's 1x1 conv.
//
// Replaces no TPU kernel: the JAX package has no HPU-Net, and where XLA
// runs a conv it fuses such elementwise work into the conv's output. In the
// port cuDNN computes each conv of models/hprob_unet.py::ResBlock and ATen
// then ran, each as a pass of its own over the bf16 activation: the conv's
// bias add (Convolution.cpp adds it after cuDNN's conv, with the bias cast to
// bf16 by one more launch), the pre-activation ReLU of the next conv
// (clamp_min), and, after the block's 1x1 conv, the skip conv's bias add and
// the residual add. These kernels do that work in one read of each input and
// one write of each output, rounding where ATen's passes round, so their
// outputs are bit-equal to theirs:
//
//   mode 1, after a 3x3 conv (in place):
//     y = relu(bf16(float(y) + float(bf16(bias[c]))))
//   mode 2, after the block's 1x1 conv (out over y, r a second buffer):
//     t = bf16(float(y) + float(bf16(bias[c])))                 ATen's add_
//     s = x, or bf16(float(ys) + float(bf16(skip_bias[c])))     the 1x1 skip
//     out = bf16(float(s) + float(t))                           the residual
//     r = relu(out), only where another block of the level follows
//   relu(u) = isnan(u) ? u : bf16(fmaxf(float(u), 0))           clamp_min
//
// What bounds it on this card: bytes. A launch moves 0.2-350 MB of bf16
// activation (mode 1 reads and writes it once; mode 2 reads two inputs and
// writes one or two outputs) and does a few operations per 16 bytes, so the
// least time is the bytes at 3.35 TB/s. The design follows from that:
// - the activations are channels_last, (M, C): a thread moves 8 consecutive
//   elements with one 16-byte load or store per tensor, neighbouring
//   threads on neighbouring addresses;
// - C need not be a multiple of 8 (the level-0 down width is 12): vector v
//   holds channels (8v + k) mod C, which repeat every P = lcm(C, 8) / 8
//   vectors. A block holds a multiple of P threads and the grid strides by
//   a multiple of it, so each thread's 8 channels never change: it reads
//   their biases once into registers (rounded to bf16 there, so the casts'
//   launches go) and the loop touches no memory but the activations;
// - kUnroll iterations' 16-byte loads are in flight a thread before any is
//   used;
// - one wave of resident blocks fills all SMs (the occupancy API, cached per
//   kernel and block size) and strides over the tensor: no tail wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;           // bf16 elements a 16-byte vector
constexpr int kUnroll = 4;        // iterations whose loads are in flight a thread
constexpr int kMaxThreads = 256;  // a block; P at most this
constexpr int kMaxDevices = 64;
constexpr int kKernels = 5;       // mode 1, and mode 2 by (skip bias, relu copy)

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ __nv_bfloat16 relu(__nv_bfloat16 u) {
  const float f = bf(u);
  return f != f ? u : __float2bfloat16(fmaxf(f, 0.f));
}

// the 8 biases of the channels of this thread's vectors, rounded to bf16
__device__ __forceinline__ void load_bias(float (&b)[kVec], const float* __restrict__ bias,
                                          int first, int channels) {
  int c = first;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    b[k] = bf(__float2bfloat16(__ldg(bias + c)));
    c = c + 1 == channels ? 0 : c + 1;
  }
}

// the 8 bf16 elements of a 16-byte vector, in place in registers
__device__ __forceinline__ __nv_bfloat16* elements(uint4& v) {
  return reinterpret_cast<__nv_bfloat16*>(&v);
}

__device__ __forceinline__ uint4 bias_relu(uint4 v, const float (&b)[kVec]) {
  __nv_bfloat16* h = elements(v);
#pragma unroll
  for (int k = 0; k < kVec; ++k) h[k] = relu(__float2bfloat16(bf(h[k]) + b[k]));
  return v;
}

template <bool kSkipBias>
__device__ __forceinline__ uint4 residual(uint4 y, uint4 s, const float (&b)[kVec],
                                          const float (&bs)[kVec]) {
  __nv_bfloat16* t = elements(y);
  const __nv_bfloat16* x = elements(s);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const __nv_bfloat16 tk = __float2bfloat16(bf(t[k]) + b[k]);
    const __nv_bfloat16 sk = kSkipBias ? __float2bfloat16(bf(x[k]) + bs[k]) : x[k];
    t[k] = __float2bfloat16(bf(sk) + bf(tk));
  }
  return y;
}

__device__ __forceinline__ uint4 relu_vec(uint4 v) {
  __nv_bfloat16* h = elements(v);
#pragma unroll
  for (int k = 0; k < kVec; ++k) h[k] = relu(h[k]);
  return v;
}

// mode 1: y = relu(y + bias), in place. blockDim.x and the grid's stride are
// multiples of period: every vector this thread visits starts at channel
// (8 * (threadIdx.x % period)) mod channels.
__global__ void __launch_bounds__(kMaxThreads)
hpu_epilogue_bias_relu_kernel(uint4* __restrict__ y, int n_vec, int period, int channels,
                              const float* __restrict__ bias) {
  float b[kVec];
  load_bias(b, bias, threadIdx.x % period * kVec % channels, channels);
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = y[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) y[i + u * stride] = bias_relu(v[u], b);
  }
  for (; i < n_vec; i += stride) y[i] = bias_relu(y[i], b);
}

// mode 2: y = s (+ skip_bias) + (y + bias), and r = relu(y) with kRelu.
template <bool kSkipBias, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
hpu_epilogue_residual_relu_kernel(uint4* __restrict__ y, const uint4* __restrict__ s,
                                  uint4* __restrict__ r, int n_vec, int period, int channels,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ skip_bias) {
  const int first = threadIdx.x % period * kVec % channels;
  float b[kVec], bs[kVec];
  load_bias(b, bias, first, channels);
  if (kSkipBias) load_bias(bs, skip_bias, first, channels);
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 vy[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      vy[u] = y[i + u * stride];
      vs[u] = s[i + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint4 out = residual<kSkipBias>(vy[u], vs[u], b, bs);
      y[i + u * stride] = out;
      if (kRelu) r[i + u * stride] = relu_vec(out);
    }
  }
  for (; i < n_vec; i += stride) {
    const uint4 out = residual<kSkipBias>(y[i], s[i], b, bs);
    y[i] = out;
    if (kRelu) r[i] = relu_vec(out);
  }
}

// Resident blocks an SM of each kernel and block size, and SMs of each
// device, found once (0: not yet asked).
int g_per_sm[kKernels][kMaxThreads + 1];
int g_sms[kMaxDevices];

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// Makes ``device`` current for the guard's life, where another device was.
struct OnDevice {
  int previous = -1, device;
  cudaError_t error;
  explicit OnDevice(int d) : device(d) {
    error = cudaGetDevice(&previous);
    if (error == cudaSuccess && previous != device) error = cudaSetDevice(device);
  }
  ~OnDevice() {
    if (previous >= 0 && previous != device) cudaSetDevice(previous);
  }
};

// Checks the sizes and finds the block and the grid of one wave of
// ``kernel`` on the current device. Returns a cudaError_t code.
template <typename Kernel>
int plan(Kernel kernel, int id, long long n_elem, int channels, int device, int* period,
         int* threads, int* blocks) {
  if (channels < 1 || n_elem % kVec || n_elem / kVec > INT32_MAX || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  *period = channels / gcd(channels, kVec);
  if (*period > kMaxThreads) return (int)cudaErrorInvalidValue;
  // a whole number of periods, and of warps where a block of 256 holds both
  const int warps = *period * 32 / gcd(*period, 32);
  const int unit = warps <= kMaxThreads ? warps : *period;
  *threads = kMaxThreads / unit * unit;
  cudaError_t e;
  if (g_sms[device] == 0) {
    e = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  int& per_sm = g_per_sm[id][*threads];
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, *threads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long long n_vec = n_elem / kVec;
  const long long need = (n_vec + *threads - 1) / *threads;
  const long long wave = (long long)g_sms[device] * per_sm;
  *blocks = (int)(need < wave ? need : wave);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// y (n_elem) bf16 channels_last activations of ``channels`` channels on CUDA
// device ``device``, 16-byte aligned, n_elem a multiple of 8; bias
// (channels,) f32. Writes relu(y + bias) over y on ``stream``. Returns a
// cudaError_t code.
int pmpu_hpu_bias_relu(void* y, long long n_elem, int channels, const void* bias, int device,
                       void* stream) {
  if (n_elem <= 0) return (int)cudaSuccess;
  const OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  int period, threads, blocks;
  const int rc = plan(hpu_epilogue_bias_relu_kernel, 0, n_elem, channels, device, &period,
                      &threads, &blocks);
  if (rc != (int)cudaSuccess) return rc;
  hpu_epilogue_bias_relu_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(y), (int)(n_elem / kVec), period, channels,
      static_cast<const float*>(bias));
  return (int)cudaGetLastError();
}

// y, s (n_elem) and r (n_elem, or null) bf16 channels_last tensors of one
// shape as above, none overlapping; bias and skip_bias (channels,) f32, or
// skip_bias null where s is the block's input itself. Writes s (+ skip_bias)
// + (y + bias) over y and, where r is not null, its ReLU to r. Returns a
// cudaError_t code.
int pmpu_hpu_residual(void* y, const void* s, void* r, long long n_elem, int channels,
                      const void* bias, const void* skip_bias, int device, void* stream) {
  if (n_elem <= 0) return (int)cudaSuccess;
  using Kernel = void (*)(uint4*, const uint4*, uint4*, int, int, int, const float*,
                          const float*);
  const Kernel kernels[4] = {hpu_epilogue_residual_relu_kernel<false, false>,
                             hpu_epilogue_residual_relu_kernel<false, true>,
                             hpu_epilogue_residual_relu_kernel<true, false>,
                             hpu_epilogue_residual_relu_kernel<true, true>};
  const int id = (skip_bias != nullptr) * 2 + (r != nullptr);
  const Kernel kernel = kernels[id];
  const OnDevice on(device);
  if (on.error != cudaSuccess) return (int)on.error;
  int period, threads, blocks;
  const int rc = plan(kernel, 1 + id, n_elem, channels, device, &period, &threads, &blocks);
  if (rc != (int)cudaSuccess) return rc;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(y), static_cast<const uint4*>(s), static_cast<uint4*>(r),
      (int)(n_elem / kVec), period, channels, static_cast<const float*>(bias),
      static_cast<const float*>(skip_bias));
  return (int)cudaGetLastError();
}

const char* pmpu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
