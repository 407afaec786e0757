// The dense MLP's gelu as the reference rounds it, in one pass, as a CUDA
// kernel for sm_90a.
//
// Replaces no Pallas kernel: the reference calls jax.nn.gelu (its tanh form)
// in src/repro/models/layers.py:71, and XLA rounds each of its bf16 steps
//   y = g * (0.5 * (1 + tanh(c * (g + k * (g * g * g)))))
// with c = sqrt(2/pi) and k = 0.044715 rounded to the input's type first.
// PyTorch's eager version of those steps (kernels/gelu_stepwise.py,
// gelu_stepwise_plain) makes nine passes over memory; F.gelu makes one but
// rounds once, which moves a 48-layer Whisper's logits past the port's
// tolerance.  Here each thread reads its elements once, computes every step
// in fp32 registers, rounds each result to the input's type as PyTorch's
// elementwise ops do (bf16: __float2bfloat16_rn; f32: no-op), and writes
// once.  __fmul_rn/__fadd_rn keep nvcc from contracting a product and a sum
// into one FMA, which would round once where the eager ops round twice.
//
// Bound: bytes.  n elements read and n written; about 10 operations an
// element against 4 bytes (bf16) is far under the card's ratio of
// operations to bytes, but the nine conversions to bf16 are not (see
// rnd): the kernel runs at 2.5x the byte bound.  bf16 takes 16-byte
// vectors of 8 elements, f32 of 4, when the pointers are 16-byte aligned;
// the remainder (and an unaligned tensor) takes one element a thread.  A
// grid-stride loop over at most 2048 blocks of 256 threads.
//
// The launcher takes PyTorch's current stream, allocates nothing, and
// returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x rounded to the nearest bf16 (ties to even), kept as a float.  A
// conversion to bf16 issues at a sixteenth of the FMA rate, so nine an
// element take most of the kernel's time; a rounding on the bits (two
// integer ops, a mask and a NaN test) ran slower still (PERF.md).
// Converting two values in one instruction is the next step.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// g * (0.5 * (1 + tanh(c * (g + k * (g * g * g))))), each step rounded.
template <bool BF16>
__device__ __forceinline__ float gelu_steps(float g, float k, float c) {
  float a = rnd<BF16>(__fmul_rn(g, g));
  a = rnd<BF16>(__fmul_rn(a, g));
  a = rnd<BF16>(__fmul_rn(k, a));
  a = rnd<BF16>(__fadd_rn(g, a));
  a = rnd<BF16>(__fmul_rn(c, a));
  a = rnd<BF16>(tanhf(a));
  a = rnd<BF16>(__fadd_rn(1.0f, a));
  a = rnd<BF16>(__fmul_rn(0.5f, a));
  return rnd<BF16>(__fmul_rn(g, a));
}

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(256)
gelu_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
            long long nvec, float k, float c) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int VEC = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 v = reinterpret_cast<const uint4*>(x)[i];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      e[j] = from_f<T>(gelu_steps<BF16>(to_f(e[j]), k, c));
    }
    reinterpret_cast<uint4*>(y)[i] = v;
  }
  for (long long i = nvec * VEC + tid; i < n; i += stride) {
    y[i] = from_f<T>(gelu_steps<BF16>(to_f(x[i]), k, c));
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, float k, float c,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const long long nvec = aligned ? n / VEC : 0;
  const long long work = nvec + (n - nvec * VEC);
  const long long want = (work + 255) / 256;
  const int blocks = (int)(want < 2048 ? (want > 0 ? want : 1) : 2048);
  gelu_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, nvec, k, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16.  k and c are the constants 0.044715 and
// sqrt(2/pi) already rounded to the type.
int gelu_stepwise_launch(const void* x, void* y, long long n, int dtype,
                         float k, float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, k, c, s);
  return launch<float>(x, y, n, k, c, s);
}

}  // extern "C"
