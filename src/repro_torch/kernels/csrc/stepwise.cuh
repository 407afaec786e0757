// The pieces the stepwise activations' kernels share (gelu_stepwise.cu,
// silu_stepwise.cu): values in pairs, each step rounded to the tensor's
// type as PyTorch's eager ops round it, and one pass over memory.
//
// Rounding.  An eager bf16 op computes in fp32 and rounds its result to
// bf16 (round to nearest, ties to even); to repeat a chain of such ops
// bit for bit, the kernel rounds after every step.  A conversion to bf16
// issues at a sixteenth of the FMA rate, so with one value a conversion
// the roundings bound the kernel.  Here the values go in pairs: one
// cvt.rn.bf16x2.f32 (__float22bfloat162_rn) rounds two, and two integer
// ops (a shift and a mask) widen them back, which halves the conversions.
// f32 rounds nothing.  The products and sums use __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts no product and sum into one FMA, which
// would round once where the eager ops round twice.
//
// Memory.  A thread takes 16-byte vectors (8 bf16 or 4 f32 values) when
// every pointer is 16-byte aligned; the remainder, and a tensor off that
// alignment, one element a thread (computed as a pair of equal values).
// A grid-stride loop over at most 2048 blocks of 256 threads.  The
// launcher takes PyTorch's current stream, allocates nothing, and returns
// cudaGetLastError() right after the launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stepwise {

struct F2 {
  float x, y;
};

__device__ __forceinline__ F2 splat(float v) { return {v, v}; }
__device__ __forceinline__ F2 operator*(F2 a, F2 b) {
  return {__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)};
}
__device__ __forceinline__ F2 operator+(F2 a, F2 b) {
  return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y)};
}
__device__ __forceinline__ F2 operator-(F2 a, F2 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y)};
}

// A pair rounded to bf16 in one conversion, as the word that holds it
// (x in the low half, as it lies in memory).
__device__ __forceinline__ uint32_t pack_bf16(F2 v) {
  __nv_bfloat162 h = __float22bfloat162_rn(make_float2(v.x, v.y));
  return *reinterpret_cast<uint32_t*>(&h);
}

// A word of two bf16 values widened to fp32: exact, the bf16 bits are the
// high half of the float's.
__device__ __forceinline__ F2 unpack_bf16(uint32_t u) {
  return {__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u)};
}

// A pair rounded to the type, kept as floats.
template <bool BF16>
__device__ __forceinline__ F2 rnd(F2 v) {
  if constexpr (BF16) {
    return unpack_bf16(pack_bf16(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// y = op(a) or op(a, b) elementwise; op.template apply<BF16>(a, b) takes
// and returns a pair, every step but the last rounded (the store rounds
// the last).  Without b (TWO false) the op is given a for both.
template <typename T, bool TWO, typename Op>
__global__ void __launch_bounds__(256)
map_kernel(const T* __restrict__ a, const T* __restrict__ b,
           T* __restrict__ y, long long n, long long nvec, Op op) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int VEC = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < nvec; i += stride) {
    const uint4 va = reinterpret_cast<const uint4*>(a)[i];
    const uint4 vb = TWO ? reinterpret_cast<const uint4*>(b)[i] : va;
    const uint32_t* wa = reinterpret_cast<const uint32_t*>(&va);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(&vb);
    uint4 vy;
    uint32_t* wy = reinterpret_cast<uint32_t*>(&vy);
    if constexpr (BF16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wy[j] = pack_bf16(op.template apply<true>(unpack_bf16(wa[j]),
                                                  unpack_bf16(wb[j])));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        F2 r = op.template apply<false>(
            F2{__uint_as_float(wa[j]), __uint_as_float(wa[j + 1])},
            F2{__uint_as_float(wb[j]), __uint_as_float(wb[j + 1])});
        wy[j] = __float_as_uint(r.x);
        wy[j + 1] = __float_as_uint(r.y);
      }
    }
    reinterpret_cast<uint4*>(y)[i] = vy;
  }
  for (long long i = nvec * VEC + tid; i < n; i += stride) {
    const float fa = to_f(a[i]);
    const float fb = TWO ? to_f(b[i]) : fa;
    y[i] = from_f<T>(op.template apply<BF16>(splat(fa), splat(fb)).x);
  }
}

// Launch op over n elements; b may be null (a one-input op).
template <typename T, typename Op>
int launch(const void* a, const void* b, void* y, long long n, Op op,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool aligned = al(a) && al(y) && (b == nullptr || al(b));
  const long long nvec = aligned ? n / VEC : 0;
  const long long work = nvec + (n - nvec * VEC);
  const long long want = (work + 255) / 256;
  const int blocks = (int)(want < 2048 ? (want > 0 ? want : 1) : 2048);
  if (b == nullptr) {
    map_kernel<T, false, Op><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(a),
        static_cast<T*>(y), n, nvec, op);
  } else {
    map_kernel<T, true, Op><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(y), n, nvec, op);
  }
  return (int)cudaGetLastError();
}

}  // namespace stepwise
