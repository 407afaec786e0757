// silu as the reference rounds it, and its gradient, each in one pass, as
// CUDA kernels for sm_90a.
//
// Replaces no Pallas kernel: the reference calls jax.nn.silu (the MoE
// experts, Mamba2's gates, the mLSTM's gates, the dense silu MLP), and XLA
// rounds each of its bf16 steps
//   s = 1 / (exp(-x) + 1),  y = x * s
// and each step of its VJP (the logistic's JVP rule)
//   dx = dy * s + (x * dy) * (s * (1 - s))
// (kernels/silu_stepwise.py, silu_stepwise_plain / silu_stepwise_vjp_plain).
// PyTorch's eager version of those steps makes five passes over memory
// forward and about ten backward; F.silu makes one but rounds once, which
// moves the reduced Zamba2's logits 4-8% of their scale.  Here each thread
// reads its elements once, computes every step in fp32 registers, rounds
// each result to the input's type as PyTorch's elementwise ops do, and
// writes once (stepwise.cuh).  expf and the correctly rounded 1 / d are
// what PyTorch's exp and reciprocal compute (not __expf), so the two agree
// bit for bit.
//
// Bound: bytes (2 or 3 tensors an element against about 5 or 10 fp32
// operations); the roundings (4 an element forward, 9 backward, two to a
// conversion) and expf are the kernel's own work.

#include "stepwise.cuh"

namespace {

using stepwise::F2;
using stepwise::rnd;
using stepwise::splat;

// The logistic as XLA's steps round it: 1 / (exp(-x) + 1).
template <bool BF16>
__device__ __forceinline__ F2 logistic(F2 x) {
  F2 e = rnd<BF16>(F2{expf(-x.x), expf(-x.y)});
  e = rnd<BF16>(e + splat(1.0f));
  return rnd<BF16>(F2{__fdiv_rn(1.0f, e.x), __fdiv_rn(1.0f, e.y)});
}

struct SiluFwd {
  template <bool BF16>
  __device__ __forceinline__ F2 apply(F2 x, F2) const {
    return x * logistic<BF16>(x);
  }
};

struct SiluBwd {
  template <bool BF16>
  __device__ __forceinline__ F2 apply(F2 x, F2 dy) const {
    const F2 s = logistic<BF16>(x);
    const F2 a = rnd<BF16>(dy * s);
    const F2 b = rnd<BF16>(x * dy);
    const F2 d = rnd<BF16>(s * rnd<BF16>(splat(1.0f) - s));
    return a + rnd<BF16>(b * d);
  }
};

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16.
int silu_stepwise_launch(const void* x, void* y, long long n, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return stepwise::launch<__nv_bfloat16>(x, nullptr, y, n, SiluFwd{}, s);
  }
  return stepwise::launch<float>(x, nullptr, y, n, SiluFwd{}, s);
}

// dx = the VJP of silu at x for dy, in the same type.
int silu_stepwise_bwd_launch(const void* x, const void* dy, void* dx,
                             long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return stepwise::launch<__nv_bfloat16>(x, dy, dx, n, SiluBwd{}, s);
  }
  return stepwise::launch<float>(x, dy, dx, n, SiluBwd{}, s);
}

}  // extern "C"
