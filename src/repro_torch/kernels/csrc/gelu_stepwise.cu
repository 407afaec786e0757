// The dense MLP's gelu as the reference rounds it, and its gradient, each
// in one pass, as CUDA kernels for sm_90a.
//
// Replaces no Pallas kernel: the reference calls jax.nn.gelu (its tanh form)
// in src/repro/models/layers.py:71, and XLA rounds each of its bf16 steps
//   y = g * (0.5 * (1 + tanh(c * (g + k * (g * g * g)))))
// with c = sqrt(2/pi) and k = 0.044715 rounded to the input's type first,
// and each step of its VJP (kernels/gelu_stepwise.py,
// gelu_stepwise_vjp_plain):
//   g2 = g * g, t = tanh(c * (g + k * (g2 * g))),
//   p = (0.5 * (g * dy)) * (1 - t), s = c * (p + p * t),
//   dx = (dy * (0.5 * (1 + t)) + s) + (k * s) * (3 * g2).
// PyTorch's eager version of those steps makes nine passes over memory
// forward and some twenty backward; F.gelu makes one but rounds once,
// which moves a 48-layer Whisper's logits past the port's tolerance.  Here
// each thread reads its elements once, computes every step in fp32
// registers, rounds each result to the input's type as PyTorch's
// elementwise ops do, and writes once (stepwise.cuh).  The rounding of
// 0.5 * (1 + t) is dropped: 1 + t of a rounded t in [-1, 1] is 0 or at
// least 2**-8 (2**-24 in f32), so halving it is exact.  tanhf is the
// libdevice function PyTorch's tanh calls, so the two agree bit for bit.
//
// Bound: bytes (2 or 3 tensors an element against about 10 or 22 fp32
// operations), but the roundings (8 an element forward, 20 backward, two
// to a conversion) issue at a sixteenth of the FMA rate, and with tanhf
// they are the most of the time (PERF.md).

#include "stepwise.cuh"

namespace {

using stepwise::F2;
using stepwise::rnd;
using stepwise::splat;

__device__ __forceinline__ F2 tanh2(F2 v) { return {tanhf(v.x), tanhf(v.y)}; }

struct GeluFwd {
  float k, c;
  template <bool BF16>
  __device__ __forceinline__ F2 apply(F2 g, F2) const {
    F2 a = rnd<BF16>(g * g);
    a = rnd<BF16>(a * g);
    a = rnd<BF16>(splat(k) * a);
    a = rnd<BF16>(g + a);
    a = rnd<BF16>(splat(c) * a);
    a = rnd<BF16>(tanh2(a));
    a = splat(0.5f) * rnd<BF16>(splat(1.0f) + a);
    return g * a;
  }
};

struct GeluBwd {
  float k, c;
  template <bool BF16>
  __device__ __forceinline__ F2 apply(F2 g, F2 dy) const {
    const F2 g2 = rnd<BF16>(g * g);
    F2 a = rnd<BF16>(g2 * g);
    a = rnd<BF16>(splat(k) * a);
    a = rnd<BF16>(g + a);
    a = rnd<BF16>(splat(c) * a);
    const F2 t = rnd<BF16>(tanh2(a));
    const F2 half = splat(0.5f) * rnd<BF16>(splat(1.0f) + t);
    const F2 n = rnd<BF16>(dy * half);
    const F2 o = rnd<BF16>(splat(0.5f) * rnd<BF16>(g * dy));
    const F2 p = rnd<BF16>(o * rnd<BF16>(splat(1.0f) - t));
    const F2 s = rnd<BF16>(splat(c) * rnd<BF16>(p + rnd<BF16>(p * t)));
    const F2 u = rnd<BF16>(rnd<BF16>(splat(k) * s) *
                           rnd<BF16>(splat(3.0f) * g2));
    return rnd<BF16>(n + s) + u;
  }
};

template <typename T>
int fwd(const void* x, void* y, long long n, float k, float c,
        cudaStream_t s) {
  return stepwise::launch<T>(x, nullptr, y, n, GeluFwd{k, c}, s);
}

template <typename T>
int bwd(const void* x, const void* dy, void* dx, long long n, float k,
        float c, cudaStream_t s) {
  return stepwise::launch<T>(x, dy, dx, n, GeluBwd{k, c}, s);
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16.  k and c are the constants 0.044715 and
// sqrt(2/pi) already rounded to the type.
int gelu_stepwise_launch(const void* x, void* y, long long n, int dtype,
                         float k, float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, y, n, k, c, s);
  return fwd<float>(x, y, n, k, c, s);
}

// dx = the VJP of gelu at x for dy; the same types and constants.
int gelu_stepwise_bwd_launch(const void* x, const void* dy, void* dx,
                             long long n, int dtype, float k, float c,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return bwd<__nv_bfloat16>(x, dy, dx, n, k, c, s);
  return bwd<float>(x, dy, dx, n, k, c, s);
}

}  // extern "C"
