// Blocked (flash) GQA attention, forward, as a CUDA kernel for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention (body `_kernel`).  Same function: q (B,H,Sq,D) and k, v
// (B,Hkv,Sk,D), f32 or bf16; queries aligned to the END of the keys
// (q_offset = Sk - Sq); causal and sliding-window masks; q scaled by
// 1/sqrt(D) in fp32 before the product; fp32 running max, denominator and
// accumulator across KV tiles; masked scores set to -1e38 and the output
// divided by max(l, 1e-30), as the TPU kernel does; KV head h / (H/Hkv),
// never repeated.
//
// Design.  The TPU grid walks the KV blocks of one Q tile as its sequential
// last dimension with the running state in VMEM scratch.  Here one block of
// 256 threads owns one (b, h, 64-query tile) and loops over the KV tiles
// itself, the running state in registers.  The loop covers only the tiles
// the causal and window predicates can reach (the TPU kernel's `pl.when`
// skip, made into loop bounds).  Q (pre-scaled), each K/V tile and the
// tile's probabilities are staged in shared memory as fp32; four adjacent
// lanes share a query row: each scores BK/4 keys, the row max and sum are
// reduced with two shuffles, and each accumulates D/4 output dimensions
// (interleaved, so the four lanes hit four banks).  Rows are padded by one
// float against bank conflicts.  Ragged tails: q rows past Sq are computed
// on zeros and not stored, keys past Sk are masked, so any Sq and Sk work
// (the TPU kernel needs block multiples).  D is a template parameter
// (16, 32, 64, 128), the element type another.
//
// Bound on an H100: operations.  At B1 H32 D128 S2048 causal the products
// are ~3.4e10 FLOP (35 us at the 989 TFLOP/s bf16 tensor-core peak) against
// ~42 MB moved (12.5 us at 3.35 TB/s).  This kernel does its products with
// fp32 FMAs from shared memory, not on the tensor cores, so it runs far
// from that bound; wgmma tiles fed by TMA are the step that closes the gap.
//
// The launcher takes PyTorch's current stream, allocates nothing and returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e38f;     // the TPU kernel's NEG_INF
constexpr int kThreads = 256;
constexpr int kRowThreads = 4;          // lanes sharing one query row
constexpr int kBQ = kThreads / kRowThreads;   // 64 query rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <int D> struct Tile {
  static constexpr int BK = D >= 128 ? 32 : 64;   // keys per KV tile
  static constexpr int smem_floats =
      kBQ * (D + 1) + BK * (D + 1) + BK * D + kBQ * (BK + 1);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                 int Sq, int Sk, int causal, int window, float scale) {
  constexpr int BK = Tile<D>::BK;
  constexpr int KPT = BK / kRowThreads;   // keys scored per lane
  constexpr int DPT = D / kRowThreads;    // output dims per lane
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D + 1]  scaled queries
  float* Ks = Qs + kBQ * (D + 1);         // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);          // [BK][D]
  float* Ps = Vs + BK * D;                // [kBQ][BK + 1] probabilities

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int sub = tid % kRowThreads;
  const size_t qbase = (static_cast<size_t>(b) * H + h) * Sq * D;
  const size_t kbase = (static_cast<size_t>(b) * Hkv + hk) * Sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    Qs[r * (D + 1) + c] =
        qi < Sq ? to_f32(q[qbase + static_cast<size_t>(qi) * D + c]) * scale
                : 0.0f;
  }

  // the KV tiles some query of this tile can reach
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + kBQ, Sq) - 1 + q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  const int qpos = q0 + row + q_offset;
  float m = kNegInf, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      float kk = 0.0f, vv = 0.0f;
      if (kj < Sk) {
        const size_t g = kbase + static_cast<size_t>(kj) * D + c;
        kk = to_f32(k[g]);
        vv = to_f32(v[g]);
      }
      Ks[r * (D + 1) + c] = kk;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[KPT];
    float tmax = kNegInf;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * kRowThreads + sub;
      const float* qr = Qs + row * (D + 1);
      const float* kr = Ks + j * (D + 1);
      float dot = 0.0f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
      const int kpos = k0 + j;
      const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      s[jj] = ok ? dot : kNegInf;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      Ps[row * (BK + 1) + jj * kRowThreads + sub] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();      // the row's four lanes wrote its probabilities
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= corr;
    const float* pr = Ps + row * (BK + 1);
    for (int j = 0; j < BK; ++j) {
      const float p = pr[j];
      const float* vr = Vs + j * D + sub;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[d * kRowThreads], acc[d]);
    }
  }

  const int qi = q0 + row;
  if (qi < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + qbase + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      orow[d * kRowThreads + sub] = from_f32<T>(acc[d] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Sk, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tile<D>::smem_floats;
  // raise the shared-memory limit once per instance, at the first launch
  // (never again, so a later launch may be captured into a CUDA graph)
  static bool limit_raised = false;
  if (smem > 48 * 1024 && !limit_raised) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_raised = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, causal,
      window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Sq, int Sk, int D, int causal, int window,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o contiguous; o is (B,H,Sq,D).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int Hkv, int Sq, int Sk,
                           int D, int causal, int window, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                                   window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
