// Chunked gated linear recurrence (SSD / Mamba2 / mLSTM core), forward, as a
// CUDA kernel for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py:ssd_scan (body
// `_kernel`).  Same function:
//
//     h_t = exp(log_a_t) h_{t-1} + k_t v_t^T ;   y_t = q_t . h_t
//
// computed chunkwise with the TPU kernel's arithmetic.  Per chunk of Q steps:
// an inclusive cumsum `cum` of log_a; the intra-chunk term
// sum_{s<=t} (q_t.k_s) exp(clip(cum_t - cum_s)) v_s; the inter-chunk term
// exp(clip(cum_t)) q_t.h_in; the state update
// h_out = exp(clip(tot)) h_in + sum_s exp(clip(tot - cum_s)) k_s v_s^T, every
// exponent clipped to [-60, 0]; fp32 state and accumulation whatever the
// input types.  Where it differs from the TPU kernel: it also writes the final
// fp32 (N, P) state (prefill hands it to decode); it takes any S (the tail
// chunk is masked: a padded step has log_a = 0 and k = q = v = 0, so it leaves
// the state as it is and its y is not stored); q and k may have G < H heads,
// read as head h / (H/G) and never repeated; y is written in the caller's
// type (f32 or bf16).
//
// Design.  The TPU grid walks the chunks as its sequential minor dimension
// with the state in VMEM scratch.  Here one block of 256 threads owns one
// (b, h, P-tile) and loops over the chunks itself: the P columns of the
// state are independent (y[:, p] needs only v[:, p] and h[:, p]), so a
// block keeps only its (N, PT) fp32 slice of the state in shared memory, and
// narrower tiles give more blocks when B*H is small (Zamba2 at B 1: 64 heads
// x 2 tiles of 32 on 132 SMs).  A Q x Q fp32 score tile at Q 256 (256 KB)
// does not fit a block's 227 KB, so the intra-chunk work runs in 64 x 64
// sub-tiles: each 64-query tile scores only the 64-key tiles at or before it
// (the causal half), staging q and k 64 columns of N at a time, then
// accumulates the decay-weighted scores times the v tile.  Each thread holds
// a 4 x (PT/16) block of the output and a 4 x 4 block of scores in
// registers (rows ty + 16 r, columns tx + 16 c).  The cumsum is one warp's
// shuffle scan.  N (as far as the state slice fits shared memory: at chunk
// 256, 645 with PT 64 and 2772 with PT 16) and the types are runtime
// arguments; PT (16, 32, 64) is a template.
//
// Bound on an H100: operations.  At B1 H64 S2048 N = P = 64, chunk 256 the
// causal half of the products is ~6.5e9 FLOP (the TPU kernel's full Q x Q
// square would be ~1.1e10): ~2.2e9 of bf16 q.k scores, exact in fp32, at
// the 989 TFLOP/s tensor-core rate, and ~4.3e9 with f32 operands at
// 67 TFLOP/s, together 0.066 ms, against ~69 MB moved with Zamba2's one
// group of q/k in bf16 and v, y in fp32 (0.021 ms at 3.35 TB/s).  This kernel does its products as fp32 FMAs from
// shared memory and recomputes the scores for every P tile, so it runs far
// from that bound; wgmma tiles fed by TMA are the step that closes the gap.
//
// The launcher takes PyTorch's current stream, allocates nothing and returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kTile = 64;       // queries per tile, keys per tile
constexpr int kNB = 64;         // columns of N staged per pass
constexpr int kLd = kNB + 1;    // padded row of a staged q/k tile

__device__ __forceinline__ float ld(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, int bf16, size_t i, float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// exp of an exponent clipped to [-60, 0], as the TPU kernel takes it
__device__ __forceinline__ float exp_clip(float x) {
  return expf(fminf(fmaxf(x, -60.0f), 0.0f));
}

// dst[r][c] = src[base + r * ld_src + c] for r < rows, c < cols, else 0;
// a kTile x WIDTH tile with row stride DST_LD
template <int WIDTH, int DST_LD>
__device__ __forceinline__ void stage(float* dst, const void* src, int bf16,
                                      size_t base, int ld_src, int rows,
                                      int cols) {
  for (int i = threadIdx.x; i < kTile * WIDTH; i += kThreads) {
    const int r = i / WIDTH, c = i % WIDTH;
    dst[r * DST_LD + c] =
        (r < rows && c < cols)
            ? ld(src, bf16, base + static_cast<size_t>(r) * ld_src + c)
            : 0.0f;
  }
}

template <int PT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const void* __restrict__ q, const void* __restrict__ k,
                const void* __restrict__ v, const void* __restrict__ la,
                void* __restrict__ y, float* __restrict__ state, int H, int G,
                int S, int N, int P, int Q, int qk_bf16, int v_bf16,
                int la_bf16, int y_bf16) {
  constexpr int CPT = PT / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* hs = smem;                       // [N][PT]          the state slice
  float* qs = hs + N * PT;                // [kTile][kLd]     q tile
  float* ks = qs + kTile * kLd;           // [kTile][kLd]     k tile
  float* vs = ks + kTile * kLd;           // [kTile][PT]      v tile
  float* ws = vs + kTile * PT;            // [kTile][kTile+1] weighted scores
  float* cum = ws + kTile * (kTile + 1);  // [Q]              cumsum of log_a

  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hg = h / (H / G);
  const int pw = min(PT, P - p0);         // this tile's valid columns
  const size_t qk_base = (static_cast<size_t>(b) * G + hg) * S * N;
  const size_t v_base = (static_cast<size_t>(b) * H + h) * S * P + p0;
  const size_t la_base = (static_cast<size_t>(b) * H + h) * S;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const bool q_resident = N <= kNB;       // one staged q tile covers N

  for (int i = tid; i < N * PT; i += kThreads) hs[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);         // valid steps of this chunk
    __syncthreads();                      // the last chunk is done with cum
    for (int t = tid; t < Q; t += kThreads)
      cum[t] = t < L ? ld(la, la_bf16, la_base + c0 + t) : 0.0f;
    __syncthreads();
    if (tid < 32) {                       // inclusive scan, one warp
      float carry = 0.0f;
      for (int base = 0; base < Q; base += 32) {
        const int t = base + tid;
        float x = t < Q ? cum[t] : 0.0f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float n = __shfl_up_sync(0xffffffffu, x, off);
          if (tid >= off) x += n;
        }
        x += carry;
        if (t < Q) cum[t] = x;
        carry = __shfl_sync(0xffffffffu, x, 31);
      }
    }
    __syncthreads();
    const float tot = cum[Q - 1];         // padded steps add 0

    // -- y for each 64-query tile of the chunk --------------------------------
    for (int t0 = 0; t0 < L; t0 += kTile) {
      const int qrows = min(kTile, L - t0);
      const size_t q_rows_base = qk_base + static_cast<size_t>(c0 + t0) * N;
      float acc[4][CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;

      // inter-chunk: acc = q . h_in
      for (int n0 = 0; n0 < N; n0 += kNB) {
        const int nl = min(kNB, N - n0);
        __syncthreads();
        stage<kNB, kLd>(qs, q, qk_bf16, q_rows_base + n0, N, qrows, nl);
        __syncthreads();
        for (int n = 0; n < nl; ++n) {
          float a[4], hv[CPT];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qs[(ty + 16 * r) * kLd + n];
#pragma unroll
          for (int c = 0; c < CPT; ++c) hv[c] = hs[(n0 + n) * PT + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], hv[c], acc[r][c]);
        }
      }
      float cum_t[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        cum_t[r] = cum[min(t0 + ty + 16 * r, Q - 1)];
        const float e = exp_clip(cum_t[r]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] *= e;
      }

      // intra-chunk: the key tiles at or before this query tile
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        const int krows = min(kTile, L - s0);
        const size_t k_rows_base = qk_base + static_cast<size_t>(c0 + s0) * N;
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[r][j] = 0.0f;
        for (int n0 = 0; n0 < N; n0 += kNB) {
          const int nl = min(kNB, N - n0);
          __syncthreads();   // the last tile's ws/vs (and qs, ks) are consumed
          if (!q_resident)
            stage<kNB, kLd>(qs, q, qk_bf16, q_rows_base + n0, N, qrows, nl);
          stage<kNB, kLd>(ks, k, qk_bf16, k_rows_base + n0, N, krows, nl);
          __syncthreads();
          for (int n = 0; n < nl; ++n) {
            float a[4], bk[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = qs[(ty + 16 * r) * kLd + n];
#pragma unroll
            for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * kLd + n];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int j = 0; j < 4; ++j) sc[r][j] = fmaf(a[r], bk[j], sc[r][j]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = t0 + ty + 16 * r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            ws[(ty + 16 * r) * (kTile + 1) + tx + 16 * j] =
                s <= t ? sc[r][j] * exp_clip(cum_t[r] - cum[min(s, Q - 1)])
                       : 0.0f;
          }
        }
        stage<PT, PT>(vs, v, v_bf16, v_base + static_cast<size_t>(c0 + s0) * P,
                      P, krows, pw);
        __syncthreads();
        for (int s = 0; s < krows; ++s) {
          float wr[4], vv[CPT];
#pragma unroll
          for (int r = 0; r < 4; ++r) wr[r] = ws[(ty + 16 * r) * (kTile + 1) + s];
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vs[s * PT + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(wr[r], vv[c], acc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + ty + 16 * r;
        if (t >= L) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int p = tx + 16 * c;
          if (p < pw)
            st(y, y_bf16, v_base + static_cast<size_t>(c0 + t) * P + p,
               acc[r][c]);
        }
      }
    }

    // -- state update: h = exp(tot) h + sum_s exp(tot - cum_s) k_s v_s^T -------
    const float a_tot = exp_clip(tot);
    for (int n0 = 0; n0 < N; n0 += kNB) {
      const int nl = min(kNB, N - n0);
      float inc[4][CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) inc[r][c] = 0.0f;
      for (int s0 = 0; s0 < L; s0 += kTile) {
        const int krows = min(kTile, L - s0);
        const size_t k_rows_base = qk_base + static_cast<size_t>(c0 + s0) * N;
        __syncthreads();
        for (int i = tid; i < kTile * kNB; i += kThreads) {
          const int r = i / kNB, c = i % kNB;
          ks[r * kLd + c] =
              (r < krows && c < nl)
                  ? ld(k, qk_bf16, k_rows_base + static_cast<size_t>(r) * N +
                                       n0 + c) *
                        exp_clip(tot - cum[s0 + r])
                  : 0.0f;
        }
        stage<PT, PT>(vs, v, v_bf16, v_base + static_cast<size_t>(c0 + s0) * P,
                      P, krows, pw);
        __syncthreads();
        for (int s = 0; s < krows; ++s) {
          float kk[4], vv[CPT];
#pragma unroll
          for (int r = 0; r < 4; ++r) kk[r] = ks[s * kLd + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vs[s * PT + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < CPT; ++c) inc[r][c] = fmaf(kk[r], vv[c], inc[r][c]);
        }
      }
      // each thread rewrites only its own entries, which no thread reads
      // before the next chunk's first barrier
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = ty + 16 * r;
        if (n >= nl) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float* hp = hs + (n0 + n) * PT + tx + 16 * c;
          *hp = fmaf(a_tot, *hp, inc[r][c]);
        }
      }
    }
  }

  if (state != nullptr) {
    __syncthreads();
    float* out = state + (static_cast<size_t>(b) * H + h) * N * P + p0;
    for (int i = tid; i < N * PT; i += kThreads) {
      const int n = i / PT, c = i % PT;
      if (c < pw) out[static_cast<size_t>(n) * P + c] = hs[i];
    }
  }
}

// the dynamic shared memory a block of the current device may opt in to
cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

template <int PT>
int launch(const void* q, const void* k, const void* v, const void* la,
           void* y, float* state, int B, int H, int G, int S, int N, int P,
           int Q, int smem, int qk_bf16, int v_bf16, int la_bf16, int y_bf16,
           cudaStream_t stream) {
  // raise the shared-memory limit to the opt-in maximum once per instance,
  // at the first launch (never again, so a later launch may be captured
  // into a CUDA graph); the launch's own size decides the occupancy
  static bool limit_raised = false;
  if (!limit_raised) {
    int optin = 0;
    cudaError_t err = smem_optin(&optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_scan_kernel<PT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_raised = true;
  }
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan_kernel<PT><<<grid, kThreads, smem, stream>>>(
      q, k, v, la, y, state, H, G, S, N, P, Q, qk_bf16, v_bf16, la_bf16,
      y_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// *bytes: the shared memory a block may opt in to on the current device,
// which bounds the wrapper's choice of P tile.
int ssd_scan_smem_optin(int* bytes) {
  return static_cast<int>(smem_optin(bytes));
}

// q, k (B,G,S,N); v, y (B,H,S,P); la (B,H,S); state (B,H,N,P) fp32 or null;
// all contiguous.  *_bf16: 1 for bfloat16, 0 for float32.  pt: 16, 32 or 64;
// smem: the dynamic shared memory in bytes (the wrapper's formula).
int ssd_scan_launch(const void* q, const void* k, const void* v,
                    const void* la, void* y, void* state, int B, int H, int G,
                    int S, int N, int P, int Q, int pt, int smem, int qk_bf16,
                    int v_bf16, int la_bf16, int y_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(state);
  switch (pt) {
    case 16: return launch<16>(q, k, v, la, y, st, B, H, G, S, N, P, Q, smem,
                               qk_bf16, v_bf16, la_bf16, y_bf16, s);
    case 32: return launch<32>(q, k, v, la, y, st, B, H, G, S, N, P, Q, smem,
                               qk_bf16, v_bf16, la_bf16, y_bf16, s);
    case 64: return launch<64>(q, k, v, la, y, st, B, H, G, S, N, P, Q, smem,
                               qk_bf16, v_bf16, la_bf16, y_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
