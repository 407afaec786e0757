// MoE top-K router with first-come capacity positions, as a CUDA kernel for
// sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/router_topk.py:router_topk
// (body `_kernel`).  Same function: logits (T,E) f32 -> softmax in fp32,
// iterative top-K (argmax, first index on ties, the chosen expert masked
// out), weights renormalised by max(sum, 1e-9), and each (token, k) entry's
// position in its expert's lane in first-come order over the flattened
// (token, k) sequence, keep = pos < capacity.  Outputs w (T,K) f32, idx and
// pos (T,K) i32, keep (T,K) u8.
//
// Design.  The TPU kernel carries per-expert lane counters in VMEM scratch
// across its sequential token-block grid; CUDA blocks run in no order, so,
// as a2a_route does, ONE block walks the token tiles in order and keeps the
// E cursors in shared memory.  Per tile of 512 tokens: each thread routes
// one token (its softmax sum taken left to right, the K picks by repeated
// argmax over the probabilities) and parks its K experts in shared memory;
// then the tile's T_tile*K entries are ranked in flattened order in chunks
// of 512: a thread takes its rank among same-expert lanes of its warp with
// __match_any_sync, the per-warp expert counts go to shared memory, and the
// rank among earlier warps is a sum over them.  Any T (the TPU kernel needs
// block_t | T), E sized at launch (shared memory holds E*(16+1) cursors and
// counts plus the tile's experts), K up to 8.
//
// Bound on an H100: bytes, T*E*4 read and T*K*13 written (at T 2048, E 8,
// K 2: ~0.12 MB, well under 1 us).  One block is latency-bound, not
// bandwidth-bound; a multi-block form (per-block histograms and a scan over
// blocks) is the step that makes it fast.
//
// The launcher takes PyTorch's current stream, allocates nothing, and
// returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;           // one token per thread per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;

__global__ void __launch_bounds__(kThreads)
router_topk_kernel(const float* __restrict__ logits, int T, int E, int K,
                   int capacity, float* __restrict__ w_out,
                   int* __restrict__ idx_out, int* __restrict__ pos_out,
                   unsigned char* __restrict__ keep_out) {
  extern __shared__ int smem[];
  int* cursor = smem;                   // [E]           lane write cursors
  int* wcount = cursor + E;             // [kWarps][E]   per-warp counts
  int* tile_e = wcount + kWarps * E;    // [kThreads*K]  the tile's experts
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < E * (kWarps + 1); i += kThreads) smem[i] = 0;

  for (int base = 0; base < T; base += kThreads) {
    const int t = base + tid;
    if (t < T) {
      const float* row = logits + static_cast<size_t>(t) * E;
      float m = row[0];
      for (int j = 1; j < E; ++j) m = fmaxf(m, row[j]);
      float s = 0.0f;
      for (int j = 0; j < E; ++j) s += expf(row[j] - m);
      int chosen[kMaxK];
      float wk[kMaxK];
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        chosen[kk] = -1;
        wk[kk] = 0.0f;
        if (kk < K) {
          float best = -1.0f;           // below every probability
          int bi = 0;
          for (int j = 0; j < E; ++j) {
            bool taken = false;
#pragma unroll
            for (int c = 0; c < kMaxK; ++c) taken |= (c < kk && chosen[c] == j);
            if (taken) continue;
            const float p = expf(row[j] - m) / s;
            if (p > best) {
              best = p;
              bi = j;
            }
          }
          chosen[kk] = bi;
          wk[kk] = best;
        }
      }
      float ws = wk[0];
#pragma unroll
      for (int kk = 1; kk < kMaxK; ++kk)
        if (kk < K) ws += wk[kk];
      const float den = fmaxf(ws, 1e-9f);
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < K) {
          const size_t g = static_cast<size_t>(t) * K + kk;
          w_out[g] = wk[kk] / den;
          idx_out[g] = chosen[kk];
          tile_e[tid * K + kk] = chosen[kk];
        }
      }
    }
    __syncthreads();

    // rank the tile's entries in flattened (token, k) order
    const int n_entries = min(kThreads, T - base) * K;
    for (int eb = 0; eb < n_entries; eb += kThreads) {
      const int i = eb + tid;
      const int e = i < n_entries ? tile_e[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      const int wrank = __popc(peers & ((1u << lane) - 1u));
      if (e >= 0 && lane == __ffs(peers) - 1) wcount[warp * E + e] = __popc(peers);
      __syncthreads();
      if (e >= 0) {
        int p = cursor[e] + wrank;
        for (int w = 0; w < warp; ++w) p += wcount[w * E + e];
        const size_t g = static_cast<size_t>(base) * K + i;
        pos_out[g] = p;
        keep_out[g] = p < capacity ? 1 : 0;
      }
      __syncthreads();
      // advance the cursors past this chunk and clear its counts
      for (int j = tid; j < E; j += kThreads) {
        int c = 0;
        for (int w = 0; w < kWarps; ++w) {
          c += wcount[w * E + j];
          wcount[w * E + j] = 0;
        }
        cursor[j] += c;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for E experts and top-K, in bytes.
long long router_topk_smem_bytes(int E, int K) {
  return (static_cast<long long>(E) * (kWarps + 1) +
          static_cast<long long>(kThreads) * K) * sizeof(int);
}

int router_topk_launch(const float* logits, int T, int E, int K, int capacity,
                       float* w, int* idx, int* pos, unsigned char* keep,
                       void* stream) {
  if (K < 1 || K > kMaxK || K > E) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = router_topk_smem_bytes(E, K);
  // raise the shared-memory limit only when a launch needs more than any
  // before it (so repeated launches may be captured into a CUDA graph)
  static long long limit = 48 * 1024;
  if (smem > limit) {
    cudaError_t err = cudaFuncSetAttribute(
        router_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit = smem;
  }
  router_topk_kernel<<<1, kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      logits, T, E, K, capacity, w, idx, pos, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
