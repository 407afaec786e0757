// Top-K routing with first-come lane positions over many blocks, for sm_90a.
// Shared by router_topk.cu (top-K, weights) and a2a_fused.cu (top-1, NaN
// counts as the maximum, no weights).
//
// The function: logits (T,E) f32 -> for each token the softmax in fp32
// (u_j = exp(x_j - max), the sum taken left to right, p_j = u_j / sum), K
// picks by repeated argmax over p (first index on ties, a chosen expert
// masked out), weights p_k / max(sum_k p_k, 1e-9) summed in k order, and
// each (token, k) entry's position in its expert's lane: the number of
// entries of the same expert before it in flattened (token, k) order.
//
// Design.  The TPU kernels carry the E lane cursors across their sequential
// token-block grid.  Here a block takes a tile of `tt` tokens and:
//   1. routes them with no dependence on other blocks.  Each exp(x - max)
//      is computed once and kept in shared memory, overwritten by its
//      probability.  E <= 32: a thread per token reads its row from global
//      memory and does all of it.  E > 32: the tile's logits are copied to
//      shared memory coalesced (16-byte loads where the tile is aligned), a
//      warp per token takes the max (shuffles) and the exponentials, a
//      thread per token the sum (left to right, so it equals the plain
//      version's), and a warp per token the divisions and each pick (a
//      shuffle argmax over (p, index));
//   2. ranks each entry among the tile's earlier entries of its expert, in
//      chunks of one entry a thread: __match_any_sync gives the rank inside
//      a warp, per-warp counts in shared memory the rank across warps, and a
//      cursor per expert carries the chunks; the cursors end as the tile's
//      histogram;
//   3. adds the entries of earlier tiles by a decoupled look-back: it
//      publishes its histogram (flag 1), then reads the flags of up to 32
//      earlier tiles at once (one warp) and sums their histograms back to
//      the nearest tile that has published its inclusive prefix (flag 2),
//      window after window; then publishes its own inclusive prefix.
// A block takes its tile by an atomic ticket, so every tile it waits on
// belongs to a block that started before it: no launch order is assumed
// and the look-back cannot deadlock.  With one block (decode's T = 8) there
// is no ticket, no look-back and no workspace.
//
// Workspace (int32, from the caller, words [0, 1 + blocks) zeroed on the
// stream before each launch): [0] the ticket, [1 + b] tile b's flag, then
// the tiles' histograms [blocks][E] and inclusive prefixes [blocks][E].
//
// Shared memory (4-byte words, route_smem_words): the tile's rows (logits
// or exponentials) [tt][E | 1] (an odd stride: a thread per row reads
// without bank conflicts), the row sums [tt], the entries' experts,
// weights and ranks [3][tt * K], the per-warp counts [warps][E], the
// histogram and the prefix [2][E], and 4 words of broadcast.
//
// Bound on an H100: bytes (T*E*4 read, T*K*13 written); a few operations a
// byte.  The tiles are small and the look-back is one or two L2 round trips,
// so the time is a few microseconds of latency for any T the serving path
// gives.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace route {

constexpr int kMaxK = 8;
constexpr int kMaxThreads = 512;
constexpr int kThreadPathMaxE = 32;     // E above this: a warp per token
constexpr int kWindow = 32;             // tiles one look-back step reads

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Does (v, i) beat (bv, bi)?  The larger value, the lower index on ties.
// NAN_MAX: a NaN beats every number (the first NaN wins, as torch.argmax);
// otherwise a NaN never wins.
template <bool NAN_MAX>
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (NAN_MAX) {
    const bool vn = v != v, bn = bv != bv;
    if (vn || bn) return vn && (!bn || i < bi);
  }
  return v > bv || (v == bv && i < bi);
}

// The exclusive prefix over earlier tiles of the per-expert counts, by
// decoupled look-back; see the header.  Every thread of the block calls it.
// A tile publishes as a semaphore does: the block's writes, a barrier, one
// thread's st.release.gpu of the flag (cumulative over the writes the
// barrier ordered before it; an extra __threadfence measured 0.4-0.7 us
// slower); a reader's ld.acquire.gpu of the flag, a barrier, then __ldcg
// of the counts.
__device__ __forceinline__ void scan_tiles(int b, int nb, int E,
                                           const int* count, int* prefix,
                                           int* ws, int* bcast) {
  int* flags = ws + 1;
  int* agg = flags + nb;
  int* incl = agg + static_cast<size_t>(nb) * E;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool read_later = b + 1 < nb;    // the last tile has no reader
  for (int e = tid; e < E; e += nt) {
    prefix[e] = 0;
    if (b > 0 && read_later) agg[static_cast<size_t>(b) * E + e] = count[e];
  }
  __syncthreads();                       // then a release at gpu scope
  if (b > 0 && read_later && tid == 0) st_release(flags + b, 1);
  for (int hi = b; hi > 0;) {            // tiles [lo, hi) in this window
    const int lo = hi > kWindow ? hi - kWindow : 0;
    if (tid < 32) {
      const int j = hi - 1 - tid;        // lane 0 reads the nearest tile
      int f = 0;
      if (j >= lo)
        while ((f = ld_acquire(flags + j)) == 0) __nanosleep(32);
      const unsigned incl_ready = __ballot_sync(0xffffffffu, f == 2);
      if (tid == 0) {
        bcast[1] = incl_ready ? __ffs(incl_ready) - 1 : hi - lo;
        bcast[2] = incl_ready != 0;
      }
    }
    __syncthreads();
    const int n_agg = bcast[1];
    const bool found = bcast[2];
    for (int e = tid; e < E; e += nt) {
      int acc = prefix[e];
      for (int l = 0; l < n_agg; ++l)
        acc += __ldcg(agg + static_cast<size_t>(hi - 1 - l) * E + e);
      if (found) acc += __ldcg(incl + static_cast<size_t>(hi - 1 - n_agg) * E + e);
      prefix[e] = acc;
    }
    __syncthreads();                     // bcast is written again
    if (found) break;
    hi = lo;
  }
  if (read_later) {
    for (int e = tid; e < E; e += nt)
      incl[static_cast<size_t>(b) * E + e] = prefix[e] + count[e];
    __syncthreads();
    if (tid == 0) st_release(flags + b, 2);
  }
}

// One pick per k of the row's probabilities p (in place: a chosen expert is
// set to -1, below every probability) by one thread; entries' experts and
// probabilities to e_out / w_out.
template <bool NAN_MAX>
__device__ __forceinline__ void pick_thread(float* p, int E, int K,
                                            int* e_out, float* w_out) {
  for (int kk = 0; kk < K; ++kk) {
    float bv = -1.0f;
    int bi = 0;
    for (int j = 0; j < E; ++j)
      if (better<NAN_MAX>(p[j], j, bv, bi)) {
        bv = p[j];
        bi = j;
      }
    e_out[kk] = bi;
    w_out[kk] = bv;
    p[bi] = -1.0f;
  }
}

// The same picks by one warp: each lane scans its columns, then a shuffle
// argmax over (p, index).  `better` is a total order on the candidates, so
// every lane ends with the same pick.
template <bool NAN_MAX>
__device__ __forceinline__ void pick_warp(float* p, int E, int K, int lane,
                                          int* e_out, float* w_out) {
  for (int kk = 0; kk < K; ++kk) {
    float bv = -1.0f;
    int bi = 0;
    for (int j = lane; j < E; j += 32)
      if (better<NAN_MAX>(p[j], j, bv, bi)) {
        bv = p[j];
        bi = j;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better<NAN_MAX>(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      e_out[kk] = bi;
      w_out[kk] = bv;
      p[bi] = -1.0f;
    }
    __syncwarp();
  }
}

// the weights of a token's K picks: p_k / max(sum_k p_k, 1e-9), summed in
// k order
__device__ __forceinline__ void renormalise(float* w, int K) {
  float s = w[0];
  for (int kk = 1; kk < K; ++kk) s += w[kk];
  const float den = fmaxf(s, 1e-9f);
  for (int kk = 0; kk < K; ++kk) w[kk] = w[kk] / den;
}

template <bool WARP, bool NAN_MAX>
__global__ void __launch_bounds__(kMaxThreads)
route_kernel(const float* __restrict__ logits, int T, int E, int K, int tt,
             int capacity, float* __restrict__ w_out,
             int* __restrict__ idx_out, int* __restrict__ pos_out,
             unsigned char* __restrict__ keep_out, int* __restrict__ ws) {
  extern __shared__ __align__(16) int smem[];
  const int nt = blockDim.x, warps = nt >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = E | 1;
  float* x = reinterpret_cast<float*>(smem);          // [tt][ld]
  float* rsum = x + tt * ld;                          // [tt]
  int* ent_e = reinterpret_cast<int*>(rsum + tt);     // [tt * K]
  float* ent_w = reinterpret_cast<float*>(ent_e + tt * K);
  int* ent_r = reinterpret_cast<int*>(ent_w + tt * K);
  int* wcount = ent_r + tt * K;                       // [warps][E]
  int* count = wcount + warps * E;                    // [E]
  int* prefix = count + E;                            // [E]
  int* bcast = prefix + E;                            // [4]

  if (tid == 0) bcast[0] = ws != nullptr ? atomicAdd(ws, 1) : 0;
  for (int i = tid; i < (warps + 1) * E; i += nt) wcount[i] = 0;  // + count
  __syncthreads();
  const int b = bcast[0];
  const int base = b * tt;
  const int n_tok = min(tt, T - base);
  const int n_ent = n_tok * K;

  // -- 1: route the tile's tokens ---------------------------------------------
  const float* src = logits + static_cast<size_t>(base) * E;
  if (!WARP) {
    // a thread per token reads its own row from global memory (through L1)
    // and keeps only the exponentials in shared memory
    for (int t = tid; t < n_tok; t += nt) {
      const float* g = src + static_cast<size_t>(t) * E;
      float* row = x + t * ld;
      float m = g[0];
      for (int j = 1; j < E; ++j) m = fmaxf(m, g[j]);
      float s = 0.0f;
      for (int j = 0; j < E; ++j) {
        const float u = expf(g[j] - m);
        row[j] = u;
        s += u;
      }
      for (int j = 0; j < E; ++j) row[j] = row[j] / s;
      pick_thread<NAN_MAX>(row, E, K, ent_e + t * K, ent_w + t * K);
      renormalise(ent_w + t * K, K);
    }
  } else {
    // the tile's rows, coalesced, in 16-byte loads where the tile starts
    // aligned (measured 3-5% faster than 4-byte loads)
    const int n = n_tok * E;
    auto put = [&](int i, float v) {
      const int t = i / E;
      x[t * ld + (i - t * E)] = v;
    };
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int q = tid; q < n / 4; q += nt) {
        const float4 v = src4[q];
        put(4 * q, v.x);
        put(4 * q + 1, v.y);
        put(4 * q + 2, v.z);
        put(4 * q + 3, v.w);
      }
      head = n / 4 * 4;
    }
    for (int i = head + tid; i < n; i += nt) put(i, src[i]);
    __syncthreads();
    for (int t = warp; t < n_tok; t += warps) {
      float* row = x + t * ld;
      float m = row[0];
      for (int j = lane; j < E; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      for (int j = lane; j < E; j += 32) row[j] = expf(row[j] - m);
    }
    __syncthreads();
    for (int t = tid; t < n_tok; t += nt) {
      const float* row = x + t * ld;
      float s = 0.0f;
      for (int j = 0; j < E; ++j) s += row[j];
      rsum[t] = s;
    }
    __syncthreads();
    for (int t = warp; t < n_tok; t += warps) {
      float* row = x + t * ld;
      const float s = rsum[t];
      for (int j = lane; j < E; j += 32) row[j] = row[j] / s;
      __syncwarp();
      pick_warp<NAN_MAX>(row, E, K, lane, ent_e + t * K, ent_w + t * K);
      if (lane == 0) renormalise(ent_w + t * K, K);
    }
  }
  __syncthreads();

  // -- 2: rank each entry among the tile's earlier entries of its expert -----
  for (int eb = 0; eb < n_ent; eb += nt) {
    const int i = eb + tid;
    const int e = i < n_ent ? ent_e[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int wrank = __popc(peers & ((1u << lane) - 1u));
    if (e >= 0 && lane == __ffs(peers) - 1) wcount[warp * E + e] = __popc(peers);
    __syncthreads();
    if (e >= 0) {
      int r = count[e] + wrank;
      for (int w = 0; w < warp; ++w) r += wcount[w * E + e];
      ent_r[i] = r;
    }
    __syncthreads();
    for (int j = tid; j < E; j += nt) {  // advance the cursors, clear counts
      int c = 0;
      for (int w = 0; w < warps; ++w) {
        c += wcount[w * E + j];
        wcount[w * E + j] = 0;
      }
      count[j] += c;
    }
    __syncthreads();
  }
  const size_t g0 = static_cast<size_t>(base) * K;
  for (int i = tid; i < n_ent; i += nt) {   // behind it the look-back waits
    idx_out[g0 + i] = ent_e[i];
    if (w_out != nullptr) w_out[g0 + i] = ent_w[i];
  }

  // -- 3: the entries of earlier tiles ---------------------------------------
  if (ws != nullptr) {
    scan_tiles(b, gridDim.x, E, count, prefix, ws, bcast);
  } else {
    for (int e = tid; e < E; e += nt) prefix[e] = 0;
    __syncthreads();
  }
  for (int i = tid; i < n_ent; i += nt) {
    const int p = prefix[ent_e[i]] + ent_r[i];
    pos_out[g0 + i] = p;
    keep_out[g0 + i] = p < capacity ? 1 : 0;
  }
}

// Shared memory of a block, in 4-byte words (the layout in the header).
inline long long route_smem_words(int tt, int E, int K, int threads) {
  return static_cast<long long>(tt) * ((E | 1) + 1 + 3 * K) +
         static_cast<long long>(threads / 32 + 2) * E + 4;
}

// Launch on `stream`: `blocks` tiles of `tt` tokens (the last one ragged),
// `threads` a block (a multiple of 32), `ws` null for one block, else the
// workspace with its first 1 + blocks words zeroed.  Returns the
// cudaError_t of the launch.
template <bool NAN_MAX>
int launch(const float* logits, int T, int E, int K, int capacity,
           int blocks, int tt, int threads, float* w, int* idx, int* pos,
           unsigned char* keep, int* ws, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || K > E || blocks < 1 || tt < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(blocks) * tt < T ||
      (blocks > 1) != (ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool warp = E > kThreadPathMaxE;
  auto kern = route_kernel<false, NAN_MAX>;
  if (warp) kern = route_kernel<true, NAN_MAX>;
  const long long smem = route_smem_words(tt, E, K, threads) * 4;
  // raise the shared-memory limit only when a launch needs more than any
  // before it (so repeated launches may be captured into a CUDA graph)
  static long long limit[2] = {48 * 1024, 48 * 1024};
  if (smem > limit[warp]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit[warp] = smem;
  }
  kern<<<blocks, threads, static_cast<size_t>(smem), stream>>>(
      logits, T, E, K, tt, capacity, w, idx, pos, keep, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace route
