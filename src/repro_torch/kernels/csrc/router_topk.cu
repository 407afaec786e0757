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
// Design and bound: route_scan.cuh.  The TPU kernel carries per-expert lane
// counters in VMEM scratch across its sequential token-block grid; here
// ceil(T / tt) blocks each route a tile of tokens and rank its entries with
// no dependence on the others, and a decoupled look-back over the tiles'
// per-expert histograms adds the entries of earlier tiles.  Any T (the TPU
// kernel needs block_t | T), E as far as a block's shared memory holds a
// tile, K up to 8.
//
// The launcher takes PyTorch's current stream, allocates nothing (the
// wrapper passes the workspace), and returns cudaGetLastError() right after
// the launch.

#include "route_scan.cuh"

extern "C" {

// Shared memory of a block of `threads` over a tile of `tt` tokens, bytes.
long long router_topk_smem_bytes(int tt, int E, int K, int threads) {
  return route::route_smem_words(tt, E, K, threads) * 4;
}

int router_topk_launch(const float* logits, int T, int E, int K, int capacity,
                       int blocks, int tt, int threads, float* w, int* idx,
                       int* pos, unsigned char* keep, int* workspace,
                       void* stream) {
  return route::launch<false>(logits, T, E, K, capacity, blocks, tt, threads,
                              w, idx, pos, keep, workspace,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
