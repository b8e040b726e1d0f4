// Per-edge substream matcher on packed bit planes (Listing 1 Part 1, §4.4).
//
// Replaces the TPU kernel `_kernel_packed` (src/repro/kernels/substream_match/
// kernel.py:117, launched by `substream_match_pallas_packed`). Same contract:
// for each edge i, in stream order,
//   te     = the L-bit eligibility word, bit 8k+j = (w >= thr[j][k]), 0 on self-loops
//   add    = te & ~mb[u] & ~mb[v]
//   mb[u] |= add; then mb[v] is reloaded and mb[v] |= add
//   assigned[i] = highest set bit of add, or -1.
//
// Design. One block of one warp walks the stream in order. Lane k owns the
// packed words k, k+32, ... of every row, so a lane only ever touches its own
// column of the bit block: program order inside the lane is the only ordering
// the dependency chain needs, and no barrier or atomic is used. The lane's
// threshold planes stay in registers. The highest set bit is found per word
// (31 - clz) and reduced across the warp with __reduce_max_sync.
//
// Bound on the H100. The bytes the function must move are m*16 B (edge pair,
// weight, assigned) plus n_pad*width B (the bit block written once): about
// 0.2 ms at 3.35 TB/s for the paper's configuration (2^20 vertices, ~42M
// edges, L=64). What limits this design is the per-edge dependency chain:
// every edge waits on a round trip to the bit block in L2 (8 MiB at the
// paper's size, resident in the 50 MB L2). Keeping the block in shared
// memory, a cp.async/TMA edge ring and splitting the word columns across
// blocks are later work.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// WPL = packed words per lane (ceil(width / 32), rounded up to a power of two).
template <int WPL>
__global__ void __launch_bounds__(32, 1) substream_match_packed_kernel(
    const int32_t* __restrict__ edges,   // [m, 2] (u, v)
    const float* __restrict__ weights,   // [m]
    const float* __restrict__ thr,       // [8, width]; thr[j * width + k] = substream 8k+j
    uint8_t* mb,                         // [n_pad, width], initialised by the caller
    int32_t* __restrict__ assigned,      // [m]
    long long m, int width) {
  const int lane = threadIdx.x;
  float t[WPL][8];
#pragma unroll
  for (int r = 0; r < WPL; ++r) {
    const int k = lane + 32 * r;
#pragma unroll
    for (int j = 0; j < 8; ++j) t[r][j] = k < width ? thr[j * width + k] : CUDART_INF_F;
  }
  for (long long i = 0; i < m; ++i) {
    const int u = edges[2 * i];
    const int v = edges[2 * i + 1];
    const float w = weights[i];
    uint8_t* row_u = mb + static_cast<size_t>(u) * width;
    uint8_t* row_v = mb + static_cast<size_t>(v) * width;
    int best = -1;
#pragma unroll
    for (int r = 0; r < WPL; ++r) {
      const int k = lane + 32 * r;
      if (k < width) {
        unsigned te = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) te |= static_cast<unsigned>(w >= t[r][j]) << j;
        if (u == v) te = 0;  // self-loops never match
        const unsigned add = te & ~static_cast<unsigned>(row_u[k]) & ~static_cast<unsigned>(row_v[k]);
        row_u[k] = static_cast<uint8_t>(row_u[k] | add);
        row_v[k] = static_cast<uint8_t>(row_v[k] | add);  // reload: u may equal v
        if (add) best = max(best, 8 * k + 31 - __clz(add));
      }
    }
    best = __reduce_max_sync(0xffffffffu, best);
    if (lane == 0) assigned[i] = best;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// width > 256 words (L > 2048) is refused with cudaErrorInvalidValue.
extern "C" int substream_match_packed(const void* edges, const void* weights, const void* thr,
                                      void* mb, void* assigned, long long m, int width,
                                      void* stream) {
  const auto* e = static_cast<const int32_t*>(edges);
  const auto* w = static_cast<const float*>(weights);
  const auto* t = static_cast<const float*>(thr);
  auto* b = static_cast<uint8_t*>(mb);
  auto* a = static_cast<int32_t*>(assigned);
  auto s = static_cast<cudaStream_t>(stream);
  const int wpl = (width + 31) / 32;
  if (wpl <= 1) {
    substream_match_packed_kernel<1><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else if (wpl <= 2) {
    substream_match_packed_kernel<2><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else if (wpl <= 4) {
    substream_match_packed_kernel<4><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else if (wpl <= 8) {
    substream_match_packed_kernel<8><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
