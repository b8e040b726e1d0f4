// Per-edge substream matcher on the unpacked int8 bit block (Listing 1 Part 1, §4.4).
//
// Replaces the TPU kernel `_kernel` (src/repro/kernels/substream_match/kernel.py:74,
// launched by `substream_match_pallas`). Same contract: one int8 byte per substream,
// mb[n_pad, L_pad]; for each edge i, in stream order,
//   te     = the eligibility bytes, lane l = (w >= thr[l]), none on self-loops
//   add    = te & (mb[u] == 0) & (mb[v] == 0)       (per lane)
//   mb[u] |= add; then mb[v] is reloaded and mb[v] |= add
//   assigned[i] = the highest lane of add, or -1.
// A byte is taken as set when it is non-zero, so carried-in bits need not be 0/1.
//
// Design. One block of one warp walks the stream in order, as the packed kernel
// (substream_match_packed.cu) does. Lane k owns the 4-byte words k, k+32, ... of every
// row (bytes 4k..4k+3 = substreams 4k..4k+3), so a lane only ever touches its own
// columns of the bit block: program order inside the lane is the only ordering the
// dependency chain needs, and no barrier or atomic is used. At L=64 16 lanes hold
// words. The lane's thresholds stay in registers. The eligibility word holds 0x01 in
// each byte whose lane passes; the highest lane of a word is
// 4k + ((31 - clz(add)) >> 3), reduced across the warp with __reduce_max_sync.
//
// Bound on the H100. The bytes the function must move are m*16 B (edge pair, weight,
// assigned) plus n_pad*L_pad B (the bit block written once): about 0.23 ms at 3.35 TB/s
// for the paper's configuration (2^20 vertices, ~44M edges, L=64, a 64 MiB block). What
// limits this design is the per-edge dependency chain: every edge waits on a round trip
// to the bit block. Unlike the packed block (8 MiB), the unpacked block does not fit the
// 50 MB L2 at the paper's size, so some of those round trips go to HBM.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// 0x01 in every byte of x that is non-zero, 0x00 elsewhere.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

// WPL = 4-byte words per lane (ceil(words / 32), rounded up to a power of two).
template <int WPL>
__global__ void __launch_bounds__(32, 1) substream_match_unpacked_kernel(
    const int32_t* __restrict__ edges,   // [m, 2] (u, v)
    const float* __restrict__ weights,   // [m]
    const float* __restrict__ thr,       // [width]; +inf pads
    int8_t* mb,                          // [n_pad, width], initialised by the caller
    int32_t* __restrict__ assigned,      // [m]
    long long m, int width) {
  const int lane = threadIdx.x;
  const int words = width / 4;
  float t[WPL][4];
#pragma unroll
  for (int r = 0; r < WPL; ++r) {
    const int k = lane + 32 * r;
#pragma unroll
    for (int b = 0; b < 4; ++b) t[r][b] = k < words ? thr[4 * k + b] : CUDART_INF_F;
  }
  for (long long i = 0; i < m; ++i) {
    const int u = edges[2 * i];
    const int v = edges[2 * i + 1];
    const float w = weights[i];
    uint32_t* row_u = reinterpret_cast<uint32_t*>(mb + static_cast<size_t>(u) * width);
    uint32_t* row_v = reinterpret_cast<uint32_t*>(mb + static_cast<size_t>(v) * width);
    int best = -1;
#pragma unroll
    for (int r = 0; r < WPL; ++r) {
      const int k = lane + 32 * r;
      if (k < words && u != v) {  // self-loops never match
        uint32_t te = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) te |= static_cast<uint32_t>(w >= t[r][b]) << (8 * b);
        if (te) {
          const uint32_t a = row_u[k];
          const uint32_t add = te & ~(nonzero_bytes(a) | nonzero_bytes(row_v[k]));
          if (add) {
            row_u[k] = a | add;
            row_v[k] = row_v[k] | add;  // reloaded after the write to u
            best = max(best, 4 * k + ((31 - __clz(add)) >> 3));
          }
        }
      }
    }
    best = __reduce_max_sync(0xffffffffu, best);
    if (lane == 0) assigned[i] = best;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). A width that is not
// a multiple of 16 bytes or above 2048 (L > 2048) is refused with cudaErrorInvalidValue.
extern "C" int substream_match_unpacked(const void* edges, const void* weights, const void* thr,
                                        void* mb, void* assigned, long long m, int width,
                                        void* stream) {
  const auto* e = static_cast<const int32_t*>(edges);
  const auto* w = static_cast<const float*>(weights);
  const auto* t = static_cast<const float*>(thr);
  auto* b = static_cast<int8_t*>(mb);
  auto* a = static_cast<int32_t*>(assigned);
  auto s = static_cast<cudaStream_t>(stream);
  if (width % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int wpl = (width / 4 + 31) / 32;
  if (wpl <= 1) {
    substream_match_unpacked_kernel<1><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else if (wpl <= 2) {
    substream_match_unpacked_kernel<2><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else if (wpl <= 4) {
    substream_match_unpacked_kernel<4><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else if (wpl <= 8) {
    substream_match_unpacked_kernel<8><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else if (wpl <= 16) {
    substream_match_unpacked_kernel<16><<<1, 32, 0, s>>>(e, w, t, b, a, m, width);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
