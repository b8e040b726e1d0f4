// Wave-parallel substream matchers (Listing 1 Part 1) on packed bit planes.
//
// Two launchers share one kernel body:
//   substream_match_mega            replaces the TPU tile megakernel
//                                   `_kernel_waves_mega_packed` (src/repro/kernels/
//                                   substream_match/kernel.py:519, wrapper
//                                   `substream_match_pallas_mega`, with `_prefix_te_table`
//                                   :421 and `_high_bit_table` :440);
//   substream_match_waves           replaces the TPU segment kernel `_kernel_waves_packed`
//                                   (kernel.py:243, wrapper `substream_match_pallas_waves`).
// (The unpacked twins are in substream_match_waves_unpacked.cu.)
// Both walk a fill-packed wave schedule (repro_torch/graph/waves.py): wave k owns the
// slots [seg_offsets[k] * seg, seg_offsets[k + 1] * seg), and the real slots of one wave
// are vertex-disjoint. For every slot (u, v, w):
//   te       = the eligibility of every substream, none when u == v (self-loops and
//              padding slots)
//   add      = te & ~(mb[u] | mb[v])
//   mb[u] |= add; mb[v] |= add
//   assigned = the highest substream of add, or -1.
// Layout: a row is `width` uint8 words, bit j of word k = substream 8k+j.
// Operand contracts, as the TPU wrappers':
//   mega  : ids = uv [2 * total], per tile of `bslots` slots all u's then all v's; thr =
//           the flat sorted vector (+inf pads) of 8 * width entries. Since thresholds are sorted, te is the prefix of the
//           passing-threshold count (binary search, then a mask).
//   waves : ids = edges [total, 2]; thr = bit planes [8, width], thr[j * width + k] =
//           substream 8k+j; te is assembled threshold by threshold.
// Padding (and, for mega, self-loop) slots hold u = v = n_pad, the sacrificial row.
//
// Design. Greedy matching is confluent over vertex-disjoint edges, so finishing wave k
// before wave k+1 gives the sequential result bit for bit, and inside a wave every slot
// can run at once. One persistent CTA of 1024 threads walks the waves in order; its
// threads stride over the wave's slots, one slot per thread, gathering the two rows from
// the bit block in global memory as 64-bit chunks and writing back only chunks where
// add != 0. Chunk c holds substreams 64c..64c+63, one bit each; the highest substream of a
// chunk is 64c + 63 - clz(add). __syncthreads() between waves makes the writes visible to
// the block. A slot with u == v never writes, so the sacrificial row is never raced.
//
// Bound on the H100. The bytes the function must move are m*16 B (edge pair, weight,
// assigned) plus the bit block: about 0.2 ms at 3.35 TB/s at the paper's size (8 MiB,
// resident in the 50 MB L2). What limits this
// design is one round trip to the rows plus one block barrier per wave, on one SM:
// ~1-3 us a wave. Grid-wide barriers across SMs, a cp.async/TMA ring for the slot
// stream and a warp per slot at large L are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBits = 2048;  // substreams: L <= 2048

template <bool kMega>
__global__ void __launch_bounds__(kThreads, 1) substream_match_waves_kernel(
    const int32_t* __restrict__ seg_offsets,  // [num_waves + 1]
    int num_waves, int seg, int bslots,
    const int32_t* __restrict__ ids,          // mega: uv [2 * total]; waves: edges [total, 2]
    const float* __restrict__ weights,        // [total]
    const float* __restrict__ thr,            // [nbits], see above
    uint8_t* mb,                              // [n_pad + 8, width], initialised by the caller
    int32_t* __restrict__ assigned,           // [total], -1 filled by the caller
    int width) {
  __shared__ float s_thr[kMaxBits];
  const int nbits = 8 * width;
  for (int i = threadIdx.x; i < nbits; i += kThreads) s_thr[i] = thr[i];
  __syncthreads();
  const int chunks = width / 8;

  for (int k = 0; k < num_waves; ++k) {
    const long long lo = static_cast<long long>(seg_offsets[k]) * seg;
    const long long hi = static_cast<long long>(seg_offsets[k + 1]) * seg;
    for (long long s = lo + threadIdx.x; s < hi; s += kThreads) {
      int u, v;
      if (kMega) {
        const long long t = s / bslots;
        const long long j = s - t * bslots;
        u = ids[2 * t * bslots + j];
        v = ids[2 * t * bslots + bslots + j];
      } else {
        u = ids[2 * s];
        v = ids[2 * s + 1];
      }
      int best = -1;
      if (u != v) {
        const float w = weights[s];
        int cnt = 0;
        if (kMega) {  // number of thresholds <= w: the first index with !(thr <= w)
          int a = 0, b = nbits;
          while (a < b) {
            const int mid = (a + b) >> 1;
            if (s_thr[mid] <= w) a = mid + 1; else b = mid;
          }
          cnt = a;
        }
        uint64_t* ru = reinterpret_cast<uint64_t*>(mb + static_cast<size_t>(u) * width);
        uint64_t* rv = reinterpret_cast<uint64_t*>(mb + static_cast<size_t>(v) * width);
        for (int c = 0; c < chunks; ++c) {
          uint64_t te = 0;
          if (kMega) {
            const int nb = min(max(cnt - 64 * c, 0), 64);
            te = nb == 64 ? ~0ull : ((1ull << nb) - 1ull);
          } else {
#pragma unroll
            for (int byte = 0; byte < 8; ++byte) {
              const int col = 8 * c + byte;
#pragma unroll
              for (int j = 0; j < 8; ++j)
                te |= static_cast<uint64_t>(w >= s_thr[j * width + col]) << (8 * byte + j);
            }
          }
          if (te == 0) continue;
          const uint64_t a = ru[c];
          const uint64_t b = rv[c];
          const uint64_t add = te & ~(a | b);
          if (add) {
            ru[c] = a | add;
            rv[c] = b | add;
            const int top = 63 - __clzll(static_cast<long long>(add));
            best = 64 * c + top;
          }
        }
      }
      assigned[s] = best;
    }
    __syncthreads();
  }
}

// Each launches one block of 1024 threads on `stream` and returns cudaGetLastError() (0 on
// success). `width` is the row's bytes: a multiple of 8 up to 256 (L <= 2048); any other
// width is refused with cudaErrorInvalidValue.

template <bool kMega>
int launch_waves(const void* seg_offsets, int num_waves, int seg, int bslots, const void* ids,
                 const void* weights, const void* thr, void* mb, void* assigned, int width,
                 void* stream) {
  const bool ok_width = width % 8 == 0 && 8 * width <= kMaxBits;
  if (!ok_width || bslots <= 0) return static_cast<int>(cudaErrorInvalidValue);
  substream_match_waves_kernel<kMega>
      <<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(seg_offsets), num_waves, seg, bslots,
          static_cast<const int32_t*>(ids), static_cast<const float*>(weights),
          static_cast<const float*>(thr), static_cast<uint8_t*>(mb),
          static_cast<int32_t*>(assigned), width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int substream_match_mega(const void* seg_offsets, int num_waves, int seg,
                                    int bslots, const void* uv, const void* weights,
                                    const void* thr, void* mb, void* assigned, int width,
                                    void* stream) {
  return launch_waves<true>(seg_offsets, num_waves, seg, bslots, uv, weights, thr, mb,
                                  assigned, width, stream);
}

extern "C" int substream_match_waves(const void* seg_offsets, int num_waves, int seg,
                                     const void* edges, const void* weights, const void* thr,
                                     void* mb, void* assigned, int width, void* stream) {
  return launch_waves<false>(seg_offsets, num_waves, seg, 1, edges, weights, thr, mb,
                                   assigned, width, stream);
}
