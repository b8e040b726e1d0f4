// Per-edge substream matchers (Listing 1 Part 1, §4.4) in both layouts of the bit block, and
// a second engine for the same contract on the whole card (the rounds engine, at the end).
//
// Replaces the TPU kernels `_kernel_packed` (src/repro/kernels/substream_match/kernel.py:117,
// uint8 bit planes: bit j of word k = substream 8k+j) and `_kernel` (kernel.py:74, one int8
// byte per substream, set when non-zero). Same contract: for each edge i, in stream order,
//   te     = the eligibility bits, substream s = (w >= thr[s]), none on self-loops
//   add    = te & ~mb[u] & ~mb[v]
//   mb[u] |= add; mb[v] |= add
//   assigned[i] = the highest substream of add, or -1.
//
// Bound on the H100. The bytes the function must move are m*16 B (edge pair, weight,
// assigned) plus the bit block written once: 0.214 ms (packed, 8 MiB) and 0.232 ms
// (unpacked, 64 MiB) at 3.35 TB/s for the paper's configuration (2^20 vertices,
// m = 44,350,400 edges, L = 64). The operations (8 compares per packed byte, 1 per unpacked
// byte and edge) take less. What limits a scan in stream order is latency: the one-warp loop
// this replaces waited, for every edge, on two dependent round trips to the bit block in L2.
//
// Design. Two facts make the greedy scan fast and still exact:
//  * A row of the bit block only gains bits. A row loaded early is stale only by what the
//    edges between the load and its use added, and those edges are known. So the stream is
//    walked in batches of kBatch = 32 edges, one per lane, and the rows of the next batch are
//    loaded before the chain of this one (prefetch depth kPrefetch = 1 batch). Each edge then
//    reads, for u and for v, the post-value of the latest earlier edge of the window (the
//    whole previous batch and the earlier lanes of its own) that touched the vertex, and the
//    loaded row only where no such edge exists. An edge with add == 0 or u == v counts as a
//    toucher too.
//  * Substreams are independent but for `assigned`, the highest bit over all of them. So the
//    L columns are cut into chunks of kChunkBits = 64 substreams, one 64-bit word per vertex
//    (packed bytes 8c..8c+7, unpacked bytes 64c..64c+63), and one CTA walks each chunk; the
//    CTAs never touch each other's columns and combine `assigned` with atomicMax.
// A CTA's warps meet at one barrier per batch. While the walker (warp 0) runs batch k - 1, the
// others prepare batch k, lane-parallel and off the chain: four search the window (for each
// endpoint the latest toucher among the earlier lanes and in the previous batch, shuffle
// compares over half the lanes each), two compute the eligibility words (two ballots of
// `w >= thr` per edge: any thresholds, no order assumed), and one of those stages the stream
// in shared memory, chunks of kStageEdges edges double-buffered with 16-byte cp.async, so no
// warp waits on a global load of it. The walker resolves the batch's base rows (the previous
// batch's post-values, still in its lanes' registers, or the loaded rows), issues the next
// batch's row loads, runs the batch's chain and writes back.
// The chain is the only one and lives in registers: each lane recomputes its edge from its
// touchers' current post-values (shuffles) in rounds until a round changes nothing. Touchers
// are earlier lanes, so the fixed point is the sequential scan's, reached after depth + 1
// rounds of the batch's dependency chain (at most 33; one when no edge has an earlier toucher
// in the batch). No global load or store is on it. The write-back writes every vertex the
// batch changed once, from the lane of its last touch, and `assigned` in one coalesced store;
// the barrier orders those stores before the next batch's row loads. The unpacked layout
// converts on load (SWAR non-zero test to a 64-bit mask) and writes 0/1 bytes back; the
// wrapper has already normalised carried-in bytes to 0/1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 32;         // edges per batch, one per lane
constexpr int kPrefetch = 1;       // batches the bit-block row loads run ahead of their use
constexpr int kChunkBits = 64;     // substreams per CTA: one 64-bit word per vertex
constexpr int kStageEdges = 1024;  // edges per staged chunk of the stream (two buffers)
constexpr int kWarps = 7;         // walker, four window searches, two eligibility warps
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBatch == 32 && kPrefetch == 1 && kChunkBits == 64,
              "a batch is one lane per edge, a chunk one 64-bit word per vertex, one batch ahead");
static_assert(kStageEdges % kBatch == 0, "a batch never straddles two staged chunks");

enum class Layout { kPacked, kUnpacked };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The offset, in 4-byte words, of `p` inside its 16-byte line.
__device__ __forceinline__ int word_misalign(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Words [0, n) of `src` to dst[a + i], a = word_misalign(src), so that source and destination
// share their offset in the 16-byte line: whole lines by 16-byte cp.async, the ends by word.
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src, int n, int lane) {
  const int a = word_misalign(src);
  const int head = min((4 - a) & 3, n);
  const int lines = (n - head) / 4;
  if (lane < head) cp_async4(dst + a + lane, src + lane);
  for (int q = lane; q < lines; q += 32) cp_async16(dst + a + head + 4 * q, src + head + 4 * q);
  for (int i = head + 4 * lines + lane; i < n; i += 32) cp_async4(dst + a + i, src + i);
}

__device__ __forceinline__ unsigned long long shfl64(unsigned long long x, int src) {
  return __shfl_sync(kFull, x, src);
}

// 0x01 in every byte of x that is non-zero, 0x00 elsewhere.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}
// 4 bits from the 0x00/0x01 bytes of x (byte i -> bit i), and back.
__device__ __forceinline__ uint32_t gather4(uint32_t x) { return (x * 0x10204080u) >> 28; }
__device__ __forceinline__ uint32_t expand4(uint32_t n) { return (n * 0x00204081u) & 0x01010101u; }

// A vertex's row of the CTA's chunk as loaded: 8 bytes packed, up to 64 bytes unpacked.
template <Layout kL> struct Raw;
template <> struct Raw<Layout::kPacked> { unsigned long long x; };
template <> struct Raw<Layout::kUnpacked> { uint4 q[4]; };

// `pieces`: packed 1 (0 when the chunk is empty), unpacked the 16-byte pieces inside the row.
template <Layout kL>
__device__ __forceinline__ Raw<kL> load_row(const uint8_t* row, int pieces) {
  Raw<kL> r;
  if constexpr (kL == Layout::kPacked) {
    r.x = pieces ? __ldcg(reinterpret_cast<const unsigned long long*>(row)) : 0ull;
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      r.q[p] = p < pieces ? __ldcg(reinterpret_cast<const uint4*>(row) + p) : make_uint4(0, 0, 0, 0);
  }
  return r;
}

template <Layout kL>
__device__ __forceinline__ Raw<kL> zero_row() {
  Raw<kL> r;
  if constexpr (kL == Layout::kPacked) {
    r.x = 0ull;
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) r.q[p] = make_uint4(0, 0, 0, 0);
  }
  return r;
}

template <Layout kL>
__device__ __forceinline__ unsigned long long to_mask(const Raw<kL>& r) {
  if constexpr (kL == Layout::kPacked) {
    return r.x;
  } else {
    unsigned long long m = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t w[4] = {r.q[p].x, r.q[p].y, r.q[p].z, r.q[p].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m |= static_cast<unsigned long long>(gather4(nonzero_bytes(w[i]))) << (16 * p + 4 * i);
    }
    return m;
  }
}

template <Layout kL>
__device__ __forceinline__ void store_row(uint8_t* row, unsigned long long m, int pieces) {
  if constexpr (kL == Layout::kPacked) {
    if (pieces) __stcg(reinterpret_cast<unsigned long long*>(row), m);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p < pieces) {
        const uint32_t h = static_cast<uint32_t>(m >> (16 * p));
        __stcg(reinterpret_cast<uint4*>(row) + p,
               make_uint4(expand4(h & 15), expand4((h >> 4) & 15), expand4((h >> 8) & 15),
                          expand4((h >> 12) & 15)));
      }
    }
  }
}

// What the helpers leave for the walker per edge of a batch: the eligibility word (roles 5,
// 6) and four search results (roles 1-4), each 1 + the latest slot (2 * lane + side)
// that touched u (bits 0-7) and v (bits 8-15) among half the lanes, 0 for none: search[0]
// and [1] in the edge's own batch (earlier lanes only), [2] and [3] in the previous batch.
struct Prep {
  unsigned long long te;
  int search[4];
  int pad[2];
};

// One CTA of seven warps walks the whole stream over the 64 substreams of chunk blockIdx.x.
// Role 0 walks (row loads, the batch's chain, write-back); roles 1-4 search the window, two in
// the batch and two in the previous one, each over half its lanes; roles 5 and 6 compute the
// eligibility words, each for half the lanes, and role 5 stages the stream. They meet at one
// barrier per batch, the helpers preparing batch k while the walker runs batch k - 1.
// Packed: thr [8, width], thr[j * width + k] = substream 8k+j, rows of `pitch` >= width bytes
// (a multiple of 8). Unpacked: thr [width], rows of pitch = width bytes (a multiple of 16).
template <Layout kL>
__global__ void __launch_bounds__(kWarps * 32, 1) substream_match_edges_kernel(
    const int32_t* __restrict__ edges,  // [m, 2] (u, v)
    const float* __restrict__ weights,  // [m]
    const float* __restrict__ thr,
    uint8_t* mb,                        // [n_pad, pitch], initialised by the caller
    int32_t* __restrict__ assigned,     // [m]; filled with -1 by the caller when gridDim.x > 1
    long long m, int width, int pitch) {
  __shared__ __align__(16) uint32_t s_edges[2][2 * kStageEdges + 4];
  __shared__ __align__(16) uint32_t s_w[2][kStageEdges + 4];
  __shared__ __align__(16) Prep s_prep[2][kBatch];  // by batch parity

  const int lane = threadIdx.x % 32;
  // The role of each warp (0 walker, 1-4 search, 5-6 eligibility): warp w issues from
  // scheduler w % 4, so the walker (warp 0) shares its scheduler with the stager (role 5).
  const int warp = threadIdx.x / 32;
  const int role = warp == 4 ? 5 : (warp == 5 ? 4 : warp);
  const int c = blockIdx.x;
  constexpr bool kPacked = kL == Layout::kPacked;
  const int col0 = kPacked ? 8 * c : 64 * c;
  const int pieces = kPacked ? (col0 < width ? 1 : 0) : min(4, max(0, (width - col0) / 16));

  const uint32_t* e_words = reinterpret_cast<const uint32_t*>(edges);
  const uint32_t* w_words = reinterpret_cast<const uint32_t*>(weights);
  const int ae = word_misalign(e_words), aw = word_misalign(w_words);
  auto stage_chunk = [&](long long q) {
    const long long e0 = q * kStageEdges;
    if (e0 < m) {
      const int n = static_cast<int>(min(static_cast<long long>(kStageEdges), m - e0));
      stage_words(s_edges[q & 1], e_words + 2 * e0, 2 * n, lane);
      stage_words(s_w[q & 1], w_words + e0, n, lane);
    }
    cp_async_commit();
  };
  // Edge e from the staged stream; past the end a sentinel -1 - lane that matches nothing.
  auto endpoints = [&](long long e, int& u, int& v) {
    u = v = -1 - lane;
    if (e < m) {
      const uint32_t* buf = s_edges[(e / kStageEdges) & 1] + ae + 2 * (e % kStageEdges);
      u = static_cast<int>(buf[0]);
      v = static_cast<int>(buf[1]);
    }
  };
  auto row_of = [&](int x) { return mb + static_cast<size_t>(x) * pitch + col0; };

  // Per-role state, kept across batches.
  // walker: its batch's endpoints, base rows and post-values (lane l holds edge l's), and
  // the row loads of the next batch.
  int cu = 0, cv = 0, lu = -1 - lane, lv = -1 - lane, tu = 0, tv = 0;
  unsigned long long base_u = 0, base_v = 0, post_u = 0, post_v = 0;
  Raw<kL> raw_u = zero_row<kL>(), raw_v = zero_row<kL>();
  // previous-batch search: the endpoints of the previous batch. eligibility: this CTA's
  // thresholds of substreams 64c + lane and 64c + 32 + lane; `ok` masks the tail.
  int pu_prev = -1 - lane, pv_prev = -1 - lane;
  float t[2] = {0.0f, 0.0f};
  bool ok[2] = {false, false};
  const bool stager = role == kWarps - 2;
  if (role >= kWarps - 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = lane + 32 * h;
      if (kPacked) {
        const int k = col0 + (s >> 3);
        ok[h] = k < width;
        t[h] = ok[h] ? thr[(s & 7) * width + k] : 0.0f;
      } else {
        ok[h] = col0 + s < width;
        t[h] = ok[h] ? thr[col0 + s] : 0.0f;
      }
    }
    if (stager) {
      stage_chunk(0);
      cp_async_wait_all();
    }
  }
  __syncthreads();

  const long long nb = (m + kBatch - 1) / kBatch;
  for (long long k = 0; k <= nb; ++k) {
    const long long first = k * kBatch;
    if (role == 0) {
      // The walker. Batch k - 1 becomes current: its base rows are the previous batch's
      // post-values (still in the lanes' registers) or the loaded rows.
      if (k > 0) {
        const int* found = s_prep[(k - 1) & 1][lane].search;
        const int in_u = max(found[0] & 255, found[1] & 255) - 1;
        const int in_v = max(found[0] >> 8, found[1] >> 8) - 1;
        tu = in_u >= 0 ? in_u : 2 * lane;
        tv = in_v >= 0 ? in_v : 2 * lane + 1;
        const int prev_u = max(found[2] & 255, found[3] & 255) - 1;
        const int prev_v = max(found[2] >> 8, found[3] >> 8) - 1;
        const int su = prev_u >= 0 ? prev_u >> 1 : lane, sv = prev_v >= 0 ? prev_v >> 1 : lane;
        const unsigned long long uu = shfl64(post_u, su), uv = shfl64(post_v, su);
        const unsigned long long vu = shfl64(post_u, sv), vv = shfl64(post_v, sv);
        base_u = prev_u >= 0 ? ((prev_u & 1) ? uv : uu) : to_mask<kL>(raw_u);
        base_v = prev_v >= 0 ? ((prev_v & 1) ? vv : vu) : to_mask<kL>(raw_v);
        cu = lu;
        cv = lv;
      }
      // The row loads of batch k, before the chain of batch k - 1.
      endpoints(first + lane, lu, lv);
      raw_u = lu >= 0 ? load_row<kL>(row_of(lu), pieces) : zero_row<kL>();
      raw_v = lv >= 0 ? load_row<kL>(row_of(lv), pieces) : zero_row<kL>();
      if (k > 0) {
        // The chain of batch k - 1, the only one: edge l reads for u the post-value of its
        // toucher slot (an earlier lane) or its base row, likewise for v, and every lane
        // recomputes its edge from the others' current post-values, round after round, until a
        // round changes nothing. An edge's toucher is always an earlier lane, so after round r
        // every edge at depth < r of the batch's dependency chain is final and the fixed point
        // is the sequential scan's: at most 33 rounds, one where no edge has an earlier toucher
        // in the batch. Registers and shuffles only; no memory access.
        const unsigned long long te = s_prep[(k - 1) & 1][lane].te;
        const bool dep_u = tu != 2 * lane, dep_v = tv != 2 * lane + 1;
        // A slot some later edge links to is not its vertex's last touch in the batch (every
        // later toucher links to the latest one before it).
        const unsigned long long linked = (dep_u ? 1ull << tu : 0ull) | (dep_v ? 1ull << tv : 0ull);
        const unsigned long long marks =
            __reduce_or_sync(kFull, static_cast<unsigned>(linked)) |
            static_cast<unsigned long long>(__reduce_or_sync(kFull, static_cast<unsigned>(linked >> 32))) << 32;
        const bool linked_u = (marks >> (2 * lane)) & 1, linked_v = (marks >> (2 * lane + 1)) & 1;
        // a self-loop's later toucher links to either of its slots
        const bool last_u = !linked_u && !(cu == cv && linked_v), last_v = !linked_v;
        const bool chained = __any_sync(kFull, dep_u || dep_v);
        post_u = base_u;
        post_v = base_v;
        unsigned long long ru = base_u, rv = base_v;
        for (int round = 0; round <= kBatch; ++round) {
          const unsigned long long uu = shfl64(post_u, tu >> 1), uv = shfl64(post_v, tu >> 1);
          const unsigned long long vu = shfl64(post_u, tv >> 1), vv = shfl64(post_v, tv >> 1);
          ru = dep_u ? ((tu & 1) ? uv : uu) : base_u;
          rv = dep_v ? ((tv & 1) ? vv : vu) : base_v;
          const unsigned long long nu = ru | (te & ~rv), nv = rv | (te & ~ru);
          const bool changed = nu != post_u || nv != post_v;
          post_u = nu;
          post_v = nv;
          if (!chained || !__any_sync(kFull, changed)) break;
        }
        // Results: assigned, and each vertex the batch changed written once, from its last touch.
        const long long i = first - kBatch + lane;
        if (i < m) {
          const unsigned long long add = te & ~(ru | rv);
          const int best = add ? 64 * c + 63 - __clzll(static_cast<long long>(add)) : -1;
          if (gridDim.x == 1) {
            assigned[i] = best;
          } else if (best >= 0) {
            atomicMax(assigned + i, best);
          }
          if (last_u && post_u != base_u) store_row<kL>(row_of(cu), post_u, pieces);
          if (cv != cu && last_v && post_v != base_v)
            store_row<kL>(row_of(cv), post_v, pieces);
        }
      }
    } else if (role < kWarps - 2) {
      // The window search of batch k over half the lanes of its own batch (roles 1, 2; earlier
      // lanes only) or of the previous batch (roles 3, 4): for each endpoint the latest slot
      // that touched it. Four accumulators per endpoint (by step mod 4) keep the dependent
      // chains short; slots grow with the step, so the latest toucher is the largest slot.
      const bool own = role <= 2;
      const int s_lo = ((role - 1) & 1) * (kBatch / 2);
      int nu, nv;
      endpoints(first + lane, nu, nv);
      const int ku = own ? nu : pu_prev, kv = own ? nv : pv_prev;
      int bu[4] = {-1, -1, -1, -1}, bv[4] = {-1, -1, -1, -1};
#pragma unroll 1
      for (int s0 = s_lo; s0 < s_lo + kBatch / 2; s0 += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + j;
          const int qu = __shfl_sync(kFull, ku, s), qv = __shfl_sync(kFull, kv, s);
          const int slot = own && s >= lane ? -2 : 2 * s;
          bu[j] = max(bu[j], max(nu == qu ? slot : -1, nu == qv ? slot + 1 : -1));
          bv[j] = max(bv[j], max(nv == qu ? slot : -1, nv == qv ? slot + 1 : -1));
        }
      }
      const int best_u = max(max(bu[0], bu[1]), max(bu[2], bu[3]));
      const int best_v = max(max(bv[0], bv[1]), max(bv[2], bv[3]));
      s_prep[k & 1][lane].search[role - 1] = (best_u + 1) | ((best_v + 1) << 8);
      pu_prev = nu;
      pv_prev = nv;
    } else {
      // Eligibility of batch k over half its lanes (roles 5, 6), and the staging (role 5).
      // Chunk q - 1's buffer is free once batch k, the first of chunk q, is reached: every
      // warp keeps what it needs of batch k - 1 in registers.
      if (stager && first < m && first % kStageEdges == 0) stage_chunk(first / kStageEdges + 1);
      int nu, nv;
      endpoints(first + lane, nu, nv);
      const float nw = first + lane < m
          ? __uint_as_float(s_w[((first + lane) / kStageEdges) & 1][aw + (first + lane) % kStageEdges])
          : 0.0f;
      Prep* prep = s_prep[k & 1];
      const int s_lo = (role - (kWarps - 2)) * (kBatch / 2);
#pragma unroll
      for (int j = 0; j < kBatch / 2; ++j) {
        const int s = s_lo + j;
        const float ws = __shfl_sync(kFull, nw, s);
        const unsigned b0 = __ballot_sync(kFull, ok[0] && ws >= t[0]);
        const unsigned b1 = __ballot_sync(kFull, ok[1] && ws >= t[1]);
        if (lane == s) prep[s].te = nu != nv ? (static_cast<unsigned long long>(b1) << 32) | b0 : 0;
      }
      const long long next = first + kBatch;
      if (stager && next < m && next % kStageEdges == 0) cp_async_wait_all();  // before the barrier
    }
    __syncthreads();  // batch k prepared; the walker's stores before the next row loads
  }
}

template <Layout kL>
int launch(const void* edges, const void* weights, const void* thr, void* mb, void* assigned,
           long long m, int width, int pitch, void* stream) {
  constexpr bool kPacked = kL == Layout::kPacked;
  const int chunks = kPacked ? (8 * width + kChunkBits - 1) / kChunkBits
                             : (width + kChunkBits - 1) / kChunkBits;
  const bool ok = kPacked ? (pitch % 8 == 0 && pitch >= width)
                          : (width % 16 == 0 && pitch == width);
  if (width < 0 || chunks > 32 || !ok) return static_cast<int>(cudaErrorInvalidValue);
  substream_match_edges_kernel<kL><<<chunks > 0 ? chunks : 1, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edges), static_cast<const float*>(weights),
      static_cast<const float*>(thr), static_cast<uint8_t*>(mb), static_cast<int32_t*>(assigned),
      m, width, pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success). `width` is the
// thresholds' row (packed: uint8 words, up to 256; unpacked: bytes, a multiple of 16 up to
// 2048) and `pitch` the bit block's row in bytes (packed: a multiple of 8 >= width;
// unpacked: width). When width > 64 substreams, `assigned` must hold -1 on entry.
extern "C" int substream_match_packed(const void* edges, const void* weights, const void* thr,
                                      void* mb, void* assigned, long long m, int width,
                                      int pitch, void* stream) {
  return launch<Layout::kPacked>(edges, weights, thr, mb, assigned, m, width, pitch, stream);
}

extern "C" int substream_match_unpacked(const void* edges, const void* weights, const void* thr,
                                        void* mb, void* assigned, long long m, int width,
                                        int pitch, void* stream) {
  return launch<Layout::kUnpacked>(edges, weights, thr, mb, assigned, m, width, pitch, stream);
}

// ---------------------------------------------------------------------------------------------
// The rounds engine: the packed contract above for rows of one 64-bit word (L <= 64), computed
// on the whole card in place of one CTA's walk.
//
// It replaces no TPU kernel; it computes what `_kernel_packed` computes. Greedy matching under
// a fixed order is the fixed point of rounds: every live edge that is the least live edge at
// both its endpoints joins, and the edges it touches die. Each substream is one bit of a word,
// so the 64 substreams run such rounds side by side. The stream is taken in chunks of `chunk`
// consecutive edges (at most kRoundChunk); chunk k starts from the bit block that chunks < k
// left, so the fixed point is the sequential scan's, bit for bit, in `assigned` and in `mb`.
// Within a chunk every edge has a live word U = te & ~mb[u] & ~mb[v], and its 2 * chunk
// incidences (vertex, rank) arrive grouped by vertex in rank order (the caller's stable sort
// of substream_match_rounds_keys' keys). A round is two phases between grid barriers:
//   A  kill U &= ~(mb[u] | mb[v]); a segmented exclusive OR-scan of U along each vertex's run
//      gives B_u and B_v, the bits live at an earlier edge of the vertex;
//   B  win = U & ~B_u & ~B_v; mb[u] |= win, mb[v] |= win (64-bit atomicOr: winners at one
//      vertex hold disjoint bits, so the order is free); assigned = max(assigned, top bit).
// A chunk ends after a B that leaves no edge a bit it did not win, or after an A that finds no
// live edge. The grid is kRoundBlocks CTAs at most, all resident (a cooperative launch; on a
// card that holds fewer, substream_match_rounds_blocks says how many, and the caller's chunk
// shrinks to fit them); each holds kRoundTile incidences of the chunk in registers, kRoundItems consecutive positions a
// thread, for all the chunk's rounds, so a round reads only the bit-block rows of live edges
// and the B_v word of each live edge. The scan is the thread's items, then the warps, then the
// CTAs by a decoupled look-back over per-CTA aggregates, published with an epoch (one a round)
// so no flag is ever reset. No host wait: the chunk and round loops run on the device.
//
// Bound. The bytes are the per-edge kernel's (edges, weights, assigned, the block once) plus
// the grouping (keys, sorted keys, the sort's indices); what limits it is one grid barrier and
// one L2 or HBM round trip to the rows per phase, a few rounds a chunk.

#include <math_constants.h>

namespace {

constexpr int kRoundThreads = 512;
constexpr int kRoundItems = 4;
constexpr int kRoundTile = kRoundThreads * kRoundItems;  // incidences per CTA and chunk
constexpr int kRoundBlocks = 128;
constexpr int kRoundChunk = 131072;                      // edges per chunk, at most
constexpr int kRoundWarps = kRoundThreads / 32;
static_assert(2 * kRoundChunk == kRoundBlocks * kRoundTile,
              "the grid holds one chunk's incidences in registers");
// The int64 scratch the wrapper passes, zeroed before each launch but `bv`: [0, kRoundChunk)
// bv; then per CTA agg, agg_state, incl, incl_state; then 4 counters (live, rest, barrier).
// live and rest hold the last epoch in which some CTA had a live edge, or an edge with bits left
// after B: a flag stamped with its epoch, not a count, because a CTA that leaves a chunk after A
// may stamp the next chunk's first A before a slower CTA has read this one's (a count would then
// tell the slower CTA that this round had a live edge, and the grid would leave step).

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// All CTAs meet: the count `bar` only grows, by gridDim.x a barrier.
__device__ __forceinline__ void grid_barrier(unsigned long long* bar, unsigned long long& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1ull);
    while (ld_acquire(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// (head, OR) pairs of a segmented OR-scan: (h, v) followed by (bh, bv). A head restarts the OR.
__device__ __forceinline__ void seg_append(bool& h, unsigned long long& v, bool bh,
                                           unsigned long long bv) {
  v = bh ? bv : (v | bv);
  h = h || bh;
}

// The substreams whose threshold w reaches. Sorted thresholds make it a prefix of the word
// (binary search); any others are compared one by one. nvalid = 8 * width substreams.
__device__ __forceinline__ unsigned long long eligible(float w, const float* thr, int nvalid,
                                                       bool sorted) {
  if (sorted) {
    int lo = 0, hi = nvalid;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (thr[mid] <= w) lo = mid + 1; else hi = mid;
    }
    return lo >= 64 ? ~0ull : ((1ull << lo) - 1);
  }
  unsigned long long te = 0;
  for (int s = 0; s < nvalid; ++s) te |= static_cast<unsigned long long>(w >= thr[s]) << s;
  return te;
}

// Keys of the grouping: incidence i (edge i / 2, side i % 2) of the slice gets
// (chunk of its edge) << vbits | its vertex.
__global__ void substream_match_rounds_keys_kernel(const int32_t* __restrict__ edges,
                                                   int32_t* __restrict__ keys, long long n,
                                                   int chunk, int vbits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    keys[i] = static_cast<int32_t>(((i >> 1) / chunk) << vbits) | edges[i];
}

// One slice of E edges in chunks of `chunk`. keys/perm: the slice's incidences sorted by
// (chunk, vertex), stable (perm[p] = the incidence at position p). mb: [n_pad] words.
__global__ void __launch_bounds__(kRoundThreads, 1) substream_match_rounds_kernel(
    const int32_t* __restrict__ edges, const float* __restrict__ weights,
    const float* __restrict__ thr, unsigned long long* mb, int32_t* __restrict__ assigned,
    const int32_t* __restrict__ keys, const int64_t* __restrict__ perm, long long E, int chunk,
    int width, int vbits, unsigned long long* scratch, long long* stats) {
  __shared__ float s_thr[64];
  __shared__ bool s_sorted;
  __shared__ bool s_warp_h[kRoundWarps];
  __shared__ unsigned long long s_warp_v[kRoundWarps];
  __shared__ unsigned long long s_carry;

  unsigned long long* bv = scratch;
  unsigned long long* agg = scratch + kRoundChunk;
  unsigned long long* agg_state = agg + kRoundBlocks;  // epoch << 1 | has a head
  unsigned long long* incl = agg_state + kRoundBlocks;
  unsigned long long* incl_state = incl + kRoundBlocks;  // epoch
  unsigned long long* counters = incl_state + kRoundBlocks;  // live, rest, barrier

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x;
  const int nvalid = 8 * width;
  if (tid < 64) s_thr[tid] = tid < nvalid ? thr[(tid & 7) * width + (tid >> 3)] : CUDART_INF_F;
  __syncthreads();
  if (tid == 0) {
    bool sorted = true;
    for (int s = 0; s < nvalid; ++s)
      sorted = sorted && s_thr[s] == s_thr[s] && (s == 0 || s_thr[s - 1] <= s_thr[s]);
    s_sorted = sorted;
  }
  __syncthreads();
  const bool sorted = s_sorted;
  const int32_t vmask = static_cast<int32_t>((1u << vbits) - 1);

  unsigned long long barrier = 0, epoch = 0;
  long long rounds = 0;
  const long long nchunks = (E + chunk - 1) / chunk;
  for (long long k = 0; k < nchunks; ++k) {
    const long long e0 = k * chunk;
    const int npos = 2 * static_cast<int>(min(static_cast<long long>(chunk), E - e0));
    const int first_pos = b * kRoundTile + tid * kRoundItems;  // chunk-local
    const int32_t* ck = keys + 2 * e0;
    const long long* cp = reinterpret_cast<const long long*>(perm) + 2 * e0;
    // This thread's incidences, for all the chunk's rounds: vertex x, other end y, edge el
    // (chunk-local), side, whether it heads its vertex's run, and the live word.
    int x[kRoundItems], y[kRoundItems], el[kRoundItems];
    bool side1[kRoundItems], head[kRoundItems], in[kRoundItems];
    unsigned long long val[kRoundItems], bits[kRoundItems];
    int32_t prev_key = first_pos > 0 && first_pos <= npos ? __ldg(ck + first_pos - 1) : -1;
#pragma unroll
    for (int i = 0; i < kRoundItems; ++i) {
      const int p = first_pos + i;
      in[i] = p < npos;
      x[i] = y[i] = el[i] = 0;
      side1[i] = false;
      head[i] = true;
      val[i] = 0;
      if (in[i]) {
        const int32_t key = __ldg(ck + p);
        const long long j = __ldg(cp + p) - 2 * e0;
        el[i] = static_cast<int>(j >> 1);
        side1[i] = j & 1;
        x[i] = key & vmask;
        head[i] = p == 0 || key != prev_key;
        prev_key = key;
        y[i] = __ldg(edges + 2 * (e0 + el[i]) + (side1[i] ? 0 : 1));
        val[i] = x[i] != y[i] ? eligible(__ldg(weights + e0 + el[i]), s_thr, nvalid, sorted) : 0;
      }
    }
    for (bool first = true;; first = false) {
      ++epoch;
      // A: kill, then the scan.
      bool live = false;
#pragma unroll
      for (int i = 0; i < kRoundItems; ++i) {
        if (val[i]) val[i] &= ~(__ldcg(mb + x[i]) | __ldcg(mb + y[i]));
        live = live || val[i] != 0;
      }
      bool th = false;
      unsigned long long tv = 0;
#pragma unroll
      for (int i = 0; i < kRoundItems; ++i) seg_append(th, tv, head[i], val[i]);
      // the warp's inclusive scan of the threads' (head, OR) pairs, then its exclusive one
      bool h = th;
      unsigned long long v = tv;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const bool oh = __shfl_up_sync(kFull, static_cast<int>(h), off);
        const unsigned long long ov = __shfl_up_sync(kFull, v, off);
        if (lane >= off) {
          v = h ? v : (v | ov);
          h = h || oh;
        }
      }
      if (lane == 31) {
        s_warp_h[warp] = h;
        s_warp_v[warp] = v;
      }
      bool eh = __shfl_up_sync(kFull, static_cast<int>(h), 1);
      unsigned long long ev = __shfl_up_sync(kFull, v, 1);
      if (lane == 0) {
        eh = false;
        ev = 0;
      }
      __syncthreads();
      if (warp == 0) {
        bool wh = lane < kRoundWarps ? s_warp_h[lane] : false;
        unsigned long long wv = lane < kRoundWarps ? s_warp_v[lane] : 0;
#pragma unroll
        for (int off = 1; off < kRoundWarps; off <<= 1) {
          const bool oh = __shfl_up_sync(kFull, static_cast<int>(wh), off);
          const unsigned long long ov = __shfl_up_sync(kFull, wv, off);
          if (lane >= off) {
            wv = wh ? wv : (wv | ov);
            wh = wh || oh;
          }
        }
        if (lane == kRoundWarps - 1) {
          // the CTA's aggregate: published for the CTAs after it
          agg[b] = wv;
          st_release(agg_state + b, epoch << 1 | (wh ? 1 : 0));
          if (wh) {
            incl[b] = wv;
            st_release(incl_state + b, epoch);
          }
          // the look-back: the OR of the CTAs before back to the first with a head
          unsigned long long carry = 0;
          for (int j = b - 1; j >= 0; --j) {
            unsigned long long st;
            do {
              st = ld_acquire(agg_state + j);
            } while ((st >> 1) != epoch);
            if (ld_acquire(incl_state + j) == epoch) {
              carry |= __ldcg(incl + j);
              break;
            }
            carry |= __ldcg(agg + j);
            if (st & 1) break;
          }
          if (!wh) {
            incl[b] = carry | wv;
            st_release(incl_state + b, epoch);
          }
          s_carry = carry;
        }
        // the exclusive prefix of warp `lane`, for the warps of the CTA
        const bool pwh = __shfl_up_sync(kFull, static_cast<int>(wh), 1);
        const unsigned long long pwv = __shfl_up_sync(kFull, wv, 1);
        __syncwarp();
        if (lane < kRoundWarps) {
          s_warp_h[lane] = lane > 0 && pwh;
          s_warp_v[lane] = lane > 0 ? pwv : 0;
        }
      }
      __syncthreads();
      // this thread's exclusive prefix in the chunk: the CTA's carry, the warps before, the
      // lanes before
      bool ph = false;
      unsigned long long run = s_carry;
      seg_append(ph, run, s_warp_h[warp], s_warp_v[warp]);
      seg_append(ph, run, eh, ev);
#pragma unroll
      for (int i = 0; i < kRoundItems; ++i) {
        if (head[i]) run = 0;
        bits[i] = run;
        run |= val[i];
        if (val[i] && side1[i]) __stcg(bv + el[i], bits[i]);
      }
      live = __syncthreads_or(live);
      if (tid == 0 && live) atomicMax(counters, epoch);
      grid_barrier(counters + 2, barrier);
      const bool any_live = __ldcg(counters) == epoch;
      if (!any_live && !first) break;
      rounds += any_live;
      // B: the winners, from the side-0 incidence of each edge.
      bool rest = false;
#pragma unroll
      for (int i = 0; i < kRoundItems; ++i) {
        if (!in[i] || side1[i]) continue;
        unsigned long long win = 0;
        if (val[i]) {
          win = val[i] & ~bits[i] & ~__ldcg(bv + el[i]);
          if (win) {
            atomicOr(mb + x[i], win);
            atomicOr(mb + y[i], win);
          }
          rest = rest || (val[i] & ~win) != 0;
        }
        const int top = win ? 63 - __clzll(static_cast<long long>(win)) : -1;
        int32_t* a = assigned + e0 + el[i];
        if (first) *a = top;
        else if (top > *a) *a = top;
      }
      rest = __syncthreads_or(rest);
      if (tid == 0 && rest) atomicMax(counters + 1, epoch);
      grid_barrier(counters + 2, barrier);
      const bool more = __ldcg(counters + 1) == epoch;
      if (!more) break;
    }
  }
  if (b == 0 && tid == 0) {
    stats[0] += nchunks;
    stats[1] += rounds;
  }
}

}  // namespace

// The grouping keys of a slice's 2 * E incidences (edges: its [E, 2] pairs).
extern "C" int substream_match_rounds_keys(const void* edges, void* keys, long long E, int chunk,
                                           int vbits, void* stream) {
  if (E <= 0) return 0;
  if (chunk <= 0 || vbits < 1 || vbits > 31 || (E - 1) / chunk >= (1ll << (31 - vbits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = 2 * E;
  const int blocks = static_cast<int>(min(4096ll, (n + 255) / 256));
  substream_match_rounds_keys_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edges), static_cast<int32_t*>(keys), n, chunk, vbits);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the rounds engine the current device holds resident at once, at most kRoundBlocks
// (0 where it takes no cooperative launch): the chunk is at most that times kRoundTile / 2.
extern "C" int substream_match_rounds_blocks(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, substream_match_rounds_kernel,
                                                        kRoundThreads, 0);
  *blocks = err == cudaSuccess && coop ? min(kRoundBlocks, per_sm * sms) : 0;
  return static_cast<int>(err);
}

// One slice through the rounds engine on `stream`: a cooperative launch of
// ceil(2 * chunk / kRoundTile) CTAs. thr is [8, width] (width <= 8 words), mb [n_pad] 64-bit
// rows, scratch as above (all but bv zero), stats [2] (chunks,
// rounds; added to). Returns the launch's error (0 on success).
extern "C" int substream_match_rounds(const void* edges, const void* weights, const void* thr,
                                      void* mb, void* assigned, const void* keys,
                                      const void* perm, long long E, int chunk, int width,
                                      int vbits, void* scratch, void* stats, void* stream) {
  if (E <= 0) return 0;
  if (chunk <= 0 || chunk > kRoundChunk || width < 0 || width > 8 || vbits < 1 || vbits > 31 ||
      (E - 1) / chunk >= (1ll << (31 - vbits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (2 * chunk + kRoundTile - 1) / kRoundTile;
  void* args[] = {&edges, &weights, &thr, &mb, &assigned, &keys, &perm, &E, &chunk,
                  &width, &vbits, &scratch, &stats};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&substream_match_rounds_kernel), dim3(blocks),
      dim3(kRoundThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
