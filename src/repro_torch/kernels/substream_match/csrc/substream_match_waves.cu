// Wave-parallel substream matchers (Listing 1 Part 1): four kernels, one walk.
//
//   substream_match_mega            replaces the TPU tile megakernel `_kernel_waves_mega_packed`
//                                   (src/repro/kernels/substream_match/kernel.py:519, wrapper
//                                   `substream_match_pallas_mega`, with `_prefix_te_table` :421
//                                   and `_high_bit_table` :440);
//   substream_match_waves           replaces the TPU segment kernel `_kernel_waves_packed`
//                                   (kernel.py:243, wrapper `substream_match_pallas_waves`);
//   substream_match_mega_unpacked   replaces `_kernel_waves_mega` (kernel.py:451, the mega
//                                   wrapper with packed=False);
//   substream_match_waves_unpacked  replaces `_kernel_waves` (kernel.py:168, the waves wrapper
//                                   with packed=False).
// All walk a fill-packed wave schedule (repro_torch/graph/waves.py): wave k owns the slots
// [seg_offsets[k] * seg, seg_offsets[k + 1] * seg), and the real slots of one wave are
// vertex-disjoint. For every slot (u, v, w):
//   te       = substream l eligible when w >= thr[l]; none when u == v (self-loops, padding)
//   add      = te & ~(mb[u] | mb[v])
//   mb[u] |= add; mb[v] |= add
//   assigned = the highest substream of add, or -1.
// Layouts. The block has `rows` rows of `width` bytes. Packed: uint8 words, bit j of word k =
// substream 8k+j, width a multiple of 8 up to 256, so 8 * width lanes (substreams). Unpacked:
// int8 bytes, byte l = substream l, set when non-zero (the wrapper has normalised it to 0/1),
// width a multiple of 16 up to 2048, so `width` lanes. The walk works on 64-bit words, bit i
// of word c = substream 64c + i: on this little-endian card that is the packed row itself, so
// the packed kernels walk their own block and the unpacked ones a packed working copy of theirs.
// Operand contracts, as the TPU wrappers':
//   mega  : ids = uv [2 * total], per tile of `bslots` slots all u's then all v's; thr = the
//           flat sorted vector (+inf pads), one threshold a lane. Sorted thresholds make the
//           passing set a prefix, the TPU kernel's `lane < count` mask.
//   waves : ids = edges [total, 2]; thr = one threshold a lane, in any order (the wrapper
//           flattens the packed bit planes [8, width] to lanes, lane 8k+j = thr[j, k]).
// Padding (and, for mega, self-loop) slots hold u = v = n_pad, the sacrificial row.
//
// Bound on the H100. The bytes the function must move are m*16 B (edge pair, weight,
// assigned) plus the bit block: 0.214 ms packed (8 MiB block) and 0.232 ms unpacked (64 MiB,
// which does not fit the 50 MB L2) at 3.35 TB/s at the paper's size. Greedy matching is
// confluent over vertex-disjoint edges, so finishing wave k before wave k+1 gives the
// sequential result bit for bit, and inside a wave every slot can run at once. The waves are
// narrow (a few hundred slots on the paper's generated order), so the time is what one wave
// costs times the number of waves (128,990 there): a chain of latencies, not bytes or SMs. On
// the H100 a block barrier costs ~270 cycles at 16 warps and a dependent L2 round trip ~540
// (NVIDIA H100 80GB HBM3, 700 W; scripts/latency_probe.cu).
//
// Design. Two launches packed, four unpacked:
//  1. count_passing, across the card: every slot's passing count, the number of thresholds
//     <= w (a binary search), 0 on a self-loop. When the thresholds are sorted (checked once
//     by the walk; the mega operands always are) a slot's eligibility is the prefix below its
//     count, so no threshold compare is left for the walk. Unsorted thresholds are compared
//     one a substream inside the walk: right, only slower.
//  2. Unpacked only, pack_block: the working copy, one 64-bit word per 64 substreams of a row
//     (a non-zero byte is a set bit). The 8 MiB copy at the paper's size stays in the L2, where
//     the 64 MiB block cannot; 4. unpack_block writes it back as 0/1 bytes. Two passes over the
//     block at HBM rate.
//  3. The walk, the same code for both layouts: one persistent CTA of kThreads threads, one
//     __syncthreads() between two waves.
//     A slot takes G lanes (the next power of two >= its 64-substream words), a thread each,
//     each lane owning 64 substreams; `best` is a shuffle max over the G lanes; a wave wider
//     than kThreads / G slots runs in several passes. Each lane's two words are loaded before
//     either is stored, and written back only where add != 0. A slot with u == v never
//     writes, so the sacrificial row is never raced, and no bit past L is ever set: the words'
//     pad bits come back as they went in.
//     The slot stream is staged ahead in rings in shared memory by the last two warps (warps
//     that narrow waves leave idle), one a ring: the segment offsets kOffsetAhead waves ahead,
//     one 4-byte cp.async a wave; the ids and passing counts of wave k+kAhead during wave k,
//     by 16-byte cp.async (4-byte at the ends of a misaligned range), left in flight for
//     kWait barriers (cp.async.wait_group). A wave is staged when it and the waves back to
//     the current one fit the ring (kRingSlots slots); the others are read from global
//     memory. The staging warps plan each step's range a wave ahead, so that a wave's copies
//     go out right after its barrier: a wave costs what the longest chain of dependent
//     instructions between two barriers costs, and the copies' latency is not on any.
//     So the chain of a staged wave is the barrier, shared-memory reads of its slot and one
//     L2 round trip to its rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;       // one CTA of 16 warps, a (slot, lane) each
constexpr int kChunkBits = 64;      // substreams per lane: one 64-bit word
constexpr int kMaxBits = 2048;      // substreams: L <= 2048
constexpr int kRingSlots = 4096;    // slots staged in shared memory
constexpr int kAhead = 3;           // waves by which a wave's slot copy precedes it
constexpr int kWait = kAhead - 1;   // copy groups a barrier leaves in flight
constexpr int kOffsetAhead = 8;     // waves by which a segment offset's copy precedes it
constexpr int kOffsetRing = 16;     // segment offsets held in shared memory
constexpr int kStagers = 64;        // the threads that stage the slot stream: a warp a ring
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kThreads <= 1024 && kChunkBits == 64,
              "one CTA of whole warps, one 64-bit word per lane");
static_assert(kAhead >= 1, "a wave's copy lands by the barrier before it");
static_assert(kOffsetAhead >= kAhead + kWait + 3 && kOffsetAhead + 1 < kOffsetRing,
              "offsets k..k+kAhead+2 have landed, and are live, at wave k");
static_assert((kRingSlots & (kRingSlots - 1)) == 0 && kRingSlots >= kThreads,
              "a power of two: ring positions are masks; a pass fits the ring");
static_assert(kStagers == 64 && kStagers <= kThreads, "one staging warp for each ring");

struct alignas(16) Smem {
  uint32_t ids[2 * kRingSlots];  // the staged ids, by global int index (+ misalignment)
  uint32_t val[kRingSlots];      // the staged passing counts (or weights), by slot
  float thr[kMaxBits];
  int32_t off[kOffsetRing];      // seg_offsets, by wave mod kOffsetRing
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// The offset, in 4-byte words, of `p` inside its 16-byte line.
__device__ __forceinline__ int word_misalign(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Words [g0, g1) of src into `ring` (mask + 1 words, a multiple of 4) at (g + a) & mask,
// a = word_misalign(src), so that source and destination share their offset in the 16-byte
// line and no line straddles the ring's end: whole lines by 16-byte cp.async, the < 4 words
// at either end by word. Lane t of the staging warp takes every 32nd line. Positions and
// counts are 32-bit (the ring is far smaller than 2^32 words; a wave's range too).
__device__ __forceinline__ void stage_ring(uint32_t* ring, uint32_t mask, const uint32_t* src,
                                           long long g0, long long g1, int a, int t) {
  const uint32_t* from = src + g0;
  const uint32_t pos = static_cast<uint32_t>(g0) + a;  // ring position of word g0, unmasked
  const int n = static_cast<int>(g1 - g0);
  const int head = min(n, static_cast<int>((4 - (pos & 3)) & 3));
  const int lines = (n - head) >> 2, tail = head + 4 * lines;
  if (t < head) cp_async4(&ring[(pos + t) & mask], from + t);
  for (int q = t; q < lines; q += 32)
    cp_async16(&ring[(pos + head + 4 * q) & mask], from + head + 4 * q);
  if (t < n - tail) cp_async4(&ring[(pos + tail + t) & mask], from + tail + t);
}

// 0x01 in every byte of x that is non-zero, 0x00 elsewhere.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}
// 4 bits from the 0x00/0x01 bytes of x (byte i -> bit i), and back.
__device__ __forceinline__ uint32_t gather4(uint32_t x) { return (x * 0x10204080u) >> 28; }
__device__ __forceinline__ uint32_t expand4(uint32_t n) { return (n * 0x00204081u) & 0x01010101u; }

// The `pieces` (<= 4) 16-byte pieces of 64 unpacked substreams at p, as a 64-bit mask.
__device__ __forceinline__ unsigned long long load_mask(const uint8_t* p, int pieces) {
  unsigned long long m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < pieces) {
      const uint4 x = __ldcg(reinterpret_cast<const uint4*>(p) + q);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m |= static_cast<unsigned long long>(gather4(nonzero_bytes(w[i]))) << (16 * q + 4 * i);
    }
  }
  return m;
}

__device__ __forceinline__ void store_mask(uint8_t* p, unsigned long long m, int pieces) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < pieces) {
      const uint32_t h = static_cast<uint32_t>(m >> (16 * q));
      __stcg(reinterpret_cast<uint4*>(p) + q,
             make_uint4(expand4(h & 15), expand4((h >> 4) & 15), expand4((h >> 8) & 15),
                        expand4((h >> 12) & 15)));
    }
  }
}

// The block's row r, substreams 64c..64c+63, to and from the working copy's word r * chunks + c.
__global__ void pack_block(const uint8_t* __restrict__ mb, unsigned long long* __restrict__ work,
                           long long words, int width, int chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < words;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / chunks;
    const int c = static_cast<int>(i - r * chunks);
    work[i] = load_mask(mb + r * width + kChunkBits * c, min(4, (width - kChunkBits * c) / 16));
  }
}

__global__ void unpack_block(const unsigned long long* __restrict__ work, uint8_t* __restrict__ mb,
                             long long words, int width, int chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < words;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / chunks;
    const int c = static_cast<int>(i - r * chunks);
    store_mask(mb + r * width + kChunkBits * c, work[i], min(4, (width - kChunkBits * c) / 16));
  }
}

// Bit i = (w >= thr[i]) for i < n: unsorted thresholds, one compare a substream. Kept out of
// line and rolled, so that this rare path does not crowd the walk's instruction cache.
__device__ __noinline__ unsigned long long compare_lanes(const float* thr, int n, float w) {
  unsigned long long te = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) te |= static_cast<unsigned long long>(w >= thr[i]) << i;
  return te;
}

// The passing count of every slot, before the walk, across the card: the number of
// thresholds <= w (a binary search over the sorted thresholds), 0 on a self-loop. Sorted
// thresholds make the slot's eligibility the prefix below this count.
template <bool kMega>
__global__ void count_passing(const int32_t* __restrict__ ids, const float* __restrict__ weights,
                              const float* __restrict__ thr, int32_t* __restrict__ cnt,
                              long long total, int bslots, int lanes) {
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; s < total;
       s += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long iu = 2 * s, iv = 2 * s + 1;
    if (kMega) {
      const long long t = s / bslots;
      iu = 2 * t * bslots + (s - t * bslots);
      iv = iu + bslots;
    }
    const float w = weights[s];
    int a = 0;
    for (int step = 1 << (31 - __clz(lanes)); step > 0; step >>= 1)
      if (a + step <= lanes && __ldg(thr + a + step - 1) <= w) a += step;
    cnt[s] = ids[iu] == ids[iv] ? 0 : a;
  }
}

// The walk, for both layouts. lanes = the substreams a row holds; lg = log2(G), G lanes per
// slot; work = the block's 64-bit words, [rows, chunks] (the packed block itself, or the
// unpacked block's working copy); cnt = the slots' passing counts.
template <bool kMega>
__global__ void __launch_bounds__(kThreads, 1) substream_match_walk(
    const int32_t* __restrict__ seg_offsets,  // [num_waves + 1]
    int num_waves, int seg, int bslots,
    const int32_t* __restrict__ ids,          // mega: uv [2 * total]; waves: edges [total, 2]
    const float* __restrict__ weights,        // [total]
    const int32_t* __restrict__ cnt,          // [total]
    const float* __restrict__ thr,            // [lanes]
    unsigned long long* __restrict__ work,    // [rows, chunks]
    int32_t* __restrict__ assigned,           // [total], -1 filled by the caller
    int lanes, int lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int G = 1 << lg;
  const int P = kThreads >> lg;            // slots a pass
  const int chunks = (lanes + kChunkBits - 1) / kChunkBits;
  const int c = tid & (G - 1);             // this lane's 64 substreams of its slot

  bool descends = false;  // some threshold above its successor, or a NaN
  for (int i = tid; i < lanes; i += kThreads) {
    sm.thr[i] = thr[i];
    descends |= i + 1 < lanes && !(thr[i] <= thr[i + 1]);
  }
  for (int i = tid; i < kOffsetAhead && i <= num_waves; i += kThreads) sm.off[i] = seg_offsets[i];
  // Sorted thresholds: stage the passing counts; else the weights, compared inline.
  const bool sorted = !__syncthreads_or(descends);
  const uint32_t* vals = sorted ? reinterpret_cast<const uint32_t*>(cnt)
                                : reinterpret_cast<const uint32_t*>(weights);
  const int a_ids = word_misalign(ids), a_val = word_misalign(vals);

  auto slot_of = [&](int k) { return static_cast<long long>(sm.off[k % kOffsetRing]) * seg; };
  // Slot lo + r's u and v as int offsets from 2 * lo (lo a multiple of bslots for mega:
  // tile r / bslots holds its u's, then its v's, so u sits at 2r - r % bslots).
  const int bmask = (bslots & (bslots - 1)) == 0 ? bslots - 1 : -1;
  auto rel = [&](int r, int& iu, int& iv) {
    if (kMega) {
      iu = 2 * r - (bmask >= 0 ? r & bmask : r % bslots);
      iv = iu + bslots;
    } else {
      iu = 2 * r;
      iv = 2 * r + 1;
    }
  };
  auto word_of = [&](int vertex) { return work + static_cast<size_t>(vertex) * chunks + c; };
  // The slots [lo, hi)'s ids (first staging warp) or staged values (second) into their ring,
  // by the last two warps (the warps a narrow wave leaves idle).
  const int stager = tid - (kThreads - kStagers), lane = stager & 31;
  auto stage_slots = [&](long long lo, long long hi) {
    if (stager < 32)
      stage_ring(sm.ids, 2 * kRingSlots - 1, reinterpret_cast<const uint32_t*>(ids), 2 * lo,
                 2 * hi, a_ids, lane);
    else
      stage_ring(sm.val, kRingSlots - 1, vals, lo, hi, a_val, lane);
  };

  // Prologue: waves 0 .. kAhead-1 staged, those that fit the ring from slot 0. pipe bit i:
  // wave k + i is staged.
  unsigned pipe = 0;
  for (int k = 0; k < kAhead && k < num_waves; ++k) {
    if (slot_of(k + 1) <= kRingSlots) {
      pipe |= 1u << k;
      if (stager >= 0) stage_slots(slot_of(k), slot_of(k + 1));
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  long long lo = num_waves > 0 ? slot_of(0) : 0, hi = num_waves > 0 ? slot_of(1) : 0;
  // The stagers' plan for the next step, made a wave ahead so that the copies go out at once:
  // wave k + kAhead's slots, staged when the ring holds them from the current wave on.
  bool plan = kAhead < num_waves && slot_of(kAhead + 1) - lo <= kRingSlots;
  long long plan_lo = plan ? slot_of(kAhead) : 0, plan_hi = plan ? slot_of(kAhead + 1) : 0;
  for (int k = 0; k < num_waves; ++k) {
    const int n = static_cast<int>(hi - lo);
    // Ring positions in 32 bits: the rings' sizes are powers of two far below 2^32.
    const uint32_t lo_ids = static_cast<uint32_t>(2 * lo) + a_ids;
    const uint32_t lo_val = static_cast<uint32_t>(lo) + a_val;
    const long long hi_next = k + 1 < num_waves ? slot_of(k + 2) : hi;
    const int ahead = k + kAhead;
    const bool staged = pipe & 1;
    const bool stage_ahead = ahead < num_waves && slot_of(ahead + 1) - lo <= kRingSlots;
    // Staging beside the chain: the offsets kOffsetAhead waves on, wave k + kAhead's slots.
    if (stager >= 0) {
      if (plan) stage_slots(plan_lo, plan_hi);  // plan == stage_ahead
      if (stager == 32 && k + kOffsetAhead <= num_waves)
        cp_async4(&sm.off[(k + kOffsetAhead) % kOffsetRing], seg_offsets + k + kOffsetAhead);
      cp_async_commit();
      const int next = ahead + 1;
      plan = next < num_waves && slot_of(next + 1) - hi <= kRingSlots;
      if (plan) {
        plan_lo = slot_of(next);
        plan_hi = slot_of(next + 1);
      }
    }
    // The chain: each (slot, lane) of the wave, a pass of kThreads / G slots at a time.
    for (int base = 0; base < n; base += P) {
      const int r = base + (tid >> lg);
      const long long s = lo + r;
      int u = 0, v = 0;
      unsigned long long te = 0;
      if (r < n && c < chunks) {
        int iu, iv;
        rel(r, iu, iv);
        uint32_t val;
        if (staged) {
          u = static_cast<int>(sm.ids[(lo_ids + iu) & (2 * kRingSlots - 1)]);
          v = static_cast<int>(sm.ids[(lo_ids + iv) & (2 * kRingSlots - 1)]);
          val = sm.val[(lo_val + r) & (kRingSlots - 1)];
        } else {
          u = ids[2 * lo + iu];
          v = ids[2 * lo + iv];
          val = vals[s];
        }
        // The eligibility word over substreams 64c..64c+63: the prefix below the passing
        // count, or, unsorted, one compare of the weight a substream.
        if (sorted) {
          const int nb = min(max(static_cast<int>(val) - kChunkBits * c, 0), kChunkBits);
          te = nb == kChunkBits ? ~0ull : (1ull << nb) - 1ull;
        } else if (u != v) {
          te = compare_lanes(sm.thr + kChunkBits * c, min(kChunkBits, lanes - kChunkBits * c),
                             __uint_as_float(val));
        }
      }
      // Both rows' words are loaded before either is stored.
      unsigned long long a = 0, b = 0;
      if (te) {
        a = __ldcg(word_of(u));
        b = __ldcg(word_of(v));
      }
      const unsigned long long add = te & ~(a | b);
      if (add) {
        __stcg(word_of(u), a | add);
        __stcg(word_of(v), b | add);
      }
      int best = add ? kChunkBits * c + 63 - __clzll(static_cast<long long>(add)) : -1;
      for (int o = G >> 1; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o));
      if (c == 0 && r < n) assigned[s] = best;
    }
    if (stager >= 0) cp_async_wait<kWait>();  // every copy group but the last kWait has landed
    __syncthreads();                          // ... and this wave's row stores are seen by the next
    pipe = (pipe >> 1) | (stage_ahead ? 1u << (kAhead - 1) : 0u);
    lo = hi;
    hi = hi_next;
  }
}

// Count the passing thresholds of every slot, then walk; the unpacked layout packs its block
// into the working copy `work` before the walk and unpacks it after. All on `stream`. Returns
// the first CUDA error (0 on success). `width` is the row's bytes; a width the layout does not
// take, or a block that is not aligned to its loads, is refused with cudaErrorInvalidValue.
template <bool kMega, bool kPacked>
int launch(const void* seg_offsets, int num_waves, int seg, int bslots, const void* ids,
           const void* weights, const void* thr, void* mb, void* work, void* counts,
           void* assigned, long long total, long long rows, int width, void* stream) {
  const int lanes = kPacked ? 8 * width : width;
  const bool layout_ok = kPacked ? width % 8 == 0 && reinterpret_cast<uintptr_t>(mb) % 8 == 0
                                 : width % 16 == 0 && reinterpret_cast<uintptr_t>(mb) % 16 == 0;
  if (width <= 0 || !layout_ok || lanes > kMaxBits || bslots <= 0 || seg <= 0 || rows < 0 ||
      total < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (lanes + kChunkBits - 1) / kChunkBits;
  int lg = 0;
  while ((1 << lg) < chunks) ++lg;
  auto grid_for = [](long long n) {
    return static_cast<int>(n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  };
  const long long words = rows * chunks;
  auto* block = static_cast<uint8_t*>(mb);
  auto* copy = static_cast<unsigned long long*>(kPacked ? mb : work);
  auto* cnt = static_cast<int32_t*>(counts);
  count_passing<kMega><<<grid_for(total), 256, 0, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(weights),
      static_cast<const float*>(thr), cnt, total, bslots, lanes);
  if constexpr (!kPacked)
    pack_block<<<grid_for(words), 256, 0, s>>>(block, copy, words, width, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto body = substream_match_walk<kMega>;
  err = cudaFuncSetAttribute(body, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  body<<<1, kThreads, sizeof(Smem), s>>>(
      static_cast<const int32_t*>(seg_offsets), num_waves, seg, bslots,
      static_cast<const int32_t*>(ids), static_cast<const float*>(weights), cnt,
      static_cast<const float*>(thr), copy, static_cast<int32_t*>(assigned), lanes, lg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (!kPacked)
    unpack_block<<<grid_for(words), 256, 0, s>>>(copy, block, words, width, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry: `mb` [rows, width] (updated in place), `counts` int32 [total] scratch,
// `assigned` [total] filled with -1. Packed, `mb` is uint8 bit planes; unpacked, int8 of 0/1,
// and `work` uint64 [rows, ceil(width / 64)] scratch.
extern "C" int substream_match_mega(const void* seg_offsets, int num_waves, int seg, int bslots,
                                    const void* uv, const void* weights, const void* thr,
                                    void* mb, void* counts, void* assigned, long long total,
                                    long long rows, int width, void* stream) {
  return launch<true, true>(seg_offsets, num_waves, seg, bslots, uv, weights, thr, mb, nullptr,
                            counts, assigned, total, rows, width, stream);
}

extern "C" int substream_match_waves(const void* seg_offsets, int num_waves, int seg,
                                     const void* edges, const void* weights, const void* thr,
                                     void* mb, void* counts, void* assigned, long long total,
                                     long long rows, int width, void* stream) {
  return launch<false, true>(seg_offsets, num_waves, seg, 1, edges, weights, thr, mb, nullptr,
                             counts, assigned, total, rows, width, stream);
}

extern "C" int substream_match_mega_unpacked(const void* seg_offsets, int num_waves, int seg,
                                             int bslots, const void* uv, const void* weights,
                                             const void* thr, void* mb, void* work, void* counts,
                                             void* assigned, long long total, long long rows,
                                             int width, void* stream) {
  return launch<true, false>(seg_offsets, num_waves, seg, bslots, uv, weights, thr, mb, work,
                             counts, assigned, total, rows, width, stream);
}

extern "C" int substream_match_waves_unpacked(const void* seg_offsets, int num_waves, int seg,
                                              const void* edges, const void* weights,
                                              const void* thr, void* mb, void* work,
                                              void* counts, void* assigned, long long total,
                                              long long rows, int width, void* stream) {
  return launch<false, false>(seg_offsets, num_waves, seg, 1, edges, weights, thr, mb, work,
                              counts, assigned, total, rows, width, stream);
}
