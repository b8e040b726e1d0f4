// Latency probe for one CTA on the card: what a block barrier, a dependent round trip to the
// L2 and a shared-memory acquire/release hand-off cost, in SM cycles per step. These are the
// pieces of one wave of the four wave kernels
// (src/repro_torch/kernels/substream_match/csrc/substream_match_waves.cu).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/latency_probe scripts/latency_probe.cu
//   build/latency_probe
//
// One block of 64, 512 or 1024 threads runs N steps of each mode; thread 0 reads clock64()
// around the loop. Modes: a bare __syncthreads(); thread 0 loading with ld.global.cg the word
// it stored the step before (a dependent L2 round trip), with and without the barrier, or a
// different thread each step; every thread storing a word, then the barrier; two threads
// handing a flag back and forth with ld.acquire / st.release in shared memory (two hand-offs a
// step); the L2 chain with plain (L1-cached) loads and stores; the L2 chain two steps deep; a
// shared-memory chain; an L2 load without a store.
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
constexpr int N = 20000;
__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// mode 0: barrier only; 1: thread0 L2 load->store chain + barrier; 2: chain without barrier (thread 0 only)
// 3: chain with loads of the slot in a different thread than the store (thread k%32 of warp 0)
// 4: barrier + STG by all threads (no loads); 5: acquire/release ping through smem between warp 0 and warp 1 (no barrier)
// 6: chain + barrier, loads/stores plain (not cg) ; 7: chain via __ldcg/__stcg but load of a word stored 2 iterations ago
__global__ void k(unsigned long long* g, long long* out, int mode) {
  __shared__ int flag[2];
  __shared__ unsigned long long sm[64];
  if (threadIdx.x < 2) flag[threadIdx.x] = -1;
  __syncthreads();
  long long t0 = clock64();
  unsigned long long x = 0;
  for (int i = 0; i < N; ++i) {
    if (mode == 0) { __syncthreads(); }
    else if (mode == 1) { if (threadIdx.x == 0) { x = __ldcg(g + (i & 63)); __stcg(g + ((i + 1) & 63), x + 1); } __syncthreads(); }
    else if (mode == 2) { if (threadIdx.x == 0) { x = __ldcg(g + (i & 63)); __stcg(g + ((i + 1) & 63), x + 1); } }
    else if (mode == 3) { if (threadIdx.x == (i & 31)) { x = __ldcg(g + (i & 63)); __stcg(g + ((i + 1) & 63), x + 1); } __syncthreads(); }
    else if (mode == 4) { __stcg(g + 64 + threadIdx.x, (unsigned long long)i); __syncthreads(); }
    else if (mode == 5) {
      if (threadIdx.x == 0) { int v; do { asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(sa(&flag[1])) : "memory"); } while (v < i - 1);
                              asm volatile("st.release.cta.shared.b32 [%0], %1;" :: "r"(sa(&flag[0])), "r"(i) : "memory"); }
      if (threadIdx.x == 32) { int v; do { asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(v) : "r"(sa(&flag[0])) : "memory"); } while (v < i);
                              asm volatile("st.release.cta.shared.b32 [%0], %1;" :: "r"(sa(&flag[1])), "r"(i) : "memory"); }
    }
    else if (mode == 6) { if (threadIdx.x == 0) { x = g[i & 63]; g[(i + 1) & 63] = x + 1; } __syncthreads(); }
    else if (mode == 7) { if (threadIdx.x == 0) { x = __ldcg(g + (i & 63)); __stcg(g + ((i + 2) & 63), x + 1); } __syncthreads(); }
    else if (mode == 8) { if (threadIdx.x == 0) { x = sm[i & 63]; sm[(i + 1) & 63] = x + 1; } __syncthreads(); }
    else if (mode == 9) { if (threadIdx.x == 0) { x = __ldcg(g + 128 + (i & 63) * 16); } __syncthreads(); if (x == 12345) g[0] = 1; }
  }
  long long t1 = clock64();
  if (threadIdx.x == 0) { out[0] = t1 - t0; g[200] += x; }
}
int main() {
  unsigned long long* g; long long* out; cudaMalloc(&g, 1 << 20); cudaMalloc(&out, 8); cudaMemset(g, 0, 1 << 20);
  const char* names[] = {"barrier", "L2 chain+barrier", "L2 chain alone", "L2 chain other thread+barrier", "STG all+barrier",
                         "smem acquire/release ping", "plain ld/st chain+barrier", "L2 chain dist2+barrier", "smem chain+barrier", "L2 load (no store)+barrier"};
  int threads[] = {64, 512, 1024};
  for (int ti = 0; ti < 3; ++ti)
    for (int mode = 0; mode < 10; ++mode) {
      k<<<1, threads[ti]>>>(g, out, mode); cudaDeviceSynchronize();
      cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
      cudaEventRecord(a); k<<<1, threads[ti]>>>(g, out, mode); cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b); long long cyc; cudaMemcpy(&cyc, out, 8, cudaMemcpyDeviceToHost);
      printf("threads %4d  %-34s %8.1f cycles/iter  %7.3f us/iter  (%s)\n", threads[ti], names[mode], (double)cyc / N, ms * 1e3 / N, cudaGetErrorString(cudaGetLastError()));
    }
  return 0;
}
