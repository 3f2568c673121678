// Join probe: the lower and upper bound of every probe row's key in the
// sorted build side, and its match count.
//
// A kernel of the port alone: the JAX package has no Pallas kernel here.
// It runs the same binary search as the reference's jitted probe
// (spark_rapids_tpu/kernels/join.py, `_bsearch` under `lax.fori_loop`)
// and as the port's plain version (kernels/join.py `_bsearch`, a torch
// loop of about 23 steps x (8 ops per key word + 8) launches per bound).
// Here it is one launch for both bounds of a whole batch.
//
// Keys are k 64-bit words per row (int64 bit patterns), compared as
// unsigned words in lexicographic order, as kernels/canon.words_less
// compares them.  One thread per probe row holds the row's words in
// registers, finds the lower bound (the first build row not less than the
// probe) over [0, build_n), then the upper bound (the first build row
// greater than the probe) over [lower, build_n).  Both bounds are unique,
// so they equal the plain version's bit for bit.  Outputs, per probe row:
//   lo[i]     = the lower bound (also for dead or null rows)
//   counts[i] = upper - lower if the row is live and every rank word
//               (bit j of rank_mask: word j is a key's rank word) is 1,
//               that is every key is non-null; else 0.
//
// What bounds it on the H100: the latency of dependent loads.  Each step
// of a search reads one build row at an address that the previous step
// chose, so a warp's 32 threads read 32 scattered rows per step, about
// 2 log2(build_n) steps per row.  The byte bound (each probe word and
// build word read once, lo and counts written once) is far below that; a
// later design may stage the build's top levels in shared memory.
#include <cuda_runtime.h>

#define JP_MAX_WORDS 32
#define JP_THREADS 256

struct WordPtrs {
  const unsigned long long* p[JP_MAX_WORDS];
};

// sign of build row j minus the probe's words q (first k words)
__device__ __forceinline__ int cmp_build(const WordPtrs& b, long long j,
                                         const unsigned long long* q,
                                         int k) {
  // unrolled so that q[w] stays in registers and b.p[w] is a constant
  // offset into the launch parameters
#pragma unroll
  for (int w = 0; w < JP_MAX_WORDS; ++w) {
    if (w >= k) break;
    const unsigned long long x = __ldg(b.p[w] + j);
    if (x != q[w]) return x < q[w] ? -1 : 1;
  }
  return 0;
}

__global__ void __launch_bounds__(JP_THREADS)
join_probe_kernel(WordPtrs build, WordPtrs probe, int k, long long build_n,
                  const unsigned char* __restrict__ live, long long n,
                  unsigned rank_mask, long long* __restrict__ lo_out,
                  long long* __restrict__ counts_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long q[JP_MAX_WORDS];
  bool usable = live[i] != 0;
#pragma unroll
  for (int w = 0; w < JP_MAX_WORDS; ++w) {
    if (w >= k) break;
    q[w] = __ldg(probe.p[w] + i);
    if ((rank_mask >> w) & 1u) usable = usable && q[w] == 1ull;
  }
  long long lo = 0, hi = build_n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (cmp_build(build, mid, q, k) < 0) lo = mid + 1;
    else hi = mid;
  }
  long long count = 0;
  if (usable) {
    long long ulo = lo, uhi = build_n;
    while (ulo < uhi) {
      const long long mid = (ulo + uhi) >> 1;
      if (cmp_build(build, mid, q, k) <= 0) ulo = mid + 1;
      else uhi = mid;
    }
    count = ulo - lo;
  }
  lo_out[i] = lo;
  counts_out[i] = count;
}

static WordPtrs word_ptrs(const void* const* words, int k) {
  WordPtrs w;
  for (int j = 0; j < JP_MAX_WORDS; ++j)
    w.p[j] = j < k ? (const unsigned long long*)words[j] : nullptr;
  return w;
}

// build: host array of k device pointers, each to build_n sorted words;
// probe: k device pointers, each to n words; live: device bool[n];
// lo, counts: device int64[n].  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int join_probe(const void* const* build, const void* const* probe,
                          int k, long long build_n, const void* live,
                          long long n, unsigned rank_mask, void* lo,
                          void* counts, void* stream) {
  if (k < 1 || k > JP_MAX_WORDS || build_n < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + JP_THREADS - 1) / JP_THREADS;
  join_probe_kernel<<<(unsigned)blocks, JP_THREADS, 0,
                      (cudaStream_t)stream>>>(
      word_ptrs(build, k), word_ptrs(probe, k), k, build_n,
      (const unsigned char*)live, n, rank_mask, (long long*)lo,
      (long long*)counts);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
