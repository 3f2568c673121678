// Hash partitioning: partition ids, and the split of a batch by them.
//
// Replaces the TPU kernel `_make_kernel` / `hash_partition_ids` in
// spark_rapids_tpu/kernels/pallas_ops.py (pallas_call at :54 and :60).
// Same function, bit for bit: h = 42; for each key word w:
//   x = h ^ w; x ^= x >> 33; x *= M1; x ^= x >> 33; x *= M2; x ^= x >> 33
// id = int32(h % parts), with unsigned 64-bit arithmetic.
//
// Two entry points:
// - hash_partition_ids: the ids alone, one thread per row (the TPU kernel's
//   function).  The modulo is a Barrett reduction with the host-computed
//   magic M = floor((2^64 - 1) / parts): q = umulhi(h, M) is floor(h /
//   parts) or one less, so r = h - q * parts needs at most one correction.
//   Bit-equal to the 64-bit `%` for every parts < 2^31, which the GPU runs
//   as a software division routine.
// - hash_split: the split of a batch by partition id, as the exchange
//   needs it: the permutation that a stable sort of the ids would give
//   (dead rows, the live mask false, go last as partition `parts`) and
//   the row count of each partition.  A counting sort in three launches:
//     1. ids (Barrett modulo) of every row, stored as u16, plus each tile's
//        histogram, counted in shared memory with warp-aggregated atomics
//        (__match_any_sync: one atomic per distinct id in a warp);
//     2. one block scans the [parts + 1, tiles] histogram (partition-major,
//        exclusive): each (partition, tile) gets its first output row, and
//        each partition its count;
//     3. each tile's warps walk contiguous slices of the tile in row order;
//        a warp counts its slice per partition, the block turns the counts
//        into per-warp offsets, and each row's rank among the equal ids of
//        earlier lanes comes from a match ballot and a popcount.  Rows land
//        in the stable order, with no sort.
//   It takes at most HS_MAX_PARTS = 4096 partitions (u16 ids; the scatter
//   pass keeps 8 x 4097 int32 counters, 131 KB of shared memory).
//
// What bounds it on the H100: bytes.  The ids read 8 B per key word and
// write 4 B per row.  The split reads 8 B per word + 1 B live mask and
// writes 2 B of id in pass 1, reads the 2 B id twice and writes 8 B of
// permutation in pass 3: 21 B per row for one key word, against the 17 B
// (words + mask in, permutation out) a single pass would move.  The
// histogram and scan are tiles x (parts + 1) int32, small beside the rows
// for the partition counts an exchange uses.
#include <cuda_runtime.h>

#define HP_MAX_WORDS 16
#define HS_MAX_PARTS 4096
#define HS_THREADS 256
#define HS_WARPS (HS_THREADS / 32)
#define HS_SCAN_THREADS 1024

struct WordPtrs {
  const unsigned long long* p[HP_MAX_WORDS];
};

__device__ __forceinline__ unsigned long long hash_row(const WordPtrs& w,
                                                       int num_words,
                                                       long long i) {
  const unsigned long long M1 = 0xff51afd7ed558ccdull;
  const unsigned long long M2 = 0xc4ceb9fe1a85ec53ull;
  unsigned long long h = 42ull;
  // unrolled so that every w.p[k] is a constant offset into the launch
  // parameters (a runtime index would copy them to local memory)
#pragma unroll
  for (int k = 0; k < HP_MAX_WORDS; ++k) {
    if (k >= num_words) break;
    unsigned long long x = h ^ __ldg(w.p[k] + i);
    x ^= x >> 33;
    x *= M1;
    x ^= x >> 33;
    x *= M2;
    x ^= x >> 33;
    h = x;
  }
  return h;
}

// h % parts by Barrett reduction, magic = floor((2^64 - 1) / parts)
__device__ __forceinline__ unsigned fast_mod(unsigned long long h,
                                             unsigned long long parts,
                                             unsigned long long magic) {
  unsigned long long r = h - __umul64hi(h, magic) * parts;
  if (r >= parts) r -= parts;
  return (unsigned)r;
}

__global__ void hash_partition_kernel(WordPtrs words, int num_words, int n,
                                      unsigned long long num_parts,
                                      unsigned long long magic,
                                      int* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned long long h = hash_row(words, num_words, i);
    out[i] = (int)fast_mod(h, num_parts, magic);
  }
}

// -- split ------------------------------------------------------------------

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// pass 1: ids + the tile's histogram, written to hist[p * tiles + tile]
__global__ void __launch_bounds__(HS_THREADS)
split_hist_kernel(WordPtrs words, int num_words,
                  const unsigned char* __restrict__ live, int n, int parts,
                  unsigned long long magic, int tile,
                  unsigned short* __restrict__ pid, int* __restrict__ hist) {
  extern __shared__ int cnt[];
  for (int p = threadIdx.x; p <= parts; p += blockDim.x) cnt[p] = 0;
  __syncthreads();
  const int t0 = blockIdx.x * tile;
  const int t1 = min(n, t0 + tile);
  const unsigned lane = threadIdx.x & 31;
  for (int base = t0; base < t1; base += blockDim.x) {
    const int i = base + threadIdx.x;
    unsigned id = 0xFFFFFFFFu;
    if (i < t1) {
      id = live[i] ? fast_mod(hash_row(words, num_words, i),
                              (unsigned long long)parts, magic)
                   : (unsigned)parts;
      pid[i] = (unsigned short)id;
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, id);
    if (i < t1 && lane == (unsigned)(__ffs(peers) - 1))
      atomicAdd(&cnt[id], __popc(peers));
  }
  __syncthreads();
  for (int p = threadIdx.x; p <= parts; p += blockDim.x)
    hist[(long long)p * gridDim.x + blockIdx.x] = cnt[p];
}

// pass 2 (one block): exclusive scan of hist[m] in place, then each
// partition's count, counts[p] = its tiles' total
__global__ void __launch_bounds__(HS_SCAN_THREADS)
split_scan_kernel(int* __restrict__ hist, long long m, int tiles, int parts,
                  long long* __restrict__ counts) {
  __shared__ int warp_sum[HS_SCAN_THREADS / 32];
  __shared__ int total_sh;
  const long long seg = (m + blockDim.x - 1) / blockDim.x;
  const long long lo = min(m, (long long)threadIdx.x * seg);
  const long long hi = min(m, lo + seg);
  int local = 0;
  for (long long k = lo; k < hi; ++k) local += hist[k];
  // block-wide exclusive scan of the per-thread sums
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= (unsigned)d) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < blockDim.x / 32 ? warp_sum[lane] : 0;
    int wincl = ws;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, wincl, d);
      if (lane >= (unsigned)d) wincl += y;
    }
    warp_sum[lane] = wincl - ws;
    if (lane == 31) total_sh = wincl;
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - local;
  for (long long k = lo; k < hi; ++k) {
    const int c = hist[k];
    hist[k] = run;
    run += c;
  }
  __syncthreads();
  for (int p = threadIdx.x; p <= parts; p += blockDim.x) {
    const int end = p == parts ? total_sh : hist[(long long)(p + 1) * tiles];
    counts[p] = end - hist[(long long)p * tiles];
  }
}

// pass 3: stable scatter of each tile's rows to their output positions
__global__ void __launch_bounds__(HS_THREADS)
split_scatter_kernel(const unsigned short* __restrict__ pid, int n, int parts,
                     int tile, const int* __restrict__ offsets,
                     long long* __restrict__ perm) {
  extern __shared__ int wc[];             // [HS_WARPS][parts + 1]
  const int P = parts + 1;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < HS_WARPS * P; k += blockDim.x) wc[k] = 0;
  const int t0 = blockIdx.x * tile;
  const int t1 = min(n, t0 + tile);
  // each warp takes a contiguous slice of the tile, a multiple of 32 rows
  const int per = (((t1 - t0) + HS_WARPS - 1) / HS_WARPS + 31) & ~31;
  const int w0 = min(t1, t0 + (int)warp * per);
  const int w1 = min(t1, w0 + per);
  int* mine = wc + warp * P;
  __syncthreads();
  for (int base = w0; base < w1; base += 32) {
    const int i = base + lane;
    const unsigned id = i < w1 ? pid[i] : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, id);
    if (i < w1 && lane == (unsigned)(__ffs(peers) - 1)) mine[id] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int run = offsets[(long long)p * gridDim.x + blockIdx.x];
    for (int w = 0; w < HS_WARPS; ++w) {
      const int c = wc[w * P + p];
      wc[w * P + p] = run;
      run += c;
    }
  }
  __syncthreads();
  const unsigned lt = lanemask_lt();
  for (int base = w0; base < w1; base += 32) {
    const int i = base + lane;
    const unsigned id = i < w1 ? pid[i] : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, id);
    if (i < w1) perm[mine[id] + __popc(peers & lt)] = i;
    __syncwarp();
    if (i < w1 && lane == (unsigned)(__ffs(peers) - 1)) mine[id] += __popc(peers);
    __syncwarp();
  }
}

static WordPtrs word_ptrs(const void* const* words, int num_words) {
  WordPtrs w;
  for (int k = 0; k < HP_MAX_WORDS; ++k)
    w.p[k] = k < num_words ? (const unsigned long long*)words[k] : nullptr;
  return w;
}

// words: host array of num_words device pointers, each to n 64-bit words.
// out: device int32[n].  magic: floor((2^64 - 1) / num_parts).  Launches
// on `stream`; returns cudaGetLastError().
extern "C" int hash_partition_ids(const void* const* words, int num_words,
                                  int n, int num_parts,
                                  unsigned long long magic, void* out,
                                  void* stream) {
  if (num_words < 1 || num_words > HP_MAX_WORDS || n < 0 || num_parts < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const WordPtrs w = word_ptrs(words, num_words);
  const int threads = 256;
  long long blocks = ((long long)n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  cudaStream_t s = (cudaStream_t)stream;
  hash_partition_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      w, num_words, n, (unsigned long long)num_parts, magic, (int*)out);
  return (int)cudaGetLastError();
}

// live: bool[n]; pid_ws: u16[n] and hist_ws: int32[(parts + 1) * tiles]
// scratch; tiles * tile >= n.  perm: int64[n]; counts: int64[parts + 1]
// (the last is the dead rows).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hash_split(const void* const* words, int num_words,
                          const void* live, int n, int parts,
                          unsigned long long magic, int tiles, int tile,
                          void* pid_ws, void* hist_ws, void* perm,
                          void* counts, void* stream) {
  if (num_words < 1 || num_words > HP_MAX_WORDS || n < 0 || parts < 1 ||
      parts > HS_MAX_PARTS || tiles < 1 || tile < 1 ||
      (long long)tiles * tile < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0)
    return (int)cudaMemsetAsync(counts, 0, sizeof(long long) * (parts + 1),
                                s);
  static bool attr = false;
  const int scatter_smem = HS_WARPS * (parts + 1) * (int)sizeof(int);
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        HS_WARPS * (HS_MAX_PARTS + 1) * (int)sizeof(int));
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const WordPtrs w = word_ptrs(words, num_words);
  split_hist_kernel<<<tiles, HS_THREADS, (parts + 1) * sizeof(int), s>>>(
      w, num_words, (const unsigned char*)live, n, parts, magic, tile,
      (unsigned short*)pid_ws, (int*)hist_ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_scan_kernel<<<1, HS_SCAN_THREADS, 0, s>>>(
      (int*)hist_ws, (long long)(parts + 1) * tiles, tiles, parts,
      (long long*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_scatter_kernel<<<tiles, HS_THREADS, scatter_smem, s>>>(
      (const unsigned short*)pid_ws, n, parts, tile, (const int*)hist_ws,
      (long long*)perm);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
