// Join probe: the lower bound of every probe row's key in the sorted build
// side, and its match count; and the direct-address probe (`direct_probe`,
// at the end of the file), which gives the same two outputs from two tables
// over a narrow integer key's range.
//
// A kernel of the port alone: no Pallas kernel is replaced.  The reference
// searches in a jitted loop (spark_rapids_tpu/kernels/join.py:41, `_bsearch`
// under `lax.fori_loop`), as does the port's plain version (kernels/join.py
// `_bsearch`, a torch loop of about 23 steps per bound).  Here it is one
// launch for both bounds of a whole batch.
//
// Keys are k 64-bit words per row (int64 bit patterns), compared as
// unsigned words in lexicographic order, as kernels/canon.words_less
// compares them.  Outputs, per probe row:
//   lo[i]     = the first build row not less than the probe (also for dead
//               or null rows);
//   counts[i] = the build rows equal to the probe if the row is live and
//               every rank word (bit j of rank_mask: word j is a key's rank
//               word) is 1, that is every key is non-null; else 0.
// Both bounds are unique, so they equal the plain version's bit for bit.
//
// What bounds it on the H100: the latency of dependent loads.  Each step
// of a search reads a build row at an address that the step before chose;
// a plain search makes about 2 log2(build_n) of them per probe row, from
// L2 or HBM.  The byte bound (each probe and build word read once, lo and
// counts written once) is far below that, except for small builds, where
// reading the probe words and writing the outputs is the work.  The design
// (kernels/cuda_ops.probe_index builds the index once per BuildTable):
// 1. The build's sorted words are stored row-major, int64[build_n, kp] with
//    kp = k rounded up to even (16-byte rows): a comparison reads one row's
//    contiguous words, 16 bytes at a time, and stops at the first word that
//    differs, so it touches one 32-byte sector for most rows.
// 2. A separator table, the rows at every `stride`-th position, fits the
//    shared memory of one block (stride the least power of two that fits).
//    A persistent grid (blocks per SM as the occupancy allows) loads it once
//    per block with cp.async and walks over the probe rows.  The lower
//    bound's first log2(build_n / stride) levels search shared memory; the
//    last log2(stride) levels search the window ((J-1) stride, J stride] of
//    rows in global memory.  A build that fits whole has stride 1 and never
//    leaves shared memory.  The upper bound gallops from the lower one
//    (lo+1, lo+2, lo+4, ...) and bisects the last doubling: about
//    log2(count) + 2 loads (from shared memory when stride is 1), and none
//    for a row without a match, since the lower bound's last comparison
//    says whether the row at lo is equal.
// 3. The kernel is specialised on the padded word count K in {2, 4, 6, 8}
//    (one to four non-string keys, each a rank and a value word), which
//    keeps the probe's words in registers; a generic instance takes up to
//    JP_MAX_WORDS words and reads the probe's words where a comparison
//    reaches them.
#include <cuda_runtime.h>

#define JP_MAX_WORDS 32
#define JP_MAX_THREADS 1024

typedef unsigned long long u64;

struct WordPtrs {
  const u64* p[JP_MAX_WORDS];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <bool GLOBAL>
__device__ __forceinline__ ulonglong2 load_pair(const u64* p) {
  if (GLOBAL) return __ldg((const ulonglong2*)p);
  return *(const ulonglong2*)p;
}

__device__ __forceinline__ int sign_of(u64 x, u64 y) { return x < y ? -1 : 1; }

// Sign of the row at r (kp words) minus the probe.  K > 0: the probe's K
// words are q (words past k are 0 in both); K == 0: k words, the probe's
// word w read from probe.p[w][i].
template <int K, bool GLOBAL>
__device__ __forceinline__ int cmp_row(const u64* r, const u64* q,
                                       const WordPtrs& probe, long long i,
                                       int k) {
  if constexpr (K > 0) {
#pragma unroll
    for (int w = 0; w < K; w += 2) {
      const ulonglong2 v = load_pair<GLOBAL>(r + w);
      if (v.x != q[w]) return sign_of(v.x, q[w]);
      if (v.y != q[w + 1]) return sign_of(v.y, q[w + 1]);
    }
  } else {
    // unrolled, so that probe.p[w] is a constant offset into the parameters
#pragma unroll
    for (int w = 0; w < JP_MAX_WORDS; ++w) {
      if (w >= k) break;
      const u64 x = GLOBAL ? __ldg(r + w) : r[w];
      const u64 y = __ldg(probe.p[w] + i);
      if (x != y) return sign_of(x, y);
    }
  }
  return 0;
}

// The rows equal to the probe from lo on, the row at lo being one: gallop
// (lo+1, lo+2, lo+4, ...), then bisect the last doubling.
template <int K, bool GLOBAL>
__device__ __forceinline__ long long count_equal(const u64* rows, int kp,
                                                 int lo, int build_n,
                                                 const u64* q,
                                                 const WordPtrs& probe,
                                                 long long i, int k) {
  long long step = 1;
  while (lo + step < build_n &&
         cmp_row<K, GLOBAL>(rows + (size_t)(lo + step) * kp, q, probe, i,
                            k) == 0)
    step <<= 1;
  long long ulo = lo + (step >> 1) + 1;
  long long uhi = lo + step < build_n ? lo + step : build_n;
  while (ulo < uhi) {
    const long long m = (ulo + uhi) >> 1;
    if (cmp_row<K, GLOBAL>(rows + (size_t)m * kp, q, probe, i, k) == 0)
      ulo = m + 1;
    else
      uhi = m;
  }
  return ulo - lo;
}

// rows: int64[build_n, kp] sorted; seps: int64[nsep, kp], rows[j << log_stride]
template <int K>
__global__ void __launch_bounds__(JP_MAX_THREADS)
join_probe_kernel(const u64* __restrict__ rows, const u64* __restrict__ seps,
                  int kp, int build_n, int nsep, int log_stride,
                  WordPtrs probe, int k, const unsigned char* __restrict__ live,
                  int n, unsigned rank_mask, long long* __restrict__ lo_out,
                  long long* __restrict__ counts_out) {
  extern __shared__ __align__(16) u64 sep[];
  if constexpr (K > 0) kp = K;  // a constant row stride in the instance
  const int chunks = nsep * kp / 2;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(sep + 2 * c, seps + 2 * c);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    u64 q[K > 0 ? K : 1];
    bool usable = live[i] != 0;
    if constexpr (K > 0) {
#pragma unroll
      for (int w = 0; w < K; ++w) {
        q[w] = w < k ? __ldg(probe.p[w] + i) : 0ull;
        if ((rank_mask >> w) & 1u) usable = usable && q[w] == 1ull;
      }
    } else {
#pragma unroll
      for (int w = 0; w < JP_MAX_WORDS; ++w) {
        if (w >= k) break;
        if ((rank_mask >> w) & 1u)
          usable = usable && __ldg(probe.p[w] + i) == 1ull;
      }
    }
    // the lower bound among the separators: J, the first not less than the
    // probe; `eq` says whether the row at the bound found so far equals it
    int a = 0, b = nsep;
    bool eq = false;
    while (a < b) {
      const int m = (a + b) >> 1;
      const int c = cmp_row<K, false>(sep + (size_t)m * kp, q, probe, i, k);
      if (c < 0) {
        a = m + 1;
      } else {
        b = m;
        eq = c == 0;
      }
    }
    // the full lower bound lies in ((J-1) stride, J stride], within build_n
    int lo = a == 0 ? 0 : ((a - 1) << log_stride) + 1;
    int hi = a < nsep ? a << log_stride : build_n;
    while (lo < hi) {
      const int m = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      const int c = cmp_row<K, true>(rows + (size_t)m * kp, q, probe, i, k);
      if (c < 0) {
        lo = m + 1;
      } else {
        hi = m;
        eq = c == 0;
      }
    }
    long long count = 0;
    if (usable && eq)   // a build whole in shared memory gallops there
      count = log_stride == 0
                  ? count_equal<K, false>(sep, kp, lo, build_n, q, probe, i, k)
                  : count_equal<K, true>(rows, kp, lo, build_n, q, probe, i,
                                         k);
    lo_out[i] = lo;
    counts_out[i] = count;
  }
}

template <int K>
static int launch(const u64* rows, const u64* seps, int kp, int build_n,
                  int nsep, int log_stride, const WordPtrs& probe, int k,
                  const unsigned char* live, int n, unsigned rank_mask,
                  long long* lo, long long* counts, int threads,
                  cudaStream_t s) {
  static int sms = 0, cached_smem = -1, cached_threads = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const cudaError_t err = cudaFuncSetAttribute(
        join_probe_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin);
    if (err != cudaSuccess) return (int)err;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int smem = nsep * kp * 8;
  if (smem != cached_smem || threads != cached_threads) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, join_probe_kernel<K>, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_smem = smem;
    cached_threads = threads;
  }
  long long grid = (long long)per_sm * sms;
  const long long need = ((long long)n + threads - 1) / threads;
  if (grid > need) grid = need;
  join_probe_kernel<K><<<(unsigned)grid, threads, smem, s>>>(
      rows, seps, kp, build_n, nsep, log_stride, probe, k, live, n,
      rank_mask, lo, counts);
  return (int)cudaGetLastError();
}

// rows: device int64[build_n, kp], the sorted build words row-major, kp = k
// rounded up to even, pad words 0, 16-byte aligned; seps: device
// int64[ceil(build_n / 2^log_stride), kp], every 2^log_stride-th row;
// probe: host array of k device pointers, each to n words; live: device
// bool[n]; lo, counts: device int64[n]; threads: per block, a multiple of
// 32 up to JP_MAX_THREADS.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int join_probe(const void* rows, const void* seps, int k,
                          int build_n, int log_stride,
                          const void* const* probe, const void* live, int n,
                          unsigned rank_mask, void* lo, void* counts,
                          int threads, void* stream) {
  const int kp = k + (k & 1);
  if (k < 1 || k > JP_MAX_WORDS || build_n < 0 || n < 0 || log_stride < 0 ||
      log_stride > 30 || threads < 32 || threads > JP_MAX_THREADS ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int nsep = (int)(((long long)build_n + (1ll << log_stride) - 1) >>
                         log_stride);
  WordPtrs p;
  for (int j = 0; j < JP_MAX_WORDS; ++j)
    p.p[j] = j < k ? (const u64*)probe[j] : nullptr;
  const u64* r = (const u64*)rows;
  const u64* sp = (const u64*)seps;
  const unsigned char* lv = (const unsigned char*)live;
  long long* l = (long long*)lo;
  long long* c = (long long*)counts;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kp) {
    case 2:
      return launch<2>(r, sp, kp, build_n, nsep, log_stride, p, k, lv, n,
                       rank_mask, l, c, threads, s);
    case 4:
      return launch<4>(r, sp, kp, build_n, nsep, log_stride, p, k, lv, n,
                       rank_mask, l, c, threads, s);
    case 6:
      return launch<6>(r, sp, kp, build_n, nsep, log_stride, p, k, lv, n,
                       rank_mask, l, c, threads, s);
    case 8:
      return launch<8>(r, sp, kp, build_n, nsep, log_stride, p, k, lv, n,
                       rank_mask, l, c, threads, s);
    default:
      return launch<0>(r, sp, kp, build_n, nsep, log_stride, p, k, lv, n,
                       rank_mask, l, c, threads, s);
  }
}

// The shared memory one block may take, and one SM's: the separator
// table's budget.
extern "C" int join_probe_smem(int per_sm) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v,
                         per_sm ? cudaDevAttrMaxSharedMemoryPerMultiprocessor
                                : cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return v;
}

// Direct-address probe (`direct_probe`): the lookup of a join whose build
// side has one integer or DATE key of at most 1<<24 distinct values in its
// range (the reference's `TpuHashJoinBase._prepare_direct`,
// spark_rapids_tpu/exec/tpu_join.py:254, looked up at :351-358; no Pallas
// kernel is replaced).  kernels/join.direct_tables makes two int32 tables
// over the range [smin, smax] of the build's valid keys once per build:
//   hist[v - smin] = the valid build rows of key v,
//   excl[v - smin] = the first of them in the sorted build (nulls sort
//                    first, so nnull + the valid rows of smaller keys).
// Each probe row reads its key as the column stores it (int32 or int64,
// signed) and its validity byte; a row at or past the live count is dead.
// It writes the same lo and counts as `join_probe` over the same build:
//   valid, smin <= v <= smax: counts = hist[v - smin], lo = excl[v - smin];
//   valid, v < smin:          counts = 0, lo = nnull;
//   valid, v > smax, or dead: counts = 0, lo = nnull + nvalid;
//   null:                     counts = 0, lo = 0.
// What bounds it: the stream.  A dimension's tables (2 x 4 B x the range)
// sit in L2 (date_dim's 2 x 1,825 x 4 B), so each row is its key (4 or 8
// B) and one validity byte read and 16 bytes written.  A grid-stride loop,
// coalesced; the live count is read once per thread.
template <typename K>
__global__ void __launch_bounds__(JP_MAX_THREADS)
direct_probe_kernel(const K* __restrict__ keys,
                    const unsigned char* __restrict__ valid,
                    const long long* __restrict__ rows_dev,
                    long long rows_host, long long n, long long smin,
                    long long smax, const int* __restrict__ hist,
                    const int* __restrict__ excl, long long nnull,
                    long long nvalid, long long* __restrict__ lo,
                    long long* __restrict__ counts) {
  const long long live = rows_dev != nullptr ? __ldg(rows_dev) : rows_host;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    long long c = 0, l = nnull + nvalid;
    if (i < live) {
      const long long v = (long long)__ldg(keys + i);
      if (!__ldg(valid + i)) {
        l = 0;
      } else if (v < smin) {
        l = nnull;
      } else if (v <= smax) {
        const unsigned idx = (unsigned)(v - smin);
        c = __ldg(hist + idx);
        l = __ldg(excl + idx);
      }
    }
    lo[i] = l;
    counts[i] = c;
  }
}

// One launch on `stream`; returns a cudaError_t.  `key_bytes` is 4 (int32)
// or 8 (int64); the live count is `*rows_dev` when that is not null, else
// `rows_host`.  `slots` is the tables' length, which must exceed
// smax - smin.
extern "C" int direct_probe(const void* keys, int key_bytes,
                            const void* valid, const void* rows_dev,
                            long long rows_host, long long n, long long smin,
                            long long smax, const void* hist,
                            const void* excl, long long slots,
                            long long nnull, long long nvalid, void* lo,
                            void* counts, int threads, cudaStream_t stream) {
  if (threads < 32 || threads > JP_MAX_THREADS || threads % 32 != 0 ||
      (key_bytes != 4 && key_bytes != 8) || smax < smin ||
      (u64)smax - (u64)smin >= (u64)slots || slots > (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + threads - 1) / threads;
  const long long most = (long long)sms * (2048 / threads) * 4;
  if (blocks > most) blocks = most;
  const unsigned char* v = (const unsigned char*)valid;
  const long long* r = (const long long*)rows_dev;
  if (key_bytes == 4)
    direct_probe_kernel<int><<<(unsigned)blocks, threads, 0, stream>>>(
        (const int*)keys, v, r, rows_host, n, smin, smax, (const int*)hist,
        (const int*)excl, nnull, nvalid, (long long*)lo, (long long*)counts);
  else
    direct_probe_kernel<long long><<<(unsigned)blocks, threads, 0, stream>>>(
        (const long long*)keys, v, r, rows_host, n, smin, smax,
        (const int*)hist, (const int*)excl, nnull, nvalid, (long long*)lo,
        (long long*)counts);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
