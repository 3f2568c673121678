// Table stage: the whole reduce stage of the group-by table core, one launch
// per batch.
//
// Replaces the TPU kernels `_table_reduce_kernel` / `_table_reduce_tpu_32`
// in spark_rapids_tpu/kernels/pallas_ops.py (pallas_call at :206; entry
// point `table_reduce`) together with the XLA segment ops that sit beside
// them in spark_rapids_tpu/exec/tpu_aggregate.py (the chunk-lane
// segment_sum and the two-stage u32 segment_max).  The TPU kernel reduced
// f32 rows that the caller had built in device memory; on Hopper the
// building costs more than the reduce, so this kernel reads each
// aggregate's raw input column (and its validity) and computes every
// per-bucket table the finish of the table core reads, in registers.
//
// Rows are reduced into `table` buckets by an int32 bucket id; an id outside
// [0, table) (the dead slot `table`) is dropped.  A "piece" is one input
// column with one row kind; each kind has fixed sub-rows (the per-bucket
// tables it writes):
//   COUNT   [u32 count of valid rows]              (no column: count rows)
//   ICOUNT  [i64 sum]                              (the final count merge)
//   FSUM64  [u32 cnt, nan, +inf, -inf, 15 x i32 chunk lanes]
//             each finite f64 splits into f32 hi + f32 lo; each component
//             into signed 8-bit chunks on a 120-bit window anchored at the
//             batch's largest exponent `emax`, a device scalar the kernel
//             reads (the arithmetic of kernels/aggregate.part_chunk_lanes)
//   FMAX64  [u32 cnt, non-NaN cnt, u64 max of flip32(hi) << 32 | flip32(lo)]
//             (-0.0 -> 0.0; equals the two-stage u32 max bit for bit)
//   FSUMV   [u32 cnt, f64 sum]                     (variable float mode)
//   FMAX    [u32 cnt, non-NaN cnt, u32 max of flip32(f32(v))]
//   SUM32, SUM64, MAX32: the TPU kernel's own raw f32/f64 sum rows and f32
//             max rows (canonical NaN wins, as XLA's max).  Their column is
//             a [k, n] matrix and each of its k rows is one sub-row, so k
//             raw rows are one piece: they share one group, and one read
//             of the bucket, while their tables fit the budget.  A launch
//             takes raw pieces only or none (the kernel's RAW instance),
//             so the stage's row loop carries no raw-row code.
// Every table starts at zero bits: zero is the identity of every add, and
// of every ordered max word (an empty bucket's max word is 0).  The
// wrapper decodes the f32 max words.
//
// What bounds it on the H100: bytes.  The exact partial aggregate of the
// headline query reads, per row, 4 B bucket + 8 B z + 8 B x + 1 B per
// validity mask = 22 B (23 B with the live mask the bucket already
// carries), so 4194304 rows are ~92-96 MB: ~0.029 ms at 3.35 TB/s.  The
// tables are small (table x 96 B) and stay in shared memory.
//
// Design:
// - Each block keeps a private copy of its tables in shared memory and
//   reduces its rows into it with shared-memory atomics; at the end it
//   flushes the non-zero slots with global atomics into tables zeroed by
//   one cudaMemsetAsync (no init kernel).  Integer atomics and the u64 max
//   do not depend on order, so exact mode is byte-identical run to run.
// - Budget: the headline exact partial needs 7 count/flag rows x 4 B +
//   15 lanes x 4 B + 1 u64 x 8 B = 96 B per bucket, 393,216 B at table
//   4096: more than the 232,448 B one block may hold.  The wrapper packs
//   the sub-rows into groups that each fit (two groups of 48 B per
//   bucket there, ~196 KB each) and the groups run along gridDim.y.  A
//   group reads only the columns of its sub-rows: the exact partial reads
//   bucket + z + z's mask in one group and bucket + z + x + both masks in
//   the other, 35 B per row, so the y-split re-reads ~13 B per row
//   (bound with re-reads ~0.044 ms).  Tables wider than one group also
//   split their bucket range along gridDim.y.
// - Bytes in flight: each thread takes 4 consecutive rows per iteration
//   with 16-byte vector loads (bucket int4, values 2 x 16 B, masks 4 B)
//   and issues every load of the iteration before its atomics; a raw piece
//   loads TS_RAW_BATCH of its rows at a time the same way.  Where the
//   tables leave room for two blocks per SM (the raw rows of the headline
//   query: 7 x 4096 x 4 B), the launch takes the 1-row instance instead,
//   whose registers allow both (launch_by_occupancy).
// - A max only issues its atomic when the value beats the slot's current
//   word, so the common case is one shared load.
#include <cuda_runtime.h>

#define TS_MAX_PIECES 48
#define TS_MAX_GROUPS 32
#define TS_GROUP_PIECES 4
#define TS_RAW_BATCH 4
#define TS_THREADS 512
// shared bytes left to the kernel's static arrays (the pieces of its group)
#define TS_STATIC_RESERVE 1024
#define CH_LANES 15
#define CH_W0 88

enum {
  K_COUNT = 0, K_ICOUNT, K_FSUM64, K_FMAX64, K_FSUMV, K_FMAX, K_SUM32,
  K_SUM64, K_MAX32
};
enum { OP_ADD32 = 0, OP_ADD64, OP_ADDF32, OP_ADDF64, OP_MAX32, OP_MAX64 };

// One column with one kind, and the sub-rows [lo, hi) of the kind that its
// group reduces.  Global rows: 32-bit sub-row j at out32 row g32 + j; the
// kind's one 64-bit sub-row (always its last) at out64 row g64, and a SUM64
// column's sub-row j at g64 + j.  Shared: sub-row j at byte
// smem + (j - lo) * row_bytes(kind) * stride.
struct Piece {
  const void* data;
  const unsigned char* valid;   // bool[n], or null: every row valid
  const long long* emax;        // FSUM64: device scalar, else null
  int kind, lo, hi, g32, g64, smem;
};
struct Group {
  int first, count, bytes;      // pieces [first, first + count)
};
struct Plan {
  Piece piece[TS_MAX_PIECES];
  Group group[TS_MAX_GROUPS];
  int ngroups;
  int chunk;    // buckets per y-block
  int stride;   // shared slots per sub-row: chunk rounded up to even
};

__device__ __forceinline__ int sub_op(int kind, int j) {
  switch (kind) {
    case K_ICOUNT: return OP_ADD64;
    case K_FMAX64: return j == 2 ? OP_MAX64 : OP_ADD32;
    case K_FSUMV: return j == 1 ? OP_ADDF64 : OP_ADD32;
    case K_FMAX: return j == 2 ? OP_MAX32 : OP_ADD32;
    case K_SUM32: return OP_ADDF32;
    case K_SUM64: return OP_ADDF64;
    case K_MAX32: return OP_MAX32;
    default: return OP_ADD32;   // COUNT, FSUM64
  }
}

__device__ __forceinline__ bool wide_input(int kind) {
  return kind != K_SUM32 && kind != K_MAX32;
}

__host__ __device__ __forceinline__ bool raw_kind(int kind) {
  return kind == K_SUM32 || kind == K_SUM64 || kind == K_MAX32;
}

// shared bytes per slot of each sub-row of a piece (SUM64: all 8; every
// other kind keeps 4-byte sub-rows, with its one 64-bit sub-row last)
__device__ __forceinline__ int row_bytes(int kind) {
  return kind == K_SUM64 ? 8 : 4;
}

// f32 -> u32 whose unsigned order is the float order (canonical NaN above
// +inf, -0.0 below 0.0)
__device__ __forceinline__ unsigned flip32(float f) {
  const unsigned u = __float_as_uint(f);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

struct Slot {
  unsigned char* sh;   // shared byte address of sub-row lo, this bucket's
  int lo, hi, step;    // step: bytes between sub-rows (row_bytes * stride)
  __device__ __forceinline__ bool has(int j) const { return j >= lo && j < hi; }
  template <typename T>
  __device__ __forceinline__ T* at(int j, int slot) const {
    return reinterpret_cast<T*>(sh + (j - lo) * step) + slot;
  }
  __device__ __forceinline__ void add32(int j, int slot, int v) const {
    if (has(j)) atomicAdd(at<int>(j, slot), v);
  }
  __device__ __forceinline__ void add64(int j, int slot,
                                        unsigned long long v) const {
    if (has(j)) atomicAdd(at<unsigned long long>(j, slot), v);
  }
  __device__ __forceinline__ void addf32(int j, int slot, float v) const {
    if (has(j)) atomicAdd(at<float>(j, slot), v);
  }
  __device__ __forceinline__ void addf64(int j, int slot, double v) const {
    if (has(j)) atomicAdd(at<double>(j, slot), v);
  }
  __device__ __forceinline__ void max32(int j, int slot, unsigned v) const {
    if (!has(j)) return;
    unsigned* a = at<unsigned>(j, slot);
    if (v > *(volatile unsigned*)a) atomicMax(a, v);
  }
  __device__ __forceinline__ void max64(int j, int slot,
                                        unsigned long long v) const {
    if (!has(j)) return;
    unsigned long long* a = at<unsigned long long>(j, slot);
    if (v > *(volatile unsigned long long*)a) atomicMax(a, v);
  }
};

// One f32 component's signed 8-bit chunks into the lanes (sub-rows 4..18)
// on the window anchored at emax: value = sig * 2^(e-150); window bit 0
// weighs 2^(emax-150-CH_W0).  A chunk past the top lane lands in it, as in
// the plain version (the fit flag excludes such batches).
__device__ __forceinline__ void add_chunks(const Slot& s, int slot, float f,
                                           int emax) {
  const unsigned u = __float_as_uint(f);
  int e = (u >> 23) & 0xFF;
  const unsigned m = u & 0x7FFFFFu;
  const unsigned sig = e > 0 ? (m | 0x800000u) : m;
  if (e < 1) e = 1;
  const int p = CH_W0 - (emax - e);
  if (p < 0 || sig == 0) return;
  const unsigned l32 = sig << (p & 7);
  const int q = p >> 3;
  const int sgn = (u >> 31) ? -1 : 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = (int)((l32 >> (8 * k)) & 0xFFu);
    if (c) s.add32(4 + min(q + k, CH_LANES - 1), slot, c * sgn);
  }
}

// One valid row of one piece into its bucket's shared slots.
__device__ __forceinline__ void apply(int kind, const Slot& s, int slot,
                                      unsigned long long raw, int emax) {
  switch (kind) {
    case K_COUNT:
      s.add32(0, slot, 1);
      break;
    case K_ICOUNT:
      if (raw) s.add64(0, slot, raw);
      break;
    case K_FSUM64: {
      const double v = __longlong_as_double((long long)raw);
      s.add32(0, slot, 1);
      if (isnan(v)) {
        s.add32(1, slot, 1);
      } else if (isinf(v)) {
        s.add32(v > 0 ? 2 : 3, slot, 1);
      } else {
        const float hi = __double2float_rn(v);
        const float lo = __double2float_rn(v - (double)hi);
        add_chunks(s, slot, hi, emax);
        add_chunks(s, slot, lo, emax);
      }
      break;
    }
    case K_FMAX64: {
      double v = __longlong_as_double((long long)raw);
      if (v == 0.0) v = 0.0;
      s.add32(0, slot, 1);
      if (!isnan(v)) {
        s.add32(1, slot, 1);
        const float hi = __double2float_rn(v);
        const float lo = isfinite(v) ? __double2float_rn(v - (double)hi)
                                     : 0.0f;
        s.max64(2, slot, ((unsigned long long)flip32(hi) << 32) |
                             flip32(lo));
      }
      break;
    }
    case K_FSUMV: {
      const double v = __longlong_as_double((long long)raw);
      s.add32(0, slot, 1);
      if (v != 0.0) s.addf64(1, slot, v);
      break;
    }
    case K_FMAX: {
      double v = __longlong_as_double((long long)raw);
      if (v == 0.0) v = 0.0;
      s.add32(0, slot, 1);
      if (!isnan(v)) {
        s.add32(1, slot, 1);
        s.max32(2, slot, flip32(__double2float_rn(v)));
      }
      break;
    }
  }
}

// One row of raw sub-row j into its bucket's shared slot.
__device__ __forceinline__ void apply_raw(int kind, const Slot& s, int j,
                                          int slot, unsigned long long raw) {
  if (kind == K_SUM32) {
    const float v = __uint_as_float((unsigned)raw);
    if (v != 0.0f) s.addf32(j, slot, v);
  } else if (kind == K_SUM64) {
    const double v = __longlong_as_double((long long)raw);
    if (v != 0.0) s.addf64(j, slot, v);
  } else {
    float v = __uint_as_float((unsigned)raw);
    if (isnan(v)) v = __int_as_float(0x7fc00000);
    s.max32(j, slot, flip32(v));
  }
}

// Values [i, i + V) of one column row that starts at element `row`: raw
// bits, where the row exists.  `full`: all V exist and are aligned for
// vector loads.
template <int V>
__device__ __forceinline__ void load_values(const void* data, bool wide,
                                            long long row, long long i,
                                            long long n, bool full,
                                            unsigned long long* raw) {
  if (V == 4 && full) {
    if (wide) {
      const ulonglong2* d = reinterpret_cast<const ulonglong2*>(
          static_cast<const unsigned long long*>(data) + row + i);
      const ulonglong2 a = __ldg(d), b = __ldg(d + 1);
      raw[0] = a.x; raw[1] = a.y; raw[2] = b.x; raw[3] = b.y;
    } else {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const unsigned*>(data) + row + i));
      raw[0] = a.x; raw[1] = a.y; raw[2] = a.z; raw[3] = a.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (i + k < n)
      raw[k] = wide
          ? __ldg(static_cast<const unsigned long long*>(data) + row + i + k)
          : __ldg(static_cast<const unsigned*>(data) + row + i + k);
}

// Rows [i, i + V) of one (not raw) piece: raw value bits and validity.
template <int V>
__device__ __forceinline__ void load_piece(const Piece& p, long long i,
                                           long long n, bool full,
                                           unsigned long long* raw,
                                           bool* ok) {
  if (p.data != nullptr)
    load_values<V>(p.data, wide_input(p.kind), 0, i, n, full, raw);
  if (V == 4 && full) {
    if (p.valid != nullptr) {
      const uchar4 v = *reinterpret_cast<const uchar4*>(p.valid + i);
      ok[0] = v.x; ok[1] = v.y; ok[2] = v.z; ok[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) ok[k] = true;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    ok[k] = i + k < n && (p.valid == nullptr || p.valid[i + k]);
}

// Rows [i, i + V) of every sub-row of a raw piece, TS_RAW_BATCH sub-rows'
// loads at a time before their atomics.  Row j of the [k, n] column
// starts at element j * n.
template <int V>
__device__ __forceinline__ void reduce_raw(const Piece& p, const Slot& s,
                                           long long i, long long n,
                                           bool full, const int* slot) {
  const bool wide = wide_input(p.kind);
  for (int j0 = p.lo; j0 < p.hi; j0 += TS_RAW_BATCH) {
    unsigned long long raw[TS_RAW_BATCH][V];
#pragma unroll
    for (int r = 0; r < TS_RAW_BATCH; ++r)
      if (j0 + r < p.hi)
        load_values<V>(p.data, wide, (long long)(j0 + r) * n, i, n, full,
                       raw[r]);
#pragma unroll
    for (int r = 0; r < TS_RAW_BATCH; ++r) {
      if (j0 + r >= p.hi) continue;
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (slot[k] >= 0) apply_raw(p.kind, s, j0 + r, slot[k], raw[r][k]);
    }
  }
}

template <int V, bool RAW>
__global__ void __launch_bounds__(TS_THREADS)
table_stage_kernel(const int* __restrict__ bucket, long long n, int table,
                   const Plan plan, unsigned long long* __restrict__ out64,
                   unsigned* __restrict__ out32) {
  extern __shared__ __align__(16) unsigned char sh[];
  __shared__ Piece sp[TS_GROUP_PIECES];
  __shared__ int semax[TS_GROUP_PIECES];
  const int nch = (table + plan.chunk - 1) / plan.chunk;
  const int gi = blockIdx.y / nch;
  const int b0 = (blockIdx.y % nch) * plan.chunk;
  const int bw = min(plan.chunk, table - b0);
  const int np = plan.group[gi].count;
  const int bytes = plan.group[gi].bytes;
  if (threadIdx.x < np) {
    const Piece p = plan.piece[plan.group[gi].first + threadIdx.x];
    sp[threadIdx.x] = p;
    semax[threadIdx.x] = p.emax != nullptr ? (int)*p.emax : 0;
  }
  for (int i = threadIdx.x * 8; i < bytes; i += blockDim.x * 8)
    *reinterpret_cast<unsigned long long*>(sh + i) = 0ull;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x * V;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
       i < n; i += stride) {
    const bool full = i + V <= n;
    int slot[V];
    if (V == 4 && full) {
      const int4 b = __ldg(reinterpret_cast<const int4*>(bucket + i));
      slot[0] = b.x; slot[1] = b.y; slot[2] = b.z; slot[3] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        slot[k] = i + k < n ? __ldg(bucket + i + k) : -1;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      slot[k] -= b0;
      if ((unsigned)slot[k] >= (unsigned)bw) slot[k] = -1;
    }
    if constexpr (RAW) {
      for (int q = 0; q < np; ++q) {
        const Slot s{sh + sp[q].smem, sp[q].lo, sp[q].hi,
                     row_bytes(sp[q].kind) * plan.stride};
        reduce_raw<V>(sp[q], s, i, n, full, slot);
      }
    } else {
      unsigned long long raw[TS_GROUP_PIECES][V];
      bool ok[TS_GROUP_PIECES][V];
#pragma unroll
      for (int q = 0; q < TS_GROUP_PIECES; ++q)
        if (q < np) load_piece<V>(sp[q], i, n, full, raw[q], ok[q]);
#pragma unroll
      for (int q = 0; q < TS_GROUP_PIECES; ++q) {
        if (q >= np) continue;
        const int kind = sp[q].kind;
        const Slot s{sh + sp[q].smem, sp[q].lo, sp[q].hi, 4 * plan.stride};
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (slot[k] >= 0 && ok[q][k]) apply(kind, s, slot[k], raw[q][k],
                                               semax[q]);
      }
    }
  }
  __syncthreads();

  // flush the non-zero slots
  for (int q = 0; q < np; ++q) {
    const Piece& p = sp[q];
    for (int j = p.lo; j < p.hi; ++j) {
      const int op = sub_op(p.kind, j);
      const unsigned char* row =
          sh + p.smem + (j - p.lo) * row_bytes(p.kind) * plan.stride;
      const long long g =
          op == OP_ADD64 || op == OP_ADDF64 || op == OP_MAX64
              ? (long long)(p.g64 + (p.kind == K_SUM64 ? j : 0)) * table + b0
              : (long long)(p.g32 + j) * table + b0;
      for (int t = threadIdx.x; t < bw; t += blockDim.x) {
        switch (op) {
          case OP_ADD32:
          case OP_ADDF32:
          case OP_MAX32: {
            const unsigned v = reinterpret_cast<const unsigned*>(row)[t];
            if (v == 0u) break;
            if (op == OP_ADD32) atomicAdd(out32 + g + t, v);
            else if (op == OP_MAX32) atomicMax(out32 + g + t, v);
            else atomicAdd(reinterpret_cast<float*>(out32 + g + t),
                           __uint_as_float(v));
            break;
          }
          default: {
            const unsigned long long v =
                reinterpret_cast<const unsigned long long*>(row)[t];
            if (v == 0ull) break;
            if (op == OP_ADD64) atomicAdd(out64 + g + t, v);
            else if (op == OP_MAX64) atomicMax(out64 + g + t, v);
            else atomicAdd(reinterpret_cast<double*>(out64 + g + t),
                           __longlong_as_double((long long)v));
          }
        }
      }
    }
  }
}

// Blocks of one instance that fit an SM beside `smem` dynamic shared bytes
// (cached per instance, which gets its shared-memory limit on first use).
template <int V, bool RAW>
static int blocks_per_sm(int smem, int* blocks) {
  static int limit_set = 0, cached_smem = -1, cached = 1;
  if (!limit_set) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const cudaError_t err = cudaFuncSetAttribute(
        table_stage_kernel<V, RAW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - TS_STATIC_RESERVE);
    if (err != cudaSuccess) return (int)err;
    limit_set = 1;
  }
  if (smem != cached_smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, table_stage_kernel<V, RAW>, TS_THREADS, smem);
    if (cached < 1) cached = 1;
    cached_smem = smem;
  }
  *blocks = cached;
  return 0;
}

template <int V, bool RAW>
static int launch(const int* bucket, long long n, int table, const Plan& plan,
                  int smem, int per_sm, unsigned long long* out64,
                  unsigned* out32, cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int nch = (table + plan.chunk - 1) / plan.chunk;
  const int groups = plan.ngroups * nch;
  long long gx = (long long)per_sm * sms / groups;
  // a block's shared init and flush cost about table slots; give each
  // block at least 8 row iterations
  const long long need = (n + (long long)TS_THREADS * V * 8 - 1) /
                         ((long long)TS_THREADS * V * 8);
  if (gx > need) gx = need;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned)gx, (unsigned)groups);
  table_stage_kernel<V, RAW><<<grid, TS_THREADS, smem, s>>>(
      bucket, n, table, plan, out64, out32);
  return (int)cudaGetLastError();
}

// The 4-row instance needs more registers than the 1-row one (ptxas: 90-96
// against 40 at 512 threads), so where the shared tables leave room for two
// blocks per SM only the 1-row instance gets them.  Take the instance with
// more blocks per SM: the atomics, not the loads, set the pace.
template <bool RAW>
static int launch_by_occupancy(const int* bucket, long long n, int table,
                               const Plan& plan, int vec,
                               unsigned long long* out64, unsigned* out32,
                               cudaStream_t s) {
  int smem = 0;
  for (int g = 0; g < plan.ngroups; ++g)
    smem = plan.group[g].bytes > smem ? plan.group[g].bytes : smem;
  int per1 = 1, per4 = 0;
  int err = blocks_per_sm<1, RAW>(smem, &per1);
  if (err == 0 && vec == 4) err = blocks_per_sm<4, RAW>(smem, &per4);
  if (err != 0) return err;
  if (vec == 4 && per4 >= per1)
    return launch<4, RAW>(bucket, n, table, plan, smem, per4, out64, out32,
                          s);
  return launch<1, RAW>(bucket, n, table, plan, smem, per1, out64, out32, s);
}

// bucket: int32[n]; plan: the pieces and groups (kernels/cuda_ops.py builds
// it), raw pieces only or none; vec: 4 when bucket, every column and every
// row of a raw column (16 B) and every mask (4 B) are aligned for vector
// loads, else 1.  out: one buffer of out_bytes, zeroed here, whose first
// part is out64 (u64 rows) and the rest out32 (u32 rows), each [rows,
// table].  Launches on `stream`; returns cudaGetLastError().
extern "C" int table_stage(const void* bucket, long long n, int table,
                           const Plan* plan, int vec, void* out64,
                           void* out32, long long out_bytes, void* stream) {
  if (n < 0 || table < 1 || plan->ngroups < 1 ||
      plan->ngroups > TS_MAX_GROUPS || plan->chunk < 1 ||
      plan->stride < plan->chunk || (plan->stride & 1))
    return (int)cudaErrorInvalidValue;
  const Group& last = plan->group[plan->ngroups - 1];
  const int npieces = last.first + last.count;
  if (npieces < 1 || npieces > TS_MAX_PIECES)
    return (int)cudaErrorInvalidValue;
  int nraw = 0;
  for (int q = 0; q < npieces; ++q)
    nraw += raw_kind(plan->piece[q].kind);
  if (nraw != 0 && nraw != npieces) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out64, 0, (size_t)out_bytes, s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const int* b = (const int*)bucket;
  unsigned long long* o64 = (unsigned long long*)out64;
  unsigned* o32 = (unsigned*)out32;
  if (nraw)
    return launch_by_occupancy<true>(b, n, table, *plan, vec, o64, o32, s);
  return launch_by_occupancy<false>(b, n, table, *plan, vec, o64, o32, s);
}

extern "C" int table_stage_smem_limit(void) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v - TS_STATIC_RESERVE;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
