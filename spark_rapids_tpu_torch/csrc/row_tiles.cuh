// Row tiles: a string column (Arrow's int32 offsets and bytes) walked by a
// persistent grid, one block a run of consecutive rows at a time, each
// run's bytes staged in shared memory before its rows are read.
//
// A tile is blockDim.x consecutive rows, one a thread.  Its bytes
// [offsets[r0], offsets[r1]) lie together in the column, so the block
// copies them once, as 16-byte cp.async copies from the span's start
// aligned down to 16 bytes to its end aligned up, at most `budget` bytes.
// The ragged ends come along and are never used, but they are read: up to
// 15 bytes before the span and after it.  So the column's bytes must lie
// in an allocation that starts at a 16-byte boundary and is padded to a
// multiple of 16 bytes, as every PyTorch CUDA tensor's storage is (the
// caching allocator hands out blocks aligned to, and sized in multiples
// of, 512 bytes); kernels/cuda_ops.like_match checks the start.  A row
// that the staged bytes do not hold (a span past the budget: a long row,
// or many long rows) is read where it lies, in global memory
// (rt_row_at).  The offsets need
// not start at 0 (a sliced column); empty rows and null rows take no
// bytes.
//
// Two buffers: while the block works on tile k out of one, the copy of
// its next tile (k + gridDim.x) fills the other, and the next-but-one
// tile's offsets and validity travel into registers.  A block's two
// buffers and the kernel's own shared data set how many blocks an SM
// holds; the grid is that many blocks an SM (rt_grid).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_ALIGN 16

__device__ __forceinline__ void rt_copy16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void rt_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void rt_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a row's byte range and validity
struct RtRow {
  int s, e;
  bool v;
};

__device__ __forceinline__ RtRow rt_row(const int* offsets, const bool* valid,
                                        long long n, long long r) {
  RtRow row = {0, 0, false};
  if (r < n) {
    row.s = offsets[r];
    row.e = offsets[r + 1];
    row.v = valid[r];
  }
  return row;
}

// the staged window of a tile whose span is [s, e): absolute addresses
// [base, base + len), len a multiple of 16, at most budget
__device__ __forceinline__ void rt_window(const unsigned char* data, int s,
                                          int e, int budget, uintptr_t* base,
                                          int* len) {
  const uintptr_t a = (uintptr_t)(data + s) & ~(uintptr_t)(RT_ALIGN - 1);
  const uintptr_t b = ((uintptr_t)(data + e) + RT_ALIGN - 1) &
                      ~(uintptr_t)(RT_ALIGN - 1);
  const uintptr_t w = b - a;
  *base = a;
  *len = w < (uintptr_t)budget ? (int)w : budget;
}

// every thread of the block: the copies of one tile's window into buf
__device__ __forceinline__ void rt_stage(unsigned char* buf,
                                         const unsigned char* data, int s,
                                         int e, int budget) {
  uintptr_t base;
  int len;
  rt_window(data, s, e, budget, &base, &len);
  for (int c = threadIdx.x * RT_ALIGN; c < len; c += blockDim.x * RT_ALIGN)
    rt_copy16(buf + c, (const void*)(base + c));
}

// One thread's view of a tile: the tile's window in shared memory (buf
// holds the absolute addresses [base, base + len) of the column's bytes)
// and the thread's row r (row.v false where r >= n).
struct RtTile {
  const unsigned char* buf;
  uintptr_t base;
  int len;
  long long r;
  RtRow row;
};

// where the thread's row starts: in the window when it holds the whole
// row, else in global memory
__device__ __forceinline__ const unsigned char* rt_row_at(
    const RtTile& tile, const unsigned char* data, bool* staged) {
  const uintptr_t p = (uintptr_t)(data + tile.row.s);
  *staged = p + (tile.row.e - tile.row.s) <= tile.base + tile.len;
  return *staged ? tile.buf + (p - tile.base) : (const unsigned char*)p;
}

// Calls work(tile) on every thread of the block for each tile of
// blockDim.x rows that the block takes; work may hold __syncthreads().
// buf holds 2 * budget bytes of shared memory, 16-byte aligned; budget is
// a multiple of 16.  Every thread of the block must call it.
template <class Work>
__device__ void rt_for_each_tile(const int* offsets,
                                 const unsigned char* data,
                                 const bool* valid, long long n,
                                 unsigned char* buf, int budget, Work work) {
  // each tile's span, in three slots: the tile at work, the one being
  // copied and the one whose span is being published
  __shared__ int span[3][2];
  const int R = blockDim.x, t = threadIdx.x;
  const long long G = gridDim.x;
  const long long tiles = (n + R - 1) / R;
  const long long first = blockIdx.x;
  if (first >= tiles) return;
  auto publish = [&](int slot, long long tile, const RtRow& row) {
    const long long r = tile * R + t;
    const long long last = (tile + 1) * R < n ? (tile + 1) * R - 1 : n - 1;
    if (t == 0) span[slot][0] = row.s;
    if (r == last) span[slot][1] = row.e;
  };
  RtRow cur = rt_row(offsets, valid, n, first * R + t);
  RtRow nxt = rt_row(offsets, valid, n, (first + G) * R + t);
  publish(0, first, cur);
  if (first + G < tiles) publish(1, first + G, nxt);
  __syncthreads();
  rt_stage(buf, data, span[0][0], span[0][1], budget);
  rt_commit();
  rt_wait_all();
  __syncthreads();
  for (int k = 0;; ++k) {
    const long long tile = first + k * G;
    if (tile >= tiles) break;
    const int at = k % 3, copying = (k + 1) % 3, next = (k + 2) % 3;
    RtTile view;
    view.buf = buf + (k & 1) * budget;
    rt_window(data, span[at][0], span[at][1], budget, &view.base,
              &view.len);
    view.r = tile * R + t;
    view.row = cur;
    // 1. the next tile's bytes into the other buffer
    if (tile + G < tiles)
      rt_stage(buf + ((k + 1) & 1) * budget, data, span[copying][0],
               span[copying][1], budget);
    rt_commit();
    // 2. the next-but-one tile's rows into registers
    const RtRow after = tile + 2 * G < tiles
                            ? rt_row(offsets, valid, n, (tile + 2 * G) * R + t)
                            : RtRow{0, 0, false};
    // 3. this tile
    work(view);
    // 4. publish the next-but-one tile's span
    if (tile + 2 * G < tiles) publish(next, tile + 2 * G, after);
    rt_wait_all();
    __syncthreads();
    cur = nxt;
    nxt = after;
  }
}

#define RT_DEVICES 16

// a kernel's counts on the current device: blocks an SM, SMs
static inline int* rt_cached(int (*cache)[2]) {
  int dev = 0;
  cudaGetDevice(&dev);
  return cache[dev < RT_DEVICES ? dev : RT_DEVICES - 1];
}

// blocks of `threads` threads with `smem` dynamic bytes that one SM holds
// at once, times the SMs, capped at the tiles.  cache[device] keeps both
// counts after the first call on a device, which also raises the kernel's
// dynamic shared memory limit to `smem`.
template <class Kernel>
static int rt_grid(Kernel kernel, long long n, int threads, int smem,
                   int (*cache)[2]) {
  int* c = rt_cached(cache);
  if (c[0] == 0) {
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                  smem);
    c[1] = sms;
    c[0] = blocks < 1 ? 1 : blocks;
  }
  const long long tiles = (n + threads - 1) / threads;
  const long long grid = (long long)c[0] * c[1];
  return (int)(grid < tiles ? grid : (tiles < 1 ? 1 : tiles));
}
