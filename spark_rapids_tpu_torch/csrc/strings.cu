// SQL LIKE: one pattern against every row of a string column.
//
// A kernel of the port alone: no Pallas kernel is replaced.  The reference
// runs the patterns that are not a prefix, suffix, substring or equality
// through a host regex (spark_rapids_tpu/expr/string_ops.py:202-210,
// `_like_to_regex`); the port runs every such pattern here, one thread per
// row, on the Arrow layout (int32 offsets, bytes).
//
// The pattern comes compiled from the host (kernels/cuda_ops.like_tokens)
// as tokens, passed by value as a kernel argument: a byte (0-255) matches
// itself, LM_ONE (`_`) one UTF-8 character, LM_ANY (`%`) any run of
// characters; the escape is resolved on the host.  The match is the linear
// greedy wildcard match: each `%` records where it began, and a mismatch
// goes back to the last `%` and lets it take one character more.  The last
// `%` is the only point it returns to, so a row costs O(bytes x tokens) in
// the worst case and O(bytes) in the common one.
//
// What bounds it on the H100: the row's bytes are read with byte loads of
// one thread, and neighbouring threads read neighbouring rows, tens of
// bytes apart; the byte bound (the rows' bytes, offsets and validity read
// once, one byte written a row) is met only when a warp's rows share
// sectors.  Rows of 19-78 bytes, as TPC-H's comments, do.
#include <cuda_runtime.h>

#define LM_MAX_TOKENS 512
#define LM_ONE 256
#define LM_ANY 257

struct LikePattern {
  int len;
  short tok[LM_MAX_TOKENS];
};

__device__ __forceinline__ int char_bytes(unsigned char b) {
  return b < 0xC0 ? 1 : b < 0xE0 ? 2 : b < 0xF0 ? 3 : 4;
}

__global__ void like_match_kernel(const int* offsets,
                                  const unsigned char* data,
                                  const bool* valid, long long n,
                                  LikePattern pat, bool* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    if (!valid[r]) {
      out[r] = false;
      continue;
    }
    const int e = offsets[r + 1];
    int i = offsets[r], p = 0, star = -1, mark = 0;
    bool ok = true;
    while (i < e) {
      const int t = p < pat.len ? pat.tok[p] : -1;
      if (t == LM_ONE) {
        i += char_bytes(data[i]);
        if (i > e) i = e;
        p++;
      } else if (t >= 0 && t < LM_ONE && data[i] == t) {
        i++;
        p++;
      } else if (t == LM_ANY) {
        star = p++;
        mark = i;
      } else if (star >= 0) {
        p = star + 1;
        mark += char_bytes(data[mark]);
        if (mark > e) mark = e;
        i = mark;
      } else {
        ok = false;
        break;
      }
    }
    if (ok) {
      while (p < pat.len && pat.tok[p] == LM_ANY) p++;
      ok = p == pat.len;
    }
    out[r] = ok;
  }
}

extern "C" int like_match(const void* offsets, const void* data,
                          const void* valid, long long n,
                          const LikePattern* pat, void* out, int threads,
                          void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  like_match_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)offsets, (const unsigned char*)data, (const bool*)valid, n,
      *pat, (bool*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
