// SQL LIKE: one pattern against every row of a string column.
//
// A kernel of the port alone: no Pallas kernel is replaced.  The reference
// runs the patterns that are not a prefix, suffix, substring or equality
// through a host regex (spark_rapids_tpu/expr/string_ops.py:202-210,
// `_like_to_regex`); the port runs every such pattern here, on the Arrow
// layout (int32 offsets, bytes).
//
// The pattern comes compiled from the host (kernels/cuda_ops.like_tokens,
// like_pieces) as tokens: a byte (0-255) matches itself, LM_ONE (`_`) one
// UTF-8 character (the bytes its lead byte counts, cut at the row's end),
// LM_ANY (`%`) any run of characters; the escape is resolved on the host.
// The host also cuts the tokens into pieces at the `%`s: the first piece is
// anchored at the row's start; each later one is looked for at its leftmost
// place after the one before, which is right because a piece matches a
// fixed number of characters, so its leftmost match ends first; the last
// piece must end at the row's end.  A candidate place is a character
// start counted from where the last `%` began (char_bytes of each lead
// byte), the places the greedy wildcard match (kernels/cuda_ops
// like_match_plain) tries, so every row, valid UTF-8 or not, gets the
// plain version's answer.  A last piece without `_` has one place, the
// row's end less its bytes: the walk to it reads lead bytes alone and the
// piece is compared once.
//
// The design: a persistent grid walks the column in tiles of 256 rows
// (row_tiles.cuh): a tile's bytes come into shared memory in one run of
// 16-byte cp.async copies while the block works on the tile before it, so
// that global memory is read once and coalesced.  The pattern sits in
// shared memory, passed once as a __grid_constant__ parameter.  The block
// then works on the window's bytes, not on its rows: its threads build,
// 32 places a word, a bitmap of the lead bytes and a bitmap of the places
// where the pattern's second piece matches (its first byte sifts four
// places at a time, its second the places left, a four-byte compare and
// the whole piece the rest), so that a warp's threads run the same steps
// on neighbouring words.  A thread then takes a row: the first piece
// compared at the row's start, the second at the first set bit that
// leaves the row room for it (at the row's end when it is the last).
// The rows that found it mark the bitmap words where they will look for
// the third piece, and only those words of its bitmap are built; the
// pieces after the third are looked for in the row alone (lm_rest).  In a
// row without a lead byte, `_` is one byte and every place is a character
// start, so the bitmaps give the greedy match's answer; a row with one,
// or one longer than the window, takes the greedy piece search alone
// (lm_row).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): not the
// bytes (54 a row at TPC-H's o_comment: its 19-78-byte rows, 4-byte
// offsets, a validity byte in and a byte out, over 3.35 TB/s), but the
// copy into shared memory and the sift, a few operations for every byte
// of the window.  Measured by chip_smoke.py's phase 3 at 4,194,304 rows:
// 25.3% of the byte bound with Q13's '%special%requests%' over o_comment
// rows ('s' is common, so most words go through both sifts, and the rows
// that hold 'special' need words of the third piece's bitmap), 59.9%
// with Q16's '%Customer%Complaints%' over s_comment rows.  One thread a
// row, reading its bytes one load at a time from global memory, its
// tokens from the parameter bank at addresses that differed across the
// warp, each row on its own path through the search loops, took 11.1%
// of the bound at Q13's shape; a first tiled design that built the
// second piece's bitmap alone and searched the third in each row, 19.9%.
#include <cuda_runtime.h>

#include "row_tiles.cuh"

#define LM_MAX_TOKENS 512
#define LM_MAX_PIECES (LM_MAX_TOKENS / 2 + 1)
#define LM_ONE 256
#define LM_ANY 257
#define LM_THREADS 256
// bytes of one staged tile: 70 a row, which with the bitmaps leaves room
// for five blocks an SM
#define LM_ROW_BYTES 70
#define LM_BUDGET (LM_THREADS * LM_ROW_BYTES)

struct LikePattern {
  int len;                         // tokens
  int pieces;                      // the pattern's %s, plus one
  short tok[LM_MAX_TOKENS];
  short start[LM_MAX_PIECES];      // each piece's first token
  short count[LM_MAX_PIECES];      // and its tokens (0 for an empty piece)
  unsigned char fixed[LM_MAX_PIECES];  // no `_` among them
};

__device__ __forceinline__ int char_bytes(unsigned b) {
  return b < 0xC0 ? 1 : b < 0xE0 ? 2 : b < 0xF0 ? 3 : 4;
}

#define LM_MISMATCH (-1)
#define LM_RAN_OUT (-2)

// the piece's tokens from byte i of the row: where they end, LM_MISMATCH,
// or LM_RAN_OUT when the row ends before they do
__device__ __forceinline__ int lm_try(const unsigned char* p, int i, int e,
                                      const short* tok, int count) {
  for (int k = 0; k < count; ++k) {
    if (i >= e) return LM_RAN_OUT;
    const int t = tok[k];
    const unsigned b = p[i];
    if (t == LM_ONE) {
      i += char_bytes(b);
      if (i > e) i = e;
    } else if (b == (unsigned)t) {
      i++;
    } else {
      return LM_MISMATCH;
    }
  }
  return i;
}

// whether the aligned 32-bit word holds the byte c, or a byte >= 0xC0 (a
// lead byte of two or more)
__device__ __forceinline__ bool lm_stop(unsigned w, unsigned cc) {
  const unsigned m = w ^ cc;
  return (((m - 0x01010101u) & ~m) | (w & (w << 1))) & 0x80808080u;
}

// the first place from x on (a character at a time) whose byte is c, or e
__device__ __forceinline__ int lm_find(const unsigned char* p, int x, int e,
                                       unsigned c) {
  const unsigned cc = c * 0x01010101u;
  while (x < e) {
    if ((((uintptr_t)(p + x)) & 3) == 0 && x + 4 <= e &&
        !lm_stop(*(const unsigned*)(p + x), cc)) {
      x += 4;
      continue;
    }
    const unsigned b = p[x];
    if (b == c) return x;
    x += char_bytes(b);
  }
  return e;
}

// the first place from x on that is at or past t (t <= e)
__device__ __forceinline__ int lm_walk(const unsigned char* p, int x, int t) {
  while (x < t) {
    if ((((uintptr_t)(p + x)) & 3) == 0 && x + 4 <= t) {
      const unsigned w = *(const unsigned*)(p + x);
      if (!(w & (w << 1) & 0x80808080u)) {
        x += 4;
        continue;
      }
    }
    x += char_bytes(p[x]);
  }
  return x;
}

// whether the row's e bytes at p match pieces j on of the pattern, the
// pieces before them matched up to byte pos
__device__ bool lm_rest(const unsigned char* p, int e, const LikePattern& pat,
                        int j, int pos) {
  for (; j < pat.pieces; ++j) {
    const int count = pat.count[j];
    if (count == 0) return true;                // a trailing %
    const short* tok = pat.tok + pat.start[j];
    const bool last = j == pat.pieces - 1;
    if (last && pat.fixed[j]) {
      const int t = e - count;
      if (t < pos || lm_walk(p, pos, t) != t) return false;
      return lm_try(p, t, e, tok, count) == e;
    }
    const int first = tok[0];
    int x = pos;
    for (;;) {
      if (first != LM_ONE) x = lm_find(p, x, e, first);
      if (x >= e) return false;
      const int end = lm_try(p, x, e, tok, count);
      if (end == LM_RAN_OUT) return false;
      if (end >= 0 && (!last || end == e)) {
        pos = end;
        break;
      }
      x += char_bytes(p[x]);
      if (x > e) x = e;
    }
    if (last) return true;
  }
  return true;
}

// whether the row's e bytes at p match the pattern
__device__ bool lm_row(const unsigned char* p, int e, const LikePattern& pat) {
  const int pos = lm_try(p, 0, e, pat.tok + pat.start[0], pat.count[0]);
  if (pos < 0) return false;
  if (pat.pieces == 1) return pos == e;
  return lm_rest(p, e, pat, 1, pos);
}

// -- the tile's bitmaps --------------------------------------------------------

// bitmap words of one staged window
#define LM_WORDS (LM_BUDGET / 32)

// A piece's sift: its first literal bytes (up to 4, before any `_`), low
// byte first, and how many
struct LmKey {
  unsigned key, mask;
  int n;
};

__device__ __forceinline__ LmKey lm_key(const short* tok, int count) {
  LmKey k = {0u, 0u, 0};
  while (k.n < 4 && k.n < count && tok[k.n] != LM_ONE) {
    k.key |= (unsigned)tok[k.n] << (8 * k.n);
    k.n++;
  }
  k.mask = k.n == 4 ? ~0u : (1u << (8 * k.n)) - 1;
  return k;
}

// bit 7 of every byte of t that is 0, and perhaps of a byte 0x01 above
// one (a borrow): a superset, which the checks after the sift remove
__device__ __forceinline__ unsigned lm_zero(unsigned t) {
  return (t - 0x01010101u) & ~t & 0x80808080u;
}

// gathers bit 7 of each byte of z into bits 0-3
__device__ __forceinline__ unsigned lm_gather4(unsigned z) {
  return ((z >> 7) * 0x204081u >> 21) & 0xFu;
}

// whether the piece's tokens match the window's bytes from x on, each `_`
// one byte
__device__ __forceinline__ bool lm_at(const unsigned char* buf, int len,
                                      int x, const short* tok, int count) {
  if (x + count > len) return false;
  for (int k = 0; k < count; ++k)
    if (tok[k] != LM_ONE && buf[x + k] != (unsigned)tok[k]) return false;
  return true;
}

// Word group g of the window (of len bytes, a multiple of 16): its bytes
// [32 g, 32 g + 32) and the next four as nine 32-bit words (0 past the
// window); returns the places of the group inside the window
__device__ __forceinline__ unsigned lm_load(const unsigned char* buf,
                                            int len, int g, unsigned* w) {
  const int at = 32 * g;
  const uint4 lo = *(const uint4*)(buf + at);
  const uint4 hi = at + 16 < len ? *(const uint4*)(buf + at + 16)
                                 : make_uint4(0, 0, 0, 0);
  w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
  w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
  w[8] = at + 32 < len ? *(const unsigned*)(buf + at + 32) : 0u;
  return len - at >= 32 ? ~0u : (1u << (len - at)) - 1;
}

// the group's lead bytes (>= 0xC0, rare in text: gathered only where
// there is one)
__device__ __forceinline__ unsigned lm_lead(const unsigned* w, unsigned in) {
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) bits |= w[q] & (w[q] << 1);
  if (!(bits & 0x80808080u)) return 0;
  bits = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    bits |= lm_gather4(w[q] & (w[q] << 1) & 0x80808080u) << (4 * q);
  return bits & in;
}

// The places of word group g (w, in from lm_load) where the piece
// matches, each `_` one byte (the rows that read the bitmap hold no lead
// byte).  Its first byte sifts the places four at a time, its second
// those left where the first is there at all; a place left is compared
// with the key's four bytes in one word, then checked whole.
__device__ __forceinline__ unsigned lm_sift(const unsigned char* buf,
                                            int len, int g,
                                            const unsigned* w, unsigned in,
                                            const short* tok, int count,
                                            const LmKey& k) {
  unsigned cand = in;
  if (k.n >= 1) {
    const unsigned c0 = (k.key & 0xFFu) * 0x01010101u;
    unsigned z0[8], any = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      z0[q] = lm_zero(w[q] ^ c0);
      any |= z0[q];
    }
    if (!any) return 0;
    unsigned bits = 0;
    if (k.n >= 2) {
      const unsigned c1 = ((k.key >> 8) & 0xFFu) * 0x01010101u;
      unsigned z1 = lm_zero(w[0] ^ c1);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const unsigned z1n = lm_zero(w[q + 1] ^ c1);
        bits |= lm_gather4(z0[q] & __funnelshift_r(z1, z1n, 8)) << (4 * q);
        z1 = z1n;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) bits |= lm_gather4(z0[q]) << (4 * q);
    }
    cand &= bits;
  }
  unsigned found = 0;
  const unsigned* words = (const unsigned*)buf;
  while (cand) {
    const int i = __ffs(cand) - 1;
    cand &= cand - 1;
    const int x = 32 * g + i;
    if (k.n > 2 && x + 8 <= len) {
      const unsigned u = __funnelshift_r(words[x >> 2], words[(x >> 2) + 1],
                                         8 * (x & 3));
      if ((u & k.mask) != k.key) continue;
    }
    if (lm_at(buf, len, x, tok, count)) found |= 1u << i;
  }
  return found;
}

// the first set bit of bm in [lo, hi], or -1
__device__ __forceinline__ int lm_first(const unsigned* bm, int lo, int hi) {
  if (lo > hi) return -1;
  const int last = hi >> 5;
  for (int wi = lo >> 5; wi <= last; ++wi) {
    unsigned m = bm[wi];
    if (wi == lo >> 5) m &= ~0u << (lo & 31);
    if (wi == last && (hi & 31) != 31) m &= (2u << (hi & 31)) - 1;
    if (m) return 32 * wi + __ffs(m) - 1;
  }
  return -1;
}

__device__ __forceinline__ bool lm_bit(const unsigned* bm, int x) {
  return (bm[x >> 5] >> (x & 31)) & 1u;
}

#define LM_NO 0
#define LM_YES 1
#define LM_MORE 2

// A staged row at byte rel of the window (len bytes, no lead byte among
// them), its first two pieces: the first compared at the row's start,
// the second (c1 tokens, f1 its bitmap) at its first set bit that leaves
// the row room, or at the row's end when it is the last.  LM_MORE: they
// match and the pieces from the third on remain, from byte *pos.
__device__ __forceinline__ int lm_head(const unsigned char* buf, int rel,
                                       int len, const LikePattern& sp,
                                       int c1, const unsigned* f1,
                                       int* pos) {
  int p = sp.count[0];
  if (!lm_at(buf + rel, len, 0, sp.tok + sp.start[0], p)) return LM_NO;
  if (sp.pieces == 1) return p == len;
  if (c1 == 0) return LM_YES;                   // the pattern ends with %
  if (sp.pieces == 2) {
    const int x = len - c1;
    return x >= p && lm_bit(f1, rel + x);
  }
  const int x = lm_first(f1, rel + p, rel + len - c1);
  if (x < 0) return LM_NO;
  *pos = x - rel + c1;
  return LM_MORE;
}

// The bitmap words that lm_tail reads for a row whose third piece (c2
// tokens) is looked for from byte pos: [*lo, *hi], empty when the row
// has no room for it
__device__ __forceinline__ void lm_span(int rel, int len, int c2, int pos,
                                        int* lo, int* hi) {
  *lo = (rel + pos) >> 5;
  *hi = pos <= len - c2 ? (rel + len - c2) >> 5 : *lo - 1;
}

// The rest of a row that lm_head left at LM_MORE: the third piece (c2
// tokens, f2 its bitmap, built over lm_span's words at least) at its
// first set bit from pos that leaves the row room, or at the row's end
// when it is the last, the pieces after it looked for in the row alone
__device__ __forceinline__ bool lm_tail(const unsigned char* buf, int rel,
                                        int len, const LikePattern& sp,
                                        int c2, const unsigned* f2,
                                        int pos) {
  if (c2 == 0) return true;                     // the pattern ends with %
  if (sp.pieces == 3) {
    const int x = len - c2;
    return x >= pos && lm_bit(f2, rel + x);
  }
  const int x = lm_first(f2, rel + pos, rel + len - c2);
  return x >= 0 && lm_rest(buf + rel, len, sp, 3, x - rel + c2);
}

// -- kernels -------------------------------------------------------------------

// A tile in three steps.  1. Every thread builds words of the window's
// bitmaps of lead bytes and of the places where the pattern's second
// piece matches, and each thread's row reads them (lm_head); a row that
// holds a lead byte, or that the window does not hold, takes lm_row
// alone.  2. The rows that found the second piece mark the words where
// they look for the third, and those words of its bitmap are built:
// in text few rows get that far.  3. Those rows read it (lm_tail).
__global__ void __launch_bounds__(LM_THREADS)
    like_match_kernel(const int* offsets, const unsigned char* data,
                      const bool* valid, long long n,
                      const __grid_constant__ LikePattern pat, bool* out) {
  extern __shared__ __align__(16) unsigned char lm_buf[];
  __shared__ LikePattern sp;
  __shared__ unsigned lead[LM_WORDS], found1[LM_WORDS], found2[LM_WORDS];
  __shared__ unsigned char need[LM_WORDS];
  {
    const int* src = (const int*)&pat;
    int* dst = (int*)&sp;
    for (int k = threadIdx.x; k < (int)(sizeof(LikePattern) / 4);
         k += blockDim.x)
      dst[k] = src[k];
    for (int k = threadIdx.x; k < LM_WORDS; k += blockDim.x) need[k] = 0;
  }
  __syncthreads();
  // the second and third pieces, when the pattern has them
  const int c1 = sp.pieces > 1 ? sp.count[1] : 0;
  const int c2 = sp.pieces > 2 ? sp.count[2] : 0;
  const short* tok1 = sp.tok + (sp.pieces > 1 ? sp.start[1] : 0);
  const short* tok2 = sp.tok + (sp.pieces > 2 ? sp.start[2] : 0);
  const LmKey key1 = lm_key(tok1, c1), key2 = lm_key(tok2, c2);
  rt_for_each_tile(
      offsets, data, valid, n, lm_buf, LM_BUDGET, [&](const RtTile& tile) {
        const int words = (tile.len + 31) >> 5;
        for (int g = threadIdx.x; g < words; g += blockDim.x) {
          unsigned w[9];
          const unsigned in = lm_load(tile.buf, tile.len, g, w);
          lead[g] = lm_lead(w, in);
          if (c1) found1[g] = lm_sift(tile.buf, tile.len, g, w, in, tok1,
                                      c1, key1);
        }
        __syncthreads();
        bool staged = false;
        const unsigned char* p = rt_row_at(tile, data, &staged);
        const int len = tile.row.e - tile.row.s;
        const int rel = staged ? (int)(p - tile.buf) : 0;
        int state = LM_NO, pos = 0;
        if (tile.r < n && tile.row.v) {
          state = !staged || lm_first(lead, rel, rel + len - 1) >= 0
                      ? lm_row(p, len, sp)
                      : lm_head(tile.buf, rel, len, sp, c1, found1, &pos);
        }
        if (c2) {
          // the same on every thread: the pattern has a third piece
          if (state == LM_MORE) {
            int lo, hi;
            lm_span(rel, len, c2, pos, &lo, &hi);
            for (int g = lo; g <= hi; ++g) need[g] = 1;
          }
          __syncthreads();
          for (int g = threadIdx.x; g < words; g += blockDim.x) {
            if (!need[g]) continue;
            need[g] = 0;
            unsigned w[9];
            const unsigned in = lm_load(tile.buf, tile.len, g, w);
            found2[g] = lm_sift(tile.buf, tile.len, g, w, in, tok2, c2,
                                key2);
          }
          __syncthreads();
        }
        if (state == LM_MORE)
          state = lm_tail(tile.buf, rel, len, sp, c2, found2, pos);
        if (tile.r < n) out[tile.r] = state == LM_YES;
      });
}

static int lm_grid_cache[RT_DEVICES][2];

extern "C" int like_match(const void* offsets, const void* data,
                          const void* valid, long long n,
                          const LikePattern* pat, void* out, void* stream) {
  if (n <= 0) return 0;
  const int grid = rt_grid(like_match_kernel, n, LM_THREADS, 2 * LM_BUDGET,
                           lm_grid_cache);
  like_match_kernel<<<grid, LM_THREADS, 2 * LM_BUDGET,
                      (cudaStream_t)stream>>>(
      (const int*)offsets, (const unsigned char*)data, (const bool*)valid, n,
      *pat, (bool*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
