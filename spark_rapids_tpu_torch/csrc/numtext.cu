// Numbers to text and back: the shortest decimal digits of every double (or
// float) of a column (`format_double`), and every string of a column read as
// a double (or float), correctly rounded (`parse_double`).
//
// Kernels of the port alone: no Pallas kernel is replaced.  The reference
// casts between strings and floats in per-row host loops
// (spark_rapids_tpu/expr/cast.py:189-265, `float(s)` and `repr(x)`).  Here
// each row is one thread of one launch.
//
// `format_double` is Schubfach (R. Giulietti, "The Schubfach way to render
// doubles", 2020; the layout of A. Bolz's C++ version): three products of
// the value's scaled boundaries with a 128-bit power of ten, rounded to odd,
// give the shortest digits that read back to the same value, and among them
// the closest.  Outputs: `digits` (at most 17 of them, trailing zeros
// stripped) and `exp10`, with |x| = digits * 10^exp10; 0 for 0, NaN and the
// infinities, which the caller writes itself.
//
// `parse_double` checks Java's grammar (kernels/cuda_ops.parse_double_plain
// lists it) and keeps the first 19 significant digits w and their decimal
// exponent q.  The product of w with the same 128-bit power of ten bounds
// the value from both sides (the power is rounded up, the digits may be cut
// short); when both bounds round to the same float, that is the answer,
// since rounding is monotone.  The rows where they differ (a value within
// about 2^-64 of a halfway point, or more than 19 digits that straddle one)
// compare every digit of the input exactly with the halfway point above the
// lower bound's float, in big integers of 32-bit words (at most 800 digits
// are kept; a non-zero digit past them counts as above).  No row leaves the
// card.
//
// The table: g(e) for e in [NT_POW10_MIN, NT_POW10_MAX], the 128-bit
// significand of 10^e in [2^127, 2^128), rounded up unless exact, as two
// words (low, high); kernels/cuda_ops.pow10_table builds it on the host
// with Python's integers at first use.
//
// What bounds them on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): not the
// bytes.  format moves 20 bytes a value and runs at about 41% of that bound
// at 3.35 TB/s; parse moves the row's bytes, 4 of offsets, a validity byte
// in and 9 (or 5) bytes out, and runs at 22-23% of that bound on texts of
// random doubles, 15-17% on texts of floats (chip_smoke.py's phase 3, at
// 4,194,304 rows).  Both are held by their integer work, which the card
// runs as several 32-bit operations for each 64-bit one: three 64x128-bit
// products a value, and for parse dependent byte loads along the row and a
// 64-bit multiply-add a digit.  Staging a tile's rows in shared memory
// (with the digits read four at a time and the undecided rows passed to a
// second launch) did not beat this design on those texts: the loads were
// not what held it.  The slow rows of parse take thousands of operations
// each, in a branch that other rows of their warp skip.
#include <cuda_runtime.h>
#include <stdint.h>

#define NT_POW10_MIN (-350)
#define NT_POW10_MAX 350
#define NT_MAX_DIGITS 800
#define NT_BN_WORDS 96

typedef unsigned long long u64;
typedef unsigned int u32;

struct Fmt {
  int p, emin, emax, bias, lmax, lmin;
  u64 inf, nan;
};

__device__ __forceinline__ Fmt fmt_of(int f32) {
  Fmt f;
  if (f32) {
    f.p = 24; f.emin = -126; f.emax = 127; f.bias = 127; f.lmax = 39;
    f.lmin = -46; f.inf = 0xFFull << 23; f.nan = 0x7FC00000ull;
  } else {
    f.p = 53; f.emin = -1022; f.emax = 1023; f.bias = 1023; f.lmax = 309;
    f.lmin = -325; f.inf = 0x7FFull << 52; f.nan = 0x7FF8ull << 48;
  }
  return f;
}

// floor(log2(10^e)) and floor(log10(2^q)) (minus log10(4/3) when the lower
// boundary is closer); right shifts of negative ints are arithmetic here
__device__ __forceinline__ int floor_log2_pow10(int e) {
  return (e * 1741647) >> 19;
}
__device__ __forceinline__ int floor_log10_pow2(int q, bool lower) {
  return (q * 1262611 - (lower ? 524031 : 0)) >> 22;
}

// -- format_double ------------------------------------------------------------

// floor(g * cp / 2^128), its lowest bit set when the rest is not 0
__device__ __forceinline__ u64 round_to_odd(u64 glo, u64 ghi, u64 cp) {
  const u64 x1 = __umul64hi(glo, cp);
  const u64 y0 = ghi * cp;
  const u64 y1 = __umul64hi(ghi, cp);
  const u64 z = y0 + x1;
  const u64 vb = y1 + (z < y0 ? 1ull : 0ull);
  return vb | (z > 1 ? 1ull : 0ull);
}

// shortest (digits, exp10) of c * 2^q, c > 0 holding `sig` bits at most
__device__ void to_decimal(u64 c, int q, int sig, int qmin, const u64* table,
                           u64* digits, int* exp10) {
  u64 d;
  int e;
  if (q <= 0 && -q < sig && (c & ((1ull << -q) - 1)) == 0) {
    d = c >> -q;
    e = 0;
  } else {
    const bool even = (c & 1) == 0;
    const bool lower_closer = c == (1ull << (sig - 1)) && q > qmin;
    const u64 cbl = 4 * c - 2 + (lower_closer ? 1 : 0);
    const u64 cb = 4 * c;
    const u64 cbr = 4 * c + 2;
    const int k = floor_log10_pow2(q, lower_closer);
    const int h = q + floor_log2_pow10(-k) + 1;
    const u64* g = table + 2 * (-k - NT_POW10_MIN);
    const u64 glo = g[0], ghi = g[1];
    const u64 vbl = round_to_odd(glo, ghi, cbl << h);
    const u64 vb = round_to_odd(glo, ghi, cb << h);
    const u64 vbr = round_to_odd(glo, ghi, cbr << h);
    const u64 lower = vbl + (even ? 0 : 1);
    const u64 upper = vbr - (even ? 0 : 1);
    const u64 s = vb / 4;
    bool done = false;
    if (s >= 10) {
      const u64 sp = s / 10;
      const bool up_inside = lower <= 40 * sp;
      const bool wp_inside = 40 * sp + 40 <= upper;
      if (up_inside != wp_inside) {
        d = sp + (wp_inside ? 1 : 0);
        e = k + 1;
        done = true;
      }
    }
    if (!done) {
      const bool u_inside = lower <= 4 * s;
      const bool w_inside = 4 * s + 4 <= upper;
      if (u_inside != w_inside) {
        d = s + (w_inside ? 1 : 0);
      } else {
        const u64 mid = 4 * s + 2;
        const bool up = vb > mid || (vb == mid && (s & 1) != 0);
        d = s + (up ? 1 : 0);
      }
      e = k;
    }
  }
  while (d % 10 == 0) {
    d /= 10;
    e += 1;
  }
  *digits = d;
  *exp10 = e;
}

__global__ void format_double_kernel(const void* x, int f32, long long n,
                                     const u64* table, long long* digits,
                                     int* exp10) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    u64 c;
    int q, ex, sig, qmin;
    if (f32) {
      const u32 b = ((const u32*)x)[i];
      const u32 frac = b & 0x7FFFFFu;
      ex = (b >> 23) & 0xFF;
      sig = 24;
      qmin = -149;
      if (ex == 0xFF) ex = -1;
      c = ex > 0 ? (u64)(frac | 0x800000u) : (u64)frac;
      q = ex > 0 ? ex - 150 : -149;
    } else {
      const u64 b = ((const u64*)x)[i];
      const u64 frac = b & ((1ull << 52) - 1);
      ex = (int)((b >> 52) & 0x7FF);
      sig = 53;
      qmin = -1074;
      if (ex == 0x7FF) ex = -1;
      c = ex > 0 ? (frac | (1ull << 52)) : frac;
      q = ex > 0 ? ex - 1075 : -1074;
    }
    u64 d = 0;
    int e = 0;
    if (ex >= 0 && c != 0) to_decimal(c, q, sig, qmin, table, &d, &e);
    digits[i] = (long long)d;
    exp10[i] = e;
  }
}

// -- parse_double: the fast path ------------------------------------------------

struct W192 {
  u64 w[3];
};

__device__ __forceinline__ int bitlen192(const W192& x) {
  if (x.w[2]) return 192 - __clzll(x.w[2]);
  if (x.w[1]) return 128 - __clzll(x.w[1]);
  return 64 - __clzll(x.w[0]);
}

__device__ __forceinline__ u64 bit192(const W192& x, int i) {
  return (x.w[i >> 6] >> (i & 63)) & 1ull;
}

// whether any of bits [0, i) is set
__device__ __forceinline__ bool any_below192(const W192& x, int i) {
  const int wd = i >> 6, off = i & 63;
  for (int k = 0; k < wd; ++k)
    if (x.w[k]) return true;
  return off && (x.w[wd] & ((1ull << off) - 1));
}

// the low 64 bits of x >> s, 0 <= s < 192
__device__ __forceinline__ u64 shr192(const W192& x, int s) {
  const int wd = s >> 6, off = s & 63;
  u64 r = x.w[wd] >> off;
  if (off && wd + 1 < 3) r |= x.w[wd + 1] << (64 - off);
  return r;
}

// the bits of x * 2^E (x > 0, bit length past the format's precision),
// rounded to nearest, ties to even
__device__ u64 round192(const W192& x, int E, const Fmt& f) {
  const int L = bitlen192(x);
  const int etop = L - 1 + E;
  if (etop > f.emax) return f.inf;
  const int peff = etop >= f.emin ? f.p : f.p - (f.emin - etop);
  if (peff < 0) return 0;
  const int shift = L - peff;
  u64 m = shift < 192 ? shr192(x, shift) : 0;
  const u64 rb = bit192(x, shift - 1);
  const bool sticky = any_below192(x, shift - 1);
  if (rb && (sticky || (m & 1))) m += 1;
  u64 bits = etop >= f.emin ? ((u64)(etop + f.bias - 1) << (f.p - 1)) + m : m;
  return bits < f.inf ? bits : f.inf;
}

__device__ __forceinline__ W192 mul_64_128(u64 a, u64 glo, u64 ghi) {
  W192 r;
  const u64 a0 = a * glo, a1 = __umul64hi(a, glo);
  const u64 b0 = a * ghi, b1 = __umul64hi(a, ghi);
  const u64 s = a1 + b0;
  r.w[0] = a0;
  r.w[1] = s;
  r.w[2] = b1 + (s < a1 ? 1ull : 0ull);
  return r;
}

__device__ __forceinline__ W192 sub_small(W192 x, u64 v) {
  const u64 o = x.w[0];
  x.w[0] = o - v;
  if (o < v) {
    if (x.w[1]-- == 0) x.w[2]--;
  }
  return x;
}

__device__ __forceinline__ W192 add_128(W192 x, u64 lo, u64 hi) {
  const u64 s0 = x.w[0] + lo;
  const u64 c0 = s0 < lo;
  const u64 s1 = x.w[1] + hi;
  const u64 c1 = s1 < hi;
  const u64 s1c = s1 + c0;
  const u64 c2 = s1c < s1;
  x.w[0] = s0;
  x.w[1] = s1c;
  x.w[2] += c1 + c2;
  return x;
}

// -- parse_double: big integers for the rows the fast path cannot decide ------

struct Big {
  u32 w[NT_BN_WORDS];
  int n;
};

__device__ void big_mul_small(Big& a, u32 m) {
  u64 carry = 0;
  for (int k = 0; k < a.n; ++k) {
    const u64 t = (u64)a.w[k] * m + carry;
    a.w[k] = (u32)t;
    carry = t >> 32;
  }
  if (carry && a.n < NT_BN_WORDS) a.w[a.n++] = (u32)carry;
}

__device__ void big_add_small(Big& a, u32 v) {
  u64 carry = v;
  for (int k = 0; k < a.n && carry; ++k) {
    const u64 t = (u64)a.w[k] + carry;
    a.w[k] = (u32)t;
    carry = t >> 32;
  }
  if (carry && a.n < NT_BN_WORDS) a.w[a.n++] = (u32)carry;
}

__device__ void big_mul_pow5(Big& a, int k) {
  while (k >= 13) {
    big_mul_small(a, 1220703125u);   // 5^13
    k -= 13;
  }
  u32 m = 1;
  while (k-- > 0) m *= 5;
  if (m > 1) big_mul_small(a, m);
}

__device__ void big_shl(Big& a, int s) {
  if (a.n == 0 || s <= 0) return;
  const int wd = s >> 5, off = s & 31;
  int n = a.n + wd + 1;
  if (n > NT_BN_WORDS) n = NT_BN_WORDS;
  for (int k = n - 1; k >= 0; --k) {
    const int src = k - wd;
    u32 v = 0;
    if (src >= 0 && src < a.n) v = a.w[src] << off;
    if (off && src - 1 >= 0 && src - 1 < a.n) v |= a.w[src - 1] >> (32 - off);
    a.w[k] = v;
  }
  a.n = n;
  while (a.n > 0 && a.w[a.n - 1] == 0) a.n--;
}

__device__ int big_cmp(const Big& a, const Big& b) {
  if (a.n != b.n) return a.n < b.n ? -1 : 1;
  for (int k = a.n - 1; k >= 0; --k)
    if (a.w[k] != b.w[k]) return a.w[k] < b.w[k] ? -1 : 1;
  return 0;
}

__device__ void big_set(Big& a, u64 v) {
  a.n = 0;
  while (v) {
    a.w[a.n++] = (u32)v;
    v >>= 32;
  }
}

// the float after c (bits) or c itself: every digit of [i, j) against the
// halfway point between c and the float above it
__device__ u64 slow_path(const unsigned char* s, int i, int j, int ex, u64 c,
                         const Fmt& f) {
  const int ef = (int)(c >> (f.p - 1));
  u64 m;
  int e;
  if (ef) {
    m = (c & ((1ull << (f.p - 1)) - 1)) | (1ull << (f.p - 1));
    e = ef - f.bias - (f.p - 1);
  } else {
    m = c;
    e = f.emin - (f.p - 1);
  }
  Big L, R;
  L.n = 0;
  int nd = 0, frac = 0, dropped = 0, chunk_n = 0;
  u32 chunk = 0;
  bool sticky = false, point = false;
  const u32 pow10s[10] = {1u, 10u, 100u, 1000u, 10000u, 100000u, 1000000u,
                          10000000u, 100000000u, 1000000000u};
  for (int k = i; k < j; ++k) {
    const int ch = s[k];
    if (ch >= '0' && ch <= '9') {
      const int d = ch - '0';
      if (nd == 0 && d == 0) {
        if (point) frac++;
        continue;
      }
      if (nd < NT_MAX_DIGITS) {
        chunk = chunk * 10 + d;
        if (++chunk_n == 9) {
          big_mul_small(L, pow10s[9]);
          if (L.n == 0) big_set(L, chunk); else big_add_small(L, chunk);
          chunk = 0;
          chunk_n = 0;
        }
        if (point) frac++;
      } else {
        if (d) sticky = true;
        if (!point) dropped++;
      }
      nd++;
    } else if (ch == '.') {
      point = true;
    } else {
      break;
    }
  }
  if (chunk_n) {
    big_mul_small(L, pow10s[chunk_n]);
    if (L.n == 0) big_set(L, chunk); else big_add_small(L, chunk);
  }
  const int Q = ex - frac + dropped;
  big_set(R, 2 * m + 1);
  if (Q >= 0) big_mul_pow5(L, Q); else big_mul_pow5(R, -Q);
  const int sh = Q - (e - 1);
  if (sh > 0) big_shl(L, sh); else big_shl(R, -sh);
  const int cmp = big_cmp(L, R);
  if (cmp > 0 || (cmp == 0 && (sticky || (m & 1)))) return c + 1;
  return c;
}

// -- parse_double ---------------------------------------------------------------

__device__ __forceinline__ int lower_ascii(int c) {
  return (c >= 'A' && c <= 'Z') ? c + 32 : c;
}

// whether s[i, j) is `word` (lower case) in any case
__device__ __forceinline__ bool is_word(const unsigned char* s, int i, int j,
                                        const char* word, int len) {
  if (j - i != len) return false;
  for (int k = 0; k < len; ++k)
    if (lower_ascii(s[i + k]) != word[k]) return false;
  return true;
}

__global__ void parse_double_kernel(const int* offsets,
                                    const unsigned char* data,
                                    const bool* valid, long long n, int f32,
                                    const u64* table, void* out, bool* ok) {
  const Fmt f = fmt_of(f32);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    bool good = false;
    u64 bits = 0;
    if (valid[r]) {
      int i = offsets[r], j = offsets[r + 1];
      while (i < j && data[i] <= ' ') i++;
      while (j > i && data[j - 1] <= ' ') j--;
      u64 sign = 0;
      if (i < j && (data[i] == '+' || data[i] == '-')) {
        if (data[i] == '-') sign = 1ull << (f32 ? 31 : 63);
        i++;
      }
      if (is_word(data, i, j, "nan", 3)) {
        good = true;
        bits = f.nan;
      } else if (is_word(data, i, j, "inf", 3) ||
                 is_word(data, i, j, "infinity", 8)) {
        good = true;
        bits = sign | f.inf;
      } else {
        int jj = j;
        if (jj > i) {
          const int last = data[jj - 1];
          if (last == 'd' || last == 'D' || last == 'f' || last == 'F') jj--;
        }
        u64 w = 0;
        int nd = 0, frac = 0, dropped = 0, k = i;
        bool seen = false, point = false, sticky = false;
        for (; k < jj; ++k) {
          const int ch = data[k];
          if (ch >= '0' && ch <= '9') {
            seen = true;
            const int d = ch - '0';
            if (nd == 0 && d == 0) {
              if (point) frac++;
              continue;
            }
            if (nd < 19) {
              w = w * 10 + d;
              if (point) frac++;
            } else {
              if (d) sticky = true;
              if (!point) dropped++;
            }
            nd++;
          } else if (ch == '.' && !point) {
            point = true;
          } else {
            break;
          }
        }
        int ex = 0;
        bool syntax = seen;
        if (syntax && k < jj) {
          if (data[k] != 'e' && data[k] != 'E') {
            syntax = false;
          } else {
            k++;
            bool eneg = false;
            if (k < jj && (data[k] == '+' || data[k] == '-')) {
              eneg = data[k] == '-';
              k++;
            }
            if (k == jj) syntax = false;
            for (; syntax && k < jj; ++k) {
              const int ch = data[k];
              if (ch < '0' || ch > '9') {
                syntax = false;
              } else if (ex < 100000) {
                ex = ex * 10 + (ch - '0');
              }
            }
            if (eneg) ex = -ex;
          }
        }
        if (syntax) {
          good = true;
          const int q = ex - frac + dropped;
          const int lead = q + (nd < 19 ? nd : 19) - 1;
          if (w == 0) {
            bits = sign;
          } else if (lead > f.lmax) {
            bits = sign | f.inf;
          } else if (lead < f.lmin) {
            bits = sign;
          } else {
            const u64* g = table + 2 * (q - NT_POW10_MIN);
            const int E = floor_log2_pow10(q) - 127;
            const W192 P = mul_64_128(w, g[0], g[1]);
            const bool exact = q >= 0 && q <= 55;
            const W192 lo = exact ? P : sub_small(P, w);
            const W192 hi = sticky ? add_128(P, g[0], g[1]) : P;
            const u64 a = round192(lo, E, f);
            const u64 b = round192(hi, E, f);
            bits = sign | (a == b ? a : slow_path(data, i, jj, ex, a, f));
          }
        }
      }
    }
    if (f32) ((u32*)out)[r] = (u32)bits; else ((u64*)out)[r] = bits;
    ok[r] = good;
  }
}

// -- entry points (plain C) ------------------------------------------------------

static int grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return blocks < 1 ? 1 : (int)blocks;
}

extern "C" int format_double(const void* x, int f32, long long n,
                             const void* table, void* digits, void* exp10,
                             int threads, void* stream) {
  if (n <= 0) return 0;
  format_double_kernel<<<grid_for(n, threads), threads, 0,
                         (cudaStream_t)stream>>>(
      x, f32, n, (const u64*)table, (long long*)digits, (int*)exp10);
  return (int)cudaGetLastError();
}

extern "C" int parse_double(const void* offsets, const void* data,
                            const void* valid, long long n, int f32,
                            const void* table, void* out, void* ok,
                            int threads, void* stream) {
  if (n <= 0) return 0;
  parse_double_kernel<<<grid_for(n, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)offsets, (const unsigned char*)data, (const bool*)valid, n,
      f32, (const u64*)table, out, (bool*)ok);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
