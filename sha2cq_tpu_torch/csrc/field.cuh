// BN254 field arithmetic for the port's CUDA kernels (sm_90a).
//
// Values live in device memory in the reference layout: (16, *batch) arrays
// of 16-bit limbs (int32 lanes, or uint16 for column stacks stored narrow),
// Montgomery form with R = 2^256.  A thread repacks its element into eight
// 32-bit words on load and back into 16-bit limbs on store, and computes on
// the words: 8x32-bit CIOS Montgomery multiplication on 64-bit products
// (mul.lo / mul.hi pairs).
//
// Bit-exactness with the reference (16-bit-digit REDC, one conditional
// subtract): for any a, b < 2^256, Montgomery reduction computes
// t = (a*b + m*p) / R with the unique m < R such that a*b + m*p = 0 mod R,
// whatever the digit size, so t is the reference's t; the low 256 bits are
// then conditionally reduced by p exactly as the reference does (its
// overflow limb is dropped for p < 2^255, i.e. Fr and Fq).  add and sub
// follow the reference's carry/borrow rules word for word.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct Fp {
  uint32_t p[8];   // modulus, little-endian 32-bit words
  uint32_t n0;     // -p^{-1} mod 2^32
};

// Limb element at `base`, limbs `stride` elements apart -> 8 words.
template <typename T>
__device__ __forceinline__ void load_limbs(uint32_t w[8], const T* base,
                                           long stride) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t lo = (uint32_t)base[(2 * i) * stride];
    uint32_t hi = (uint32_t)base[(2 * i + 1) * stride];
    w[i] = (lo & 0xFFFFu) | (hi << 16);
  }
}

__device__ __forceinline__ void store_limbs(int32_t* base, long stride,
                                            const uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    base[(2 * i) * stride] = (int32_t)(w[i] & 0xFFFFu);
    base[(2 * i + 1) * stride] = (int32_t)(w[i] >> 16);
  }
}

// r = (t >= p) ? t - p : t over 256 bits.
__device__ __forceinline__ void cond_sub_p(uint32_t r[8], const uint32_t t[8],
                                           const Fp& f) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)t[i] - f.p[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 63) & 1;
  }
  const bool ge = borrow == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = ge ? d[i] : t[i];
}

// Montgomery product r = a*b*R^{-1} (canonical for a < 2^256, b < p).
__device__ __forceinline__ void mont_mul(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8], const Fp& f) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a[i] * b[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * f.n0;
    s = (uint64_t)m * f.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * f.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  cond_sub_p(r, t, f);   // t[8], the overflow word, is dropped (p < 2^255)
}

// r = (a + b) mod p for canonical a, b: subtract p on carry-out or s >= p.
__device__ __forceinline__ void add_mod(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8], const Fp& f) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)v;
    c = v >> 32;
  }
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)s[i] - f.p[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 63) & 1;
  }
  const bool need_sub = (c != 0) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = need_sub ? d[i] : s[i];
}

// r = (a - b) mod p for canonical a, b: add p back on borrow-out.
__device__ __forceinline__ void sub_mod(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8], const Fp& f) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 63) & 1;
  }
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)d[i] + f.p[i] + c;
    s[i] = (uint32_t)v;
    c = v >> 32;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = borrow ? s[i] : d[i];
}

inline Fp make_fp(const uint32_t* p8, uint32_t n0) {
  Fp f;
  for (int i = 0; i < 8; ++i) f.p[i] = p8[i];
  f.n0 = n0;
  return f;
}

inline long ceil_div(long a, long b) { return (a + b - 1) / b; }
