// BN254 field arithmetic for the port's CUDA kernels (sm_90a).
//
// Values live in device memory in the reference layout: (16, *batch) arrays
// of 16-bit limbs (int32 lanes, or uint16 for column stacks stored narrow),
// Montgomery form with R = 2^256.  A thread repacks its element into eight
// 32-bit words on load and back into 16-bit limbs on store, and computes on
// the words: 8x32-bit CIOS Montgomery multiplication on PTX carry chains
// (ptx.cuh), and add/sub with the same chains.
//
// Bit-exactness with the reference (16-bit-digit REDC, one conditional
// subtract): for any a, b < 2^256, Montgomery reduction computes
// t = (a*b + m*p) / R with the unique m < R such that a*b + m*p = 0 mod R,
// whatever the digit size, so t is the reference's t; t is then
// conditionally reduced by p exactly as the reference does.  For p < 2^255
// (Fr, Fq) t < 2^256 and the reference's overflow limb is 0; for a wide
// modulus, p > 2^255 (secp256k1's Fp and Fq; FieldCtx.wide), t may reach
// 2^256 and the template instance WIDE = true keeps that ninth word, as the
// reference's `ctx.wide` branch keeps its overflow limb
// (sha2cq_tpu/fields/device.py:376-382).  add and sub follow the
// reference's carry/borrow rules word for word (they serve p < 2^255 only).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

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

// r = (t >= p) ? t - p : t for t = t8 * 2^256 + t[0..8).  Narrow (p <
// 2^255): t8 is 0 and not read.  WIDE: t8 is 0 or 1, and t8 = 1 means
// t >= 2^256 > p; t < 2p, so the 256-bit difference is all of t - p.
template <bool WIDE = false>
__device__ __forceinline__ void cond_sub_p(uint32_t r[8], const uint32_t t[8],
                                           const Fp& f, uint32_t t8 = 0) {
  uint32_t d[8];
  d[0] = sub_cc(t[0], f.p[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) d[i] = subc_cc(t[i], f.p[i]);
  bool ge;
  if constexpr (WIDE) {
    // t8 - borrow: 0xFFFFFFFF only for t8 = 0 with a borrow out (t < p)
    ge = subc(t8, 0) != 0xFFFFFFFFu;
  } else {
    ge = subc(0, 0) == 0;                 // no borrow out
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = ge ? d[i] : t[i];
}

// acc[0..8) += x[k] * y at word offsets 2k (x = the even or odd words of a
// 256-bit operand): one carry chain, whose carry-out is added into *top.
// With carry_in, the chain also takes the carry flag left by the caller.
template <bool CARRY_IN>
__device__ __forceinline__ void mac_chain(uint32_t acc[8], uint32_t* top,
                                          uint32_t x0, uint32_t x1,
                                          uint32_t x2, uint32_t x3,
                                          uint32_t y) {
  acc[0] = CARRY_IN ? madc_lo_cc(x0, y, acc[0]) : mad_lo_cc(x0, y, acc[0]);
  acc[1] = madc_hi_cc(x0, y, acc[1]);
  acc[2] = madc_lo_cc(x1, y, acc[2]);
  acc[3] = madc_hi_cc(x1, y, acc[3]);
  acc[4] = madc_lo_cc(x2, y, acc[4]);
  acc[5] = madc_hi_cc(x2, y, acc[5]);
  acc[6] = madc_lo_cc(x3, y, acc[6]);
  acc[7] = madc_hi_cc(x3, y, acc[7]);
  *top = addc(*top, 0);
}

// Montgomery product r = a*b*R^{-1} (canonical for a < 2^256, b < p).
//
// CIOS over 32-bit words with the running sum split in two, so that every
// round runs four short carry chains instead of one long one:
//   t = E + L + 2^32 * O,
// where E collects the products of the even words (a[2k], p[2k]) at word
// offsets 2k and O those of the odd words at offsets 2k (its weight 2^32
// makes them land at 2k + 1), and L is one pending word.  A round adds
// a*b[i] and m*p (m = t * n0 mod 2^32), which clears word 0 of E, and then
// divides by 2^32 by renaming alone: E' = O, L' = E[1], O' = E >> 64.
// Bound on E and O, for any p < 2^256 (narrow or WIDE) and a, b < 2^256:
// a mac_chain adds x * y with x = sum_k x_k 2^{64k} < 2^256 and y < 2^32,
// so less than 2^256, and a round adds two chains to each of E and O, less
// than 2^257.  They start as the halves of a * b[0], each below 2^256.
// From round 1 on, a round starts with E < 2^258 and O < 2^195: it leaves
// E < 2^259 and O < 2^258, so E' = O < 2^258 and O' = E >> 64 < 2^195.
// Every value stays far below the 2^288 of nine words: e8 and o8 never
// wrap.  Nothing here depends on p < 2^255; only t's final bound does.
//
// The chains on E and on O are independent, and each is 8 dependent
// multiply-adds long (the old single chain ran through all 16 products of a
// round), so a warp has multiply-adds to issue while a chain waits.
//
// The result is t = (a*b + m*p) / R < (R*b + R*p) / R = b + p, reduced by
// one conditional subtraction: canonical for b < p.  Narrow (p < 2^255):
// t < 2^256, so t's ninth word (e8 + the carry) is 0 and is not formed.
// WIDE (2^255 < p < 2^256): t < 2^257 and its ninth word, 0 or 1, goes to
// cond_sub_p<true>.
template <bool WIDE = false>
__device__ __forceinline__ void mont_mul(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8], const Fp& f) {
  uint32_t E[8], O[8], e8, o8, L;
  {
    const uint32_t bi = b[0];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      E[2 * k] = mul_lo(a[2 * k], bi);
      E[2 * k + 1] = mul_hi(a[2 * k], bi);
      O[2 * k] = mul_lo(a[2 * k + 1], bi);
      O[2 * k + 1] = mul_hi(a[2 * k + 1], bi);
    }
    e8 = 0;
    o8 = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i > 0) {
      const uint32_t bi = b[i];
      E[0] = add_cc(E[0], L);            // its carry has O's weight 2^32
      mac_chain<true>(O, &o8, a[1], a[3], a[5], a[7], bi);
      mac_chain<false>(E, &e8, a[0], a[2], a[4], a[6], bi);
    }
    const uint32_t m = E[0] * f.n0;
    mac_chain<false>(E, &e8, f.p[0], f.p[2], f.p[4], f.p[6], m);
    mac_chain<false>(O, &o8, f.p[1], f.p[3], f.p[5], f.p[7], m);
    // E[0] is now 0: divide by 2^32
    L = E[1];
    uint32_t shifted[8];
#pragma unroll
    for (int k = 0; k < 6; ++k) shifted[k] = E[k + 2];
    shifted[6] = e8;
    shifted[7] = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      E[k] = O[k];
      O[k] = shifted[k];
    }
    e8 = o8;
    o8 = 0;
  }
  // t = E + L + 2^32 * O, where O[7] = 0 after the last renaming
  uint32_t t[8];
  t[0] = add_cc(E[0], L);
#pragma unroll
  for (int k = 1; k < 8; ++k) t[k] = addc_cc(E[k], O[k - 1]);
  if constexpr (WIDE) {
    cond_sub_p<true>(r, t, f, addc(e8, O[7]));
  } else {
    cond_sub_p(r, t, f);
  }
}

// r = (a + b) mod p for canonical a, b: subtract p on carry-out or s >= p.
__device__ __forceinline__ void add_mod(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8], const Fp& f) {
  uint32_t s[8], d[8];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) s[i] = addc_cc(a[i], b[i]);
  const uint32_t c = addc(0, 0);
  d[0] = sub_cc(s[0], f.p[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) d[i] = subc_cc(s[i], f.p[i]);
  const uint32_t borrow = subc(0, 0);     // all ones on borrow
  const bool need_sub = (c != 0) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = need_sub ? d[i] : s[i];
}

// r = (a - b) mod p for canonical a, b: add p back on borrow-out.
__device__ __forceinline__ void sub_mod(uint32_t r[8], const uint32_t a[8],
                                        const uint32_t b[8], const Fp& f) {
  uint32_t d[8], s[8];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) d[i] = subc_cc(a[i], b[i]);
  const bool borrow = subc(0, 0) != 0;
  s[0] = add_cc(d[0], f.p[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) s[i] = addc_cc(d[i], f.p[i]);
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
