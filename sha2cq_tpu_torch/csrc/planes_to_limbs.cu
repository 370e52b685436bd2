// K2: the digit-matmul NTT's fused epilogue.
//
// Replaces sha2cq_tpu/ops/pallas_field.py::planes_to_limbs_mul (kernel
// _epilogue_kernel, helpers _planes_to_limbs_cols, _sweep_cols).  Input: the
// (32, M, X) int32 digit planes of one int8 DFT product; output: (16, M, X)
// canonical Montgomery limbs, each multiplied by its twiddle or by a scale.
//
// Per element, in registers and in the reference's exact order: byte columns
// C_q = sum_u byte_u(plane[q-u]) for q < 36, 16-bit limb columns from byte
// pairs, the byte positions 32..34 folded in with 2^{8q} mod p, a carry
// sweep, five rounds folding the 2^256 excess with R mod p (the relaxed
// value, < 2^256), then one Montgomery multiply by the multiplier.
//
// Bound: memory.  An element reads 128 B of planes and 64 B of multiplier
// (cached when it repeats) and writes 64 B; the integer work (~700 ops) is
// far below the card's rate.  So: one thread per output element, every
// plane read coalesced across consecutive x, nothing in shared memory.  The
// multiplier is indexed in place -- element (m, x) reads
// mult[l, m, (x / div) % mod] -- so a per-element tile (div 1, mod X), a
// periodic twiddle block (x = b*m1 + t1: div 1, mod m1; x = t1*B + b: div B)
// and a broadcast scalar (m stride 0, mod 1) need no broadcast in memory.
// No shape gate: any M, X; the tail of the last block is masked.
#include "field.cuh"

struct Folds {
  uint32_t k[3][16];   // 16-bit limbs of 2^{8q} mod p, q = 32, 33, 34
  uint32_t r[16];      // 16-bit limbs of R mod p
};

__device__ __forceinline__ uint32_t sweep16(uint32_t limbs[16],
                                            const uint32_t cols[16]) {
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t v = cols[j] + carry;
    limbs[j] = v & 0xFFFFu;
    carry = v >> 16;
  }
  return carry;
}

__global__ void k2_kernel(const int32_t* __restrict__ planes,
                          const int32_t* __restrict__ mult,
                          int32_t* __restrict__ out, long M, long X,
                          long mult_limb_stride, long mult_m_stride,
                          long mult_div, long mult_mod, Fp f, Folds fc) {
  const long MX = M * X;
  const long e = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (e >= MX) return;
  const long m = e / X;
  const long x = e - m * X;

  uint32_t pl[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) pl[q] = (uint32_t)planes[q * MX + e];

  uint32_t C[36];
#pragma unroll
  for (int q = 0; q < 36; ++q) {
    uint32_t acc = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pi = q - u;
      if (pi >= 0 && pi < 32) acc += (pl[pi] >> (8 * u)) & 0xFFu;
    }
    C[q] = acc;
  }
  uint32_t cols[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) cols[t] = C[2 * t] + (C[2 * t + 1] << 8);

  uint32_t excess = 0;
#pragma unroll
  for (int qi = 0; qi < 3; ++qi) {
    const uint32_t h = C[32 + qi];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t prod = h * fc.k[qi][j];
      cols[j] += prod & 0xFFFFu;
      if (j + 1 < 16) cols[j + 1] += prod >> 16;
      else excess += prod >> 16;
    }
  }
  uint32_t limbs[16];
  excess += sweep16(limbs, cols);
#pragma unroll
  for (int round = 0; round < 5; ++round) {
    uint32_t nxt = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) cols[j] = limbs[j];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t prod = excess * fc.r[j];
      cols[j] += prod & 0xFFFFu;
      if (j + 1 < 16) cols[j + 1] += prod >> 16;
      else nxt = prod >> 16;
    }
    excess = nxt + sweep16(limbs, cols);
  }

  uint32_t a[8], b[8], r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = limbs[2 * i] | (limbs[2 * i + 1] << 16);
  load_limbs(b, mult + m * mult_m_stride + (x / mult_div) % mult_mod,
             mult_limb_stride);
  mont_mul(r, a, b, f);
  store_limbs(out + e, MX, r);
}

extern "C" int k2_planes_to_limbs_mul(const void* planes, const void* mult,
                                      void* out, long M, long X,
                                      long mult_limb_stride,
                                      long mult_m_stride, long mult_div,
                                      long mult_mod, const uint32_t* p8,
                                      uint32_t n0, const uint32_t* folds,
                                      void* stream) {
  const Fp f = make_fp(p8, n0);
  Folds fc;
  for (int q = 0; q < 3; ++q)
    for (int j = 0; j < 16; ++j) fc.k[q][j] = folds[16 * q + j];
  for (int j = 0; j < 16; ++j) fc.r[j] = folds[48 + j];
  const int threads = 256;
  k2_kernel<<<(unsigned)ceil_div(M * X, threads), threads, 0,
              (cudaStream_t)stream>>>(
      (const int32_t*)planes, (const int32_t*)mult, (int32_t*)out, M, X,
      mult_limb_stride, mult_m_stride, mult_div, mult_mod, f, fc);
  return (int)cudaGetLastError();
}
