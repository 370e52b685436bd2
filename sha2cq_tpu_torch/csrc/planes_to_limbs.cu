// K2: the digit-matmul NTT's fused epilogue.
//
// Replaces sha2cq_tpu/ops/pallas_field.py::planes_to_limbs_mul (kernel
// _epilogue_kernel, helpers _planes_to_limbs_cols, _sweep_cols).  Input: the
// (32, M, X) int32 digit planes of one int8 DFT product, plane q holding a
// nonnegative value below 2^31 of weight 2^{8q}; output: (16, M, X)
// canonical Montgomery limbs of V = sum_q plane[q] 2^{8q}, each multiplied
// by its twiddle or by a scale.
//
// Word form.  The reference builds byte columns, 16-bit limb columns, folds
// the bytes at positions 32..34 with 2^{8q} mod p and the 2^256 excess with
// R mod p in five rounds.  Here V is computed exactly in nine 32-bit words
// and reduced in one step:
//   V = A_0 + A_1 + A_2 + A_3,  A_b = sum_w plane[4w + b] 2^{32w + 8b},
// where word w of A_b is one funnel shift of planes 4(w-1)+b and 4w+b (a
// plane is below 2^31, so its two pieces never overlap), and the four are
// summed on carry chains.  V < 2^31 * 2^256 / 255 < 2^280, so T = V >> 224
// is below 2^56 and fits one 64-bit word.  With mu = floor(2^288 / p):
//   q = floor(T * mu / 2^64)        (one __umul64hi)
//   q <= T 2^224 / p, so q p <= V and v = V - q p >= 0;
//   q > T 2^224 / p - T / 2^64 - 1 > T 2^224 / p - 2, so
//   v < (V - T 2^224) + 2p < 2^224 + 2p < 2^256   (p < 2^254),
// and q <= T 2^224 / p < 2^280 / 2^248 = 2^32 fits one word (p > 2^248).
// v has V's residue and is below 2^256, which is all mont_mul needs for a
// canonical product (field.cuh), so the output equals the reference's bit
// for bit although v may differ from the reference's relaxed value.  The
// wrapper checks 2^248 < p < 2^254, which the bounds above use (Fr, Fq).
//
// Bound: memory.  An element reads 128 B of planes and 64 B of multiplier
// (cached when it repeats) and writes 64 B; per element the kernel issues
// about 27 funnel shifts, 27 adds, 16 products and 18 subtracts for V and
// its reduction, then one Montgomery product (264 multiply-add slots):
// 552-584 SASS instructions in all (tools/sass_count.py), against 1,712 and
// three calls into 64-bit division subroutines for the reference's form
// (byte columns, six 16-limb carry sweeps, 128 fold products, 64-bit
// indices).  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) it
// reaches 77-83% of its bytes bound at (32, 512, 2048).  Indices are
// 32-bit: x from blockIdx.x, rows m from blockIdx.y and threadIdx.y (a
// block holds several rows when X is small), the multiplier mode a
// template parameter, and a periodic multiplier's column a shift or a mask
// when its period is a power of two.
#include "field.cuh"

enum K2Mode { K2_TILE = 0, K2_MINOR = 1, K2_MAJOR = 2, K2_SCALAR = 3 };

template <int MODE>
__global__ void __launch_bounds__(256, 4)
k2_kernel(const uint32_t* __restrict__ planes,
          const int32_t* __restrict__ mult, int32_t* __restrict__ out, int M,
          int X, long MX, long mult_ls, int mult_ms, int period, int sh,
          Fp f, uint64_t mu) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= X) return;
  int col = 0;                          // the multiplier's column for x
  if (MODE == K2_MINOR) col = sh >= 0 ? (x & (period - 1)) : x % period;
  if (MODE == K2_MAJOR) col = sh >= 0 ? (x >> sh) : x / period;
  for (int m = blockIdx.y * blockDim.y + threadIdx.y; m < M;
       m += gridDim.y * blockDim.y) {
    const long e = (long)m * X + x;
    uint32_t pl[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) pl[q] = __ldg(planes + q * MX + e);

    uint32_t V[9];
#pragma unroll
    for (int w = 0; w < 8; ++w) V[w] = pl[4 * w];
    V[8] = 0;
#pragma unroll
    for (int b = 1; b < 4; ++b) {
      uint32_t A[9];
      A[0] = pl[b] << (8 * b);
#pragma unroll
      for (int w = 1; w < 8; ++w)
        A[w] = __funnelshift_l(pl[4 * w - 4 + b], pl[4 * w + b], 8 * b);
      A[8] = pl[28 + b] >> (32 - 8 * b);
      V[0] = add_cc(V[0], A[0]);
#pragma unroll
      for (int w = 1; w < 8; ++w) V[w] = addc_cc(V[w], A[w]);
      V[8] = addc(V[8], A[8]);
    }

    const uint64_t T = ((uint64_t)V[8] << 32) | V[7];
    const uint32_t q = (uint32_t)__umul64hi(T, mu);
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lo[i] = q * f.p[i];
      hi[i] = __umulhi(q, f.p[i]);
    }
    V[0] = sub_cc(V[0], lo[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) V[i] = subc_cc(V[i], lo[i]);
    V[8] = subc(V[8], 0);
    V[1] = sub_cc(V[1], hi[0]);
#pragma unroll
    for (int i = 2; i < 8; ++i) V[i] = subc_cc(V[i], hi[i - 1]);
    // V[8] - hi[7] - borrow is 0: v = V - q p < 2^256

    const int32_t* mp = mult;
    if (MODE == K2_TILE) mp = mult + e;
    if (MODE == K2_MINOR || MODE == K2_MAJOR) mp = mult + m * mult_ms + col;
    uint32_t b[8], r[8];
    load_limbs(b, mp, mult_ls);
    mont_mul(r, V, b, f);
    store_limbs(out + e, MX, r);
  }
}

// planes (32, M, X) int32, out (16, M, X) int32; mode: K2Mode; mult: a
// (16, M, X) tile, (16, M, period) read at column x % period (minor) or
// (16, M, X / period) read at column x / period (major), or a (16,) scalar;
// mult_ls / mult_ms: its limb and row strides; mu = floor(2^288 / p).
extern "C" int k2_planes_to_limbs_mul(const void* planes, const void* mult,
                                      void* out, int M, int X, int mode,
                                      long mult_ls, int mult_ms, int period,
                                      const uint32_t* p8, uint32_t n0,
                                      uint64_t mu, void* stream) {
  if (M < 1 || X < 1 || mode < 0 || mode > 3 || period < 1)
    return (int)cudaErrorInvalidValue;
  const Fp f = make_fp(p8, n0);
  const int sh = (period & (period - 1)) ? -1 : __builtin_ctz(period);
  int tx = 32;
  while (tx < 256 && tx < X) tx *= 2;
  const dim3 block(tx, 256 / tx);
  const long gy = ceil_div(M, block.y);
  const dim3 grid((unsigned)ceil_div(X, tx),
                  (unsigned)(gy < 65535 ? gy : 65535));
  const long MX = (long)M * X;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pl = (const uint32_t*)planes;
  const int32_t* mu32 = (const int32_t*)mult;
  int32_t* o = (int32_t*)out;
#define K2_LAUNCH(MODE)                                                     \
  k2_kernel<MODE><<<grid, block, 0, st>>>(pl, mu32, o, M, X, MX, mult_ls,   \
                                          mult_ms, period, sh, f, mu)
  switch (mode) {
    case K2_TILE: K2_LAUNCH(K2_TILE); break;
    case K2_MINOR: K2_LAUNCH(K2_MINOR); break;
    case K2_MAJOR: K2_LAUNCH(K2_MAJOR); break;
    default: K2_LAUNCH(K2_SCALAR); break;
  }
#undef K2_LAUNCH
  return (int)cudaGetLastError();
}
