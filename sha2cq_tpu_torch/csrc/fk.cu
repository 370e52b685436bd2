// K7 and K8: the G1 kernels of the CQ tables' cached quotients, the
// Feist-Khovratovich route of plonk/static_tables.fk_cached_quotients.
//
// They replace no TPU kernel: the JAX package computes the cached
// quotients on the host (sha2cq_tpu/plonk/static_tables.py::
// fk_all_quotient_commitments, through the native g1_batch_scalar_mul and
// g1_group_ntt), and so did the port; these move that work to the card.
//   K7 `g1_scalar_mul`: out[e] = s[e mod n_sc] * P[e mod n_pts], e < n,
//      one thread a product (one SRS transform against several table
//      columns' scalars; one row of scales over several columns' points).
//   K8 `g1_ntt`: a radix-2 NTT over G1 points, out_k = sum_j w^{jk} P_j,
//      one launch a stage, in place, over input the wrapper has put in
//      bit-reversed order (curves/device.group_ntt): each thread one
//      butterfly (a, b) -> (a + w^i b, a - w^i b), the twiddle product
//      fused in; w^0 = 1 is skipped.
// Both are bound by operations.  A product by a scalar below 2^256 runs in
// fixed 4-bit windows from the top over a table of 1..15 * P (7
// doublings and 7 additions, in local memory): 252 doublings (7 products)
// and up to 64 additions (16 products), about 2,900 Montgomery products,
// against 96 bytes of point read and written and 32 of scalar.  A warp's
// threads take the same branches but for a zero window digit, so no
// thread waits on another's bits as in double-and-add.
#include "g1.cuh"

namespace {

constexpr int FK_THREADS = 128;

// r = s * p for s = sum_i s[i] 2^{32 i}.
__device__ __forceinline__ void scalar_mul(Jac& r, const Jac& p,
                                           const uint32_t s[8],
                                           const Curve& c) {
  Jac tab[16];
  tab[1] = p;
#pragma unroll 1
  for (int i = 2; i < 16; i += 2) {
    pt_double(tab[i], tab[i >> 1], c.f);
    pt_add(tab[i + 1], tab[i], p, c);
  }
  set_identity(r, c);
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {
    if (w != 63) dbl_n(r, 4, c.f);
    const uint32_t d = (s[w >> 3] >> (4 * (w & 7))) & 15u;
    if (d) pt_add(r, r, tab[d], c);
  }
}

// K7: e < n; points (16, n_pts) limbs a coordinate (Montgomery), scalars
// (16, n_sc) canonical limbs, outputs (16, n).
__global__ void __launch_bounds__(FK_THREADS)
k7_scalar_mul_kernel(const int32_t* __restrict__ px,
                     const int32_t* __restrict__ py,
                     const int32_t* __restrict__ pz, long n_pts,
                     const int32_t* __restrict__ sc, long n_sc, int32_t* ox,
                     int32_t* oy, int32_t* oz, long n, Curve c) {
  const long e = blockIdx.x * (long)FK_THREADS + threadIdx.x;
  if (e >= n) return;
  Jac p, r;
  load_jac(p, px, py, pz, e % n_pts, n_pts);
  uint32_t s[8];
  load_limbs(s, sc + e % n_sc, n_sc);
  scalar_mul(r, p, s, c);
  store_jac(ox, oy, oz, e, n, r);
}

// K8, stage s of a 2^k-point NTT over `cols` columns of (16, cols, 2^k)
// limbs a coordinate; tw: (16, 2^(k-1)) canonical w^i.  Thread t is
// butterfly b = t mod 2^(k-1) of column t / 2^(k-1): positions i and
// i + 2^s of its block of 2^(s+1), twiddle w^{(i mod 2^s) 2^(k-1-s)}.
__global__ void __launch_bounds__(FK_THREADS)
k8_ntt_stage_kernel(int32_t* x, int32_t* y, int32_t* z,
                    const int32_t* __restrict__ tw, long cols, int k, int s,
                    Curve c) {
  const long t = blockIdx.x * (long)FK_THREADS + threadIdx.x;
  const long halfm = 1L << (k - 1);
  if (t >= cols * halfm) return;
  const long b = t & (halfm - 1);
  const long lo = b & ((1L << s) - 1);
  const long i = ((t >> (k - 1)) << k) + ((b >> s) << (s + 1)) + lo;
  const long j = i + (1L << s);
  const long stride = cols << k;
  Jac a, q, u;
  load_jac(a, x, y, z, i, stride);
  load_jac(q, x, y, z, j, stride);
  const long wi = lo << (k - 1 - s);
  if (wi != 0) {
    uint32_t w[8];
    load_limbs(w, tw + wi, halfm);
    scalar_mul(u, q, w, c);
    q = u;
  }
  pt_add(u, a, q, c);
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  sub_mod(q.y, zero, q.y, c.f);                 // -w^i b
  pt_add(a, a, q, c);
  store_jac(x, y, z, i, stride, u);
  store_jac(x, y, z, j, stride, a);
}

}  // namespace

extern "C" int k7_g1_scalar_mul(const void* px, const void* py,
                                const void* pz, long n_pts,
                                const void* scalars, long n_sc, void* ox,
                                void* oy, void* oz, long n,
                                const uint32_t* p8, uint32_t n0,
                                const uint32_t* one8, void* stream) {
  if (n == 0) return 0;
  if (n_pts < 1 || n_sc < 1) return (int)cudaErrorInvalidValue;
  const Curve c = make_curve(p8, n0, one8);
  k7_scalar_mul_kernel<<<(unsigned)ceil_div(n, FK_THREADS), FK_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)px, (const int32_t*)py, (const int32_t*)pz, n_pts,
      (const int32_t*)scalars, n_sc, (int32_t*)ox, (int32_t*)oy,
      (int32_t*)oz, n, c);
  return (int)cudaGetLastError();
}

// All k stages, one launch each, in place on (x, y, z).
extern "C" int k8_g1_ntt(void* x, void* y, void* z, const void* tw,
                         long cols, long k, const uint32_t* p8, uint32_t n0,
                         const uint32_t* one8, void* stream) {
  if (cols == 0 || k == 0) return 0;
  if (k < 0 || k > 30) return (int)cudaErrorInvalidValue;
  const Curve c = make_curve(p8, n0, one8);
  const long threads = cols << (k - 1);
  for (int s = 0; s < k; ++s) {
    k8_ntt_stage_kernel<<<(unsigned)ceil_div(threads, FK_THREADS),
                          FK_THREADS, 0, (cudaStream_t)stream>>>(
        (int32_t*)x, (int32_t*)y, (int32_t*)z, (const int32_t*)tw, cols,
        (int)k, s, c);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}
