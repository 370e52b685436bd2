// K5 and K6: the device MSM's bucket sums and window reduction over BN254
// G1 (Jacobian points over Fq), the Pippenger of ops/msm.msm_device.
//
// Replaces sha2cq_tpu/ops/msm.py::_window_sums_v2 (called by msm_device):
//   K5 `msm_bucket_sums` its sort-by-digit, block-local and Hillis-Steele
//      prefix scans and bucket gather (:180-256), which give per window the
//      sum B_b of the points whose digit is b;
//   K6 `msm_window_reduce` its two suffix scans (:257-270), which give per
//      window sum_{b >= 1} b * B_b.
// The point formulas are the reference's curves/device.py::point_add:80 and
// point_double:64 (add-2007-bl, dbl-2009-l, the same edge-case rules), so
// every output equals the plain versions in ops/msm.py limb for limb.
//
// The scans exist in the reference only because XLA has no scatter-add of
// points.  Here the digits are sorted outside the kernels (torch.sort) and
// each bucket's segment of the sorted point indices is walked directly:
//
// K5: one thread per (window, bucket).  It walks its segment, gathers each
//   affine point (64 bytes, x then y in 32-bit words) and adds it into a
//   Jacobian sum with the mixed addition (the reference's point_add with
//   Z2 = 1, 11 products).  Bucket 0 (digit zero) is skipped.
//   Bound: operations.  n * nw mixed additions at 11 Montgomery products
//   each, against n * nw * 64 bytes of gathers; one thread per bucket keeps
//   the sum in registers with no synchronisation.  A skewed digit
//   distribution makes one thread's walk long (all scalars equal: one
//   thread walks n points); the result stays right, and splitting long
//   segments is the first thing a redesign does.
// K6: bucket b = p*T*L + j*T + t of a window goes to thread t of block p
//   (j < L), so neighbouring threads read neighbouring buckets.  A thread
//   forms its run's sum S = sum_j B and T * sum_j j*B by running sums
//   (2L - 1 additions, log2 T doublings); the block combines its threads in
//   a tree, W = W_l + W_r + 2^l S_r at level l, into a sum weighted from
//   the block's first bucket; a second launch combines the P blocks of a
//   window the same way, keeping the doublings of the offsets p*T*L for
//   one final log2(T*L) doublings.
//   Bound: operations, 2 * nw * 2^c Jacobian additions (16 products each),
//   against one read of the buckets.
#include "field.cuh"

namespace {

constexpr int K5_THREADS = 128;
constexpr int K6_MAX = 128;      // most threads of a K6 block (shared arrays)

struct Curve {
  Fp f;
  uint32_t one[8];               // Montgomery one, R mod q
};

struct Jac {
  uint32_t x[8], y[8], z[8];
};

__device__ __forceinline__ bool is_zero8(const uint32_t a[8]) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) o |= a[i];
  return o == 0;
}

__device__ __forceinline__ void copy8(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = a[i];
}

__device__ __forceinline__ void dbl2(uint32_t r[8], const uint32_t a[8],
                                     const Fp& f) {
  add_mod(r, a, a, f);
}

// The identity as the reference builds it: (one, one, 0).
__device__ __forceinline__ void set_identity(Jac& p, const Curve& c) {
  copy8(p.x, c.one);
  copy8(p.y, c.one);
#pragma unroll
  for (int i = 0; i < 8; ++i) p.z[i] = 0;
}

// point_double (and point_add's double leg); an identity stays Z = 0.
__device__ __noinline__ void pt_double(Jac& r, const Jac& p, const Fp& f) {
  uint32_t A[8], B[8], ZZ[8], C[8], t[8], u[8], Dd[8], E[8], F[8];
  uint32_t X3[8], Y3[8];
  mont_mul(A, p.x, p.x, f);
  mont_mul(B, p.y, p.y, f);
  mont_mul(ZZ, p.y, p.z, f);
  add_mod(u, p.x, B, f);
  mont_mul(C, B, B, f);
  mont_mul(t, u, u, f);
  sub_mod(u, t, A, f);
  sub_mod(u, u, C, f);
  dbl2(Dd, u, f);
  dbl2(E, A, f);
  add_mod(E, E, A, f);
  mont_mul(F, E, E, f);
  dbl2(u, Dd, f);
  sub_mod(X3, F, u, f);
  sub_mod(u, Dd, X3, f);
  mont_mul(Y3, E, u, f);
  dbl2(C, C, f);
  dbl2(C, C, f);
  dbl2(C, C, f);
  sub_mod(Y3, Y3, C, f);
  copy8(r.x, X3);
  copy8(r.y, Y3);
  dbl2(r.z, ZZ, f);
}

// The tail of point_add once H = U2 - U1 != 0: X3, Y3, Z3 from r = S2 - S1,
// U1, S1 and Z1*Z2.
__device__ __forceinline__ void add_tail(Jac& out, const uint32_t H[8],
                                         const uint32_t R[8],
                                         const uint32_t U1[8],
                                         const uint32_t S1[8],
                                         const uint32_t ZZ12[8],
                                         const Fp& f) {
  uint32_t HH[8], rr[8], HHH[8], V[8], u[8], T1[8], T2[8];
  mont_mul(HH, H, H, f);
  mont_mul(rr, R, R, f);
  mont_mul(HHH, H, HH, f);
  mont_mul(V, U1, HH, f);
  sub_mod(u, rr, HHH, f);
  dbl2(T1, V, f);
  sub_mod(out.x, u, T1, f);
  sub_mod(u, V, out.x, f);
  mont_mul(T1, R, u, f);
  mont_mul(T2, S1, HHH, f);
  mont_mul(out.z, ZZ12, H, f);
  sub_mod(out.y, T1, T2, f);
}

// point_add(p, q): p or q the identity -> the other; p == q -> double;
// p == -q -> identity.
__device__ __noinline__ void pt_add(Jac& r, const Jac& p, const Jac& q,
                                    const Curve& c) {
  const Fp& f = c.f;
  if (is_zero8(p.z)) { r = q; return; }
  if (is_zero8(q.z)) { r = p; return; }
  uint32_t Z1Z1[8], Z2Z2[8], U1[8], U2[8], S1[8], S2[8], H[8], R[8], t[8];
  mont_mul(Z1Z1, p.z, p.z, f);
  mont_mul(Z2Z2, q.z, q.z, f);
  mont_mul(U1, p.x, Z2Z2, f);
  mont_mul(U2, q.x, Z1Z1, f);
  mont_mul(t, q.z, Z2Z2, f);
  mont_mul(S1, p.y, t, f);
  mont_mul(t, p.z, Z1Z1, f);
  mont_mul(S2, q.y, t, f);
  sub_mod(H, U2, U1, f);
  sub_mod(R, S2, S1, f);
  if (is_zero8(H)) {
    if (is_zero8(R)) pt_double(r, p, f);
    else set_identity(r, c);
    return;
  }
  mont_mul(t, p.z, q.z, f);
  Jac out;
  add_tail(out, H, R, U1, S1, t, f);
  r = out;
}

// point_add(p, (x2, y2, one)): the mixed addition.  With Z2 = one the
// reference's Z2Z2, Z2*Z2Z2 and the products by them are exact copies, so
// leaving them out changes no output limb.
__device__ __noinline__ void pt_add_affine(Jac& r, const Jac& p,
                                           const uint32_t x2[8],
                                           const uint32_t y2[8],
                                           const Curve& c) {
  const Fp& f = c.f;
  if (is_zero8(p.z)) {
    copy8(r.x, x2);
    copy8(r.y, y2);
    copy8(r.z, c.one);
    return;
  }
  uint32_t Z1Z1[8], U2[8], S2[8], H[8], R[8], t[8];
  mont_mul(Z1Z1, p.z, p.z, f);
  mont_mul(U2, x2, Z1Z1, f);
  mont_mul(t, p.z, Z1Z1, f);
  mont_mul(S2, y2, t, f);
  sub_mod(H, U2, p.x, f);
  sub_mod(R, S2, p.y, f);
  if (is_zero8(H)) {
    if (is_zero8(R)) pt_double(r, p, f);
    else set_identity(r, c);
    return;
  }
  Jac out;
  add_tail(out, H, R, p.x, p.y, p.z, f);
  r = out;
}

__device__ __forceinline__ void dbl_n(Jac& p, int k, const Fp& f) {
  for (int i = 0; i < k; ++i) pt_double(p, p, f);
}

__device__ __forceinline__ void load_jac(Jac& p, const int32_t* bx,
                                         const int32_t* by, const int32_t* bz,
                                         long e, long stride) {
  load_limbs(p.x, bx + e, stride);
  load_limbs(p.y, by + e, stride);
  load_limbs(p.z, bz + e, stride);
}

__device__ __forceinline__ void store_jac(int32_t* ox, int32_t* oy,
                                          int32_t* oz, long e, long stride,
                                          const Jac& p) {
  store_limbs(ox + e, stride, p.x);
  store_limbs(oy + e, stride, p.y);
  store_limbs(oz + e, stride, p.z);
}

// K5.  pts: (n, 16) words, x then y (Montgomery), all zero for the
// identity; order: (nw, n) point indices sorted by digit; starts:
// (nw, m + 1) segment offsets; out: (16, nw * m) limbs per coordinate.
__global__ void __launch_bounds__(K5_THREADS)
k5_bucket_sums_kernel(const uint4* __restrict__ pts,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ starts, int32_t* ox,
                      int32_t* oy, int32_t* oz, int nw, long n, int m,
                      Curve c) {
  const long N = (long)nw * m;
  const long e = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (e >= N) return;
  const int w = (int)(e / m), b = (int)(e % m);
  Jac acc;
  set_identity(acc, c);
  if (b != 0) {
    const int32_t* seg = starts + (long)w * (m + 1) + b;
    const int32_t* ord = order + (long)w * n;
    const int end = seg[1];
    for (int k = seg[0]; k < end; ++k) {
      const uint4* q = pts + 4L * ord[k];
      const uint4 a0 = q[0], a1 = q[1], a2 = q[2], a3 = q[3];
      const uint32_t x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t y[8] = {a2.x, a2.y, a2.z, a2.w, a3.x, a3.y, a3.z, a3.w};
      if (is_zero8(x) && is_zero8(y)) continue;        // the identity
      pt_add_affine(acc, acc, x, y, c);
    }
  }
  store_jac(ox, oy, oz, e, N, acc);
}

// K6, first launch: grid (P, nw), T = 2^logT threads; part gets each
// block's (S, W) as 2 x 24 words.
__global__ void __launch_bounds__(K6_MAX)
k6_partials_kernel(const int32_t* __restrict__ bx,
                   const int32_t* __restrict__ by,
                   const int32_t* __restrict__ bz, uint32_t* part, int m,
                   int L, int logT, Curve c) {
  __shared__ Jac shS[K6_MAX], shW[K6_MAX];
  const int T = 1 << logT, t = threadIdx.x;
  const int p = blockIdx.x, w = blockIdx.y, P = gridDim.x;
  const long N = (long)gridDim.y * m;
  const long base = (long)w * m + (long)p * T * L + t;
  Jac run, acc, B;
  set_identity(run, c);
  set_identity(acc, c);
  for (int j = L - 1; j >= 1; --j) {
    load_jac(B, bx, by, bz, base + (long)j * T, N);
    pt_add(run, run, B, c);
    pt_add(acc, acc, run, c);
  }
  load_jac(B, bx, by, bz, base, N);
  pt_add(run, run, B, c);
  dbl_n(acc, logT, c.f);
  shS[t] = run;
  shW[t] = acc;
  __syncthreads();
  for (int l = 0; l < logT; ++l) {
    if ((t & ((2 << l) - 1)) == 0) {
      Jac S = shS[t], W = shW[t], SR = shS[t + (1 << l)];
      const Jac WR = shW[t + (1 << l)];
      pt_add(S, S, SR, c);
      pt_add(W, W, WR, c);
      dbl_n(SR, l, c.f);
      pt_add(W, W, SR, c);
      shS[t] = S;
      shW[t] = W;
    }
    __syncthreads();
  }
  if (t == 0) {
    Jac* dst = reinterpret_cast<Jac*>(part) + 2L * ((long)w * P + p);
    dst[0] = shS[0];
    dst[1] = shW[0];
  }
}

// K6, second launch: one block of P = 2^logP threads per window; the
// window's sum is W + 2^logR V, V = sum_p p S_p formed in the tree.
__global__ void __launch_bounds__(K6_MAX)
k6_combine_kernel(const uint32_t* __restrict__ part, int32_t* ox,
                  int32_t* oy, int32_t* oz, int logP, int logR, Curve c) {
  __shared__ Jac shS[K6_MAX], shV[K6_MAX], shW[K6_MAX];
  const int t = threadIdx.x, w = blockIdx.x, nw = gridDim.x;
  const Jac* src = reinterpret_cast<const Jac*>(part) +
                   2L * ((long)w * (1 << logP) + t);
  shS[t] = src[0];
  shW[t] = src[1];
  set_identity(shV[t], c);
  __syncthreads();
  for (int l = 0; l < logP; ++l) {
    if ((t & ((2 << l) - 1)) == 0) {
      const int o = t + (1 << l);
      Jac S = shS[t], V = shV[t], W = shW[t], SR = shS[o];
      const Jac VR = shV[o], WR = shW[o];
      pt_add(S, S, SR, c);
      pt_add(V, V, VR, c);
      dbl_n(SR, l, c.f);
      pt_add(V, V, SR, c);
      pt_add(W, W, WR, c);
      shS[t] = S;
      shV[t] = V;
      shW[t] = W;
    }
    __syncthreads();
  }
  if (t == 0) {
    Jac V = shV[0], W = shW[0];
    dbl_n(V, logR, c.f);
    pt_add(W, W, V, c);
    store_jac(ox, oy, oz, w, nw, W);
  }
}

Curve make_curve(const uint32_t* p8, uint32_t n0, const uint32_t* one8) {
  Curve c;
  c.f = make_fp(p8, n0);
  for (int i = 0; i < 8; ++i) c.one[i] = one8[i];
  return c;
}

}  // namespace

extern "C" int k5_msm_bucket_sums(const void* pts, const void* order,
                                  const void* starts, void* ox, void* oy,
                                  void* oz, long nw, long n, long m,
                                  const uint32_t* p8, uint32_t n0,
                                  const uint32_t* one8, void* stream) {
  const long N = nw * m;
  if (N == 0) return 0;
  k5_bucket_sums_kernel<<<(unsigned)ceil_div(N, K5_THREADS), K5_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const uint4*)pts, (const int32_t*)order, (const int32_t*)starts,
      (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int)nw, n, (int)m,
      make_curve(p8, n0, one8));
  return (int)cudaGetLastError();
}

extern "C" int k6_msm_window_reduce(const void* bx, const void* by,
                                    const void* bz, void* part, void* ox,
                                    void* oy, void* oz, long nw, long m,
                                    long L, long logT, long logP, long logR,
                                    const uint32_t* p8, uint32_t n0,
                                    const uint32_t* one8, void* stream) {
  if (nw == 0) return 0;
  if (logT > 7 || logP > 7) return (int)cudaErrorInvalidValue;
  const Curve c = make_curve(p8, n0, one8);
  const cudaStream_t s = (cudaStream_t)stream;
  k6_partials_kernel<<<dim3(1u << logP, (unsigned)nw), 1u << logT, 0, s>>>(
      (const int32_t*)bx, (const int32_t*)by, (const int32_t*)bz,
      (uint32_t*)part, (int)m, (int)L, (int)logT, c);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  k6_combine_kernel<<<(unsigned)nw, 1u << logP, 0, s>>>(
      (const uint32_t*)part, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz,
      (int)logP, (int)logR, c);
  return (int)cudaGetLastError();
}
