// BN254 G1 point arithmetic for the port's CUDA kernels: Jacobian points
// over Fq in registers, with field.cuh's Montgomery product.  Shared by the
// device MSM (K5, K6: msm.cu) and the CQ tables' FK preprocessing (K7, K8:
// fk.cu).
//
// The formulas are the reference's curves/device.py::point_add:80 and
// point_double:64 (add-2007-bl, dbl-2009-l, the same edge-case rules), so
// every output equals the plain versions limb for limb.  The functions are
// inlined, so their Jacobian arguments stay in registers; only point_add's
// rare P = Q leg is out of line.  Everything is in an anonymous namespace:
// each source that includes this file has its own copy.
#pragma once

#include "field.cuh"

namespace {

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
__device__ __forceinline__ void pt_double(Jac& r, const Jac& p, const Fp& f) {
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

// point_add's double leg (P == Q), out of line: it is rare, and inlining
// it at each of K6's and K5's tree additions would add half again to the
// code those kernels stream through.  The mixed addition, K5's hot loop,
// keeps it inline (measured faster there: PERF.md).
__device__ __noinline__ void pt_double_leg(Jac& r, const Jac& p,
                                           const Fp& f) {
  pt_double(r, p, f);
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
__device__ __forceinline__ void pt_add(Jac& r, const Jac& p, const Jac& q,
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
    if (is_zero8(R)) pt_double_leg(r, p, f);
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
__device__ __forceinline__ void pt_add_affine(Jac& r, const Jac& p,
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

Curve make_curve(const uint32_t* p8, uint32_t n0, const uint32_t* one8) {
  Curve c;
  c.f = make_fp(p8, n0);
  for (int i = 0; i < 8; ++i) c.one[i] = one8[i];
  return c;
}

}  // namespace
