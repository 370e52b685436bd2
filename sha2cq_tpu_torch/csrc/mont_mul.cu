// K1: elementwise Montgomery multiplication of (16, *batch) limb arrays.
//
// Replaces sha2cq_tpu/ops/pallas_field.py::pallas_mont_mul (kernel
// _mont_mul_kernel, body _mont_mul_cols) and the jnp fields.device.mont_mul
// the reference's h path calls (ZETA pre-multiply, vanishing inverse, ZETA^-1
// pattern, the residual butterflies).
//
// Bound: memory.  A product reads 64 B (two 16-limb int32 elements) and
// writes 64 B against ~250 integer multiply-adds; at 3.35 TB/s that is ~26 G
// products/s of traffic versus far more integer throughput, so the design
// is one thread per element with each limb plane read and written fully
// coalesced (consecutive threads, consecutive addresses) and nothing staged
// in shared memory.  The second operand may be the same shape (b_mod = n), a
// broadcast scalar (b_mod = 1) or a row broadcast over the middle axis
// (b_mod = X): its element is i % b_mod, read from L1/L2 when it repeats.
#include "field.cuh"

__global__ void k1_mont_mul_kernel(const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ b,
                                   int32_t* __restrict__ out, long n,
                                   long b_stride, long b_mod, Fp f) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  load_limbs(x, a + i, n);
  load_limbs(y, b + (i % b_mod), b_stride);
  mont_mul(r, x, y, f);
  store_limbs(out + i, n, r);
}

extern "C" int k1_mont_mul(const void* a, const void* b, void* out, long n,
                           long b_stride, long b_mod, const uint32_t* p8,
                           uint32_t n0, void* stream) {
  const Fp f = make_fp(p8, n0);
  const int threads = 256;
  k1_mont_mul_kernel<<<(unsigned)ceil_div(n, threads), threads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n, b_stride, b_mod,
      f);
  return (int)cudaGetLastError();
}

extern "C" const char* k_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
