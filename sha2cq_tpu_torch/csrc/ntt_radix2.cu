// K4: radix-2 NTT along the last axis of a (16, B, n) limb array.
//
// Replaces sha2cq_tpu/ops/ntt.py::_ntt_core and ntt_last_axis (jnp
// reshape/slice stages; the reference has no Pallas kernel for them): one
// bit-reversal gather, then k = log2(n) decimation-in-time stages.  Stage s
// views each column as (n / 2^{s+1}, 2, 2^s) blocks and turns every pair
// top = v[b, 0, j], bot = v[b, 1, j] into
//   t = mont_mul(bot, tw[j * n / 2^{s+1}]),  top' = top + t,  bot' = top - t
// all mod p, with the reference's add/sub/mont_mul rules word for word, so
// the output equals the reference's bit for bit.  Input limbs are int32 or
// int16 storage; output and twiddles (16, n/2) are int32 limbs.
//
// Bound: memory.  Every stage reads and writes the whole array, 64 B per
// element at int32 limbs, against one Montgomery multiply per pair, so a
// stage runs at the card's bandwidth and the whole transform costs k full
// passes.  Design, kept simple: one launch per stage, one thread per
// butterfly over B * n/2 threads, in place in the output.  Each limb plane is
// read and written coalesced across a warp (consecutive threads take
// consecutive j, hence consecutive addresses, for s >= 5; the first stages
// pair neighbouring elements and use half of each transaction).  The
// bit-reversal gather is fused into stage 0's loads, so the input is read
// once and never copied.  Shared-memory multi-stage tiles are later work.
#include <climits>

#include "field.cuh"

__device__ __forceinline__ long bitrev(long i, int k) {
  return (long)(__brev((unsigned)i) >> (32 - k));
}

template <typename T, bool FIRST>
__global__ void k4_stage(const T* __restrict__ src, int32_t* __restrict__ dst,
                         const int32_t* __restrict__ tw, long B, int k, int s,
                         Fp f) {
  const long hn = 1L << (k - 1);               // butterflies per column
  const long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (t >= B * hn) return;
  const long col = (t >> (k - 1)) << k;       // column start
  const long r = t & (hn - 1);
  const long half = 1L << s;
  const long j = r & (half - 1);
  const long top = ((r >> s) << (s + 1)) | j;
  const long bot = top + half;
  const long ls = B << k;                      // limb stride
  uint32_t x[8], y[8], w[8], m[8], o[8];
  if (FIRST) {
    load_limbs(x, src + col + bitrev(top, k), ls);
    load_limbs(y, src + col + bitrev(bot, k), ls);
  } else {
    load_limbs(x, dst + col + top, ls);
    load_limbs(y, dst + col + bot, ls);
  }
  load_limbs(w, tw + (j << (k - 1 - s)), hn);
  mont_mul(m, y, w, f);
  add_mod(o, x, m, f);
  store_limbs(dst + col + top, ls, o);
  sub_mod(o, x, m, f);
  store_limbs(dst + col + bot, ls, o);
}

// in: (16, B, 2^k) limbs (int16 storage when in_is16), out: (16, B, 2^k)
// int32, tw: (16, 2^(k-1)) int32 Montgomery twiddles; 1 <= k <= 30.
extern "C" int k4_ntt_radix2(const void* in, int in_is16, void* out,
                             const void* tw, long B, int k, const uint32_t* p8,
                             uint32_t n0, void* stream) {
  if (k < 1 || k > 30 || B < 1) return (int)cudaErrorInvalidValue;
  const Fp f = make_fp(p8, n0);
  const int threads = 256;
  const long blocks = ceil_div(B << (k - 1), threads);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  const int32_t* w = (const int32_t*)tw;
  if (in_is16)
    k4_stage<uint16_t, true><<<(unsigned)blocks, threads, 0, st>>>(
        (const uint16_t*)in, o, w, B, k, 0, f);
  else
    k4_stage<int32_t, true><<<(unsigned)blocks, threads, 0, st>>>(
        (const int32_t*)in, o, w, B, k, 0, f);
  cudaError_t e = cudaGetLastError();
  for (int s = 1; s < k && e == cudaSuccess; ++s) {
    k4_stage<int32_t, false><<<(unsigned)blocks, threads, 0, st>>>(
        o, o, w, B, k, s, f);
    e = cudaGetLastError();
  }
  return (int)e;
}
