// K4: radix-2 NTT along the last axis of a (16, B, n) limb array.
//
// Replaces sha2cq_tpu/ops/ntt.py::_ntt_core and ntt_last_axis (jnp
// reshape/slice stages; the reference has no Pallas kernel for them): one
// bit-reversal gather, then k = log2(n) decimation-in-time stages.  After the
// gather, position p of a column holds in[bitrev_k(p)]; stage s pairs every
// p whose bit s is 0 with p + 2^s and turns top = v[p], bot = v[p + 2^s] into
//   t = mont_mul(bot, tw[j << (k-1-s)]), j = p mod 2^s,
//   top' = top + t,  bot' = top - t          (all mod p)
// with the reference's add/sub/mont_mul.  Every output of those is canonical
// and the transform's value is unique mod p, so any schedule of the same
// butterflies gives the reference's limbs bit for bit.
//
// Passes.  Stages s0..s1-1 touch only bits s0..s1-1 of p, so they split a
// column into independent groups of G = 2^(s1-s0) points
//   p = hi 2^s1 + i 2^s0 + lo   (i < G; hi < 2^(k-s1), lo < 2^s0 fixed).
// A pass loads R such groups into shared memory (eight 32-bit words a point,
// at most 2^11 points: 64 KB), runs its stages there with one __syncthreads
// between stages, and writes the points back once.  The wrapper cuts the k
// stages into passes (ops/ntt.k4_passes): one pass up to k = 11; beyond,
// passes of at most 8 stages, so that a block holds 8 groups and reads each
// limb row in runs of 32 bytes (two passes up to k = 16, three up to
// k = 24).  Memory order:
// * the first pass (s0 = 0) fuses the bit-reversal into its load: with
//   u = bitrev(hi), position hi 2^s1 + bitrev_L(i') holds
//   in[i' 2^(k-s1) + u], so a block takes R consecutive u and reads runs of
//   R consecutive elements of every limb row; it writes each group's G
//   contiguous positions;
// * a later pass (s0 > 0) takes R consecutive lo, reads and writes runs of R
//   consecutive positions in place, and leaves natural order.
// Twiddles come from a (n/2, 8)-word table (one 32-byte sector a twiddle),
// built beside the (16, n/2) limb table (ops/ntt.twiddle_table).
//
// Bound: operations at the path's batches (one Montgomery product per
// butterfly against 2 x 64 B of HBM traffic per point and pass), latency at
// one column (two launches of 128 blocks at 2^14 points).  chip_smoke.py
// prints its time and share of that bound at every path shape; PERF.md
// keeps them with the card they were taken on.
#include <climits>

#include "field.cuh"

constexpr int K4_THREADS = 256;
constexpr int K4_MAX_LOG = 11;    // points a block may hold: 2^11 (64 KB);
                                  // ops/ntt.K4_TILE_LOG is the same
constexpr int K4_SMEM_MAX =       // 32 B a point plus a 16 B pad a group
    32 * (1 << K4_MAX_LOG) + 16 * (1 << (K4_MAX_LOG - 1));

__device__ __forceinline__ int bitrev(int i, int bits) {
  return bits ? (int)(__brev((unsigned)i) >> (32 - bits)) : 0;
}

__device__ __forceinline__ void ld8(uint32_t w[8], const uint4* s) {
  const uint4 a = s[0], b = s[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void st8(uint4* d, const uint32_t w[8]) {
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// One pass: stages s0..s1-1 on groups of 2^(s1-s0) points, 2^rlog groups a
// block.  FIRST: s0 == 0, reading `src` (int32 or int16 storage) through the
// bit-reversal; otherwise src == dst (in place).
template <typename T, bool FIRST>
__global__ void __launch_bounds__(K4_THREADS, 3)
k4_pass(const T* src, int32_t* dst, const uint4* __restrict__ tw, long B,
        int k, int s0, int s1, int rlog, Fp f) {
  extern __shared__ uint4 sm[];
  const int L = s1 - s0, G = 1 << L, R = 1 << rlog, E = R << L;
  const int gs = 2 * G + 1;             // uint4 a group: 16 B of pad apart
  const int hb = k - s1;                // bits of hi
  const long n = 1L << k, ls = B << k;  // column length, limb stride
  const long total = B << (k - L);      // groups in the array
  const long gid0 = (long)blockIdx.x << rlog;
  const bool g_fast_load = s0 > 0 || hb > 0;

  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    const int g = g_fast_load ? (t & (R - 1)) : (t >> L);
    const int i = g_fast_load ? (t >> rlog) : (t & (G - 1));
    const long gid = gid0 + g;
    if (gid >= total) continue;
    long off;
    int slot;
    if (FIRST) {
      off = (gid >> hb) * n + ((long)i << hb) + (gid & ((1L << hb) - 1));
      slot = bitrev(i, L);
    } else {
      const long lo = gid & ((1L << s0) - 1);
      const long hi = (gid >> s0) & ((1L << hb) - 1);
      off = (gid >> (s0 + hb)) * n + (hi << s1) + ((long)i << s0) + lo;
      slot = i;
    }
    uint32_t w[8];
    load_limbs(w, src + off, ls);
    st8(sm + g * gs + 2 * slot, w);
  }

  const long lo_mask = (1L << s0) - 1;
  for (int l = 0; l < L; ++l) {
    __syncthreads();
    const int s = s0 + l;
    for (int b = threadIdx.x; b < (E >> 1); b += blockDim.x) {
      const int g = b >> (L - 1);
      const int r = b & ((G >> 1) - 1);
      const int j = r & ((1 << l) - 1);
      const int it = ((r >> l) << (l + 1)) | j;
      const long twi = (((long)j << s0) + ((gid0 + g) & lo_mask)) << (k - 1 - s);
      uint4* pt = sm + g * gs + 2 * it;
      uint4* pb = pt + (2 << l);
      uint32_t x[8], y[8], w[8], m[8], o[8];
      ld8(x, pt);
      ld8(y, pb);
      ld8(w, tw + 2 * twi);
      mont_mul(m, y, w, f);
      add_mod(o, x, m, f);
      st8(pt, o);
      sub_mod(o, x, m, f);
      st8(pb, o);
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    const int g = s0 > 0 ? (t & (R - 1)) : (t >> L);
    const int i = s0 > 0 ? (t >> rlog) : (t & (G - 1));
    const long gid = gid0 + g;
    if (gid >= total) continue;
    long off;
    if (FIRST) {
      const int hi = bitrev((int)(gid & ((1L << hb) - 1)), hb);
      off = (gid >> hb) * n + ((long)hi << s1) + i;
    } else {
      const long lo = gid & ((1L << s0) - 1);
      const long hi = (gid >> s0) & ((1L << hb) - 1);
      off = (gid >> (s0 + hb)) * n + (hi << s1) + ((long)i << s0) + lo;
    }
    uint32_t w[8];
    ld8(w, sm + g * gs + 2 * i);
    store_limbs(dst + off, ls, w);
  }
}

template <typename T, bool FIRST>
static cudaError_t launch_pass(const T* src, int32_t* dst, const uint4* tw,
                               long B, int k, int s0, int s1, int rlog,
                               const Fp& f, cudaStream_t st) {
  const int L = s1 - s0;
  const long E = 1L << (L + rlog);
  const long blocks = ceil_div(B << (k - L), 1L << rlog);
  const int smem = (int)(32 * E + 16 * (1L << rlog));
  if (blocks > INT_MAX || smem > K4_SMEM_MAX) return cudaErrorInvalidValue;
  static unsigned long long attr_set = 0;   // devices this kernel may use
  int dev = 0;                               // > 48 KB of shared memory on
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && !(attr_set >> dev & 1)) {
    e = cudaFuncSetAttribute(k4_pass<T, FIRST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K4_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr_set |= 1ULL << dev;
  }
  long threads = E / 2;
  threads = threads < 32 ? 32 : threads > K4_THREADS ? K4_THREADS : threads;
  k4_pass<T, FIRST><<<(unsigned)blocks, (unsigned)threads, smem, st>>>(
      src, dst, tw, B, k, s0, s1, rlog, f);
  return cudaGetLastError();
}

// in: (16, B, 2^k) limbs (int16 storage when in_is16); out: (16, B, 2^k)
// int32; tw: (2^(k-1), 8) words of the Montgomery twiddles; passes: npass
// triples (s0, s1, rlog) that cut stages 0..k-1 in order, each pass at most
// 2^K4_MAX_LOG points a block.  1 <= k <= 30.
extern "C" int k4_ntt_radix2(const void* in, int in_is16, void* out,
                             const void* tw, long B, int k, int npass,
                             const int* passes, const uint32_t* p8,
                             uint32_t n0, void* stream) {
  if (k < 1 || k > 30 || B < 1 || npass < 1)
    return (int)cudaErrorInvalidValue;
  for (int q = 0, s = 0; q < npass; ++q) {   // the passes cut 0..k in order
    const int* ps = passes + 3 * q;
    if (ps[0] != s || ps[1] <= ps[0] || ps[2] < 0 ||
        ps[1] - ps[0] + ps[2] > K4_MAX_LOG)
      return (int)cudaErrorInvalidValue;
    s = ps[1];
    if (q == npass - 1 && s != k) return (int)cudaErrorInvalidValue;
  }
  const Fp f = make_fp(p8, n0);
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  const uint4* w = (const uint4*)tw;
  cudaError_t e;
  if (in_is16)
    e = launch_pass<uint16_t, true>((const uint16_t*)in, o, w, B, k, 0,
                                    passes[1], passes[2], f, st);
  else
    e = launch_pass<int32_t, true>((const int32_t*)in, o, w, B, k, 0,
                                   passes[1], passes[2], f, st);
  for (int q = 1; q < npass && e == cudaSuccess; ++q)
    e = launch_pass<int32_t, false>(o, o, w, B, k, passes[3 * q],
                                    passes[3 * q + 1], passes[3 * q + 2], f,
                                    st);
  return (int)e;
}
