// K5 and K6: the device MSM's bucket sums and window reduction over BN254
// G1 (Jacobian points over Fq), the Pippenger of ops/msm.msm_device.
//
// Replaces sha2cq_tpu/ops/msm.py::_window_sums_v2 (called by msm_device):
//   K5 `msm_bucket_sums` its sort-by-digit, block-local and Hillis-Steele
//      prefix scans and bucket gather (:180-256), which give per window the
//      sum B_b of the points whose digit is b;
//   K6 `msm_window_reduce` its two suffix scans (:257-270), which give per
//      window sum_{b >= 1} b * B_b.
// The point formulas (g1.cuh) are the reference's
// curves/device.py::point_add:80 and point_double:64 (add-2007-bl,
// dbl-2009-l, the same edge-case rules), so every output equals the plain
// versions in ops/msm.py limb for limb.
//
// The scans exist in the reference only because XLA has no scatter-add of
// points.  Here the digits are sorted outside the kernels (torch.sort), and
// K5 is a segmented reduction over each window's sorted point indices, so
// that its cost does not depend on how the digits are spread:
//
// K5: bound by operations, one mixed addition (11 products) for each
//   (point, window) with a nonzero digit, against 64 bytes of gather each.
//   Three steps, on one stream:
//   chunks: the window's live range [starts[w, 1], n) is cut into chunks of
//     S = K5_CHUNK sorted positions (32, chosen by measurement against 16
//     and 64, PERF.md); one thread adds its chunk's affine points in order
//     into a Jacobian sum (the mixed addition: the reference's point_add
//     with Z2 = one), closing a piece where the digit changes.  A bucket
//     that lies inside the chunk is written to the output; the chunk's
//     first piece, when its bucket began in an earlier chunk or goes on in
//     a later one, goes to head[chunk], and its last such piece to
//     tail[chunk]; key[chunk] is the chunk's first bucket.
//   tree: log2(chunks) launches; level l adds head[i + 2^l] into head[i]
//     (i a multiple of 2^(l+1)) when both chunks start in the same bucket,
//     so head[x] ends as the sum of the pieces of key[x] over chunks
//     [x, x + lowbit(x)).
//   finish: one thread a bucket; a bucket that spans chunks c0 < c1 is
//     tail[c0] (or head[c0] when it begins at c0's start) plus the tree's
//     nodes head[x], x = c0 + 1, x += lowbit(x), while x <= c1; an empty
//     bucket, and bucket 0, is the identity.
//   A thread adds at most S points and O(log n) Jacobian sums, whatever
//   the digits are: a bucket of 2^19 points is 2^19 / S chunks and a tree.
// K6: bound by operations, 2 * nw * 2^c Jacobian additions (16 products
//   each), against one read of the buckets.  Thread t of block p sums the
//   buckets p*T*L + j*T + t, j < L (L = K6_RUN, T = K6_THREADS, fewer for
//   a small window and more beyond 2^16 buckets: k6_shape; neighbouring
//   threads read neighbouring buckets), by running sums into S and
//   W = sum_j j * B_j (2L - 1 additions in one loop with one addition
//   site).  Its leaf is D = S and
//   V = T * W (log2 T doublings).  A pair (D, V) of s neighbouring threads
//   combines with its right neighbour as V = (V_l + V_r) + D_r,
//   D = 2 (D_l + D_r): one tree level, whose V and D two threads compute,
//   so every level keeps the threads of its nodes busy and no thread
//   doubles more than once a level.  The block tree gives each block's
//   D = T * S_p and V_p; a second launch, one block of P threads a window,
//   scales D by L (log2 L doublings) and runs the same tree over the
//   window's blocks, whose root V is the window's sum.
#include "g1.cuh"

namespace {

constexpr int K5_THREADS = 128;
constexpr int K5_CHUNK = 32;     // sorted positions a K5 thread adds
constexpr int K6_RUN = 16;       // buckets a K6 thread sums
constexpr int K6_THREADS = 32;   // threads of a K6 block
constexpr int K6_MAX = 128;      // most threads of a K6 block (shared arrays)

// A point in scratch memory: 24 words, x, y, z.
__device__ __forceinline__ void put_point(uint32_t* dst, const Jac& p) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(p.x[0], p.x[1], p.x[2], p.x[3]);
  d[1] = make_uint4(p.x[4], p.x[5], p.x[6], p.x[7]);
  d[2] = make_uint4(p.y[0], p.y[1], p.y[2], p.y[3]);
  d[3] = make_uint4(p.y[4], p.y[5], p.y[6], p.y[7]);
  d[4] = make_uint4(p.z[0], p.z[1], p.z[2], p.z[3]);
  d[5] = make_uint4(p.z[4], p.z[5], p.z[6], p.z[7]);
}

__device__ __forceinline__ void get_point(Jac& p, const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint32_t* w[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const uint4 v = s[i];
    uint32_t* o = w[i >> 1] + 4 * (i & 1);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}

// The bucket holding sorted position k >= st[1]: the largest b in [1, m)
// with st[b] <= k (st[m] = n > k).
__device__ __forceinline__ int bucket_of(const int32_t* st, int m, int k) {
  int lo = 1, hi = m - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (st[mid] <= k) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// K5, chunks.  pts: (n, 16) words, x then y (Montgomery), all zero for the
// identity; order: (nw, n) point indices sorted by digit; starts: (nw,
// m + 1) segment offsets; out: (16, nw * m) limbs per coordinate; head,
// tail: (nw, C) points; key: (nw, C).  Grid (ceil(C / K5_THREADS), nw).
__global__ void __launch_bounds__(K5_THREADS)
k5_chunks_kernel(const uint4* __restrict__ pts,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ starts, int32_t* ox,
                 int32_t* oy, int32_t* oz, uint32_t* head, uint32_t* tail,
                 int32_t* key, int n, int m, int C, Curve c) {
  const int w = blockIdx.y;
  const int j = blockIdx.x * K5_THREADS + threadIdx.x;
  if (j >= C) return;
  const int32_t* st = starts + (long)w * (m + 1);
  const int k0 = st[1] + j * K5_CHUNK;
  if (k0 >= n) return;
  const int k1 = min(k0 + K5_CHUNK, n);
  const int32_t* ord = order + (long)w * n;
  const long N = (long)gridDim.y * m;
  const long slot = (long)w * C + j;
  int b = bucket_of(st, m, k0);
  key[slot] = b;
  bool first = true;
  bool begun = st[b] >= k0;          // the piece's bucket begins in the chunk
  int end = st[b + 1];
  Jac acc;
  set_identity(acc, c);
  for (int k = k0;; ++k) {
    if (k == end || k == k1) {       // close the piece of bucket b
      if (begun && end <= k1) store_jac(ox, oy, oz, (long)w * m + b, N, acc);
      else put_point((first ? head : tail) + 24 * slot, acc);
      if (k == k1) break;
      first = false;
      begun = true;
      do end = st[++b + 1]; while (end <= k);   // skip empty buckets
      set_identity(acc, c);
    }
    const uint4* q = pts + 4L * ord[k];
    const uint4 a0 = q[0], a1 = q[1], a2 = q[2], a3 = q[3];
    const uint32_t x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const uint32_t y[8] = {a2.x, a2.y, a2.z, a2.w, a3.x, a3.y, a3.z, a3.w};
    if (is_zero8(x) && is_zero8(y)) continue;        // the identity
    pt_add_affine(acc, acc, x, y, c);
  }
}

// K5, tree level l: head[i] += head[i + 2^l] for i a multiple of 2^(l+1)
// when chunks i and i + 2^l start in the same bucket.  Grid
// (ceil(ceil(C / 2^(l+1)) / K5_THREADS), nw).
__global__ void __launch_bounds__(K5_THREADS)
k5_tree_kernel(uint32_t* head, const int32_t* __restrict__ key,
               const int32_t* __restrict__ starts, int n, int m, int C,
               int l, Curve c) {
  const int w = blockIdx.y;
  const long i = (long)(blockIdx.x * K5_THREADS + threadIdx.x) << (l + 1);
  const long j = i + (1L << l);
  const int s1 = starts[(long)w * (m + 1) + 1];
  if (j >= (n - s1 + K5_CHUNK - 1) / K5_CHUNK) return;   // live chunks
  const long base = (long)w * C;
  if (key[base + i] != key[base + j]) return;
  Jac a, q;
  get_point(a, head + 24 * (base + i));
  get_point(q, head + 24 * (base + j));
  pt_add(a, a, q, c);
  put_point(head + 24 * (base + i), a);
}

// K5, finish: one thread a (window, bucket).
__global__ void __launch_bounds__(K5_THREADS)
k5_finish_kernel(const uint32_t* __restrict__ head,
                 const uint32_t* __restrict__ tail,
                 const int32_t* __restrict__ key,
                 const int32_t* __restrict__ starts, int32_t* ox,
                 int32_t* oy, int32_t* oz, int nw, int m, int C, Curve c) {
  const long N = (long)nw * m;
  const long e = blockIdx.x * (long)K5_THREADS + threadIdx.x;
  if (e >= N) return;
  const int w = (int)(e / m), b = (int)(e % m);
  const int32_t* st = starts + (long)w * (m + 1);
  Jac acc;
  if (b == 0 || st[b] == st[b + 1]) {
    set_identity(acc, c);
    store_jac(ox, oy, oz, e, N, acc);
    return;
  }
  const int c0 = (st[b] - st[1]) / K5_CHUNK;
  const int c1 = (st[b + 1] - 1 - st[1]) / K5_CHUNK;
  if (c0 == c1) return;                    // written by the chunks step
  const long base = (long)w * C;
  int x;
  if (key[base + c0] == b) {               // b begins at chunk c0's start
    get_point(acc, head + 24 * (base + c0));
    x = c0 == 0 ? C : c0 + (c0 & -c0);
  } else {
    get_point(acc, tail + 24 * (base + c0));
    x = c0 + 1;
  }
  for (; x <= c1; x += x & -x) {
    Jac q;
    get_point(q, head + 24 * (base + x));
    pt_add(acc, acc, q, c);
  }
  store_jac(ox, oy, oz, e, N, acc);
}

// K6's tree over the n = blockDim.x pairs (D, V) in shared memory: at each
// level thread 2i forms node i's V = (V_l + V_r) + D_r and thread 2i + 1
// its D = 2 (D_l + D_r); the root lands in slot 0.  One addition and one
// doubling in the code: the two roles share them.
__device__ __forceinline__ void k6_tree(Jac* shD, Jac* shV, int n,
                                        const Curve& c) {
  const int t = threadIdx.x;
  const bool odd = t & 1;
  __syncthreads();
  for (int half = n >> 1; half >= 1; half >>= 1) {
    const int node = t >> 1;
    const bool active = t < 2 * half;
    Jac a, b;
    if (active) {
      a = odd ? shD[2 * node] : shV[2 * node];
      b = odd ? shD[2 * node + 1] : shV[2 * node + 1];
#pragma unroll 1
      for (int k = 0; k < (odd ? 1 : 2); ++k) {
        pt_add(a, a, b, c);
        b = shD[2 * node + 1];
      }
      if (odd) pt_double(a, a, c.f);
    }
    __syncthreads();
    if (active) (odd ? shD : shV)[node] = a;
    __syncthreads();
  }
}

__device__ __forceinline__ void select_jac(Jac& r, bool first, const Jac& a,
                                           const Jac& b) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.x[i] = first ? a.x[i] : b.x[i];
    r.y[i] = first ? a.y[i] : b.y[i];
    r.z[i] = first ? a.z[i] : b.z[i];
  }
}

// K6, runs: grid (P, nw), T threads; thread t of block p sums buckets
// p*T*L + j*T + t, j < L (neighbouring threads read neighbouring buckets).
// part gets each block's (D, V) as 2 x 24 words.
__global__ void __launch_bounds__(K6_MAX)
k6_runs_kernel(const int32_t* __restrict__ bx, const int32_t* __restrict__ by,
               const int32_t* __restrict__ bz, uint32_t* part, int m, int L,
               int logT, Curve c) {
  __shared__ Jac shD[K6_MAX], shV[K6_MAX];
  const int T = blockDim.x, t = threadIdx.x;
  const int p = blockIdx.x, w = blockIdx.y, P = gridDim.x;
  const long N = (long)gridDim.y * m;
  const long b0 = (long)w * m + (long)p * T * L + t;
  // 2L - 1 additions in one loop: even steps run += B_j (j from L - 1
  // down to 0), odd steps acc += run; the next bucket is loaded a step
  // ahead of its addition
  Jac run, acc, B, a, b;
  set_identity(run, c);
  set_identity(acc, c);
  load_jac(B, bx, by, bz, b0 + (long)(L - 1) * T, N);
#pragma unroll 1
  for (int s = 0; s < 2 * L - 1; ++s) {
    const bool to_acc = s & 1;
    select_jac(a, to_acc, acc, run);
    select_jac(b, to_acc, run, B);
    if (!to_acc && s + 2 < 2 * L - 1)
      load_jac(B, bx, by, bz, b0 + (long)(L - 2 - s / 2) * T, N);
    pt_add(a, a, b, c);
    if (to_acc) acc = a;
    else run = a;
  }
  // leaves: D = S_t, V = T * sum_j j B_j (the thread's runs are T apart)
  dbl_n(acc, logT, c.f);
  shD[t] = run;
  shV[t] = acc;
  k6_tree(shD, shV, T, c);
  if (t == 0) {
    uint32_t* dst = part + 48L * ((long)w * P + p);
    put_point(dst, shD[0]);
    put_point(dst + 24, shV[0]);
  }
}

// K6, windows: one block of P threads a window, the tree over its blocks'
// (D, V), D scaled from T * S_p to the block's span T * L * S_p first; the
// root's V is the window's sum.
__global__ void __launch_bounds__(K6_MAX)
k6_windows_kernel(const uint32_t* __restrict__ part, int32_t* ox,
                  int32_t* oy, int32_t* oz, int logL, Curve c) {
  __shared__ Jac shD[K6_MAX], shV[K6_MAX];
  const int t = threadIdx.x, P = blockDim.x, w = blockIdx.x;
  const uint32_t* src = part + 48L * ((long)w * P + t);
  Jac D;
  get_point(D, src);
  dbl_n(D, logL, c.f);
  shD[t] = D;
  get_point(shV[t], src + 24);
  k6_tree(shD, shV, P, c);
  if (t == 0) store_jac(ox, oy, oz, w, gridDim.x, shV[0]);
}

// K6's shape for m = 2^c buckets a window (ops/msm.k6_shape is the same
// rule): L = K6_RUN and T = K6_THREADS, fewer when the window is small, and
// T larger when P = m / (L T) blocks would exceed K6_MAX.  False when m is
// not a power of two or beyond K6_MAX^2 * K6_RUN (c > 18).
bool k6_shape(long m, long& L, long& T, long& P) {
  if (m < 1 || (m & (m - 1))) return false;
  L = m < K6_RUN ? m : K6_RUN;
  T = m / L < K6_THREADS ? m / L : K6_THREADS;
  if (m / (L * T) > K6_MAX) T = m / (L * K6_MAX);
  P = m / (L * T);
  return T <= K6_MAX;
}

}  // namespace

// head, tail: (nw, C) x 24 words and key (nw, C) int32 of scratch, C =
// ceil(n / K5_CHUNK).
extern "C" int k5_msm_bucket_sums(const void* pts, const void* order,
                                  const void* starts, void* ox, void* oy,
                                  void* oz, void* head, void* tail, void* key,
                                  long nw, long n, long m,
                                  const uint32_t* p8, uint32_t n0,
                                  const uint32_t* one8, void* stream) {
  if (nw == 0) return 0;
  if (m < 2 || n >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const Curve c = make_curve(p8, n0, one8);
  const cudaStream_t s = (cudaStream_t)stream;
  const long C = ceil_div(n, K5_CHUNK);
  if (C > 0) {
    k5_chunks_kernel<<<dim3((unsigned)ceil_div(C, K5_THREADS), (unsigned)nw),
                       K5_THREADS, 0, s>>>(
        (const uint4*)pts, (const int32_t*)order, (const int32_t*)starts,
        (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (uint32_t*)head,
        (uint32_t*)tail, (int32_t*)key, (int)n, (int)m, (int)C, c);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    for (int l = 0; (1L << l) < C; ++l) {
      const long pairs = ceil_div(C, 2L << l);
      k5_tree_kernel<<<dim3((unsigned)ceil_div(pairs, K5_THREADS),
                            (unsigned)nw), K5_THREADS, 0, s>>>(
          (uint32_t*)head, (const int32_t*)key, (const int32_t*)starts,
          (int)n, (int)m, (int)C, l, c);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  k5_finish_kernel<<<(unsigned)ceil_div(nw * m, K5_THREADS), K5_THREADS, 0,
                     s>>>((const uint32_t*)head, (const uint32_t*)tail,
                          (const int32_t*)key, (const int32_t*)starts,
                          (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, (int)nw,
                          (int)m, (int)C, c);
  return (int)cudaGetLastError();
}

// part: (nw, P) x 2 x 24 words of scratch, (L, T, P) = k6_shape(m).
extern "C" int k6_msm_window_reduce(const void* bx, const void* by,
                                    const void* bz, void* part, void* ox,
                                    void* oy, void* oz, long nw, long m,
                                    const uint32_t* p8, uint32_t n0,
                                    const uint32_t* one8, void* stream) {
  if (nw == 0) return 0;
  long L, T, P;
  if (!k6_shape(m, L, T, P)) return (int)cudaErrorInvalidValue;
  int logL = 0, logT = 0;
  while ((1L << logL) < L) ++logL;
  while ((1L << logT) < T) ++logT;
  const Curve c = make_curve(p8, n0, one8);
  const cudaStream_t s = (cudaStream_t)stream;
  k6_runs_kernel<<<dim3((unsigned)P, (unsigned)nw), (unsigned)T, 0, s>>>(
      (const int32_t*)bx, (const int32_t*)by, (const int32_t*)bz,
      (uint32_t*)part, (int)m, (int)L, logT, c);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  k6_windows_kernel<<<(unsigned)nw, (unsigned)P, 0, s>>>(
      (const uint32_t*)part, (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, logL,
      c);
  return (int)cudaGetLastError();
}
