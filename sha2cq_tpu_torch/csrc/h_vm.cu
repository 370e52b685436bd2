// K3: the h-fold bytecode VM, one thread per extended-domain row.
//
// Counterpart of sha2cq_tpu/plonk/h_vm.py::_vm_scan (a lax.scan over a
// lax.switch; the reference has no Pallas kernel for it).  The program is
// the reference assembler's (N, 4) int32 stream (op, a, b, dst) over a
// register file; a plain PyTorch interpreter would launch several kernels
// per instruction (~10^5 small launches per prove at SHA-256 shapes), this
// kernel launches once.
//
// Design: every thread runs the whole program for its own row.  The
// instruction stream and the scalar table (repacked to 8 words) are staged
// in shared memory once per block; the register file is per-thread local
// memory (indexed by the instruction, so it cannot live in registers);
// the current result is computed into a temporary before it is written to
// `dst`, because dst may reuse an operand's register.  Opcodes, as in the
// reference:
//   0..7  dst <- column a of group op, rolled by b (jnp.roll semantics:
//         out[j] = col[(j - b) mod n]); groups advice, instance, fixed,
//         sigma, z, lk, st, aux, each (16, C, n) int32 or uint16 limbs
//   8     dst <- scalar b
//   9-11  dst <- r[a] + r[b], r[a] - r[b], r[a] * r[b]
//   12-14 dst <- r[a] + s[b], r[a] - s[b], r[a] * s[b]
//   15    dst <- s[b] - r[a]
//
// Bound: integer multiply rate and latency.  The SHA-256 k=13 program has
// 1322 instructions per row (480 Montgomery multiplies of ~130 64-bit
// multiply-adds each, 316 column loads) over 16384 rows; each column load is
// a coalesced 16-limb gather.  One thread per row gives only ~16k threads, a
// few warps per SM, so latency is not hidden by occupancy; it ran in 0.89 ms
// on an H100 80GB HBM3 at a 700 W power limit.  More row parallelism (or
// splitting a row's work across threads) is later work.
#include "field.cuh"

struct VmGroups {
  const void* p[8];
  int cols[8];
  int is16[8];
};

template <int MAXREG>
__global__ void k3_kernel(const int32_t* __restrict__ instrs, int n_instr,
                          const int32_t* __restrict__ scal, int n_scal,
                          VmGroups g, int32_t* __restrict__ out, long n,
                          int out_reg, Fp f) {
  extern __shared__ uint32_t smem[];
  int4* sins = reinterpret_cast<int4*>(smem);
  uint32_t* ssc = smem + 4 * n_instr;
  for (int i = threadIdx.x; i < n_instr; i += blockDim.x)
    sins[i] = reinterpret_cast<const int4*>(instrs)[i];
  for (int i = threadIdx.x; i < n_scal; i += blockDim.x) {
    uint32_t w[8];
    load_limbs(w, scal + i, (long)n_scal);
#pragma unroll
    for (int k = 0; k < 8; ++k) ssc[8 * i + k] = w[k];
  }
  __syncthreads();

  const long j = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (j >= n) return;

  uint32_t regs[MAXREG][8];
  for (int pc = 0; pc < n_instr; ++pc) {
    const int4 ins = sins[pc];
    const int op = ins.x, a = ins.y, b = ins.z, dst = ins.w;
    uint32_t r[8];
    if (op < 8) {
      long src = (j - b) % n;
      if (src < 0) src += n;
      const long ls = (long)g.cols[op] * n;
      const long off = (long)a * n + src;
      if (g.is16[op])
        load_limbs(r, reinterpret_cast<const uint16_t*>(g.p[op]) + off, ls);
      else
        load_limbs(r, reinterpret_cast<const int32_t*>(g.p[op]) + off, ls);
    } else if (op == 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = ssc[8 * b + k];
    } else {
      uint32_t x[8], y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = regs[a][k];
      if (op <= 11) {
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = regs[b][k];
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = ssc[8 * b + k];
      }
      switch (op) {
        case 9: case 12: add_mod(r, x, y, f); break;
        case 10: case 13: sub_mod(r, x, y, f); break;
        case 11: case 14: mont_mul(r, x, y, f); break;
        default: sub_mod(r, y, x, f); break;   // 15: s[b] - r[a]
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) regs[dst][k] = r[k];
  }
  store_limbs(out + j, n, regs[out_reg]);
}

template <int MAXREG>
static int launch(const int32_t* instrs, int n_instr, const int32_t* scal,
                  int n_scal, const VmGroups& g, int32_t* out, long n,
                  int out_reg, const Fp& f, cudaStream_t stream) {
  const size_t smem = (size_t)n_instr * 16 + (size_t)n_scal * 32;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k3_kernel<MAXREG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 64;
  k3_kernel<MAXREG><<<(unsigned)ceil_div(n, threads), threads, smem, stream>>>(
      instrs, n_instr, scal, n_scal, g, out, n, out_reg, f);
  return (int)cudaGetLastError();
}

extern "C" int k3_h_vm_run(const void* instrs, int n_instr, const void* scal,
                           int n_scal, const uint64_t* group_ptrs,
                           const int* group_cols, const int* group_is16,
                           void* out, long n, int out_reg, int n_reg,
                           const uint32_t* p8, uint32_t n0, void* stream) {
  const Fp f = make_fp(p8, n0);
  VmGroups g;
  for (int i = 0; i < 8; ++i) {
    g.p[i] = reinterpret_cast<const void*>(group_ptrs[i]);
    g.cols[i] = group_cols[i];
    g.is16[i] = group_is16[i];
  }
  const int32_t* ins = (const int32_t*)instrs;
  const int32_t* sc = (const int32_t*)scal;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_reg <= 32) return launch<32>(ins, n_instr, sc, n_scal, g, o, n, out_reg, f, s);
  if (n_reg <= 64) return launch<64>(ins, n_instr, sc, n_scal, g, o, n, out_reg, f, s);
  if (n_reg <= 128) return launch<128>(ins, n_instr, sc, n_scal, g, o, n, out_reg, f, s);
  if (n_reg <= 256) return launch<256>(ins, n_instr, sc, n_scal, g, o, n, out_reg, f, s);
  return (int)cudaErrorInvalidValue;
}
