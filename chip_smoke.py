#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sha2cq_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

--parent DIR: DIR holds an older tree of the repo (its sha2cq_tpu_torch/);
its kernel library is built too, and its K1, K2, K3 and K4 (under this
tree's wrappers: their C entries are unchanged) are timed against this
tree's on the same inputs, in turns (old, new, new, old); so are its K5 and
K6 (called with the C arguments of the tree before K5's chunked redesign)
on the 2^20-point commit's inputs, and its K5 once on the 0/1 column's.

Phases, each printing its own line (any failure exits nonzero; no phase
catches an error and goes on):

1. toolchain and card: nvidia-smi name and power limit, torch.version.cuda,
   nvcc --version, and the build of csrc/*.cu (one nvcc per source, all at
   once; seconds, ptxas report);
2. kernels K1 (mont_mul), K2 (planes_to_limbs_mul), K4 (ntt_radix2) and
   K3 (h_vm_run) each against its plain PyTorch version on the card at the
   main path's shapes, bit for bit, with both times (CUDA events), its
   bound (the larger of its bytes over the HBM rate and its 32-bit
   multiply-adds over the card's integer multiply-add rate) and its share
   of the bound: K2 at the k=18 coset route's (32, 512, 2048) in all four
   multiplier modes and at the k=13 residual level's (32, 32, 32768); K4
   at the k=13 c2e batch, one column and int16 input, at the k=9
   butterfly route's l2c, c2e and e2c shapes, and on one 64-column chunk
   at k=18's extended size 2^19 (8 columns held against the plain
   version); K3 on the SHA-256 program at the k=13 shape (16384
   extended rows) and at the k=18 coset shape (2^18 rows, the rot_scale=1
   program); the NTT plans built on the card (the m=512 digit matrix, the
   k=18 c2e twiddle tensor) against the host-built ones, bit for bit, with
   both build times; K5 (msm_bucket_sums) and K6 (msm_window_reduce) at the
   device MSM's bucket shape (2^12 points, the path's window bits), each
   against its plain version on the same inputs: affine equality of every
   bucket / window sum on the card, and their limbs bit for bit; and the
   CQ tables' cached quotients (cq_fk_phase): the device FK route equal to
   the host route (native FK) on a 2^10-row column, a sigma half-table of
   circuit32 (5 columns of 2^16 rows) through StaticTableValues.many cold
   and warm (the warm run's K7 and K8 launches), then K7 (g1_scalar_mul)
   over (5, 2^17) against the native host batch product, and K8 (g1_ntt)
   at 2^17 and 2^16 points over 5 columns, column 0 against the native
   host group NTT and every column brought back by the inverse transform;
   affine points bit for bit, with ms, bound and share;
3. SHA-256 circuit32 / SCHEME8 at k=9, one block: under each h route
   (butterfly -- the auto route at k=9 --, monolithic digit-matmul,
   coset-streamed) the proof with h on the card is byte-identical to the
   port's host-path proof and verifies; the butterfly prove launches K4;
4. the slice: circuit32 / SCHEME8 at k=13 with 110 chained blocks (the
   flagship's constraint system and device shapes: n = 8192, ext = 16384):
   setup, keygen (its h program is the one K3 ran in phase 2), the
   h forward of each route on the same random inputs (bit-identical; ms and
   peak memory), the kernel breakdown of one h pass, one cold and one warm
   create_proof(device="cuda") with profiler phases,
   verify_proof(...).check(), and K1-K3 launched by each prove;
5. the full-width path: circuit32 / SCHEME8 at k=18 with 2048 chained
   blocks (n = 2^18, ext = 2^19, rs = 2): setup, keygen, one
   create_proof(device="cuda") (auto: the coset-streamed route; its
   program is the one K3 ran at 2^18 rows in phase 2) with profiler phases,
   verify_proof(...).check(), K1-K3 launched by the prove, and the coset
   and forced monolithic h forwards on the same inputs (bit-identical; ms
   and peak memory);
6. the device MSM at full width: a 2^20-point SRS made natively
   (poly/kzg/params._g1_powers_of_s, OpenMP), 2^20 random full-width
   coefficients, ParamsKZG.commit on the card (msm() -> msm_device -> K5 ->
   K6 -> host fold) cold and warm, equal to the native host Pippenger
   (ops/msm.msm_host) on the same packed basis; K5 and K6 launched by both
   commits, K1 by the cold one alone (it fills the device basis cache,
   basis_cached 0 in its msm_basis span) and none by the warm one, which
   reads the cached words (basis_cached 1); the pack-and-digit seconds, the host seconds, the SRS build
   seconds, the peak device bytes; commits of a 0/1 column, a 16-bit
   column and one scalar for every point (each puts half or all of a
   window's points in one bucket) against the host MSM, both timed; at the
   path's window bits K5 and K6 against their plain versions on each
   column's own points, digits and bucket layout (affine and limb
   equality, ms, bound and share beside the longest bucket; the kernels
   line reports the uniform commit's); K5 / K6 device ms (CUDA events)
   with bound and share at window bits 14, 15 and 16; and K5 on every
   skewed layout and at c = 14 within 1.5x of its uniform time;
7. secp256k1 on the card (K1w, the wide-modulus instance of K1): at 2^20
   elements of SecpFp and of SecpFq, operands with edge values first
   (p - 1, R mod p, 2^256 - 1 as a, pairs whose REDC result t reaches
   2^256), against its plain version bit for bit, with ms, bound and share;
   then to_mont -> pow_const -> inv -> from_mont on 4096 elements of each
   field on the card, equal to Python's integers, K1w launched by it;
8. the generic-limb SHA-2 circuit (models/sha/circuit.py) at MINI_LIMBS,
   k=7: MockProver satisfied and a wrong digest rejected; the proof with h
   on the card equals the port's host-path proof and verifies;
9. the mesh (parallel/distributed.py), on four shards of this card, and
   again on every card of the machine where it has more than one: the
   k=13 and k=18 route comparisons of phases 4 and 5 include the mesh h
   module (bit-identical to the other routes' h: at k=18 beside the coset
   route and the butterfly route, which runs at k=18 nowhere else; ms and
   peak); then the sharded MSM on phase 6's 2^20-point SRS and uniform
   scalars (2^18 points a shard, the reference's window bits for them),
   its folded window sums equal to msm_device's and msm_host's point, with
   time, peak bytes and K5 / K6 launches per shard; the sharded gate at
   2^20 rows against its plain version; K3 over a k=13 shard's extended
   rows and K4 on a shard's c2e batch against their plain versions;
   distributed_ntt at k=20 (R = C = 2^10) bit for bit against the
   single-card NTT and the native host NTT, both timed;
   run_program_sharded against run_program on the k=13 program at 16384
   rows; and the slice proved through create_proof(mesh=...) cold and
   warm, byte-identical to phase 4's single-card proofs under the same
   seeds, verified, with K1, K3 and K4 launched on every shard and K2 and
   K1w on none.  The kernels line gives each kernel's `mesh_launches` on
   the four-shard mesh, read from both of its measured runs: `prove` (the
   warm mesh prove) and `msm` (the sharded MSM), each in all (`per_run`)
   and a shard (`per_shard`), and their sums under the same two names.

Phases 3-5 prove with the h inputs staged (plonk/device_eval.StagedStacks:
the advice, instance and CQ f stacks packed into pinned memory and copied
on a side stream while the CQ and permutation phases run); each prove
prints its h_stage_advice, h_stage_f, h_pack_inputs and h_device seconds,
and phase 4 also proves once with the staging function replaced by a
no-op: the same bytes, and the pack it then pays, stack by stack.

The last lines are the card's name and power limit, the kernels JSON object
and the result object {"ok": true, "device": {...}}.
Imports nothing of JAX: `jax` and `sha2cq_tpu` are blocked in sys.modules
before the port loads.  Needs only sha2cq_tpu_torch/ (and native/fieldops.c)
beside it.
"""
import argparse
import gc
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
K_SMALL = 9
K_SLICE, BLOCKS_SLICE = 13, 110
K_BIG, BLOCKS_BIG = 18, 2048
K_MSM = 20           # the device MSM's full width: HOST_THRESHOLD points
MSM_SMALL = 1 << 12  # points of phase 2's K5 / K6 check
C2E_COLUMNS = 212    # the slice's c2e batch: 123 advice + 1 instance + 8 z + 80 CQ
MESH_SHARDS = 4      # phase 9's mesh on one card: four shards of it
K_DNTT = 20          # phase 9's distributed NTT and sharded gate: 2^20
SEED = 0x5256
# Bounds (H100 SXM data sheet): HBM 3.35 TB/s;
# float32 67 TFLOP/s is 132 SMs x 128 lanes x 2 flops x 1.98 GHz, and a
# 32-bit integer multiply-add issues on half of those lanes, 16.75 T/s.
HBM_BYTES_PER_S = 3.35e12
INT_MADS_PER_S = 67e12 / 4
MONT_MADS = 264      # one 8x32-bit Montgomery product: 128 lo/hi pairs + 8 m
MIXED_ADD_PRODUCTS = 11      # a mixed Jacobian addition, 7M + 4S (K5)
JAC_ADD_PRODUCTS = 16        # a Jacobian addition, 12M + 4S (K6)
DBL_PRODUCTS = 7             # a Jacobian doubling, 2M + 5S (K7, K8)
# phase 2f: one sigma half-table of circuit32 (5 columns of 2^16 rows) over
# a TableSRS from the secret of cardbench/configs/sha256_w32_cq_tables.json
CQ_ROWS, CQ_COLUMNS = 1 << 16, 5
CQ_SECRET = 0x5BE0CD191F83D9AB9B05688C510E527FA54FF53A3C6EF372BB67AE856A09E667
ROUTES = {                       # create_proof flags forcing each h route
    "butterfly": {"h_mxu": False},
    "monolithic": {"h_mxu": True, "h_cosets": False},
    "coset": {"h_mxu": True, "h_cosets": True},
}
KERNELS = {                      # name: (source, the TPU-side code it replaces)
    "mont_mul": ("sha2cq_tpu_torch/csrc/mont_mul.cu",
                 "sha2cq_tpu/ops/pallas_field.py:70"),
    "planes_to_limbs_mul": ("sha2cq_tpu_torch/csrc/planes_to_limbs.cu",
                            "sha2cq_tpu/ops/pallas_field.py:185"),
    "h_vm_run": ("sha2cq_tpu_torch/csrc/h_vm.cu",
                 "sha2cq_tpu/plonk/h_vm.py:340"),
    "ntt_radix2": ("sha2cq_tpu_torch/csrc/ntt_radix2.cu",
                   "sha2cq_tpu/ops/ntt.py:65"),
    "msm_bucket_sums": ("sha2cq_tpu_torch/csrc/msm.cu",
                        "sha2cq_tpu/ops/msm.py:169"),
    "msm_window_reduce": ("sha2cq_tpu_torch/csrc/msm.cu",
                          "sha2cq_tpu/ops/msm.py:257"),
    "mont_mul_wide": ("sha2cq_tpu_torch/csrc/mont_mul.cu",
                      "sha2cq_tpu/fields/device.py:332"),
    # K7 and K8 replace host code: the JAX package's FK is native C
    "g1_scalar_mul": ("sha2cq_tpu_torch/csrc/fk.cu",
                      "sha2cq_tpu/plonk/static_tables.py:244"),
    "g1_ntt": ("sha2cq_tpu_torch/csrc/fk.cu",
               "sha2cq_tpu/plonk/static_tables.py:245"),
}
STAGING_MARKS = ("create_proof/h_stage_advice", "create_proof/h_stage_f",
                 "h_pack_inputs", "h_device")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls captured in one CUDA graph
    and replayed: no host work between launches, so a kernel that takes
    less time than its wrapper's Python is timed on the card alone."""
    import torch
    fn()                               # builds and caches outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int, mesh) -> float:
    """Mean host-clock ms of fn() over iters calls (after one warm-up),
    each run ending in a synchronise of every card of the mesh: the time of
    work that spans cards."""
    fn()
    mesh.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    mesh.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def timed_once(fn):
    """(fn(), its device ms) for one call: for plain versions too slow to
    run twice."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(nbytes: float, mads: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the 32-bit multiply-adds over the integer rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = mads / INT_MADS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def msm_work(live: int, nw: int, m: int):
    """(bytes, multiply-adds) of K5 and of K6: K5 one mixed addition for
    each of the `live` (point, window) pairs with a nonzero digit, each
    reading its point's 64 bytes; K6 2 * nw * m Jacobian additions over
    nw * m buckets of 96 bytes."""
    return ((64 * live, live * MIXED_ADD_PRODUCTS * MONT_MADS),
            (96 * nw * m, 2 * nw * m * JAC_ADD_PRODUCTS * MONT_MADS))


def same_points(a, b) -> bool:
    """Whether two Jacobian batches on the card hold the same affine points,
    lane by lane: both the identity, or X1 Z2^2 = X2 Z1^2 and
    Y1 Z2^3 = Y2 Z1^3 (products by K1)."""
    from sha2cq_tpu_torch.fields import device as D
    a = [t.reshape(16, -1) for t in a]
    b = [t.reshape(16, -1) for t in b]
    z1s, z2s = D.mont_mul(a[2], a[2], D.FQ), D.mont_mul(b[2], b[2], D.FQ)
    ex = D.eq(D.mont_mul(a[0], z2s, D.FQ), D.mont_mul(b[0], z1s, D.FQ))
    ey = D.eq(D.mont_mul(a[1], D.mont_mul(z2s, b[2], D.FQ), D.FQ),
              D.mont_mul(b[1], D.mont_mul(z1s, a[2], D.FQ), D.FQ))
    ia, ib = D.is_zero(a[2]), D.is_zero(b[2])
    return bool(((ia & ib) | (~ia & ~ib & ex & ey)).all())


def scalar_mul_products(s: int) -> int:
    """Montgomery products of K7's product by s (csrc/fk.cu): the table of
    1..15 P (7 doublings, 7 additions), 252 doublings and an addition for
    each nonzero 4-bit window of s."""
    nonzero = sum(d != "0" for d in f"{s:064x}")
    return (7 + 252) * DBL_PRODUCTS + (7 + nonzero) * JAC_ADD_PRODUCTS


def ntt_work(m: int, cols: int, twiddles: list):
    """(bytes, multiply-adds) of K8's group NTT of m points over cols
    columns: each stage's butterflies read and write two points and read a
    twiddle, and make two additions and a product by their twiddle where it
    is not w^0 (twiddles: w^0 .. w^{m/2 - 1})."""
    k = m.bit_length() - 1
    products = sum(
        (m // 2 >> s) * (2 * JAC_ADD_PRODUCTS + (
            scalar_mul_products(twiddles[lo << (k - 1 - s)]) if lo else 0))
        for s in range(k) for lo in range(1 << s))
    return k * cols * (m // 2) * (4 * 96 + 32), cols * products * MONT_MADS


def jac_words_on(words, shape, dev):
    """A point batch on dev (Montgomery limbs) from the native layout:
    (m, 12) u64 words, canonical x, y, z of four words each."""
    import numpy as np
    import torch
    from sha2cq_tpu_torch.fields import device as D
    t = torch.from_numpy(np.ascontiguousarray(words).view(np.int16)).to(dev)
    limbs = t.t().to(D.LIMB) & D.MASK                       # (48, m)
    return tuple(D.to_mont(limbs[16 * i:16 * (i + 1)].contiguous(), D.FQ)
                 .reshape(16, *shape) for i in range(3))


def cq_fk_phase(dev, record) -> dict:
    """Phase 2f: the CQ tables' cached quotients on the card (plonk/
    static_tables.fk_cached_quotients).  The route against the host route
    (native FK) on a column of DEVICE_MIN_ROWS rows, point for point; one
    sigma half-table of circuit32 (CQ_COLUMNS columns of CQ_ROWS rows)
    through StaticTableValues.many cold (the B_hat fill) and warm; then at
    the route's shapes, on the warm run's B_hat: K7's t_hat * B_hat over
    (CQ_COLUMNS, 2 CQ_ROWS) with random scalars against the native host
    batch product on the same inputs, and K8's group NTTs of 2 CQ_ROWS and
    CQ_ROWS points over CQ_COLUMNS columns, column 0 against the native
    host group NTT and every column brought back by the inverse transform
    and 1/m.  Affine points bit for bit.  Returns the warm table's
    launches (counts set to 0 just before it)."""
    import numpy as np
    import torch
    from sha2cq_tpu_torch import native_loader as NL
    from sha2cq_tpu_torch.curves import device as CD
    from sha2cq_tpu_torch.fields.host import FR_MOD
    from sha2cq_tpu_torch.models.sha import tables32
    from sha2cq_tpu_torch.ops import cuda_field as CF
    from sha2cq_tpu_torch.plonk import static_tables as ST
    from sha2cq_tpu_torch.poly.kzg import params as KP
    n, cols = CQ_ROWS, CQ_COLUMNS
    n2 = 2 * n
    rng = random.Random(SEED + 2)
    t0 = time.perf_counter()
    srs = KP._g1_powers_of_s(CQ_SECRET % FR_MOD, n)
    srs_s = time.perf_counter() - t0

    vals = [rng.randrange(1 << 16) for _ in range(ST.DEVICE_MIN_ROWS)]
    card = ST.StaticTableValues(vals, srs).qs
    route = ST.fk_device
    ST.fk_device = lambda size: None
    try:
        host = ST.StaticTableValues(vals, srs).qs
    finally:
        ST.fk_device = route
    say("cq_route", rows=len(vals), equal_to_host_fk=card == host,
        srs_points=n, srs_s=srs_s)
    if card != host:
        fail("the device FK route differs from the host route (native FK)")

    columns = list(tables32.sigma_half_columns(
        tables32.SCHEME32, "bs0", hi=True).values())
    ST._device_srs_cache.clear()
    runs = {}
    for run in ("cold", "warm"):
        CF.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ST.StaticTableValues.many(columns, srs)
        runs[run] = dict(seconds=time.perf_counter() - t0,
                         launches={k: v for k, v in CF.launches.items() if v})
    launches = dict(CF.launches)
    say("cq_table", table="bs0h", rows=n, columns=len(columns), **runs)
    if launches["g1_scalar_mul"] != 2 or launches["g1_ntt"] != 2:
        fail(f"a warm table launched K7 {launches['g1_scalar_mul']} and K8 "
             f"{launches['g1_ntt']} times, not 2 and 2")

    # K7: t_hat * B_hat, the products of one table
    B = ST._device_srs_ntt(srs, n, dev)
    ints = [rng.randrange(FR_MOD) for _ in range(cols * n2)]
    ints[:3] = [0, 1, FR_MOD - 1]
    sc = CD.raw_limbs(ints).reshape(16, cols, n2).to(dev)
    out = CD.batch_scalar_mul(B, sc)
    words = NL.np_jac_from_tuples(CD._host_points(B))
    sw = NL._np_u64_limbs(ints, 4).reshape(cols, n2, 4)
    t0 = time.perf_counter()
    ref = np.concatenate([NL.native_batch_scalar_mul_np(words, sw[c])
                          for c in range(cols)])
    host_ms = (time.perf_counter() - t0) * 1e3
    mads = sum(scalar_mul_products(v) for v in ints) * MONT_MADS
    record("g1_scalar_mul", CD.to_affine(out),
           CD.to_affine(jac_words_on(ref, (cols, n2), dev)),
           cuda_time_ms(lambda: CD.batch_scalar_mul(B, sc), 3), host_ms,
           cols * n2 * (96 + 32 + 96), mads, shape=[cols, n2],
           plain="the native host batch product (OpenMP)", affine_equal=True)
    del B, sc, words, sw, ref

    # K8: the group NTTs of 2N and N points over the table's columns
    for m in (n2, n):
        k = m.bit_length() - 1
        omega = ST._omega_for_k(k)
        pts = tuple(c[..., :m].contiguous() for c in out)
        got = CD.group_ntt(pts, omega)
        w0 = NL.np_jac_from_tuples(CD._host_points(tuple(c[:, 0] for c in pts)))
        t0 = time.perf_counter()
        NL.native_group_ntt_np(w0, ST._np_twiddles(omega, m), k)
        host_ms = (time.perf_counter() - t0) * 1e3
        back = CD.batch_scalar_mul(
            CD.group_ntt(got, pow(omega, FR_MOD - 2, FR_MOD)),
            CD.raw_limbs([pow(m, FR_MOD - 2, FR_MOD)]).to(dev))
        if not same_points(back, pts):
            fail(f"K8 at {m} points: the inverse transform does not bring "
                 "every column back")
        twiddles = [1] * (m // 2)
        for i in range(1, m // 2):
            twiddles[i] = twiddles[i - 1] * omega % FR_MOD
        record("g1_ntt", CD.to_affine(tuple(c[:, 0] for c in got)),
               CD.to_affine(jac_words_on(w0, (m,), dev)),
               cuda_time_ms(lambda: CD.group_ntt(pts, omega), 3), None,
               *ntt_work(m, cols, twiddles), shape=[cols, m],
               plain="column 0 against the native host group NTT",
               host_native_ms_one_column=host_ms, round_trip_equal=True)
        del pts, got, back, w0
    del out
    torch.cuda.empty_cache()
    return launches


def load_parent_kernels(parent: str):
    """The kernel-library module of an older tree at `parent`, loaded from
    its own file (it builds that tree's csrc/ into that tree's _build/)."""
    path = os.path.join(parent, "sha2cq_tpu_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def alternate(tag, old_fn, new_fn, iters, timer=cuda_time_ms, **shape):
    """Old and new timed in turns (old, new, new, old) on the same inputs."""
    times = [timer(f, iters) for f in (old_fn, new_fn, new_fn, old_fn)]
    say("parent_vs_new", kernel=tag, timer=timer.__name__,
        old_ms=[times[0], times[3]],
        new_ms=[times[1], times[2]],
        speedup=(times[0] + times[3]) / (times[1] + times[2]), **shape)


def rand_limbs(gen, shape, device, p):
    """Canonical random field elements, (16, *shape) int32 limbs: 16-bit
    random limbs with the top limb kept below p's (so every value < p)."""
    import torch
    x = torch.randint(0, 1 << 16, (16, *shape), generator=gen,
                      dtype=torch.int32)
    x[15] %= (p >> 240)
    return x.to(device)


def by_stack(timings, phase) -> dict:
    """Seconds of each stack's sub-phase of `phase` (profiler paths
    "phase/stack")."""
    return {k.split("/")[1]: v for k, v in timings.items()
            if k.startswith(phase + "/")}


def staging_report(tag, timings) -> None:
    """The staged h inputs of one prove, from the profiler: the marks the
    staging threads start at, the h phase's pack (what was not staged,
    plus the wait on the threads) and h_device; beside them each staging
    thread's pack-and-copy per stack and the h phase's pack per stack."""
    missing = [m for m in STAGING_MARKS if m not in timings]
    if missing:
        fail(f"{tag}: the prove recorded no {missing}")
    say(f"{tag}_staging", **{m.split("/")[-1] + "_s": timings[m]
                            for m in STAGING_MARKS},
        staged_pack_s=by_stack(timings, "h_stage"),
        h_pack_by_stack_s=by_stack(timings, "h_pack_inputs"))


def compare_routes(C, pk, dev, routes, tag, meshes=None):
    """The h forward of each route on the same seeded inputs: bit-identical
    outputs; forward ms and peak device memory per route.  A route named in
    `meshes` is the mesh h module on that mesh (inputs cut into its column
    shards before the timed forwards); its ms is the host clock around
    forwards that end in a synchronise of every card of the mesh, the
    others' CUDA events."""
    import torch
    from sha2cq_tpu_torch.plonk.device_eval import get_h_fn
    stacks, rt = C.h_inputs(pk, dev, SEED)
    first = None
    for route in routes:
        mesh = (meshes or {}).get(route)
        t0 = time.perf_counter()
        if mesh is not None:
            fn = get_h_fn(pk, mesh=mesh)
            args = fn.shard_inputs(*stacks)
            want = "mesh"
        else:
            flags = ROUTES[route]
            fn = get_h_fn(pk, dev, flags["h_mxu"], flags.get("h_cosets"))
            args, want = stacks, route
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if fn.route != want:
            fail(f"{tag}: {route} built the {fn.route} route")
        scal = fn.scalar_table(*rt[:4], rt[4:])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, scal)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if mesh is not None:
            ms = wall_ms(lambda: fn(*args, scal), 3, mesh)
        else:
            ms = cuda_time_ms(lambda: fn(*args, scal), 3)
        if first is None:
            first = out
        same = all(bool(torch.equal(a, b)) for a, b in zip(out, first))
        say(f"{tag}_route", route=route, identical=same, forward_ms=ms,
            peak_bytes=peak, resident_bytes_before=base,
            module_build_s=round(build_s, 3),
            **({"shards": len(mesh), "halo_rows": fn.vm.halo,
                "shard_rows": fn.vm.rows} if mesh is not None else {}))
        if not same:
            fail(f"{tag}: the {route} route's h differs from the "
                 f"{routes[0]} route's")
        del out, args
    del stacks, first


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an older tree whose kernels are timed "
                    "against this tree's")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "sha2cq_tpu_torch")):
        fail("the sha2cq_tpu_torch package must sit beside this script")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.modules["jax"] = None          # the port must never import jax
    sys.modules["sha2cq_tpu"] = None   # ... nor the JAX package
    sys.path.insert(0, ROOT)
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    # ---- phase 1: toolchain and card -------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from sha2cq_tpu_torch.ops import kernels as K
    nvcc_ver = subprocess.run([K.nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    K.build(verbose=True)
    K.get_lib()
    build_s = time.perf_counter() - t0
    say("toolchain", card=smi, torch=torch.__version__,
        torch_cuda=torch.version.cuda, nvcc=nvcc_ver.splitlines()[-1],
        kernel_build_s=round(build_s, 3),
        device=torch.cuda.get_device_name(0),
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    for ln in K.build_info.get("log", "").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"[ptxas] {ln.strip()}", flush=True)
    plib = None
    if args.parent:
        PK = load_parent_kernels(args.parent)
        PK.build(verbose=True)
        plib = PK.get_lib()
        for ln in PK.build_info.get("log", "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[ptxas parent] {ln.strip()}", flush=True)

    from sha2cq_tpu_torch import compat as C
    from sha2cq_tpu_torch.fields import device as D
    from sha2cq_tpu_torch.ops import cuda_field as CF
    from sha2cq_tpu_torch.ops import mxu_ntt as MX
    from sha2cq_tpu_torch.ops import ntt as NTT
    from sha2cq_tpu_torch.plonk import h_vm
    from sha2cq_tpu_torch.plonk.device_eval import get_h_fn
    from sha2cq_tpu_torch.poly.domain import EvaluationDomain
    from sha2cq_tpu_torch.utils.profiling import profiler

    from sha2cq_tpu_torch.fields import host as FH
    from sha2cq_tpu_torch.parallel import distributed as DIST
    # the meshes of phase 9: four shards of this card, and every card of
    # the machine where it has more than one
    meshes = {"mesh": DIST.Mesh([dev] * MESH_SHARDS)}
    if torch.cuda.device_count() >= 2:
        meshes["mesh_cards"] = DIST.default_mesh()

    gen = torch.Generator().manual_seed(SEED)
    p = D.FR.p
    kernels = {}
    label = {"mesh": f"{MESH_SHARDS} shards of one card",
             "mesh_cards": f"{torch.cuda.device_count()} cards"}

    def shard_counts(n):
        """Every kernel's launches on each of n shards in the run since the
        last reset (a shard that launched nothing counted none)."""
        return [dict(CF.shard_launches.get(i) or dict.fromkeys(CF.launches, 0))
                for i in range(n)]

    def k13_program_inputs(pk):
        """The k=13 key's h program, random int16 column groups of the
        widths its loads reach over its 16384 extended rows, and a random
        scalar table."""
        prog = h_vm.assemble_h_program(pk)
        rows = pk.vk.domain.extended_n
        ncols = {g: 1 for g in h_vm.GROUPS}
        for op, ia, _b, _d in prog.instrs.tolist():
            if op < 8:
                ncols[h_vm.GROUPS[op]] = max(ncols[h_vm.GROUPS[op]], ia + 1)
        groups = {g: rand_limbs(gen, (c, rows), dev, p).to(torch.int16)
                  for g, c in ncols.items()}
        scal = rand_limbs(gen, (prog.n_runtime + len(prog.const_scalars),),
                          dev, p)
        return prog, groups, scal, rows

    def mesh_runs(key, m, case, slice_proofs, k13):
        """Phase 9 (a), (d) and (e) on mesh m: the distributed NTT at
        k = 20, the row-sharded VM on the k=13 program, the slice proved
        on the mesh (cold and warm) against the single-card proofs
        `slice_proofs` (seed -> bytes).  Returns the warm prove's report."""
        prog13, groups13, scal13, rows13 = k13
        # (a) the four-step NTT at k = 20 against the single-card NTT and
        # the native host NTT
        rng = random.Random(SEED + 9)
        n9 = 1 << K_DNTT
        omega = pow(FH.FR_ROOT_OF_UNITY, 1 << (FH.FR_S - K_DNTT), p)
        vals = [rng.randrange(p) for _ in range(n9)]
        a = D.pack(vals, D.FR, device=dev)
        CF.reset_launches()
        t0 = time.perf_counter()
        out = DIST.distributed_ntt(a, omega, K_DNTT, m)
        m.synchronize()
        first_s = time.perf_counter() - t0
        ntt_launches, ntt_per_shard = dict(CF.launches), shard_counts(len(m))
        single = NTT.ntt(a, omega, K_DNTT)
        t0 = time.perf_counter()
        host = NTT.ntt_host(vals, omega, p)
        host_s = time.perf_counter() - t0
        same = bool(torch.equal(out, single)) and D.unpack(out, D.FR) == host
        kr, kc = DIST.four_step_split(K_DNTT, len(m))
        say("mesh_ntt", k=K_DNTT, R=1 << kr, C=1 << kc, shards=len(m),
            equal_to_single_and_host=same, first_s=first_s,
            ms=wall_ms(lambda: DIST.distributed_ntt(a, omega, K_DNTT, m), 5, m),
            single_card_ms=cuda_time_ms(lambda: NTT.ntt(a, omega, K_DNTT), 5),
            host_native_s=host_s, launches=ntt_launches,
            per_shard=ntt_per_shard, on=label[key])
        if not same:
            fail(f"the distributed NTT at k={K_DNTT} ({label[key]}) differs "
                 "from the single-card and host NTTs")
        del a, out, single, vals, host

        # (d) the row-sharded VM against run_program on the k=13 program at
        # 16384 rows
        state = {g: groups13[g] for g in ("advice", "instance", "z", "lk", "st")}
        consts = {g: groups13[g] for g in ("fixed", "sigma", "aux")}
        want = h_vm.run_program(h_vm.load_program(prog13, groups13, scal13),
                                state, consts, scal13, rows13)
        got = h_vm.run_program_sharded(prog13, state, consts, scal13, rows13, m)
        same = bool(torch.equal(want, got))
        vm = h_vm.ShardedVM(prog13, m, rows13)
        say("mesh_run_program", rows=rows13, shards=len(m),
            max_shift=vm.shift, halo_rows=vm.halo, identical=same,
            ms=wall_ms(lambda: h_vm.run_program_sharded(
                prog13, state, consts, scal13, rows13, m), 1, m),
            on=label[key])
        if not same:
            fail(f"run_program_sharded ({label[key]}) differs from "
                 "run_program")
        del want, got

        # (e) the slice on the mesh, cold and warm: the single-card bytes
        profiler.enable()
        runs = {}
        for run, seed in (("cold", 1), ("warm", 2)):
            CF.reset_launches()
            t0 = time.perf_counter()
            got = C.prove(case, seed, mesh=m)
            runs[run] = dict(seconds=round(time.perf_counter() - t0, 3),
                             identical=got == slice_proofs[seed],
                             verified=C.verify(case, got),
                             launches=dict(CF.launches),
                             per_shard=shard_counts(len(m)))
            timings = profiler.timings()
            runs[run]["h_device_s"] = timings.get("h_device")
            profiler.reset()
        profiler.disable()
        say("mesh_prove", k=K_SLICE, blocks=BLOCKS_SLICE, shards=len(m),
            on=label[key], **runs)
        for run, r in runs.items():
            if not (r["identical"] and r["verified"]):
                fail(f"the {run} k=13 mesh proof ({label[key]}) differs from "
                     "the single-card proof or fails to verify")
            for name in ("mont_mul", "h_vm_run", "ntt_radix2"):
                if any(c[name] <= 0 for c in r["per_shard"]):
                    fail(f"kernel {name} was not launched on every shard of "
                         f"the {run} mesh prove ({label[key]})")
            # the mesh route runs the butterfly NTT over Fr only
            for name in ("planes_to_limbs_mul", "mont_mul_wide"):
                if r["launches"][name]:
                    fail(f"kernel {name} was launched by the {run} mesh "
                         f"prove ({label[key]})")
        return runs["warm"]

    def record(name, out, ref, ms, plain_ms, nbytes, mads, report=False,
               **shape):
        """One kernel checked against its plain version at one shape; the
        kernels line reports the shape marked `report`, else the first
        shape recorded."""
        err = max_abs_err(out, ref)
        source, replaces = KERNELS[name]
        bound, by = bound_ms(nbytes, mads)
        kernels.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None))
        k = kernels[name]
        if report:
            k.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        k["max_abs_err"] = max(k["max_abs_err"], err)
        say("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by,
            share_of_bound=None if ms is None else bound / ms, **shape)
        if err != 0:
            fail(f"{name} disagrees with its plain version ({shape})")

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def parent(fn):
        """fn with the parent tree's kernel library in place of this tree's:
        the parent's kernels under this tree's wrappers, for the kernels
        whose C entries did not change (K1-K4)."""
        def call():
            saved = K._lib
            K._lib = plib
            try:
                return fn()
            finally:
                K._lib = saved
        return call

    # ---- phase 2a: K1 and K2 at the path's shapes ------------------------
    N1 = 123 * 8192
    a = rand_limbs(gen, (N1,), dev, p)
    b = rand_limbs(gen, (N1,), dev, p)
    out = CF.mont_mul(a, b)
    torch.cuda.synchronize()
    ref = D.mont_mul_plain(a, b)
    record("mont_mul", out, ref,
           cuda_time_ms(lambda: CF.mont_mul(a, b), 20),
           cuda_time_ms(lambda: D.mont_mul_plain(a, b), 3),
           3 * 64 * N1, N1 * MONT_MADS, shape=[16, N1])
    if plib is not None:
        alternate("mont_mul", parent(lambda: CF.mont_mul(a, b)),
                  lambda: CF.mont_mul(a, b), 20, shape=[16, N1])
        if not torch.equal(parent(lambda: CF.mont_mul(a, b))(), out):
            fail("the parent's K1 and this tree's disagree")
    # the c2e ZETA pre-multiply: a 64-column chunk times a (16, 1, n) row
    x = rand_limbs(gen, (64, 8192), dev, p)
    row = rand_limbs(gen, (1, 8192), dev, p)
    out = CF.mont_mul(x, row)
    torch.cuda.synchronize()
    record("mont_mul", out, D.mont_mul_plain(x, row),
           cuda_time_ms(lambda: CF.mont_mul(x, row), 20),
           cuda_time_ms(lambda: D.mont_mul_plain(x, row), 3),
           64 * (2 * 64 * 8192 + 8192), 64 * 8192 * MONT_MADS,
           shape=[16, 64, 8192], mode="row")
    del a, b, x, row, out, ref

    # K2 at (32, 512, 2048), the k=18 coset route's shape (m2 = 512 rows, a
    # 4-column chunk times m1 = 512), in every mode, and at (32, 32, 32768),
    # the k=13 residual level's scalar-mode shape

    def k2_mult(mode, M, X):
        """(multiplier, flags, multiplier elements) of one K2 mode."""
        shape, kw = {"scalar": ((1,), {"mult_is_tile": False}),
                     "major": ((M, 32), {"mult_major": X // 32}),
                     "minor": ((M, 32), {"mult_minor": 32}),
                     "tile": ((M, X), {})}[mode]
        return rand_limbs(gen, shape, dev, p), kw, math.prod(shape)

    # tile first: the kernels line reports the first shape recorded, and
    # keeps reporting tile mode so that its K2 entry stays comparable
    for M, X, k2_modes in ((512, 2048, ("tile", "minor", "major", "scalar")),
                           (32, 32768, ("scalar",))):
        planes = torch.randint(0, (1 << 31) - 1, (32, M, X), generator=gen,
                               dtype=torch.int32).to(dev)
        # per element: the word form's 16 products (8 lo/hi pairs), then
        # one Montgomery product
        k2_mads = M * X * (16 + MONT_MADS)
        for mode in k2_modes:
            mult, kw, n_mult = k2_mult(mode, M, X)
            out = CF.planes_to_limbs_mul(planes, mult, **kw)
            torch.cuda.synchronize()
            ref = CF.planes_to_limbs_mul_plain(planes, mult, **kw)
            record("planes_to_limbs_mul", out, ref,
                   cuda_time_ms(lambda: CF.planes_to_limbs_mul(planes, mult, **kw), 20),
                   cuda_time_ms(lambda: CF.planes_to_limbs_mul_plain(planes, mult, **kw), 2),
                   (32 + 16) * 4 * M * X + 64 * n_mult, k2_mads,
                   shape=[32, M, X], mode=mode,
                   on_h_path=mode in ("major", "scalar"))
            if plib is not None:
                old = parent(lambda: CF.planes_to_limbs_mul(planes, mult, **kw))
                alternate("planes_to_limbs_mul", old,
                          lambda: CF.planes_to_limbs_mul(planes, mult, **kw), 20,
                          shape=[32, M, X], mode=mode)
                if not torch.equal(old(), out):
                    fail("the parent's K2 and this tree's disagree")
        del planes, mult, out, ref

    # ---- phase 2b: K4 at the butterfly route's shapes --------------------
    # k=13 slice: the coefficient columns of n = 2^13 after the ZETA
    # pre-multiply and the zero pad to ext = 2^14 (the c2e batch, one
    # column, int16 storage in); k=9 (the auto butterfly route): l2c on the
    # int16 Lagrange stacks, c2e, e2c; k=18: one 64-column chunk at the
    # extended size 2^19, checked on 8 of its columns
    t0 = time.perf_counter()
    small = C.build_sha256(K_SMALL, 1, SEED)
    small_setup_s = time.perf_counter() - t0
    widths = list(C.h_input_widths(small.pk).values())
    l2c_cols, c2e_cols = sum(widths[:4]), sum(widths)
    dom13 = EvaluationDomain(3, K_SLICE)
    x = D.mont_mul(rand_limbs(gen, (C2E_COLUMNS, dom13.n), dev, p),
                   dom13._zeta_pattern(dom13.n, True, dev)[:, None, :])
    x = torch.nn.functional.pad(x, (0, dom13.extended_n - dom13.n))
    dom9, dom18 = small.pk.vk.domain, EvaluationDomain(3, K_BIG)
    k13 = (dom13.extended_omega, dom13.extended_k)
    k4_cases = [    # (case, input, (omega, k), columns the plain version checks)
        ("c2e_batch", x, k13, None),
        ("one_column", x[:, 0].contiguous(), k13, None),
        ("int16_input", x[:, :8].to(torch.int16), k13, None),
        ("k9_l2c", rand_limbs(gen, (l2c_cols, dom9.n), dev, p).to(torch.int16),
         (dom9.omega_inv, dom9.k), None),
        ("k9_c2e", rand_limbs(gen, (c2e_cols, dom9.extended_n), dev, p),
         (dom9.extended_omega, dom9.extended_k), None),
        ("k9_e2c", rand_limbs(gen, (dom9.extended_n,), dev, p),
         (dom9.extended_omega_inv, dom9.extended_k), None),
        ("k18_ext_chunk", rand_limbs(gen, (64, dom18.extended_n), dev, p),
         (dom18.extended_omega, dom18.extended_k), 8),
    ]
    del x
    for case_name, arg, (omega, ek), check_cols in k4_cases:
        tw = NTT.twiddle_table(omega, ek, "Fr", dev)
        cols = arg[0].numel() >> ek
        nbytes = (arg.element_size() * 16 + 64) * arg[0].numel() + 64 * tw.shape[1]
        mads = ek * cols * (1 << (ek - 1)) * MONT_MADS
        CF.reset_launches()
        out = CF.ntt_radix2(arg, tw, ek)
        torch.cuda.synchronize()
        launched = CF.launches["ntt_radix2"]
        sub = arg if check_cols is None else arg[:, :check_cols]
        ref, plain_ms = timed_once(lambda: NTT.ntt_last_axis_plain(sub, tw, ek))
        got = out if check_cols is None else out[:, :check_cols]
        iters = 20 if cols << ek <= 1 << 22 else 5
        # eager ms: what a caller pays, the wrapper's Python included;
        # device_ms: CUDA-graph replays, the card alone (the two part at
        # the small shapes, where the wrapper takes longer than the kernel)
        record("ntt_radix2", got, ref,
               cuda_time_ms(lambda: CF.ntt_radix2(arg, tw, ek), iters),
               plain_ms, nbytes, mads, shape=list(arg.shape), case=case_name,
               device_ms=graph_time_ms(lambda: CF.ntt_radix2(arg, tw, ek), iters),
               passes=NTT.k4_passes(ek, cols), wrapper_calls=launched,
               plain_columns=check_cols or cols)
        del ref, got, sub
        if plib is not None:
            old = parent(lambda: CF.ntt_radix2(arg, tw, ek))
            alternate("ntt_radix2", old, lambda: CF.ntt_radix2(arg, tw, ek),
                      iters, timer=graph_time_ms, shape=list(arg.shape),
                      case=case_name)
            if not torch.equal(old(), out):
                fail(f"the parent's K4 and this tree's disagree ({case_name})")
        del out
        torch.cuda.empty_cache()
    del k4_cases, arg
    torch.cuda.empty_cache()

    # ---- phase 2c: K3 on the SHA-256 program at both path shapes ---------
    # The programs come from the k=9 key: circuit32 / SCHEME8 has the
    # constraint system of the k=13 and k=18 keys, so the same programs
    # (phases 4 and 5 check that they are).
    k3_programs = {"k13_monolithic": (h_vm.assemble_h_program(small.pk),
                                      1 << (K_SLICE + 1)),
                   "k18_coset": (h_vm.assemble_h_program(small.pk, rot_scale=1),
                                 1 << K_BIG)}
    for case_name, (prog, rows) in k3_programs.items():
        ins = prog.instrs
        ncols = {g: 1 for g in h_vm.GROUPS}
        for op, ia, _b, _d in ins.tolist():
            if op < 8:
                ncols[h_vm.GROUPS[op]] = max(ncols[h_vm.GROUPS[op]], ia + 1)
        groups = {g: rand_limbs(gen, (c, rows), dev, p).to(torch.int16)
                  for g, c in ncols.items()}
        nsc = prog.n_runtime + len(prog.const_scalars)
        scal = rand_limbs(gen, (nsc,), dev, p)
        loaded = h_vm.load_program(prog, groups, scal)
        n_mul = int(((ins[:, 0] == h_vm.MUL) | (ins[:, 0] == h_vm.MULS)).sum())
        n_load_cols = len({(op, ia) for op, ia, _b, _d in ins.tolist() if op < 8})

        def k3():
            return h_vm.vm_run(loaded, groups, scal)

        out = k3()
        torch.cuda.synchronize()
        ref, plain_ms = timed_once(lambda: h_vm.vm_run_plain(
            ins, groups, scal, prog.n_reg, prog.out_reg))
        iters = 20 if rows <= 1 << 16 else 5
        record("h_vm_run", out, ref, cuda_time_ms(k3, iters), plain_ms,
               rows * (n_load_cols * 16 * 2 + 64) + ins.nbytes,
               rows * n_mul * MONT_MADS, shape=[16, rows], case=case_name,
               instructions=int(ins.shape[0]), products=n_mul,
               columns=n_load_cols, registers=prog.n_reg,
               streams=len(loaded.split.starts) - 1)
        del ref
        if plib is not None:
            alternate("h_vm_run", parent(k3), k3, iters, shape=[16, rows],
                      case=case_name)
            if not torch.equal(parent(k3)(), out):
                fail("the parent's K3 and this tree's disagree")
        del groups, out, loaded
        torch.cuda.empty_cache()

    # ---- phase 2d: NTT plans built on the card against the host ----------
    w512 = pow(dom13.extended_omega, dom13.extended_n // 512, p)
    t0 = time.perf_counter()
    host_mat, host_rowsum = MX._digit_matrix_host(512, w512, D.FR)
    host_mat_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mat, rowsum = MX.dft_digit_matrix_dev(512, w512, D.FR, dev)
    torch.cuda.synchronize()
    card_mat_s = time.perf_counter() - t0
    same_mat = bool(torch.equal(mat.cpu(), host_mat)) and \
        bool(torch.equal(rowsum.cpu(), host_rowsum))
    w18, m2, m1 = dom18.extended_omega, 512, dom18.extended_n // 512
    t0 = time.perf_counter()
    host_tw = MX._twiddle_tensor_host(w18, m2, m1, D.FR)
    host_tw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_tw = MX.twiddle_tensor_dev(w18, m2, m1, D.FR, dev)
    torch.cuda.synchronize()
    card_tw_s = time.perf_counter() - t0
    same_tw = bool(torch.equal(card_tw.cpu(), host_tw))
    say("plans", digit_matrix_512_identical=same_mat,
        digit_matrix_card_s=card_mat_s, digit_matrix_host_s=host_mat_s,
        twiddle_k18_c2e_identical=same_tw, twiddle_shape=[16, m2, m1],
        twiddle_card_s=card_tw_s, twiddle_host_s=host_tw_s)
    if not (same_mat and same_tw):
        fail("a card-built NTT plan differs from the host-built one")
    del host_mat, host_rowsum, mat, rowsum, host_tw, card_tw

    # ---- phase 2e: K5 and K6 at the device MSM's bucket shape ------------
    # MSM_SMALL random points (a repeated point and a P, -P pair under equal
    # scalars among them) in the path's buckets: 2^c a window, c the window
    # bits the full-width commit of phase 6 takes (phase 6 checks both
    # kernels again on the commit's own inputs; the kernels line reports
    # that shape)
    from sha2cq_tpu_torch import native_loader as NL
    from sha2cq_tpu_torch.curves import device as PD
    from sha2cq_tpu_torch.curves import host as CH
    from sha2cq_tpu_torch.ops import msm as M
    rng = random.Random(SEED)
    c_msm = M.pick_window_bits(1 << K_MSM)
    pts = CH.jac_batch_to_affine(NL.native_batch_scalar_mul(
        [CH.jac_from_affine(CH.G1_GEN)] * MSM_SMALL,
        [rng.randrange(1, p) for _ in range(MSM_SMALL)]))
    scal_msm = [rng.randrange(p) for _ in range(MSM_SMALL)]
    pts[5], scal_msm[5] = pts[4], scal_msm[4]
    pts[9], scal_msm[9] = CH.g1_neg(pts[8]), scal_msm[8]
    words = M.affine_words(PD.pack_affine(pts, device=dev))
    digits = M._scalars_to_digits(NL.fr_buf(scal_msm), c_msm, dev)
    order, starts = M.bucket_layout(digits, c_msm)
    nw, m = digits.shape[0], 1 << c_msm

    def k5():
        return M.msm_bucket_sums(words, order, starts)

    buckets = k5()
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: M.bucket_sums_plain(words, order, starts))
    if not same_points(buckets, ref):
        fail("K5's bucket sums are not its plain version's points")
    work5, work6 = msm_work(int((digits != 0).sum()), nw, m)
    record("msm_bucket_sums", torch.stack(buckets), torch.stack(ref),
           cuda_time_ms(k5, 10), plain_ms, *work5, shape=[nw, m],
           points=MSM_SMALL, window_bits=c_msm, affine_equal=True,
           device_ms=graph_time_ms(k5, 10))
    sums = M.msm_window_reduce(buckets)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: M.window_reduce_plain(buckets))
    if not same_points(sums, ref):
        fail("K6's window sums are not its plain version's points")
    record("msm_window_reduce", torch.stack(sums), torch.stack(ref),
           cuda_time_ms(lambda: M.msm_window_reduce(buckets), 10), plain_ms,
           *work6, shape=[nw, m], window_bits=c_msm, affine_equal=True,
           device_ms=graph_time_ms(lambda: M.msm_window_reduce(buckets), 10))
    want = CH.jac_to_affine(NL.native_msm(
        scal_msm, [CH.jac_from_affine(q) for q in pts]))
    if M._fold_windows(sums, c_msm) != want:
        fail("K5 + K6 at 2^12 points disagree with the native host MSM")
    del pts, words, digits, order, starts, buckets, sums, ref
    torch.cuda.empty_cache()

    # ---- phase 2f: K7 and K8 at the CQ tables' shapes --------------------
    fk_launches = cq_fk_phase(dev, record)
    for name in ("g1_scalar_mul", "g1_ntt"):
        kernels[name]["launches"] = fk_launches[name]

    # ---- phase 3: k=9 proofs on the card == host-path proof --------------
    t0 = time.perf_counter()
    proof_host = C.prove(small, 9, h_device=False)
    k9_launches = {}
    for route, flags in ROUTES.items():
        CF.reset_launches()
        proof_card = C.prove(small, 9, h_device=True, device=dev,
                             **flags)
        k9_launches[route] = dict(CF.launches)
        same = proof_card == proof_host
        ok_small = C.verify(small, proof_card)
        say("k9_identity", route=route, identical=same, verified=ok_small,
            launches=k9_launches[route], proof_bytes=len(proof_card))
        if not (same and ok_small):
            fail(f"k=9 card proof ({route}) differs from the host-path "
                 "proof or fails to verify")
    if get_h_fn(small.pk, dev).route != "butterfly":
        fail("the auto route at k=9 is not the butterfly route")
    if k9_launches["butterfly"]["ntt_radix2"] <= 0:
        fail("the k=9 butterfly prove did not launch K4")
    kernels["ntt_radix2"]["launches"] = k9_launches["butterfly"]["ntt_radix2"]
    say("k9_done", seconds=round(time.perf_counter() - t0, 3),
        setup_and_keygen_s=round(small_setup_s, 3))
    del small

    # ---- phase 4: the slice ----------------------------------------------
    t0 = time.perf_counter()
    case = C.build_sha256(K_SLICE, BLOCKS_SLICE, SEED)
    setup_s = time.perf_counter() - t0
    cs = case.pk.vk.cs
    dom = case.pk.vk.domain
    t0 = time.perf_counter()
    h_fn = get_h_fn(case.pk, dev)
    torch.cuda.synchronize()
    hfn_build_s = time.perf_counter() - t0
    say("slice_setup", k=K_SLICE, blocks=BLOCKS_SLICE, n=dom.n,
        ext=dom.extended_n, advice=cs.num_advice_columns,
        fixed=cs.num_fixed_columns, static_lookups=len(cs.static_lookups),
        program=list(h_fn.prog.instrs.shape), n_reg=h_fn.prog.n_reg,
        route=h_fn.route, setup_and_keygen_s=round(setup_s, 3),
        h_module_build_s=round(hfn_build_s, 3))

    if h_fn.route != "monolithic" or not np.array_equal(
            h_fn.prog.instrs, k3_programs["k13_monolithic"][0].instrs):
        fail("the k=13 slice's h program is not the one K3 ran in phase 2")
    ext = dom.extended_n

    # the three routes on the same inputs (queue 3's comparison)
    compare_routes(C, case.pk, dev, list(ROUTES) + list(meshes), "k13",
                   meshes)

    # where the device time of one h pass (auto route) goes: torch.profiler
    # summed by kernel; plus the 2^14 NTT on its own
    stacks, rt = C.h_inputs(case.pk, dev, SEED)
    h_args = stacks + [h_fn.scalar_table(*rt[:4], rt[4:])]
    h_fn(*h_args)
    torch.cuda.synchronize()
    h_ms = cuda_time_ms(lambda: h_fn(*h_args), 3)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        h_fn(*h_args)
        torch.cuda.synchronize()
    # device rows only: a host op's row repeats the time of its kernels
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
        key=lambda r: -r[1])
    device_ms = sum(r[1] for r in by_kernel)
    say("h_breakdown", route=h_fn.route, h_forward_ms=h_ms,
        device_ms_profiled=device_ms)
    for key, ms, calls in by_kernel[:12]:
        print(f"[h_kernel] {ms:9.3f} ms x{calls:<4d} {key[:100]}", flush=True)
    col = rand_limbs(gen, (ext,), dev, p)
    ntt_ms = cuda_time_ms(lambda: MX.mxu_ntt(col, dom.extended_omega,
                                             dom.extended_k), 10)
    say("ntt_2e14", ms=ntt_ms, columns=1)
    del stacks, h_args

    # the slice's main path: cold and warm prove through the kernels
    torch.cuda.reset_peak_memory_stats()
    profiler.enable()
    CF.reset_launches()
    t0 = time.perf_counter()
    proof = C.prove(case, 1, device=dev)
    cold_s = time.perf_counter() - t0
    cold_launches = dict(CF.launches)
    say("prove_cold", seconds=round(cold_s, 3), launches=cold_launches,
        proof_bytes=len(proof))
    print(profiler.report("cold prove phases"), flush=True)
    staging_report("k13_cold", profiler.timings())
    profiler.reset()
    CF.reset_launches()
    t0 = time.perf_counter()
    proof_w = C.prove(case, 2, device=dev)
    warm_s = time.perf_counter() - t0
    warm_launches = dict(CF.launches)
    say("prove_warm", seconds=round(warm_s, 3), launches=warm_launches)
    print(profiler.report("warm prove phases"), flush=True)
    staging_report("k13_warm", profiler.timings())
    profiler.reset()
    # the same warm prove with the staging function replaced by a no-op:
    # the same bytes, and the pack the h phase then pays for every stack
    from sha2cq_tpu_torch.plonk import device_eval as DE
    real_stage = DE.stage_stacks
    DE.stage_stacks = lambda out, stacks, n, device: None
    try:
        t0 = time.perf_counter()
        proof_u = C.prove(case, 2, device=dev)
        unstaged_s = time.perf_counter() - t0
    finally:
        DE.stage_stacks = real_stage
    timings = profiler.timings()
    say("k13_unstaged", seconds=round(unstaged_s, 3),
        identical_to_staged=proof_u == proof_w,
        h_pack_inputs_s=timings["h_pack_inputs"],
        h_device_s=timings["h_device"],
        h_pack_by_stack_s=by_stack(timings, "h_pack_inputs"))
    if proof_u != proof_w:
        fail("the k=13 proof with staging differs from the one without")
    profiler.reset()
    profiler.disable()
    t0 = time.perf_counter()
    ok = C.verify(case, proof) and C.verify(case, proof_w)
    say("verify", ok=ok, seconds=round(time.perf_counter() - t0, 3))
    if not ok:
        fail("the k=13 slice proof does not verify")
    for name in ("mont_mul", "planes_to_limbs_mul", "h_vm_run"):
        if cold_launches[name] <= 0 or warm_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the k=13 prove")
    say("prove_memory", peak_device_bytes=torch.cuda.max_memory_allocated())
    # phase 9 proves the slice on the mesh under the same seeds
    slice_proofs = {1: proof, 2: proof_w}
    del h_fn, proof, proof_w
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 5: the full-width path, k=18 with 2048 blocks -------------
    t0 = time.perf_counter()
    big = C.build_sha256(K_BIG, BLOCKS_BIG, SEED)
    setup_s = time.perf_counter() - t0
    dom = big.pk.vk.domain
    say("k18_setup", k=K_BIG, blocks=BLOCKS_BIG, n=dom.n, ext=dom.extended_n,
        setup_and_keygen_s=round(setup_s, 3))
    torch.cuda.reset_peak_memory_stats()
    profiler.enable()
    CF.reset_launches()
    t0 = time.perf_counter()
    proof = C.prove(big, 1, device=dev)
    prove_s = time.perf_counter() - t0
    big_launches = dict(CF.launches)
    big_fn = get_h_fn(big.pk, dev)
    route = big_fn.route
    if not np.array_equal(big_fn.prog.instrs,
                          k3_programs["k18_coset"][0].instrs):
        fail("the k=18 key's coset h program is not the one K3 ran in "
             "phase 2")
    say("k18_prove", seconds=round(prove_s, 3), route=route,
        launches=big_launches, proof_bytes=len(proof),
        peak_device_bytes=torch.cuda.max_memory_allocated())
    print(profiler.report("k=18 prove phases"), flush=True)
    staging_report("k18", profiler.timings())
    profiler.reset()
    profiler.disable()
    t0 = time.perf_counter()
    ok = C.verify(big, proof)
    say("k18_verify", ok=ok, seconds=round(time.perf_counter() - t0, 3))
    if not ok:
        fail("the k=18 proof does not verify")
    if route != "coset":
        fail(f"the auto route at k=18 is {route}, not the coset route")
    for name in ("mont_mul", "planes_to_limbs_mul", "h_vm_run"):
        if big_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the k=18 prove")
        kernels[name]["launches"] = big_launches[name]
    compare_routes(C, big.pk, dev, ["coset", "monolithic", "butterfly"] +
                   list(meshes), "k18", meshes)
    del big, big_fn, proof
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 6: the device MSM at full width, 2^20 points --------------
    from sha2cq_tpu_torch.poly.kzg import params as KP
    n_msm = 1 << K_MSM
    rng = random.Random(SEED + K_MSM)
    s_msm = rng.randrange(p)
    t0 = time.perf_counter()
    params = KP.ParamsKZG(k=K_MSM, n=n_msm, g=KP._g1_powers_of_s(s_msm, n_msm),
                          g_lagrange=[], g2=CH.G2_GEN,
                          s_g2=CH.g2_mul(CH.G2_GEN, s_msm))
    srs_s = time.perf_counter() - t0
    coeffs = [rng.randrange(p) for _ in range(n_msm)]
    t0 = time.perf_counter()
    packed = M.packed_basis(params, "_g_packed", params.g)
    basis_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    commits = {}
    profiler.enable()
    for run in ("cold", "warm"):
        profiler.clear_log()
        CF.reset_launches()
        t0 = time.perf_counter()
        point = params.commit(coeffs)
        torch.cuda.synchronize()
        cached = [sp.counts.get("basis_cached") for sp in profiler.log()
                  if sp.name == "msm_basis"]
        commits[run] = (point, time.perf_counter() - t0, dict(CF.launches),
                        cached)
    profiler.clear_log()
    profiler.reset()
    profiler.disable()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    host = M.msm_host(coeffs, params.g, packed=packed)
    host_s = time.perf_counter() - t0
    say("msm_commit", points=n_msm, window_bits=M.pick_window_bits(n_msm),
        equal_to_host=all(v[0] == host for v in commits.values()),
        cold_s=commits["cold"][1], warm_s=commits["warm"][1],
        host_native_s=host_s, srs_build_s=srs_s, basis_pack_s=basis_s,
        peak_device_bytes=peak, resident_bytes_before=resident,
        cold_launches=commits["cold"][2], launches=commits["warm"][2],
        basis_cached={run: v[3] for run, v in commits.items()})
    if any(v[0] != host for v in commits.values()):
        fail("the card's commitment of 2^20 points differs from the native "
             "host MSM's")
    for name in ("msm_bucket_sums", "msm_window_reduce"):
        if any(v[2][name] <= 0 for v in commits.values()):
            fail(f"kernel {name} was not launched by the 2^20-point commit")
    if commits["cold"][2]["mont_mul"] <= 0:
        fail("kernel mont_mul was not launched by the cold 2^20-point "
             "commit, which fills the device basis cache")
    if commits["warm"][2]["mont_mul"] != 0:
        fail("the warm 2^20-point commit launched mont_mul: it did not read "
             "the cached basis words")
    if (commits["cold"][3], commits["warm"][3]) != ([0], [1]):
        fail("msm_basis counted basis_cached "
             f"{commits['cold'][3]} cold and {commits['warm'][3]} warm, "
             "not [0] and [1]")
    for name in ("msm_bucket_sums", "msm_window_reduce"):
        kernels[name]["launches"] = commits["warm"][2][name]
    # columns of small values, as a circuit's witness mostly holds, and one
    # scalar for every point: bits put about half the points in bucket 1 of
    # window 0, 16-bit words (c = 15) in bucket 1 of window 1, one scalar
    # all of them in one bucket of every window; K5 cuts each such bucket
    # into chunks
    c_full = M.pick_window_bits(n_msm)
    columns = {"uniform": coeffs,
               "bits": [rng.randrange(2) for _ in range(n_msm)],
               "words16": [rng.randrange(1 << 16) for _ in range(n_msm)],
               "equal": [rng.randrange(p)] * n_msm}
    for kind in ("bits", "words16", "equal"):
        col = columns[kind]
        t0 = time.perf_counter()
        point = params.commit(col)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = M.msm_host(col, params.g, packed=packed)
        host_s = time.perf_counter() - t0
        say("msm_commit_skewed", scalars=kind, equal_to_host=point == want,
            device_s=dev_s, host_native_s=host_s,
            faster_than_host=dev_s < host_s)
        if point != want:
            fail(f"the card's commitment of a {kind} column differs from "
                 "the native host MSM's")
    # K5 and K6 against their plain versions on each column's own points,
    # digits and bucket layout at the path's window bits (the kernels line
    # reports the uniform commit's)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words = M.affine_words(PD.pack_affine(device=dev, packed=packed, n=n_msm))
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    fq8 = K.field_words(D.FQ) + (K.one_words(D.FQ),)
    k5_ms = {}
    for kind, col in columns.items():
        digits = M._scalars_to_digits(NL.fr_buf([x % p for x in col]),
                                      c_full, dev)
        order, starts = M.bucket_layout(digits, c_full)
        nw, m = digits.shape[0], 1 << c_full
        live = int((digits != 0).sum())
        seg = (starts[:, 2:] - starts[:, 1:-1]).max().item()
        del digits

        def k5():
            return M.msm_bucket_sums(words, order, starts)

        buckets = k5()
        torch.cuda.synchronize()
        ref, plain_ms = timed_once(
            lambda: M.bucket_sums_plain(words, order, starts))
        if not same_points(buckets, ref):
            fail(f"K5's bucket sums at 2^20 points ({kind}) are not its "
                 "plain version's points")
        k5_ms[kind] = cuda_time_ms(k5, 3)
        record("msm_bucket_sums", torch.stack(buckets), torch.stack(ref),
               k5_ms[kind], plain_ms, *msm_work(live, nw, m)[0],
               report=kind == "uniform", shape=[nw, m], points=n_msm,
               window_bits=c_full, scalars=kind, longest_bucket=seg,
               affine_equal=True)
        del ref
        sums = M.msm_window_reduce(buckets)
        torch.cuda.synchronize()
        ref, plain_ms = timed_once(lambda: M.window_reduce_plain(buckets))
        if not same_points(sums, ref):
            fail(f"K6's window sums at 2^20 points ({kind}) are not its "
                 "plain version's points")
        record("msm_window_reduce", torch.stack(sums), torch.stack(ref),
               cuda_time_ms(lambda: M.msm_window_reduce(buckets), 3),
               plain_ms, *msm_work(0, nw, m)[1], report=kind == "uniform",
               shape=[nw, m], window_bits=c_full, scalars=kind,
               longest_bucket=seg, affine_equal=True)
        del ref
        if plib is not None and kind in ("uniform", "bits"):
            # the parent's K5 (one thread a bucket) and K6 (runs of 16,
            # blocks of 128) on the same inputs, with their own arguments
            old5 = torch.empty((3, 16, nw, m), dtype=torch.int32, device=dev)

            def parent_k5():
                rc = plib.k5_msm_bucket_sums(
                    words.data_ptr(), order.data_ptr(), starts.data_ptr(),
                    old5[0].data_ptr(), old5[1].data_ptr(),
                    old5[2].data_ptr(), nw, n_msm, m, *fq8, stream())
                if rc != 0:
                    fail(f"the parent's K5 failed to launch ({rc})")

            if kind == "uniform":
                alternate("msm_bucket_sums", parent_k5, k5, 3,
                          shape=[nw, m], window_bits=c_full, scalars=kind)
                L6 = min(16, m)
                T6 = min(128, m // L6)
                P6 = m // (L6 * T6)
                part = torch.empty((nw, P6, 2, 24), dtype=torch.int32,
                                   device=dev)
                old6 = torch.empty((3, 16, nw), dtype=torch.int32, device=dev)

                def parent_k6():
                    rc = plib.k6_msm_window_reduce(
                        buckets[0].data_ptr(), buckets[1].data_ptr(),
                        buckets[2].data_ptr(), part.data_ptr(),
                        old6[0].data_ptr(), old6[1].data_ptr(),
                        old6[2].data_ptr(), nw, m, L6, T6.bit_length() - 1,
                        P6.bit_length() - 1, (T6 * L6).bit_length() - 1,
                        *fq8, stream())
                    if rc != 0:
                        fail(f"the parent's K6 failed to launch ({rc})")

                alternate("msm_window_reduce", parent_k6,
                          lambda: M.msm_window_reduce(buckets), 3,
                          shape=[nw, m], window_bits=c_full, scalars=kind)
                torch.cuda.synchronize()
                if not same_points(old6, sums):
                    fail("the parent's K6 and this tree's disagree")
                del part, old6
            else:
                _, old_ms = timed_once(parent_k5)
                say("parent_vs_new", kernel="msm_bucket_sums",
                    timer="timed_once", old_ms=[old_ms], new_ms=[k5_ms[kind]],
                    speedup=old_ms / k5_ms[kind], shape=[nw, m],
                    window_bits=c_full, scalars=kind, longest_bucket=seg)
            torch.cuda.synchronize()
            if not same_points(old5, buckets):
                fail("the parent's K5 and this tree's disagree")
            del old5
        del order, starts, buckets, sums
        torch.cuda.empty_cache()
    # K5 / K6 by window bits at full width, uniform scalars
    buf = NL.fr_buf([x % p for x in coeffs])
    for c in (14, 15, 16):
        t0 = time.perf_counter()
        digits = M._scalars_to_digits(buf, c, dev)
        order, starts = M.bucket_layout(digits, c)
        torch.cuda.synchronize()
        digit_s = time.perf_counter() - t0
        nw, m = digits.shape[0], 1 << c
        (b5, by5), (b6, by6) = (bound_ms(*w) for w in msm_work(
            int((digits != 0).sum()), nw, m))
        buckets = M.msm_bucket_sums(words, order, starts)
        k5 = [cuda_time_ms(lambda: M.msm_bucket_sums(words, order, starts), 3)
              for _ in range(3)]
        k6 = [cuda_time_ms(lambda: M.msm_window_reduce(buckets), 3)
              for _ in range(3)]
        if c == 14:
            k5_ms["uniform c = 14"] = min(k5)
        seg = (starts[:, 2:] - starts[:, 1:-1]).max().item()
        say("msm_kernel", window_bits=c, windows=nw,
            chosen=c == M.pick_window_bits(n_msm), k5_ms=k5, k5_bound_ms=b5,
            k5_bound_by=by5, k5_share=b5 / min(k5), k6_ms=k6,
            k6_bound_ms=b6, k6_bound_by=by6, k6_share=b6 / min(k6),
            k5_plus_k6_ms=min(k5) + min(k6), longest_bucket=seg,
            digits_and_order_s=digit_s, scalars_and_points_s=pack_s)
        del digits, order, starts, buckets
        torch.cuda.empty_cache()
    # K5's time no longer follows the longest bucket: each skewed layout,
    # and c = 14, within 1.5x of uniform scalars at the path's window bits
    ratios = {k: v / k5_ms["uniform"] for k, v in k5_ms.items()
              if k != "uniform"}
    say("msm_k5_skew", window_bits=c_full, uniform_ms=k5_ms["uniform"],
        ratio_to_uniform=ratios)
    if max(ratios.values()) > 1.5:
        fail(f"K5 on a skewed layout takes over 1.5x its uniform time: "
             f"{ratios}")
    msm_point = host         # phase 9b holds the sharded MSM against it
    del words, buf, columns
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 7: secp256k1 on the card, K1w ------------------------------
    from sha2cq_tpu_torch.curves import secp256k1 as SECP
    R = 1 << 256
    n_wide = 1 << 20
    for ctx in SECP.device_ctxs():
        q = ctx.p
        # a < 2^256 (all 16 limbs random), b < p; edge values first: every
        # pair of (p - 1, 2^256 - 1, R mod p, 0, 1, 2^255) as a and
        # (p - 1, R mod p, 0, 1, p // 2) as b
        a = torch.randint(0, 1 << 16, (16, n_wide), generator=gen,
                          dtype=torch.int32)
        b = rand_limbs(gen, (n_wide,), "cpu", q)
        pairs = [(x, y) for x in (q - 1, R - 1, R % q, 0, 1, 1 << 255)
                 for y in (q - 1, R % q, 0, 1, q // 2)]
        for j, (x, y) in enumerate(pairs):
            a[:, j] = torch.tensor([(x >> (16 * i)) & 0xFFFF for i in range(16)])
            b[:, j] = torch.tensor([(y >> (16 * i)) & 0xFFFF for i in range(16)])
        # how many of the first 4096 pairs drive REDC's t past 2^256
        head = [[sum(int(t[i, j]) << (16 * i) for i in range(16))
                 for j in range(4096)] for t in (a, b)]
        npinv = pow(q, -1, R)
        over = sum(x * y + ((-x * y * npinv) % R) * q >= R * R
                   for x, y in zip(*head))
        a, b = a.to(dev), b.to(dev)
        out = CF.mont_mul(a, b, ctx)
        torch.cuda.synchronize()
        ref = D.mont_mul_plain(a, b, ctx)
        record("mont_mul_wide", out, ref,
               cuda_time_ms(lambda: CF.mont_mul(a, b, ctx), 20),
               cuda_time_ms(lambda: D.mont_mul_plain(a, b, ctx), 3),
               3 * 64 * n_wide, n_wide * MONT_MADS, shape=[16, n_wide],
               field=ctx.name, edge_pairs=len(pairs),
               t_at_least_2_256_in_first_4096=over)
        if over == 0:
            fail(f"{ctx.name}: no operand pair drives t past 2^256")
        del a, b, out, ref
    # the secp main path: Montgomery conversion, a power and an inverse of
    # 4096 elements of each field on the card
    rng = random.Random(SEED)
    CF.reset_launches()
    t0 = time.perf_counter()
    chain = {}
    for ctx in SECP.device_ctxs():
        q = ctx.p
        vals = [0, 1, q - 1] + [rng.randrange(q) for _ in range(4093)]
        x = D.to_mont(D.pack(vals, ctx, mont=False, device=dev), ctx)
        y = D.from_mont(D.inv(D.pow_const(x, 0x10001, ctx), ctx), ctx)
        got = D.unpack(y, ctx, mont=False)
        chain[ctx.name] = got == [pow(pow(v, 0x10001, q), q - 2, q)
                                  for v in vals]
    wide_launches = dict(CF.launches)
    say("secp_chain", elements=4096, equal_to_python=chain,
        seconds=round(time.perf_counter() - t0, 3), launches=wide_launches)
    if not all(chain.values()):
        fail(f"the secp256k1 chain on the card differs from Python's: {chain}")
    if wide_launches["mont_mul_wide"] <= 0 or wide_launches["mont_mul"] != 0:
        fail("the secp256k1 chain did not run on K1w alone")
    kernels["mont_mul_wide"]["launches"] = wide_launches["mont_mul_wide"]

    # ---- phase 8: the generic-limb SHA-2 circuit at MINI_LIMBS, k=7 -------
    from sha2cq_tpu_torch import plonk as PL
    from sha2cq_tpu_torch.dev.mock_prover import MockProver
    from sha2cq_tpu_torch.models.sha.circuit import Sha2CqCircuit
    from sha2cq_tpu_torch.models.sha.setup import build_sha_setup
    from sha2cq_tpu_torch.models.sha.tables import MINI_LIMBS
    from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
    t0 = time.perf_counter()
    k_mini = 7
    rng = random.Random(SEED)
    s_mini = rng.randrange(p)
    tables, configs, b0, _srs = build_sha_setup(MINI_LIMBS, 1 << k_mini,
                                                s_mini, cache=False)
    mini_cls = type("MiniShaCircuit", (Sha2CqCircuit,), {"LIMBS": MINI_LIMBS})
    circuit = mini_cls([rng.randrange(1 << MINI_LIMBS.word_len)
                        for _ in range(16)], tables)
    digest = list(circuit.expected_digest())
    satisfied = MockProver.run(k_mini, circuit, [digest]).verify() == []
    wrong = list(digest)
    wrong[0] ^= 1
    rejected = MockProver.run(k_mini, circuit, [wrong]).verify() != []
    params_mini = ParamsKZG.setup_from_toxic_waste(k_mini, s_mini)
    vk = PL.keygen_vk(params_mini, circuit)
    mini = types.SimpleNamespace(
        params=params_mini, vk=vk,
        pk=PL.keygen_pk(params_mini, configs, b0, vk, circuit),
        circuits=[circuit], instances=[[digest]], k=k_mini)
    proof_host = C.prove(mini, 11, h_device=False)
    CF.reset_launches()
    proof_card = C.prove(mini, 11, h_device=True, device=dev)
    mini_launches = dict(CF.launches)
    ok_mini = C.verify(mini, proof_card)
    say("sha_mini", k=k_mini, mock_satisfied=satisfied,
        wrong_digest_rejected=rejected, identical=proof_card == proof_host,
        verified=ok_mini, route=get_h_fn(mini.pk, dev).route,
        launches=mini_launches, seconds=round(time.perf_counter() - t0, 3))
    if not (satisfied and rejected and ok_mini and proof_card == proof_host):
        fail("the MINI_LIMBS SHA-2 circuit fails on the card")
    for name in ("mont_mul", "h_vm_run", "ntt_radix2"):
        if mini_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the MINI SHA-2 prove")

    # ---- phase 9: the mesh ------------------------------------------------
    # (the h forwards of phases 4 and 5 ran the mesh routes: 9d's k=13 and
    # k=18 comparisons)
    t9 = time.perf_counter()
    mesh = meshes["mesh"]

    # (b) sharded MSM window sums: phase 6's 2^20-point SRS and uniform
    # scalars, 2^18 points a shard at the reference's window bits for them
    c9 = M.pick_window_bits_v2(n_msm // MESH_SHARDS)
    digits = M._scalars_to_digits(NL.fr_buf([x % p for x in coeffs]), c9, dev)
    pts = PD.pack_affine(device=dev, packed=packed, n=n_msm)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    CF.reset_launches()
    t0 = time.perf_counter()
    sums = DIST.sharded_msm_window_sums(pts, digits, n_msm, mesh, c9)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    msm_launches, msm_per_shard = dict(CF.launches), shard_counts(MESH_SHARDS)
    peak = torch.cuda.max_memory_allocated()
    folded = DIST.fold_window_sums(sums, c9)
    same = folded == msm_point == commits["warm"][0]
    ms = wall_ms(lambda: DIST.sharded_msm_window_sums(pts, digits, n_msm,
                                                      mesh, c9), 3, mesh)
    # one step of the fold over the shards' window sums (there are
    # shards - 1), and one shard's conversion of its points to K5's words
    win = DIST.window_sums_to_points(sums)
    fold_step_ms = wall_ms(lambda: PD.point_add(win, win), 3, mesh)
    words_ms = wall_ms(lambda: M._pack_affine_words(
        tuple(t[:, :n_msm // MESH_SHARDS] for t in pts)), 3, mesh)
    say("mesh_msm", points=n_msm, shards=MESH_SHARDS, window_bits=c9,
        windows=int(sums.shape[0]), equal_to_msm_device_and_host=same,
        first_s=first_s, ms=ms, fold_step_ms=fold_step_ms,
        shard_affine_words_ms=words_ms, peak_device_bytes=peak,
        resident_bytes_before=resident, launches=msm_launches,
        per_shard=msm_per_shard, on=label["mesh"])
    if not same:
        fail("the sharded MSM's folded window sums differ from msm_device "
             "and msm_host")
    for name in ("msm_bucket_sums", "msm_window_reduce"):
        if any(c[name] <= 0 for c in msm_per_shard):
            fail(f"kernel {name} was not launched on every shard of the "
                 "sharded MSM")
    del params, packed, coeffs, digits, pts, sums, win
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the sharded gate at 2^20 rows against its plain version
    v9 = rand_limbs(gen, (1 << K_DNTT,), dev, p)
    s9 = rand_limbs(gen, (1 << K_DNTT,), dev, p)
    y9 = rand_limbs(gen, (1,), dev, p)

    def gate_plain():
        sq = D.mont_mul_plain(v9, v9)
        return D.add(D.mont_mul_plain(v9, y9),
                     D.mont_mul_plain(s9, D.sub(sq, v9)))

    out = DIST.sharded_pointwise_gate(v9, s9, y9, mesh)
    ref, plain_ms = timed_once(gate_plain)
    same = bool(torch.equal(out, ref))
    say("mesh_gate", rows=1 << K_DNTT, shards=MESH_SHARDS, equal_to_plain=same,
        ms=wall_ms(lambda: DIST.sharded_pointwise_gate(v9, s9, y9, mesh), 5,
                   mesh), plain_ms=plain_ms, on=label["mesh"])
    if not same:
        fail("the sharded gate differs from its plain version")
    del v9, s9, y9, out, ref

    # (d) K3 and K4 at a k=13 mesh shard's shapes against their plain
    # versions: the extended rows of shard 0 (m + 2 S'), a shard's c2e batch
    k13 = k13_program_inputs(case.pk)
    prog13, groups13, scal13, rows13 = k13
    vm13 = h_vm.ShardedVM(prog13, mesh, rows13)
    ext0 = {g: vm13.extend(vm13.row_shards(t))[0] for g, t in groups13.items()}
    loaded = h_vm.load_program(prog13, ext0, scal13)
    out = h_vm.vm_run(loaded, ext0, scal13)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: h_vm.vm_run_plain(
        prog13.instrs, ext0, scal13, prog13.n_reg, prog13.out_reg))
    n_mul = int(((prog13.instrs[:, 0] == h_vm.MUL) |
                 (prog13.instrs[:, 0] == h_vm.MULS)).sum())
    n_load_cols = len({(op, ia) for op, ia, _b, _d in prog13.instrs.tolist()
                       if op < 8})
    record("h_vm_run", out, ref,
           cuda_time_ms(lambda: h_vm.vm_run(loaded, ext0, scal13), 20),
           plain_ms, vm13.rows * (n_load_cols * 16 * 2 + 64) +
           prog13.instrs.nbytes, vm13.rows * n_mul * MONT_MADS,
           shape=[16, vm13.rows], case="k13_mesh_shard",
           halo_rows=vm13.halo, kept_rows=vm13.m,
           streams=len(loaded.split.starts) - 1)
    dom13 = case.pk.vk.domain
    cols13 = -(-C2E_COLUMNS // MESH_SHARDS)
    x = rand_limbs(gen, (cols13, dom13.extended_n), dev, p)
    tw = NTT.twiddle_table(dom13.extended_omega, dom13.extended_k, "Fr", dev)
    out = CF.ntt_radix2(x, tw, dom13.extended_k)
    torch.cuda.synchronize()
    ref, plain_ms = timed_once(lambda: NTT.ntt_last_axis_plain(
        x, tw, dom13.extended_k))
    record("ntt_radix2", out, ref,
           cuda_time_ms(lambda: CF.ntt_radix2(x, tw, dom13.extended_k), 20),
           plain_ms, (4 * 16 + 64) * x[0].numel() + 64 * tw.shape[1],
           dom13.extended_k * cols13 * (dom13.extended_n // 2) * MONT_MADS,
           shape=list(x.shape), case="k13_mesh_shard_c2e",
           passes=NTT.k4_passes(dom13.extended_k, cols13))
    del x, out, ref, ext0, loaded

    mesh_report = {key: mesh_runs(key, m, case, slice_proofs, k13)
                   for key, m in meshes.items()}
    # the mesh path's launches on the four-shard mesh, every kernel read
    # from both of its measured runs (each reset just before it): the warm
    # mesh prove and the sharded MSM, apart and summed, in all and a shard
    mesh_path = {"prove": mesh_report["mesh"],
                 "msm": {"launches": msm_launches, "per_shard": msm_per_shard}}
    for name, k in kernels.items():
        runs = {run: {"per_run": r["launches"][name],
                      "per_shard": [c[name] for c in r["per_shard"]]}
                for run, r in mesh_path.items()}
        k["mesh_launches"] = {
            "per_run": sum(r["per_run"] for r in runs.values()),
            "per_shard": [sum(c) for c in zip(*(r["per_shard"]
                                                for r in runs.values()))],
            **runs}
    say("mesh_done", seconds=round(time.perf_counter() - t9, 3),
        meshes={key: label[key] for key in meshes},
        multi_card="run" if "mesh_cards" in meshes else
        f"not run: {torch.cuda.device_count()} card")
    del case, slice_proofs

    say("done", seconds=round(time.perf_counter() - t_start, 3))
    print(smi, flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
