#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sha2cq_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own line (any failure exits nonzero; no phase
catches an error and goes on):

1. toolchain and card: nvidia-smi name and power limit, torch.version.cuda,
   nvcc --version, and the build of csrc/*.cu (one nvcc per source, all at
   once; seconds, ptxas report);
2. kernels K1 (mont_mul), K2 (planes_to_limbs_mul) and K4 (ntt_radix2) each
   against its plain PyTorch version on the card at the main path's shapes,
   bit for bit, with both times (CUDA events); the NTT plans built on the
   card (the m=512 digit matrix, the k=18 c2e twiddle tensor) against the
   host-built ones, bit for bit, with both build times;
3. SHA-256 circuit32 / SCHEME8 at k=9, one block: under each h route
   (butterfly -- the auto route at k=9 --, monolithic digit-matmul,
   coset-streamed) the proof with h on the card is byte-identical to the
   port's host-path proof and verifies; the butterfly prove launches K4;
4. the slice: circuit32 / SCHEME8 at k=13 with 110 chained blocks (the
   flagship's constraint system and device shapes: n = 8192, ext = 16384):
   setup, keygen, K3 against its plain version on the slice's program, the
   h forward of each route on the same random inputs (bit-identical; ms and
   peak memory), the kernel breakdown of one h pass, one cold and one warm
   create_proof(h_device=True, device="cuda") with profiler phases,
   verify_proof(...).check(), and K1-K3 launched by each prove;
5. the full-width path: circuit32 / SCHEME8 at k=18 with 2048 chained
   blocks (n = 2^18, ext = 2^19, rs = 2): setup, keygen, one
   create_proof(h_device=True, device="cuda") (auto: the coset-streamed
   route) with profiler phases, verify_proof(...).check(), K1-K3 launched by
   the prove, and the coset and forced monolithic h forwards on the same
   inputs (bit-identical; ms and peak memory).

The last lines are the card's name and power limit, the kernels JSON object
and the result object {"ok": true, "device": {...}}.
Imports nothing of JAX: `jax` is blocked in sys.modules before the port loads.
"""
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
K_SMALL = 9
K_SLICE, BLOCKS_SLICE = 13, 110
K_BIG, BLOCKS_BIG = 18, 2048
C2E_COLUMNS = 212    # the slice's c2e batch: 123 advice + 1 instance + 8 z + 80 CQ
SEED = 0x5256
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
}


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


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def rand_limbs(gen, shape, device, p):
    """Canonical random field elements, (16, *shape) int32 limbs: 16-bit
    random limbs with the top limb kept below p's (so every value < p)."""
    import torch
    x = torch.randint(0, 1 << 16, (16, *shape), generator=gen,
                      dtype=torch.int32)
    x[15] %= (p >> 240)
    return x.to(device)


def compare_routes(C, pk, dev, routes, tag):
    """The h forward of each route on the same seeded inputs: bit-identical
    outputs; forward ms (CUDA events) and peak device memory per route."""
    import torch
    from sha2cq_tpu_torch.plonk.device_eval import get_h_fn
    stacks, rt = C.h_inputs(pk, dev, SEED)
    first = None
    for route in routes:
        flags = ROUTES[route]
        t0 = time.perf_counter()
        fn = get_h_fn(pk, dev, flags["h_mxu"], flags.get("h_cosets"))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if fn.route != route:
            fail(f"{tag}: flags {flags} built the {fn.route} route")
        scal = fn.scalar_table(*rt[:4], rt[4:])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*stacks, scal)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_time_ms(lambda: fn(*stacks, scal), 3)
        if first is None:
            first = out
        same = all(bool(torch.equal(a, b)) for a, b in zip(out, first))
        say(f"{tag}_route", route=route, identical=same, forward_ms=ms,
            peak_bytes=peak, resident_bytes_before=base,
            module_build_s=round(build_s, 3))
        if not same:
            fail(f"{tag}: the {route} route's h differs from the "
                 f"{routes[0]} route's")
        del out
    del stacks, first


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "sha2cq_tpu_torch")) or \
            not os.path.isdir(os.path.join(ROOT, "sha2cq_tpu")):
        fail("the sha2cq_tpu_torch package (and its reference overlay "
             "sha2cq_tpu/) must sit beside this script")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.modules["jax"] = None          # the port must never import jax
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
    ptxas = [ln.strip() for ln in K.build_info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    say("toolchain", card=smi, torch=torch.__version__,
        torch_cuda=torch.version.cuda, nvcc=nvcc_ver.splitlines()[-1],
        kernel_build_s=round(build_s, 3),
        device=torch.cuda.get_device_name(0))
    for ln in ptxas:
        print(f"[ptxas] {ln}", flush=True)

    from sha2cq_tpu_torch import compat as C
    from sha2cq_tpu_torch.fields import device as D
    from sha2cq_tpu_torch.ops import cuda_field as CF
    from sha2cq_tpu_torch.ops import mxu_ntt as MX
    from sha2cq_tpu_torch.ops import ntt as NTT
    from sha2cq_tpu_torch.plonk import h_vm
    from sha2cq_tpu_torch.plonk.device_eval import get_h_fn
    from sha2cq_tpu_torch.poly.domain import EvaluationDomain
    from sha2cq_tpu_torch.utils.profiling import profiler

    gen = torch.Generator().manual_seed(SEED)
    p = D.FR.p
    kernels = {}

    def record(name, out, ref, ms, plain_ms, **shape):
        err = max_abs_err(out, ref)
        source, replaces = KERNELS[name]
        kernels.setdefault(name, dict(name=name, route="cuda", source=source,
                                      replaces=replaces, launches=0,
                                      max_abs_err=0, ms=ms, plain_ms=plain_ms))
        k = kernels[name]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        say("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **shape)
        if err != 0:
            fail(f"{name} disagrees with its plain version ({shape})")

    # ---- phase 2a: K1 and K2 at the path's shapes ------------------------
    a = rand_limbs(gen, (123 * 8192,), dev, p)
    b = rand_limbs(gen, (123 * 8192,), dev, p)
    out = CF.mont_mul(a, b)
    torch.cuda.synchronize()
    ref = D.mont_mul_plain(a, b)
    record("mont_mul", out, ref,
           cuda_time_ms(lambda: CF.mont_mul(a, b), 20),
           cuda_time_ms(lambda: D.mont_mul_plain(a, b), 3),
           shape=[16, 123 * 8192])
    # the c2e ZETA pre-multiply: a 64-column chunk times a (16, 1, n) row
    x = rand_limbs(gen, (64, 8192), dev, p)
    row = rand_limbs(gen, (1, 8192), dev, p)
    out = CF.mont_mul(x, row)
    torch.cuda.synchronize()
    record("mont_mul", out, D.mont_mul_plain(x, row),
           cuda_time_ms(lambda: CF.mont_mul(x, row), 20),
           cuda_time_ms(lambda: D.mont_mul_plain(x, row), 3),
           shape=[16, 64, 8192], mode="row")
    del a, b, x, row, out, ref

    M, X = 512, 2048
    planes = torch.randint(0, (1 << 31) - 1, (32, M, X), generator=gen,
                           dtype=torch.int32).to(dev)
    modes = {
        "tile": (rand_limbs(gen, (M, X), dev, p), {}),
        "minor": (rand_limbs(gen, (M, 32), dev, p), {"mult_minor": 32}),
        "major": (rand_limbs(gen, (M, 32), dev, p), {"mult_major": 64}),
        "scalar": (rand_limbs(gen, (1,), dev, p), {"mult_is_tile": False}),
    }
    for mode, (mult, kw) in modes.items():
        out = CF.planes_to_limbs_mul(planes, mult, **kw)
        torch.cuda.synchronize()
        ref = CF.planes_to_limbs_mul_plain(planes, mult, **kw)
        record("planes_to_limbs_mul", out, ref,
               cuda_time_ms(lambda: CF.planes_to_limbs_mul(planes, mult, **kw), 20),
               cuda_time_ms(lambda: CF.planes_to_limbs_mul_plain(planes, mult, **kw), 2),
               shape=[32, M, X], mode=mode)
    del planes, modes, out, ref

    # ---- phase 2b: K4 at the k=13 slice's c2e shapes ---------------------
    # the coefficient columns of n = 2^13 after the ZETA pre-multiply and
    # the zero pad to ext = 2^14
    dom13 = EvaluationDomain(3, K_SLICE)
    ek = dom13.extended_k
    x = D.mont_mul(rand_limbs(gen, (C2E_COLUMNS, dom13.n), dev, p),
                   dom13._zeta_pattern(dom13.n, True, dev)[:, None, :])
    x = torch.nn.functional.pad(x, (0, dom13.extended_n - dom13.n))
    tw = NTT.twiddle_table(dom13.extended_omega, ek, "Fr", dev)
    for shape_name, arg in (("c2e_batch", x), ("one_column", x[:, 0])):
        arg = arg.contiguous()
        out = CF.ntt_radix2(arg, tw, ek)
        torch.cuda.synchronize()
        ref = NTT.ntt_last_axis_plain(arg, tw, ek)
        record("ntt_radix2", out, ref,
               cuda_time_ms(lambda: CF.ntt_radix2(arg, tw, ek), 20),
               cuda_time_ms(lambda: NTT.ntt_last_axis_plain(arg, tw, ek), 1),
               shape=list(arg.shape), case=shape_name)
    x16 = x[:, :8].to(torch.int16)      # int16 storage in, as the h path has
    out = CF.ntt_radix2(x16, tw, ek)
    torch.cuda.synchronize()
    record("ntt_radix2", out, NTT.ntt_last_axis_plain(x16, tw, ek), None,
           None, shape=list(x16.shape), case="int16_input")
    del x, x16, out, ref

    # ---- phase 2c: NTT plans built on the card against the host ----------
    dom18 = EvaluationDomain(3, K_BIG)
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

    # ---- phase 3: k=9 proofs on the card == host-path proof --------------
    t0 = time.perf_counter()
    small = C.build_sha256(C.PORT, K_SMALL, 1, SEED)
    proof_host = C.prove(C.PORT, small, 9)
    k9_launches = {}
    for route, flags in ROUTES.items():
        CF.reset_launches()
        proof_card = C.prove(C.PORT, small, 9, h_device=True, device=dev,
                             **flags)
        k9_launches[route] = dict(CF.launches)
        same = proof_card == proof_host
        ok_small = C.verify(C.PORT, small, proof_card)
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
    say("k9_done", seconds=round(time.perf_counter() - t0, 3))
    del small

    # ---- phase 4: the slice ----------------------------------------------
    t0 = time.perf_counter()
    case = C.build_sha256(C.PORT, K_SLICE, BLOCKS_SLICE, SEED)
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

    # phase 2d: K3 on the slice's program over ext = 16384 rows
    prog = h_fn.prog
    ncols = {g: 1 for g in h_vm.GROUPS}
    for op, ia, _b, _d in prog.instrs.tolist():
        if op < 8:
            ncols[h_vm.GROUPS[op]] = max(ncols[h_vm.GROUPS[op]], ia + 1)
    ext = dom.extended_n
    groups = {g: rand_limbs(gen, (c, ext), dev, p).to(torch.int16)
              for g, c in ncols.items()}
    nsc = 4 + cs.num_challenges + len(prog.const_scalars)
    scal = rand_limbs(gen, (nsc,), dev, p)
    loaded = h_vm.load_program(prog, groups, scal)

    def k3():
        return h_vm.vm_run(loaded, groups, scal)

    def k3_plain():
        return h_vm.vm_run_plain(prog.instrs, groups, scal, prog.n_reg,
                                 prog.out_reg)

    out = k3()
    torch.cuda.synchronize()
    ref = k3_plain()
    record("h_vm_run", out, ref, cuda_time_ms(k3, 5),
           cuda_time_ms(k3_plain, 1), shape=[16, ext],
           instructions=int(prog.instrs.shape[0]), registers=prog.n_reg)
    del groups, out, ref

    # the three routes on the same inputs (queue 3's comparison)
    compare_routes(C, case.pk, dev, list(ROUTES), "k13")

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
    proof = C.prove(C.PORT, case, 1, h_device=True, device=dev)
    cold_s = time.perf_counter() - t0
    cold_launches = dict(CF.launches)
    say("prove_cold", seconds=round(cold_s, 3), launches=cold_launches,
        proof_bytes=len(proof))
    print(profiler.report("cold prove phases"), flush=True)
    profiler.reset()
    CF.reset_launches()
    t0 = time.perf_counter()
    proof_w = C.prove(C.PORT, case, 2, h_device=True, device=dev)
    warm_s = time.perf_counter() - t0
    warm_launches = dict(CF.launches)
    say("prove_warm", seconds=round(warm_s, 3), launches=warm_launches)
    print(profiler.report("warm prove phases"), flush=True)
    profiler.reset()
    profiler.disable()
    t0 = time.perf_counter()
    ok = C.verify(C.PORT, case, proof) and C.verify(C.PORT, case, proof_w)
    say("verify", ok=ok, seconds=round(time.perf_counter() - t0, 3))
    if not ok:
        fail("the k=13 slice proof does not verify")
    for name in ("mont_mul", "planes_to_limbs_mul", "h_vm_run"):
        if cold_launches[name] <= 0 or warm_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the k=13 prove")
    say("prove_memory", peak_device_bytes=torch.cuda.max_memory_allocated())
    del case, h_fn, proof, proof_w
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 5: the full-width path, k=18 with 2048 blocks -------------
    t0 = time.perf_counter()
    big = C.build_sha256(C.PORT, K_BIG, BLOCKS_BIG, SEED)
    setup_s = time.perf_counter() - t0
    dom = big.pk.vk.domain
    say("k18_setup", k=K_BIG, blocks=BLOCKS_BIG, n=dom.n, ext=dom.extended_n,
        setup_and_keygen_s=round(setup_s, 3))
    torch.cuda.reset_peak_memory_stats()
    profiler.enable()
    CF.reset_launches()
    t0 = time.perf_counter()
    proof = C.prove(C.PORT, big, 1, h_device=True, device=dev)
    prove_s = time.perf_counter() - t0
    big_launches = dict(CF.launches)
    route = get_h_fn(big.pk, dev).route
    say("k18_prove", seconds=round(prove_s, 3), route=route,
        launches=big_launches, proof_bytes=len(proof),
        peak_device_bytes=torch.cuda.max_memory_allocated())
    print(profiler.report("k=18 prove phases"), flush=True)
    profiler.reset()
    profiler.disable()
    t0 = time.perf_counter()
    ok = C.verify(C.PORT, big, proof)
    say("k18_verify", ok=ok, seconds=round(time.perf_counter() - t0, 3))
    if not ok:
        fail("the k=18 proof does not verify")
    if route != "coset":
        fail(f"the auto route at k=18 is {route}, not the coset route")
    for name in ("mont_mul", "planes_to_limbs_mul", "h_vm_run"):
        if big_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the k=18 prove")
        kernels[name]["launches"] = big_launches[name]
    compare_routes(C, big.pk, dev, ["coset", "monolithic"], "k18")

    say("done", seconds=round(time.perf_counter() - t_start, 3))
    print(smi, flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
