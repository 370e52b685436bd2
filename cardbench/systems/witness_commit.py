"""System `witness_commit`: a k-row prover's witness commitments through
sha2cq_tpu_torch's ParamsKZG.commit_lagrange_many, over an SRS made from
the configuration's fixed secret.

Set-up: the SRS's two bases, [s^i] G1 and [L_i(s)] G1 (made by the
program's native code on the first run in a checkout, then read back from
$CARDBENCH_CACHE/srs), the parameters, and one commit of a column drawn
for it, outside the window, with the program's span log on: the set-up
raises, and the run prints no result, where that commit ran no
msm_bucket_sums (K5) under its kzg_commit_many span, i.e. where the
program commits this configuration on the host.  A program with no
ops.msm.msm_device_many is refused the same way before the bases are made.
Traffic: request i is one advice column (cardbench/witness_columns.py),
drawn from (seed, i) before its span starts, as the (rows, 4) u64 buffer
the prover builds; serving it is the prover's own call,
commit_lagrange_many([column]), a batch of one, so that commits_per_s
counts one commitment a request.  The check draws every served column
again and compares its commitment with [sum_i v_i L_i(s)] G1
(reference/kzg_lagrange.py), in worker processes that are all gone when
it returns.  The control (`control`) serves the plain commitment of the
values cut to 240 bits.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context, resource_tracker
from types import SimpleNamespace

from cardbench import witness_columns
from cardbench.reference import bn254, kzg_lagrange

SPAN = "kzg_commit_many"
CHECK_WORKERS = 6
HOST_REFUSAL = ("the program commits this configuration on the host: "
                "ParamsKZG.commit_lagrange_many ran no device MSM")


def _secret(config) -> int:
    return int(config["srs_secret"], 0) % bn254.R


def _cached_points(name: str, secret: int, n: int, make) -> list:
    """`make()`'s n affine points, made once and then read from
    $CARDBENCH_CACHE/srs (x, y as 32-byte little-endian words)."""
    tag = hashlib.sha256(f"{secret}:{n}".encode()).hexdigest()[:16]
    cache = os.path.join(os.environ["CARDBENCH_CACHE"], "srs")
    path = os.path.join(cache, f"{name}_{n}_{tag}.bin")
    if os.path.exists(path) and os.path.getsize(path) == 64 * n:
        with open(path, "rb") as f:
            raw = f.read()
        ints = [int.from_bytes(raw[i:i + 32], "little")
                for i in range(0, len(raw), 32)]
        return list(zip(ints[0::2], ints[1::2]))
    pts = make()
    os.makedirs(cache, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little")
                         for x, y in pts))
    os.replace(tmp, path)
    return pts


def setup(config, traffic, seed, device):
    from sha2cq_tpu_torch.curves import host as CH
    from sha2cq_tpu_torch.ops import msm as M
    from sha2cq_tpu_torch.poly.kzg import params as KP
    if not hasattr(M, "msm_device_many"):
        raise RuntimeError(HOST_REFUSAL + " (no ops.msm.msm_device_many)")
    s, k = _secret(config), config["k"]
    n = 1 << k
    if traffic["rows"] != n or traffic["used_rows"] != \
            config["blocks"] * config["block_rows"] or \
            len(traffic["columns"]) != config["advice_columns"] or \
            traffic["blinded_rows"] != config["blinding_factors"] + 1:
        raise ValueError("the traffic's rows and columns are not the "
                         "configuration's")
    params = KP.ParamsKZG(
        k=k, n=n,
        g=_cached_points("g1", s, n, lambda: KP._g1_powers_of_s(s, n)),
        g_lagrange=_cached_points(
            "g1lagrange", s, n, lambda: KP._lagrange_basis_from_s(s, n)),
        g2=CH.G2_GEN, s_g2=CH.g2_mul(CH.G2_GEN, s))
    state = SimpleNamespace(config=config, traffic=traffic, seed=seed,
                            device=device, params=params)
    if not _ran_on_device(lambda: serve(state, request(state, "warm-up"))):
        raise RuntimeError(HOST_REFUSAL)
    return state


def _ran_on_device(call) -> bool:
    """Whether `call` ran K5 (a msm_bucket_sums span) inside a root span
    kzg_commit_many, read from the program's span log with the profiler
    on for the call; the profiler is left as it was."""
    from sha2cq_tpu_torch.utils.profiling import profiler
    was = profiler.enabled
    profiler.enable()
    profiler.clear_log()
    try:
        call()
        spans = profiler.log()
    finally:
        if not was:
            profiler.disable()
        profiler.reset()
        profiler.clear_log()
    roots = {sp.trace for sp in spans
             if sp.name == SPAN and sp.parent is None}
    return any(sp.name == "msm_bucket_sums" and sp.trace in roots
               for sp in spans)


def request(state, index):
    """Request `index`: its column's values, drawn afresh from (seed,
    index)."""
    return SimpleNamespace(index=index, words=witness_columns.request_words(
        state.seed, index, state.traffic))


def serve(state, req):
    words, req.words = req.words, None        # drawn again by the check
    return state.params.commit_lagrange_many([words])[0]


@contextlib.contextmanager
def control(state):
    """ParamsKZG.commit_lagrange_many replaced by the plain commitment of
    the values cut to 240 bits (the 16 full windows of a 15-bit
    Pippenger): the exactness guarantee broken as a lower precision would
    break it."""
    from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
    real = ParamsKZG.commit_lagrange_many
    if getattr(state, "lagrange", None) is None:
        state.lagrange = kzg_lagrange.lagrange_at(_secret(state.config),
                                                  state.traffic["rows"])
    lag = state.lagrange

    def cut(self, columns):
        out = []
        for words in columns:
            words = words.copy()
            words[:, 3] &= (1 << 48) - 1
            out.append(kzg_lagrange.commitment(
                kzg_lagrange.evaluate_words(words, lag)))
        return out
    ParamsKZG.commit_lagrange_many = cut
    try:
        yield
    finally:
        ParamsKZG.commit_lagrange_many = real


def check(state, served) -> dict:
    """Every commitment of the window against [sum_i v_i L_i(s)] G1 of its
    column, drawn again (in CHECK_WORKERS processes, whose resource
    tracker is stopped with them); also the live digits of each, for
    msm_witness_roofline."""
    state.params = None
    s = _secret(state.config)
    jobs = [(state.seed, req.index, state.traffic, s) for req, _ in served]
    try:
        with ProcessPoolExecutor(CHECK_WORKERS,
                                 mp_context=get_context("spawn")) as pool:
            results = list(pool.map(witness_columns.value_and_live, jobs))
    finally:
        # the spawn pool starts multiprocessing's resource tracker, which
        # would otherwise end only after this process
        stop = getattr(resource_tracker._resource_tracker, "_stop", None)
        if stop is not None:
            stop()
    state.findings = [f"commit {i} differs from [sum v_i L_i(s)] G1"
                      for i, ((_, point), (value, _)) in enumerate(zip(served, results))
                      if point != kzg_lagrange.commitment(value)]
    state.live = [live for _, live in results]
    wrong = len(state.findings)
    state.findings.append(f"{len(served)} commitments checked")
    return {"commits_wrong": (wrong, 0)}
