"""System `commit`: KZG commitments through sha2cq_tpu_torch's
ParamsKZG.commit, over an SRS made from the configuration's fixed secret.

Set-up: the SRS's points [s^i] G1 (the program's native power chain on the
first run in a checkout, then read back from $CARDBENCH_CACHE/srs), the
parameters, and one commit of a vector drawn for it, outside the window
(the program's packed basis is made and disk-cached by the first run's).
Traffic: request i is `points` scalars of the mix's `scalars` distribution
drawn afresh from (seed, i) (cardbench/scalars.py), before its span
starts; serving it commits them and lets them go.  The check draws every
served request's vector again and compares its commitment with [p(s)] G1
(reference/kzg_commit.py).
The control (`control`) serves the plain commitment of the coefficients
cut to 240 bits.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from types import SimpleNamespace

from cardbench import scalars
from cardbench.reference import bn254, kzg_commit

SPAN = "ParamsKZG.commit"
CHECK_WORKERS = 4


def _secret(config) -> int:
    return int(config["srs_secret"], 0) % bn254.R


def _srs_points(secret: int, n: int) -> list:
    """[s^i] G1 for i < n: made by the program's native power chain once,
    then read from the cache (x, y as 32-byte little-endian words)."""
    tag = hashlib.sha256(f"{secret}:{n}".encode()).hexdigest()[:16]
    cache = os.path.join(os.environ["CARDBENCH_CACHE"], "srs")
    path = os.path.join(cache, f"g1_{n}_{tag}.bin")
    if os.path.exists(path) and os.path.getsize(path) == 64 * n:
        with open(path, "rb") as f:
            raw = f.read()
        ints = [int.from_bytes(raw[i:i + 32], "little")
                for i in range(0, len(raw), 32)]
        return list(zip(ints[0::2], ints[1::2]))
    from sha2cq_tpu_torch.poly.kzg import params as KP
    pts = KP._g1_powers_of_s(secret, n)
    os.makedirs(cache, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little")
                         for x, y in pts))
    os.replace(tmp, path)
    return pts


def setup(config, traffic, seed, device):
    from sha2cq_tpu_torch.curves import host as CH
    from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
    s, n = _secret(config), 1 << config["srs_log2"]
    if traffic["points"] > n:
        raise ValueError(f"{traffic['points']} points over an SRS of {n}")
    params = ParamsKZG(k=config["srs_log2"], n=n, g=_srs_points(s, n),
                       g_lagrange=[], g2=CH.G2_GEN, s_g2=CH.g2_mul(CH.G2_GEN, s))
    state = SimpleNamespace(config=config, traffic=traffic, seed=seed,
                            device=device, params=params)
    params.commit(request(state, "warm-up").coeffs)
    return state


def request(state, index):
    """Request `index`: its coefficients, drawn afresh from (seed, index)."""
    words = scalars.request_words(state.seed, index, state.traffic)
    return SimpleNamespace(index=index, coeffs=scalars.to_ints(words))


def serve(state, req):
    coeffs, req.coeffs = req.coeffs, None     # drawn again by the check
    return state.params.commit(coeffs)


@contextlib.contextmanager
def control(state):
    """ParamsKZG.commit replaced by the plain commitment of the coefficients
    cut to 240 bits (the 16 full windows of a 15-bit Pippenger): the
    exactness guarantee broken as a lower precision would break it."""
    from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
    real, s, mask = ParamsKZG.commit, _secret(state.config), (1 << 240) - 1

    def cut(self, coeffs):
        return kzg_commit.commitment(kzg_commit.evaluate(
            [c & mask for c in coeffs], s))
    ParamsKZG.commit = cut
    try:
        yield
    finally:
        ParamsKZG.commit = real


def check(state, served) -> dict:
    """Every commitment of the window against [p(s)] G1 of its request's
    coefficients, drawn again (in CHECK_WORKERS processes); also the live
    digits of each, for msm_roofline."""
    state.params = None
    s = _secret(state.config)
    jobs = [(state.seed, req.index, state.traffic, s) for req, _ in served]
    with ProcessPoolExecutor(CHECK_WORKERS, mp_context=get_context("spawn")) as pool:
        results = list(pool.map(scalars.value_and_live, jobs))
    state.findings = [f"commit {i} differs from [p(s)] G1"
                      for i, ((_, point), (value, _)) in enumerate(zip(served, results))
                      if point != kzg_commit.commitment(value)]
    state.live = [live for _, live in results]
    wrong = len(state.findings)
    state.findings.append(f"{len(served)} commitments checked")
    return {"commits_wrong": (wrong, 0)}
