"""The port's wrappers of the native host MSM (sha2cq_tpu_torch.native_loader):
the batch-affine Pippenger, taken above 512 points, against the pure-Python
Pippenger of ops/msm.msm_host; the batched wrappers (native_msm_multi,
native_msm_grouped_multi, through g1_msm_unified) against the JAX package's
(sha2cq_tpu.native_loader, through g1_msm_multi and g1_msm_grouped_multi);
and an allocation failure on the C side, which leaves the output unwritten
or reports a nonzero job status, raises MemoryError instead of reading as
the identity."""
import random

import numpy as np
import pytest

from sha2cq_tpu import native_loader as RNL

from sha2cq_tpu_torch import native_loader as NL
from sha2cq_tpu_torch.curves import host as CH
from sha2cq_tpu_torch.fields.host import FR_MOD
from sha2cq_tpu_torch.ops import msm as M

N = 600          # above native/fieldops.c's MSM_SMALL_N = 512


@pytest.fixture(scope="module")
def case():
    if NL.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = random.Random(600)
    jac = NL.native_batch_scalar_mul([CH.jac_from_affine(CH.G1_GEN)] * N,
                                     [rng.randrange(1, FR_MOD) for _ in range(N)])
    pts = CH.jac_batch_to_affine(jac)
    sc = [rng.randrange(FR_MOD) for _ in range(N)]
    sc[3] = 0
    pts[7], sc[7] = pts[6], sc[6]
    pts[9], sc[9] = CH.g1_neg(pts[8]), sc[8]
    return sc, pts


def _python_pippenger(sc, pts, monkeypatch):
    """msm_host with the native calls answering None: its pure-Python
    Jacobian Pippenger."""
    with monkeypatch.context() as mp:
        mp.setattr(NL, "native_msm", lambda *a: None)
        return M.msm_host(sc, pts)


def test_native_batch_affine_msm_matches_python_pippenger(case, monkeypatch):
    sc, pts = case
    want = _python_pippenger(sc, pts, monkeypatch)
    jac = [CH.jac_from_affine(p) for p in pts]
    assert CH.jac_to_affine(NL.native_msm(sc, jac)) == want
    packed = NL.pack_points_affine(pts)
    assert CH.jac_to_affine(NL.native_msm_packed(sc, packed, N)) == want
    idx = list(range(N - 1, -1, -1))
    got = NL.native_msm_indexed([sc[i] for i in idx], idx, packed)
    assert CH.jac_to_affine(got) == want


class _NoWriteLib:
    """A native library whose MSMs fail to allocate: g1_msm and
    g1_msm_indexed return without writing `out`, as fieldops.c does."""

    def g1_msm(self, *args):
        pass

    def g1_msm_indexed(self, *args):
        pass


def test_native_msm_allocation_failure_raises(case, monkeypatch):
    sc, pts = case
    packed = NL.pack_points_affine(pts[:4])
    monkeypatch.setattr(NL, "get_lib", lambda: _NoWriteLib())
    with pytest.raises(MemoryError):
        NL.native_msm(sc[:4], [CH.jac_from_affine(p) for p in pts[:4]])
    with pytest.raises(MemoryError):
        NL.native_msm_packed(sc[:4], packed, 4)
    with pytest.raises(MemoryError):
        NL.native_msm_indexed(sc[:2], [0, 3], packed)


def test_native_msm_identity_result_is_not_a_failure(case):
    """A result that is the identity (P + (-P)) is written, so it reads as
    the identity and raises nothing."""
    _, pts = case
    jac = [CH.jac_from_affine(p) for p in (pts[8], pts[9])]
    assert CH.jac_to_affine(NL.native_msm([5, 5], jac)) is None
    assert CH.jac_to_affine(NL.native_msm([0, 0], jac)) is None


def _batched_jobs(pts):
    """Seeded jobs of both kinds over one packed basis: plain (list
    scalars), indexed (a list and an int64 array of indices, a u64 scalar
    buffer), empty; grouped (CSR rows by group, one with a repeated row)."""
    rng = random.Random(601)
    packed = NL.pack_points_affine(pts)
    n = len(pts)
    plain = [rng.randrange(FR_MOD) for _ in range(n)]
    idx = [rng.randrange(n) for _ in range(40)]
    idx_np = np.array([rng.randrange(n) for _ in range(530)], dtype=np.int64)
    buf = NL.fr_buf([rng.randrange(FR_MOD) for _ in range(530)])
    jobs = [(packed, None, plain),
            (packed, idx, [rng.randrange(FR_MOD) for _ in idx]),
            (packed, idx_np, buf),
            (packed, None, [])]
    gjobs = []
    for ng, rows in ((5, 60), (3, 7)):
        gid = np.array([rng.randrange(ng) for _ in range(rows)])
        order = np.argsort(gid, kind="stable").astype(np.int64)
        row_idx = np.array([rng.randrange(n) for _ in range(rows)],
                           dtype=np.int64)[order]
        row_idx[1] = row_idx[0]
        starts = np.zeros(ng + 1, dtype=np.int64)
        np.cumsum(np.bincount(gid, minlength=ng), out=starts[1:])
        gjobs.append((packed, row_idx, starts,
                      NL.fr_buf([rng.randrange(FR_MOD) for _ in range(ng)])))
    return jobs, gjobs


def _affine(jacs):
    return [CH.jac_to_affine(j) for j in jacs]


def test_batched_wrappers_match_the_jax_package(case):
    """native_msm_multi and native_msm_grouped_multi, now through
    g1_msm_unified, give the JAX package's points on the same jobs."""
    _, pts = case
    jobs, gjobs = _batched_jobs(pts)
    got = _affine(NL.native_msm_multi(jobs))
    want = _affine(RNL.native_msm_multi(jobs))
    assert got == want and got[3] is None and all(got[:3])
    got = _affine(NL.native_msm_grouped_multi(gjobs))
    assert got == _affine(RNL.native_msm_grouped_multi(gjobs)) and all(got)
    assert M.msm_combined([j + (pts,) for j in jobs], gjobs) == \
        _affine(RNL.native_msm_multi(jobs)) + \
        _affine(RNL.native_msm_grouped_multi(gjobs))


class _FailingUnified:
    """A native library whose g1_msm_unified reports a nonzero status for
    the jobs in `failing` and writes the identity there, as fieldops.c
    does when a job cannot allocate."""

    def __init__(self, lib, failing):
        def unified(modes, bases, idx, starts, sizes, scal, k, out, status):
            lib.g1_msm_unified(modes, bases, idx, starts, sizes, scal, k,
                               out, status)
            for j in failing:
                status[j] = 1
            return len(failing)
        self.g1_msm_unified = unified


@pytest.mark.parametrize("failing", [[0], [1]])
def test_batched_allocation_failure_raises(case, monkeypatch, failing):
    _, pts = case
    jobs, gjobs = _batched_jobs(pts)
    monkeypatch.setattr(NL, "get_lib",
                        lambda: _FailingUnified(NL._lib, failing))
    with pytest.raises(MemoryError):
        NL.native_msm_multi(jobs[:2])
    with pytest.raises(MemoryError):
        NL.native_msm_grouped_multi(gjobs)
    with pytest.raises(MemoryError):
        M.msm_multi([j + (pts,) for j in jobs[:2]])
    with pytest.raises(MemoryError):
        M.msm_combined([j + (pts,) for j in jobs[:1]], gjobs[:1])
