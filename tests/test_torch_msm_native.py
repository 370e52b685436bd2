"""The port's wrappers of the native host MSM (sha2cq_tpu_torch.native_loader):
the batch-affine Pippenger, taken above 512 points, against the pure-Python
Pippenger of ops/msm.msm_host; and an allocation failure on the C side,
which leaves the output unwritten, raises MemoryError instead of reading as
the identity."""
import random

import pytest

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
