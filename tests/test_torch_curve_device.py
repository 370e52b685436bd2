"""The port's device G1 point code (sha2cq_tpu_torch.curves.device, the
plain version of the MSM kernels' point arithmetic) against the JAX
package's sha2cq_tpu.curves.device: point_add and point_double under
jax.jit on one batch of lanes covering the identity on either side, P = Q
(also in two Jacobian forms), P = -Q and random points; the Jacobian limbs
must be equal.  The two JAX functions compile once for the file."""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sha2cq_tpu.curves import device as JPD
from sha2cq_tpu.fields import device as JD
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch import native_loader as NL
from sha2cq_tpu_torch.curves import device as TPD
from sha2cq_tpu_torch.curves import host as CH
from sha2cq_tpu_torch.fields.host import FQ_MOD, FR_MOD
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401


def _jacobian(pt, z):
    """An affine point (None = identity) in Jacobian form with Z = z."""
    if pt is None:
        return (0, 1, 0)
    x, y = pt
    return (x * z * z % FQ_MOD, y * z * z * z % FQ_MOD, z)


def _lanes():
    rng = random.Random(11)
    pts = [CH.g1_mul(CH.G1_GEN, rng.randrange(1, FR_MOD)) for _ in range(6)]
    z = [rng.randrange(2, FQ_MOD) for _ in range(16)]
    P = [None, pts[0], pts[1], pts[2], None, pts[3], pts[4], pts[1]]
    Q = [pts[5], None, pts[1], CH.g1_neg(pts[2]), None, pts[5], pts[0],
         pts[1]]
    zq = list(z[8:])
    zq[2] = 1                      # lane 2: P == Q in the same form
    return ([_jacobian(p, z[i]) for i, p in enumerate(P)],
            [_jacobian(q, zq[i]) for i, q in enumerate(Q)])


def _pack(points):
    arr = [JD.np_pack([p[i] for p in points], JD.FQ) for i in range(3)]
    return (tuple(jnp.asarray(a) for a in arr),
            tuple(compat.from_jax_limbs(a) for a in arr))


@pytest.fixture(scope="module")
def jax_ops():
    return jax.jit(JPD.point_add), jax.jit(JPD.point_double)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(compat.to_jax_limbs(g), np.asarray(w))


def test_point_add_and_double_match_jax(jax_ops):
    j_add, j_dbl = jax_ops
    P, Q = _lanes()
    jp, tp = _pack(P)
    jq, tq = _pack(Q)
    s = TPD.point_add(tp, tq)
    _same(s, j_add(jp, jq))
    _same(TPD.point_double(tp), j_dbl(jp))
    _same(TPD.point_double(tq), j_dbl(jq))
    aff = lambda pts: [CH.jac_to_affine(p) for p in pts]  # noqa: E731
    want = [CH.g1_add(a, b) for a, b in zip(aff(P), aff(Q))]
    assert TPD.unpack_jacobian(s) == want
    assert want[3] is None and want[4] is None          # P + (-P), 0 + 0
    assert TPD.unpack_jacobian(TPD.point_double(tp)) == \
        [CH.g1_add(a, a) for a in aff(P)]


def test_identity_neg_select_match_jax():
    P, Q = _lanes()
    jp, tp = _pack(P)
    jq, tq = _pack(Q)
    _same(TPD.identity_like((8,)), JPD.identity_like((8,)))
    assert TPD.is_identity(tp).tolist() == \
        np.asarray(JPD.is_identity(jp)).tolist()
    _same(TPD.point_neg(tp), JPD.point_neg(jp))
    mask = np.array([True, False] * 4)
    import torch
    _same(TPD.select_point(torch.from_numpy(mask), tp, tq),
          JPD.select_point(jnp.asarray(mask), jp, jq))


def test_pack_affine_matches_jax_and_the_packed_basis():
    """pack_affine from host points equals the JAX package's; from a
    native packed basis (any leading count) it gives the same limbs."""
    rng = random.Random(12)
    pts = [CH.g1_mul(CH.G1_GEN, rng.randrange(1, FR_MOD)) for _ in range(9)]
    mixed = pts[:3] + [None] + pts[3:]
    _same(TPD.pack_affine(mixed), JPD.pack_affine(mixed))
    assert TPD.unpack_jacobian(TPD.pack_affine(mixed)) == mixed
    packed = NL.pack_points_affine(pts)
    if packed is None:
        pytest.skip("native library unavailable")
    full = TPD.pack_affine(pts)
    for n in (9, 5):
        got = TPD.pack_affine(packed=packed, n=n)
        for g, w in zip(got, full):
            assert g.equal(w[:, :n])
    bad = NL._pack_jac([(pts[0][0], pts[0][1], 2)])
    with pytest.raises(ValueError, match="z = 1"):
        TPD.pack_affine(packed=bad)
