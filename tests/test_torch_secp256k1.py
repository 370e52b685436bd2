"""secp256k1 through the port (sha2cq_tpu_torch.curves.secp256k1 and the
wide-modulus device field): the cases of tests/test_secp256k1.py against the
JAX package's module, and the port's plain wide Montgomery product -- K1w's
plain version -- against the JAX fields.device.mont_mul on the same limbs,
edge values included (exact)."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.curves import secp256k1 as JS
from sha2cq_tpu.fields import device as JD
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.curves import generic as TG
from sha2cq_tpu_torch.curves import secp256k1 as S
from sha2cq_tpu_torch.fields import device as TD
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

R = 1 << 256
FIELDS = [(0, S.FP_MOD), (1, S.FQ_MOD)]


def test_generator_on_curve_and_order():
    assert S.is_on_curve(S.GENERATOR)
    assert S.mul(S.GENERATOR, S.FQ_MOD) is None
    assert S.mul(S.GENERATOR, 1) == S.GENERATOR
    assert (S.FP_MOD, S.FQ_MOD, S.GENERATOR) == \
        (JS.FP_MOD, JS.FQ_MOD, JS.GENERATOR)
    curve = TG.SECP256K1
    assert (curve.p, curve.order, curve.generator) == \
        (S.FP_MOD, S.FQ_MOD, S.GENERATOR)


def test_group_laws():
    rng = random.Random(1)
    a, b = rng.randrange(1, S.FQ_MOD), rng.randrange(1, S.FQ_MOD)
    P = S.mul(S.GENERATOR, a)
    Q = S.mul(S.GENERATOR, b)
    PQ = S.jac_to_affine(S.jac_add(S.jac_from_affine(P), S.jac_from_affine(Q)))
    QP = S.jac_to_affine(S.jac_add(S.jac_from_affine(Q), S.jac_from_affine(P)))
    assert PQ == QP == S.mul(S.GENERATOR, (a + b) % S.FQ_MOD)
    assert PQ == JS.mul(JS.GENERATOR, (a + b) % S.FQ_MOD)
    assert S.jac_to_affine(S.jac_double(S.jac_from_affine(P))) == \
        S.mul(S.GENERATOR, 2 * a % S.FQ_MOD)
    assert S.jac_to_affine(
        S.jac_add(S.jac_from_affine(P), S.jac_from_affine(S.neg(P)))) is None


def test_msm_matches_sum_and_reference():
    rng = random.Random(2)
    pts = [S.mul(S.GENERATOR, rng.randrange(1, S.FQ_MOD)) for _ in range(5)]
    scalars = [rng.randrange(S.FQ_MOD) for _ in range(5)]
    acc = S.JAC_IDENTITY
    for s, p in zip(scalars, pts):
        acc = S.jac_add(acc, S.jac_from_affine(S.mul(p, s)))
    assert S.msm(scalars, pts) == S.jac_to_affine(acc) == \
        JS.msm(scalars, pts)


def test_sqrt_both_fields():
    rng = random.Random(3)
    for _ in range(4):
        x = rng.randrange(1, S.FP_MOD)
        r = S.fp_sqrt(x * x % S.FP_MOD)
        assert r is not None and r * r % S.FP_MOD == x * x % S.FP_MOD
        assert r == JS.fp_sqrt(x * x % S.FP_MOD)
        y = rng.randrange(1, S.FQ_MOD)
        r = S.fq_sqrt(y * y % S.FQ_MOD)
        assert r is not None and r * r % S.FQ_MOD == y * y % S.FQ_MOD
        assert r == JS.fq_sqrt(y * y % S.FQ_MOD)
    w = S.FQ_ROOT_OF_UNITY
    assert pow(w, 1 << S.FQ_S, S.FQ_MOD) == 1
    assert pow(w, 1 << (S.FQ_S - 1), S.FQ_MOD) != 1


def test_serde_roundtrip():
    rng = random.Random(4)
    for _ in range(4):
        p = S.mul(S.GENERATOR, rng.randrange(1, S.FQ_MOD))
        assert S.from_bytes(S.to_bytes(p)) == p
        assert S.to_bytes(p) == JS.to_bytes(p)
    assert S.from_bytes(S.to_bytes(None)) is None
    with pytest.raises(ValueError):
        S.from_bytes(bytes(32))


@pytest.mark.parametrize("which,mod", FIELDS)
def test_device_ctxs_are_wide_and_match_the_reference(which, mod):
    t, j = S.device_ctxs()[which], JS.device_ctxs()[which]
    assert t.wide and j.wide and t.p == j.p == mod
    assert (t.name, t.n0, t.r, t.r2) == (j.name, j.n0, j.r, j.r2)
    np.testing.assert_array_equal(t.p_limbs, j.p_limbs)


def test_device_montgomery_kernels():
    """pack -> mont_mul -> unpack on the port's wide contexts (the CPU
    tensors take K1w's plain version) gives x * y mod p."""
    fp_ctx, fq_ctx = S.device_ctxs()
    rng = random.Random(5)
    for ctx, mod in ((fp_ctx, S.FP_MOD), (fq_ctx, S.FQ_MOD)):
        xs = [rng.randrange(mod) for _ in range(8)]
        ys = [rng.randrange(mod) for _ in range(8)]
        got = TD.unpack(TD.mont_mul(TD.pack(xs, ctx), TD.pack(ys, ctx), ctx),
                        ctx)
        assert got == [x * y % mod for x, y in zip(xs, ys)]


def _operands(mod, rng):
    """a < 2^256 and b < p: edge values (p - 1, 2^256 - 1, R mod p, 0, 1,
    2^255) crossed, then random pairs, many of whose REDC results t reach
    2^256 (the overflow word the wide product keeps)."""
    edges_a = [0, 1, mod - 1, mod - 2, R - 1, R - 2, R % mod, 1 << 255,
               R * R % mod]
    edges_b = [0, 1, mod - 1, R % mod, R * R % mod, mod // 2]
    pairs = [(a, b) for a in edges_a for b in edges_b]
    pairs += [(rng.randrange(R), rng.randrange(mod)) for _ in range(400)]
    pairs += [(rng.randrange(mod), rng.randrange(mod)) for _ in range(400)]
    return [a for a, _ in pairs], [b for _, b in pairs]


def _redc_t(a, b, mod):
    m = (-a * b * pow(mod, -1, R)) % R
    return (a * b + m * mod) // R


@pytest.mark.parametrize("which,mod", FIELDS)
def test_wide_mont_mul_plain_matches_jax(which, mod):
    """The port's mont_mul_plain on SecpFp / SecpFq equals the JAX
    fields.device.mont_mul limb for limb, and both equal the Montgomery
    product reduced once; the operands drive t past 2^256."""
    tctx, jctx = S.device_ctxs()[which], JS.device_ctxs()[which]
    xs, ys = _operands(mod, random.Random(60 + which))
    assert sum(_redc_t(a, b, mod) >= R for a, b in zip(xs, ys)) > 50
    A = np.array([[(x >> (16 * i)) & 0xFFFF for x in xs] for i in range(16)],
                 dtype=np.uint32)                # raw limbs: a < 2^256 kept
    B = JD.np_pack(ys, jctx, mont=False)
    want = np.asarray(JD.mont_mul(jnp.asarray(A), jnp.asarray(B), jctx))
    got = TD.mont_mul_plain(compat.from_jax_limbs(A),
                            compat.from_jax_limbs(B), tctx)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)
    rinv = pow(R, -1, mod)
    vals = TD.unpack(got, tctx, mont=False)
    assert vals == [a * b * rinv % mod for a, b in zip(xs, ys)]


@pytest.mark.parametrize("which,mod", FIELDS)
def test_wide_conversions_pow_and_inverse(which, mod):
    """to_mont -> pow_const -> inv -> from_mont on the port's wide contexts
    against Python integers (0 inverts to 0), and to_mont / from_mont
    against the JAX package's limbs."""
    ctx, jctx = S.device_ctxs()[which], JS.device_ctxs()[which]
    rng = random.Random(70 + which)
    xs = [0, 1, mod - 1, R % mod] + [rng.randrange(mod) for _ in range(60)]
    std = TD.pack(xs, ctx, mont=False)
    mont = TD.to_mont(std, ctx)
    assert torch.equal(mont, TD.pack(xs, ctx))
    np.testing.assert_array_equal(
        compat.to_jax_limbs(mont),
        np.asarray(JD.to_mont(jnp.asarray(JD.np_pack(xs, jctx, mont=False)),
                              jctx)))
    e = 0x10001
    powed = TD.pow_const(mont, e, ctx)
    inv = TD.inv(powed, ctx)
    out = TD.from_mont(inv, ctx)
    np.testing.assert_array_equal(
        compat.to_jax_limbs(TD.from_mont(mont, ctx)),
        np.asarray(JD.from_mont(jnp.asarray(compat.to_jax_limbs(mont)), jctx)))
    want = [pow(pow(x, e, mod), mod - 2, mod) for x in xs]
    assert TD.unpack(out, ctx, mont=False) == want
