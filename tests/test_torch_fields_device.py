"""The rest of the port's device field layer (sha2cq_tpu_torch.fields.device:
constants, masks, conversions, powers, inverses; the plain versions of
kernel K1 underneath) against the JAX package's functions of the same names
on the same seeded inputs, limb for limb, for Fr and Fq (mirrors
tests/test_fields_device.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.fields import device as TD
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

NAMES = ["Fr", "Fq"]


def _ctxs(name):
    return (JD.FR, TD.FR) if name == "Fr" else (JD.FQ, TD.FQ)


def _values(seed, p, n=40):
    """Random elements < p with 0, 1, p - 1 and p - 2 in front."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:4] = [0, 1, p - 1, p - 2]
    return vals


def _both(vals, jctx, mont=True):
    arr = JD.np_pack(vals, jctx, mont=mont)
    return jnp.asarray(arr), compat.from_jax_limbs(arr)


def _same(got, want):
    np.testing.assert_array_equal(compat.to_jax_limbs(got), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_constants_match_jax(name):
    jctx, tctx = _ctxs(name)
    _same(TD.zeros((3, 5), tctx), JD.zeros((3, 5), jctx))
    _same(TD.ones((4,), tctx), JD.ones((4,), jctx))
    for value in (0, 1, 7, jctx.p - 1, jctx.p + 3):
        _same(TD.const_array(tctx, value, (2, 3)),
              JD.const_array(jctx, value, (2, 3)))
    assert TD.unpack(TD.ones((4,), tctx), tctx) == [1] * 4


@pytest.mark.parametrize("name", NAMES)
def test_masks_and_select_match_jax(name):
    jctx, tctx = _ctxs(name)
    ja, ta = _both([0, 5, 0, 7, jctx.p - 1], jctx)
    jb, tb = _both([0, 5, 1, 6, jctx.p - 1], jctx)
    assert TD.is_zero(ta).tolist() == np.asarray(JD.is_zero(ja)).tolist() \
        == [True, False, True, False, False]
    assert TD.eq(ta, tb).tolist() == np.asarray(JD.eq(ja, jb)).tolist() \
        == [True, True, False, False, True]
    assert TD.eq(ta.to(torch.int16), tb).tolist() == TD.eq(ta, tb).tolist()
    _same(TD.select(TD.is_zero(ta), tb, ta), JD.select(JD.is_zero(ja), jb, ja))


@pytest.mark.parametrize("name", NAMES)
def test_conversions_and_products_match_jax(name):
    jctx, tctx = _ctxs(name)
    p = jctx.p
    xs = _values(3 if name == "Fr" else 4, p)
    ja, ta = _both(xs, jctx)
    _same(TD.mont_sq(ta, tctx), JD.mont_sq(ja, jctx))
    std = TD.from_mont(ta, tctx)
    _same(std, JD.from_mont(ja, jctx))
    assert TD.unpack(std, tctx, mont=False) == xs
    _same(TD.to_mont(std, tctx), JD.to_mont(JD.from_mont(ja, jctx), jctx))
    assert TD.unpack(TD.to_mont(std, tctx), tctx) == xs
    k = 123456789
    js, ts = _both([k], jctx)
    _same(TD.mul_scalar(ta, ts[:, 0], tctx), JD.mul_scalar(ja, js[:, 0], jctx))
    assert TD.unpack(TD.mul_scalar(ta, ts[:, 0], tctx), tctx) == \
        [x * k % p for x in xs]


@pytest.mark.parametrize("name", NAMES)
def test_pow_and_inverse_match_jax(name):
    jctx, tctx = _ctxs(name)
    p = jctx.p
    xs = _values(5 if name == "Fr" else 6, p, 9)
    ja, ta = _both(xs, jctx)
    for e in (0, 1, 2, 5, 0xDEADBEEF):
        got = TD.pow_const(ta, e, tctx)
        _same(got, jax.jit(lambda a, e=e: JD.pow_const(a, e, jctx))(ja))
        assert TD.unpack(got, tctx) == [pow(x, e, p) for x in xs]
    got = TD.inv(ta, tctx)
    _same(got, jax.jit(lambda a: JD.inv(a, jctx))(ja))
    assert TD.unpack(got, tctx) == [0 if x == 0 else pow(x, p - 2, p)
                                    for x in xs]
