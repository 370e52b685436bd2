"""Port field arithmetic (sha2cq_tpu_torch.fields.device, the plain
versions of kernel K1) against the JAX package and Python ints: exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.fields import device as TD
from sha2cq_tpu_torch.ops import cuda_field as CF
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

N = 300


def _ctxs(name):
    return (JD.FR, TD.FR) if name == "Fr" else (JD.FQ, TD.FQ)


def _values(seed, p):
    """Random elements < p plus the edge values 0, 1, p-1 and R mod p."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(N)]
    return vals + [0, 1, p - 1, (1 << 256) % p]


def _pair(name, seed):
    jctx, tctx = _ctxs(name)
    a = _values(seed, jctx.p)
    b = _values(seed + 1, jctx.p)[::-1]
    A = JD.np_pack(a, jctx)
    B = JD.np_pack(b, jctx)
    return jctx, tctx, a, b, A, B


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_plain_op_matches_jax(name, op):
    jctx, tctx, a, b, A, B = _pair(name, 11)
    want = np.asarray(getattr(JD, op)(jnp.asarray(A), jnp.asarray(B), jctx))
    got = getattr(TD, op)(compat.from_jax_limbs(A), compat.from_jax_limbs(B),
                          tctx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_plain_ops_match_python_ints(name):
    jctx, tctx, a, b, A, B = _pair(name, 21)
    p = jctx.p
    ta, tb = compat.from_jax_limbs(A), compat.from_jax_limbs(B)
    assert TD.unpack(TD.mont_mul(ta, tb, tctx), tctx) == \
        [x * y % p for x, y in zip(a, b)]
    assert TD.unpack(TD.add(ta, tb, tctx), tctx) == \
        [(x + y) % p for x, y in zip(a, b)]
    assert TD.unpack(TD.sub(ta, tb, tctx), tctx) == \
        [(x - y) % p for x, y in zip(a, b)]
    assert TD.unpack(TD.neg(ta, tctx), tctx) == [(-x) % p for x in a]


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_mont_mul_relaxed_and_broadcast_operands(name):
    """a may be relaxed (< 2^256, here 2^256 - 1), b a (16, 1) scalar or a
    (16, 1, X) row: the reference's contract, bit for bit."""
    jctx, tctx, a, b, A, B = _pair(name, 31)
    A = A.copy()
    A[:, 0] = 0xFFFF                         # 2^256 - 1, not reduced
    A3 = A[:, :300].reshape(16, 10, 30)
    row = B[:, :30].reshape(16, 1, 30)
    scal = B[:, 5:6]
    for x, y in ((A, scal), (A3, row), (A3, scal.reshape(16, 1, 1))):
        want = np.asarray(JD.mont_mul(jnp.asarray(x), jnp.asarray(y), jctx))
        got = CF.mont_mul(compat.from_jax_limbs(x), compat.from_jax_limbs(y),
                          tctx)
        np.testing.assert_array_equal(compat.to_jax_limbs(got), want)


def test_cpu_tensors_take_the_plain_version():
    """The wrappers dispatch on the tensor's device alone: CPU tensors run
    the plain version and count no kernel launch."""
    _, tctx, a, b, A, B = _pair("Fr", 41)
    CF.reset_launches()
    ta, tb = compat.from_jax_limbs(A), compat.from_jax_limbs(B)
    assert torch.equal(CF.mont_mul(ta, tb, tctx), TD.mont_mul_plain(ta, tb, tctx))
    assert CF.launches == {"mont_mul": 0, "planes_to_limbs_mul": 0,
                           "h_vm_run": 0, "ntt_radix2": 0}


@pytest.mark.parametrize("mont", [True, False])
def test_pack_unpack_match_jax(mont):
    """pack / np_pack / np_pack_buf / unpack / unpack_buf: the native
    (n >= 256) and Python routes give the reference's limbs and ints."""
    p = JD.FR.p
    for n in (7, 300):
        vals = _values(51 + n, p)[:n]
        want = JD.np_pack(vals, JD.FR, mont=mont)
        got = TD.pack(vals, TD.FR, mont=mont)
        np.testing.assert_array_equal(compat.to_jax_limbs(got), want)
        assert TD.unpack(got, TD.FR, mont=mont) == vals
        buf = TD.unpack_buf(got, TD.FR, mont=mont)
        np.testing.assert_array_equal(
            buf, JD.unpack_buf(jnp.asarray(want), JD.FR, mont=mont))
        np.testing.assert_array_equal(TD.np_pack_buf(buf, TD.FR, mont=mont),
                                      want)
        narrow = got.to(torch.int16)
        assert narrow.dtype == torch.int16
        assert TD.unpack(narrow, TD.FR, mont=mont) == vals
