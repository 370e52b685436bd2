"""The port's mxu_ntt_batch and mxu_lagrange_to_coeff_batch against the JAX
package's, limb for limb, on the same seeded (16, 5, 2^6) inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu.fields.host import FR_MOD as P
from sha2cq_tpu.ops import mxu_ntt as JM
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.fields import device as TD
from sha2cq_tpu_torch.ops import mxu_ntt as TM
from tests.test_torch_mxu_ntt import _omega, _rand, one_torch_thread  # noqa: F401

K, COLS = 6, 5


def _columns(seed):
    rng = np.random.default_rng(seed)
    return JD.np_pack(_rand(rng, COLS << K), JD.FR).reshape(16, COLS, 1 << K)


@pytest.mark.parametrize("max_m,chunk,scaled", [
    (512, 16, False),     # one 64-point digit matmul, the default chunk
    (8, 2, True),         # four-step levels, chunks of 2, a scale at the end
])
def test_ntt_batch_matches_jax(max_m, chunk, scaled):
    X = _columns(60 + max_m)
    w = _omega(K)
    scale = JD.np_pack([123456789], JD.FR) if scaled else None
    jplan, jres = JM.get_plan(1 << K, w, "Fr", max_m)
    want = np.asarray(JM.mxu_ntt_batch(
        jnp.asarray(X), jplan, jres, JD.FR, max_m=max_m, chunk=chunk,
        scale=None if scale is None else jnp.asarray(scale)))
    tplan, tres = TM.get_plan(1 << K, w, "Fr", max_m)
    got = TM.mxu_ntt_batch(
        compat.from_jax_limbs(X), tplan, tres, TD.FR, max_m=max_m,
        chunk=chunk,
        scale=None if scale is None else compat.from_jax_limbs(scale))
    assert got.shape == (16, COLS, 1 << K)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)


def test_lagrange_to_coeff_batch_matches_jax():
    X = _columns(61)
    w_inv = pow(_omega(K), P - 2, P)
    n_inv = pow(1 << K, P - 2, P)
    want = np.asarray(JM.mxu_lagrange_to_coeff_batch(
        jnp.asarray(X), w_inv, K, n_inv))
    got = TM.mxu_lagrange_to_coeff_batch(compat.from_jax_limbs(X), w_inv, K,
                                         n_inv)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)
    # and it is the inverse transform: back through the forward NTT
    plan, res = TM.get_plan(1 << K, _omega(K), "Fr")
    back = TM.mxu_ntt_batch(got, plan, res)
    assert TD.unpack(back, TD.FR) == JD.unpack(X, JD.FR)
