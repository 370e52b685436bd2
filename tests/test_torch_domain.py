"""Device methods of the port's EvaluationDomain (sha2cq_tpu_torch.poly.
domain: the butterfly route's transforms) against the JAX package's
EvaluationDomain on the same seeded inputs: exact (tolerance 0).  K = 4
with a degree-5 constraint system (ext = 4n) against the JAX device
methods, and K = 9 with degree 3 (ext = 2n, the SHA-256 circuit's shape)
against the same class's host methods, because XLA's CPU compile of the
jitted 2^9 and 2^10 butterflies takes over a minute (canonical forms are
unique, so equal values are equal limbs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu.fields.host import FR_MOD as P
from sha2cq_tpu.poly.domain import EvaluationDomain as JDomain
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.poly.domain import EvaluationDomain as TDomain
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

JIT_MAX_K = 4

# device method -> the JAX domain's host method computing the same values
HOST = {
    "lagrange_to_coeff": "lagrange_to_coeff_host",
    "coeff_to_lagrange": "coeff_to_lagrange_host",
    "coeff_to_extended": "coeff_to_extended_host",
    "extended_to_coeff": "extended_to_coeff_host",
    "divide_by_vanishing_poly": "divide_by_vanishing_poly_host",
    "lagrange_to_coeff_batch": "lagrange_to_coeff_host",
    "coeff_to_extended_batch": "coeff_to_extended_host",
}


def _reference(jd, method: str, x: np.ndarray) -> np.ndarray:
    """The JAX domain's answer for `method` on limbs x (uint32)."""
    if jd.k <= JIT_MAX_K:
        return np.asarray(getattr(jd, method)(jnp.asarray(x)))
    host = getattr(jd, HOST[method])

    def one(col):
        return JD.np_pack(host(JD.unpack(jnp.asarray(col), JD.FR)), JD.FR)
    if method.endswith("_batch"):
        return np.stack([one(x[:, c]) for c in range(x.shape[1])], axis=1)
    return one(x)


@pytest.mark.parametrize("j,k", [(5, 4), (3, 9)])
def test_domain_device_methods_match_jax(j, k):
    jd, td = JDomain(j, k), TDomain(j, k)
    assert (td.extended_k, td.extended_omega) == (jd.extended_k,
                                                  jd.extended_omega)
    rng = np.random.default_rng(100 + k)
    n, ext = td.n, td.extended_n
    x = compat.random_limbs(rng, (n,), P).astype(np.uint32)
    xe = compat.random_limbs(rng, (ext,), P).astype(np.uint32)
    xb = compat.random_limbs(rng, (3, n), P).astype(np.uint32)
    inputs = {"lagrange_to_coeff": x, "coeff_to_lagrange": x,
              "coeff_to_extended": x, "extended_to_coeff": xe,
              "divide_by_vanishing_poly": xe, "lagrange_to_coeff_batch": xb,
              "coeff_to_extended_batch": xb}
    for method, arg in inputs.items():
        got = getattr(td, method)(compat.from_jax_limbs(arg))
        np.testing.assert_array_equal(compat.to_jax_limbs(got),
                                      _reference(jd, method, arg),
                                      err_msg=method)
    # int16 storage in, the same values out
    got16 = td.lagrange_to_coeff_batch(compat.from_jax_limbs(
        xb, dtype=torch.int16))
    np.testing.assert_array_equal(
        compat.to_jax_limbs(got16),
        _reference(jd, "lagrange_to_coeff_batch", xb))
    for rot in (-1, 0, 2):
        np.testing.assert_array_equal(
            compat.to_jax_limbs(td.rotate_extended(
                compat.from_jax_limbs(xe), rot)),
            np.asarray(jd.rotate_extended(jnp.asarray(xe), rot)))
    np.testing.assert_array_equal(compat.to_jax_limbs(td._const(12345)),
                                  np.asarray(jd._const(12345)))
    np.testing.assert_array_equal(
        compat.to_jax_limbs(td._zeta_pattern(n, True)),
        np.asarray(jd._zeta_pattern(n, True)))


@pytest.mark.parametrize("j,k", [(5, 4), (3, 9)])
def test_domain_round_trips(j, k):
    td = TDomain(j, k)
    rng = np.random.default_rng(200 + k)
    x = compat.from_jax_limbs(compat.random_limbs(rng, (td.n,), P))
    assert torch.equal(td.lagrange_to_coeff(td.coeff_to_lagrange(x)), x)
    back = td.extended_to_coeff(td.coeff_to_extended(x))
    want = torch.nn.functional.pad(x, (0, back.shape[1] - td.n))
    assert torch.equal(back, want)
    xb = compat.from_jax_limbs(compat.random_limbs(rng, (2, td.n), P))
    ext = td.coeff_to_extended_batch(xb)
    assert torch.equal(td.extended_to_coeff(ext[:, 1])[:, :td.n], xb[:, 1])
