"""Port digit-matmul NTT entry points (sha2cq_tpu_torch.ops.mxu_ntt)
against the JAX package's mxu_ntt / mxu_intt / mxu_ntt_batch_mapped: exact.
(The epilogue, plan and host-NTT checks are in test_torch_mxu_ntt.py; this
file holds the cases that compile JAX programs.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu.fields.host import FR_MOD as P
from sha2cq_tpu.ops import mxu_ntt as JM
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.fields import device as TD
from sha2cq_tpu_torch.ops import mxu_ntt as TM
from tests.test_torch_mxu_ntt import _omega, _rand, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("k,max_m", [(6, 8), (10, 32)])
def test_ntt_and_intt_match_jax(k, max_m):
    n = 1 << k
    w = _omega(k)
    X = JD.np_pack(_rand(np.random.default_rng(100 + k), n), JD.FR)
    want = np.asarray(JM.mxu_ntt(jnp.asarray(X), w, k, max_m=max_m))
    got = TM.mxu_ntt(compat.from_jax_limbs(X), w, k, max_m=max_m)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)
    w_inv, d = pow(w, P - 2, P), pow(n, P - 2, P)
    want = np.asarray(JM.mxu_intt(jnp.asarray(X), w_inv, k, d, max_m=max_m))
    got = TM.mxu_intt(compat.from_jax_limbs(X), w_inv, k, d, max_m=max_m)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)


def test_batch_mapped_matches_jax():
    """pre_mult + pad_to + scale + narrow output, chunked: the h path's c2e
    shape at toy size (the JAX side runs its lax.map branch)."""
    rng = np.random.default_rng(5)
    C, n, k_out, max_m, chunk = 10, 16, 5, 16, 4
    X = JD.np_pack(_rand(rng, C * n), JD.FR).reshape(16, C, n)
    pre = JD.np_pack(_rand(rng, n), JD.FR)
    scale = JD.np_pack(_rand(rng, 1), JD.FR)
    w = _omega(k_out)
    jplan, jres = JM.get_plan(1 << k_out, w, "Fr", max_m)
    want = np.asarray(JM.mxu_ntt_batch_mapped(
        jnp.asarray(X.astype(np.uint16)), jplan, jres, JD.FR, max_m=max_m,
        chunk=chunk, scale=jnp.asarray(scale), out_dtype=jnp.uint16,
        pre_mult=jnp.asarray(pre), pad_to=1 << k_out))
    tplan, tres = TM.get_plan(1 << k_out, w, "Fr", max_m)
    got = TM.mxu_ntt_batch_mapped(
        compat.from_jax_limbs(X).to(torch.int16), tplan, tres, TD.FR,
        max_m=max_m, chunk=chunk, scale=compat.from_jax_limbs(scale),
        out_dtype=torch.int16, pre_mult=compat.from_jax_limbs(pre),
        pad_to=1 << k_out)
    assert got.dtype == torch.int16 and got.shape == (16, C, 1 << k_out)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)
