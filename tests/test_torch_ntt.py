"""Port radix-2 NTT (sha2cq_tpu_torch.ops.ntt: the plain version of kernel
K4 and the ntt / intt / ntt_last_axis entry points) against the JAX
package's ops/ntt.py on the same seeded inputs: exact (tolerance 0, field
arithmetic is exact).  The JAX side runs on the CPU, as its own tests run
it: its jitted butterflies at k = 1 and 3, and at k = 10, where XLA's CPU
compile of ten unrolled stages takes about a minute, its host NTT (the
same module's oracle, which its own tests hold equal to the butterflies;
canonical forms are unique, so equal values are equal limbs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu.fields.host import FR_MOD as P
from sha2cq_tpu.ops import ntt as JN
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.ops import cuda_field as CF
from sha2cq_tpu_torch.ops import ntt as TN
from tests.test_torch_mxu_ntt import _omega, one_torch_thread  # noqa: F401

KS = [1, 3, 10]
JIT_MAX_K = 3       # larger k compare with JN.ntt_host (see the docstring)


def _canonical(rng, shape):
    """Seeded canonical limbs (16, *shape) uint16: the plain version and the
    kernel agree with the reference bit for bit on canonical inputs."""
    a = compat.random_limbs(rng, shape, P)
    vals = np.zeros(a.shape[1:], dtype=object)
    for i in range(16):
        vals = vals + (a[i].astype(object) << (16 * i))
    assert (vals < P).all()
    return a


def _host(fn, limbs, omega):
    """A JAX host transform (int lists) applied to (16, n) Montgomery limbs,
    back as limbs."""
    vals = JD.unpack(jnp.asarray(limbs.astype(np.uint32)), JD.FR)
    return JD.np_pack(fn(vals, omega, P), JD.FR)


@pytest.mark.parametrize("k", KS)
def test_plain_ntt_last_axis_matches_jax(k):
    n = 1 << k
    a = _canonical(np.random.default_rng(10 + k), (5, n))
    w = _omega(k)
    if k <= JIT_MAX_K:
        want = np.asarray(JN.ntt_last_axis(jnp.asarray(a.astype(np.uint32)),
                                           JN.twiddle_table(w, k), k))
    else:
        want = np.stack([_host(JN.ntt_host, a[:, c], w) for c in range(5)],
                        axis=1)
    tw = TN.twiddle_table(w, k)
    np.testing.assert_array_equal(compat.to_jax_limbs(tw),
                                  np.asarray(JN.twiddle_table(w, k)))
    for dtype in (torch.int16, torch.int32):
        got = TN.ntt_last_axis_plain(compat.from_jax_limbs(a, dtype=dtype),
                                     tw, k)
        assert got.dtype == torch.int32 and got.shape == (16, 5, n)
        np.testing.assert_array_equal(compat.to_jax_limbs(got), want)
    # the dispatcher takes the plain version for a CPU tensor
    assert torch.equal(TN.ntt_last_axis(compat.from_jax_limbs(a), tw, k),
                       got)


@pytest.mark.parametrize("k", KS)
def test_ntt_and_intt_match_jax(k):
    n = 1 << k
    a = _canonical(np.random.default_rng(20 + k), (n,)).astype(np.uint32)
    w = _omega(k)
    w_inv, d = pow(w, P - 2, P), pow(n, P - 2, P)
    if k <= JIT_MAX_K:
        want = np.asarray(JN.ntt(jnp.asarray(a), w, k))
    else:
        want = _host(JN.ntt_host, a, w)
    got = TN.ntt(compat.from_jax_limbs(a), w, k)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)
    if k <= JIT_MAX_K:
        want_i = np.asarray(JN.intt(jnp.asarray(want), w_inv, k, d))
    else:
        want_i = _host(JN.intt_host, want, w)
    got_i = TN.intt(got, w_inv, k, d)
    np.testing.assert_array_equal(compat.to_jax_limbs(got_i), want_i)
    np.testing.assert_array_equal(compat.to_jax_limbs(got_i), a)


def test_batched_round_trip_and_host_oracle():
    """iNTT(NTT(x)) == x over a (16, 3, 64) batch, and each column equals
    the host NTT."""
    from sha2cq_tpu_torch.fields import device as TD
    k, n = 6, 64
    a = compat.from_jax_limbs(_canonical(np.random.default_rng(3), (3, n)))
    w = _omega(k)
    ev = TN.ntt(a, w, k)
    back = TN.intt(ev, pow(w, P - 2, P), k, pow(n, P - 2, P))
    assert torch.equal(back, a)
    for c in range(3):
        assert TD.unpack(ev[:, c], TD.FR) == \
            TN.ntt_host(TD.unpack(a[:, c], TD.FR), w, P)


def test_bitrev_perm_matches_jax():
    for k in (0, 1, 5, 9):
        np.testing.assert_array_equal(TN._bitrev_perm(k), JN._bitrev_perm(k))


def test_k4_wrapper_rejects_cpu_tensors():
    """K4's wrapper launches the kernel or raises: a CPU tensor never
    reaches it silently (the dispatcher sends CPU tensors to the plain
    version)."""
    a = torch.zeros((16, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CF.ntt_radix2(a, TN.twiddle_table(_omega(3), 3), 3)
