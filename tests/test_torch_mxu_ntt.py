"""Port digit-matmul NTT (sha2cq_tpu_torch.ops.mxu_ntt) and the plain
version of kernel K2 against the JAX package and the host NTT: exact.

Small max_m covers each plan shape at n <= 2^10: a single matmul, a twiddle
level with a matrix residual, a twiddle level with a butterfly residual,
and two twiddle levels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu.fields.host import FR_MOD as P
from sha2cq_tpu.fields.host import FR_ROOT_OF_UNITY, FR_S
from sha2cq_tpu.ops import mxu_ntt as JM
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.fields import device as TD
from sha2cq_tpu_torch.ops import cuda_field as CF
from sha2cq_tpu_torch.ops import mxu_ntt as TM
from sha2cq_tpu_torch.ops import ntt as TNTT

# (k, max_m): single matmul; twiddle + matrix residual; twiddle + butterfly
# residual; two twiddle levels + butterfly residual
SHAPES = [(4, 16), (10, 32), (6, 8), (9, 16)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a port test module's torch ops on one intra-op thread.  The
    suite runs several pytest workers on one host; torch's OpenMP threads in
    each of them would oversubscribe the cores, and the plain kernels'
    many small ops then slow down by an order of magnitude.  Every port
    test module imports this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _omega(k):
    w = FR_ROOT_OF_UNITY
    for _ in range(k, FR_S):
        w = w * w % P
    return w


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _planes(rng, shape, kind):
    if kind == "max":
        return np.full((32, *shape), (1 << 31) - 1, dtype=np.int32)
    if kind == "zero":
        return np.zeros((32, *shape), dtype=np.int32)
    return rng.integers(0, 1 << 31, size=(32, *shape), dtype=np.int64) \
        .astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "max", "zero"])
@pytest.mark.parametrize("mode", ["tile", "minor", "major", "scalar"])
def test_plain_epilogue_matches_jax(mode, kind):
    """K2's plain version == the reference's _planes_to_limbs followed by
    D.mont_mul, with the multiplier broadcast as the mode says."""
    rng = np.random.default_rng(7)
    M, X, m1, B = 8, 24, 6, 4
    O = _planes(rng, (M, X), kind)
    limbs = JM._planes_to_limbs(jnp.asarray(O), JD.FR)
    if mode == "tile":
        mult = JD.np_pack(_rand(rng, M * X), JD.FR).reshape(16, M, X)
        full, kw = mult, {}
    elif mode == "minor":              # x = b*m1 + t1
        mult = JD.np_pack(_rand(rng, M * m1), JD.FR).reshape(16, M, m1)
        full, kw = np.tile(mult, (1, 1, X // m1)), {"mult_minor": m1}
    elif mode == "major":              # x = t1*B + b
        mult = JD.np_pack(_rand(rng, M * (X // B)), JD.FR).reshape(16, M, X // B)
        full, kw = np.repeat(mult, B, axis=2), {"mult_major": B}
    else:
        mult = JD.np_pack(_rand(rng, 1), JD.FR)
        full, kw = mult.reshape(16, 1, 1), {"mult_is_tile": False}
    want = np.asarray(JD.mont_mul(limbs, jnp.asarray(full), JD.FR))
    got = CF.planes_to_limbs_mul(torch.from_numpy(O),
                                 compat.from_jax_limbs(mult), TD.FR, **kw)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)


def test_plain_planes_to_limbs_matches_jax():
    rng = np.random.default_rng(8)
    O = _planes(rng, (4, 40), "random")
    want = np.asarray(JM._planes_to_limbs(jnp.asarray(O), JD.FR))
    got = CF.planes_to_limbs_plain(torch.from_numpy(O), TD.FR)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)


def test_digit_matrix_native_matches_bigint(monkeypatch, tmp_path):
    """The native digit-matrix build == the reference's big-int build (its
    cache pointed at a fresh directory, so nothing cached is compared)."""
    monkeypatch.setattr(JM, "_CACHE_DIR", str(tmp_path))
    w = _omega(6)
    a = TM._digit_matrix_native(64, w, P)
    b = TM._digit_matrix_bigint(64, w, P)
    np.testing.assert_array_equal(a, b)
    mat, rowsum = JM._dft_digit_matrix_np(64, w, P)
    np.testing.assert_array_equal(a, mat)
    np.testing.assert_array_equal(a.sum(axis=1, dtype=np.int32), rowsum)


@pytest.mark.parametrize("k,max_m", SHAPES)
def test_ntt_and_intt_match_host(k, max_m):
    n = 1 << k
    w = _omega(k)
    vals = _rand(np.random.default_rng(k), n)
    x = TD.pack(vals, TD.FR)
    got = TD.unpack(TM.mxu_ntt(x, w, k, max_m=max_m), TD.FR)
    assert got == TNTT.ntt_host(vals, w, P)
    w_inv = pow(w, P - 2, P)
    back = TM.mxu_intt(TD.pack(got, TD.FR), w_inv, k, pow(n, P - 2, P),
                       max_m=max_m)
    assert TD.unpack(back, TD.FR) == vals


def test_round_trip_batch():
    """iNTT(NTT(x)) == x over a column batch at the h path's two plan
    shapes (matrix and butterfly residuals)."""
    rng = np.random.default_rng(6)
    for k, max_m in ((10, 32), (6, 8)):
        n, C = 1 << k, 3
        X = TD.pack(_rand(rng, C * n), TD.FR).reshape(16, C, n)
        w = _omega(k)
        fplan, fres = TM.get_plan(n, w, "Fr", max_m)
        iplan, ires = TM.get_plan(n, pow(w, P - 2, P), "Fr", max_m)
        ev = TM.mxu_ntt_batch_mapped(X, fplan, fres, TD.FR, max_m=max_m,
                                     chunk=2)
        back = TM.mxu_ntt_batch_mapped(
            ev, iplan, ires, TD.FR, max_m=max_m, chunk=2,
            scale=TD.pack_scalar(pow(n, P - 2, P), TD.FR))
        assert torch.equal(back, X)
