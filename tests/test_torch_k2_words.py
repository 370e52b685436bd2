"""K2's word form (sha2cq_tpu_torch.ops.cuda_field.planes_to_words_plain,
the plain mirror of csrc/planes_to_limbs.cu's reduction) against the JAX
package: the reference's _planes_to_limbs followed by mont_mul, in all four
multiplier modes, bit for bit (tolerance 0: the Montgomery product of any
value below 2^256 with the same residue is the same canonical limbs).
Planes: random, all zeros, all 2^31 - 1 (the kernel's input contract), and
the largest value _dft_planes can give at m = 512 (32 * 512 digit products
of 255 * 255)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu.ops import mxu_ntt as JM
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.fields import device as TD
from sha2cq_tpu_torch.ops import cuda_field as CF
from tests.test_torch_mxu_ntt import _rand, one_torch_thread  # noqa: F401

DFT_MAX_512 = 32 * 512 * 255 * 255       # _dft_planes' largest plane at m = 512
KINDS = ["random", "zero", "max", "dft_max", "mixed"]


def _planes(kind, shape, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 1 << 31, size=(32, *shape)).astype(np.int32)
    if kind == "zero":
        return np.zeros((32, *shape), dtype=np.int32)
    if kind == "max":
        return np.full((32, *shape), (1 << 31) - 1, dtype=np.int32)
    if kind == "dft_max":
        return np.full((32, *shape), DFT_MAX_512, dtype=np.int32)
    # each plane 0, 2^31 - 1 or random, so carries start and stop anywhere
    pick = rng.integers(0, 3, size=(32, *shape))
    rand = rng.integers(0, 1 << 31, size=(32, *shape))
    return np.where(pick == 0, 0, np.where(pick == 1, (1 << 31) - 1, rand)) \
        .astype(np.int32)


def _ints(limbs, width):
    """(width, N) little-endian digits of 16 or 8 bits -> Python ints."""
    a = np.asarray(limbs, dtype=object).reshape(limbs.shape[0], -1)
    bits = 16 if width == 16 else 8
    return [sum(int(a[i, c]) << (bits * i) for i in range(width))
            for c in range(a.shape[1])]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["tile", "minor", "major", "scalar"])
def test_word_form_epilogue_matches_jax(mode, kind):
    rng = np.random.default_rng(17)
    M, X, m1, B = 6, 24, 8, 4
    O = _planes(kind, (M, X))
    limbs = JM._planes_to_limbs(jnp.asarray(O), JD.FR)
    if mode == "tile":
        mult = JD.np_pack(_rand(rng, M * X), JD.FR).reshape(16, M, X)
        full = mult
    elif mode == "minor":              # x = b*m1 + t1
        mult = JD.np_pack(_rand(rng, M * m1), JD.FR).reshape(16, M, m1)
        full = np.tile(mult, (1, 1, X // m1))
    elif mode == "major":              # x = t1*B + b
        mult = JD.np_pack(_rand(rng, M * (X // B)), JD.FR).reshape(16, M, X // B)
        full = np.repeat(mult, B, axis=2)
    else:
        mult = JD.np_pack(_rand(rng, 1), JD.FR)
        full = mult.reshape(16, 1, 1)
    want = np.asarray(JD.mont_mul(limbs, jnp.asarray(full), JD.FR))
    got = TD.mont_mul_plain(CF.planes_to_words_plain(torch.from_numpy(O)),
                            compat.from_jax_limbs(full), TD.FR)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)


@pytest.mark.parametrize("kind", KINDS)
def test_word_form_residue_and_range(kind):
    """v = V - q p: V's residue (V = sum_q plane[q] 2^{8q}, the value the
    reference's relaxed limbs also hold mod p) and v < 2^224 + 2p < 2^256,
    the bound the kernel's comment proves."""
    p = TD.FR.p
    O = _planes(kind, (5, 16), seed=4)
    v = _ints(compat.to_jax_limbs(CF.planes_to_words_plain(torch.from_numpy(O))), 16)
    ref = _ints(np.asarray(JM._planes_to_limbs(jnp.asarray(O), JD.FR)), 16)
    V = [sum(int(x) << (8 * q) for q, x in enumerate(col))
         for col in O.reshape(32, -1).T]
    assert max(V) < 1 << 280
    assert all(a % p == b % p == c % p for a, b, c in zip(v, ref, V))
    assert max(v) < (1 << 224) + 2 * p


def test_umul64hi_is_exact():
    """The mirror's floor(t mu / 2^64) over int64 lanes, held against
    Python ints at random and extreme t < 2^56."""
    rng = np.random.default_rng(5)
    t = np.concatenate([rng.integers(0, 1 << 56, size=2000),
                        [0, 1, (1 << 56) - 1, (1 << 32) - 1, 1 << 32]])
    mu = CF.k2_mu(TD.FR)
    got = CF._umul64hi(torch.from_numpy(t.astype(np.int64)), mu)
    assert got.tolist() == [(int(x) * mu) >> 64 for x in t]
    with pytest.raises(ValueError):
        CF._umul64hi(torch.zeros(1, dtype=torch.int64), 1 << 48)


def test_k2_mu_covers_the_kernel_fields():
    """mu = floor(2^288 / p) for Fr and Fq (2^248 < p < 2^254); a modulus
    outside that range is refused, since the kernel's bounds do not hold
    for it: a wide one, a 255-bit one (2^224 + 2p would pass 2^256), a
    small one (q would pass 32 bits)."""
    for ctx in (TD.FR, TD.FQ):
        assert CF.k2_mu(ctx) == (1 << 288) // ctx.p < 1 << 40
    secp256k1 = TD.FieldCtx.make((1 << 256) - (1 << 32) - 977, "secp256k1")
    p25519 = TD.FieldCtx.make((1 << 255) - 19, "p25519")
    small = TD.FieldCtx.make((1 << 127) - 1, "m127")
    for ctx in (secp256k1, p25519, small):
        with pytest.raises(NotImplementedError):
            CF.k2_mu(ctx)
