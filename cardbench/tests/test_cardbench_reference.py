"""The plain references against independent witnesses: hashlib, the
program's own curve and MSM code (read here only, never by the
references), and the program's proofs at a small size, which the plain
verifier accepts and, altered, rejects."""
import hashlib
import random

import pytest

from cardbench.reference import bn254 as C
from cardbench.reference import kzg_commit, plonk_verify, sha2


def test_field_constants_match_the_program():
    from sha2cq_tpu_torch.fields import host as H
    assert (C.R, C.Q) == (H.FR_MOD, H.FQ_MOD)
    assert C.root_of_unity(28) == H.FR_ROOT_OF_UNITY
    assert C.delta() == H.FR_DELTA


def test_g1_against_the_program():
    from sha2cq_tpu_torch.curves import host as CH
    rng = random.Random(5)
    for _ in range(4):
        a, b = rng.randrange(C.R), rng.randrange(C.R)
        assert C.mul(C.G1, a) == CH.g1_mul(CH.G1_GEN, a)
        pa, pb = C.mul(C.G1, a), C.mul(C.G1, b)
        assert C.to_affine(C.jac_add(C.to_jac(pa), C.to_jac(pb))) == C.mul(C.G1, a + b)
        assert C.to_affine(C.jac_add(C.to_jac(pa), C.to_jac(pa))) == C.mul(C.G1, 2 * a)
        assert C.to_affine(C.jac_add(C.to_jac(pa), C.to_jac((pa[0], C.Q - pa[1])))) is None
    terms = [(rng.randrange(C.R), C.mul(C.G1, rng.randrange(C.R))) for _ in range(9)]
    want = None
    for k, p in terms:
        want = CH.g1_add(want, CH.g1_mul(p, k))
    assert C.msm(terms) == want


def test_decompress_round_trips():
    from sha2cq_tpu_torch.utils import serde
    for k in (1, 2, 12345, C.R - 1):
        p = C.mul(C.G1, k)
        assert C.decompress(serde.g1_to_bytes(p)) == p
    assert C.decompress(bytes(32)) is None
    with pytest.raises(ValueError):
        C.decompress(b"\xff" * 32)


def test_sha2_at_32_bits_is_sha256():
    msg = b"abc"
    block = bytearray(msg) + b"\x80" + bytes(64 - len(msg) - 9) + (24).to_bytes(8, "big")
    words = [int.from_bytes(block[i:i + 4], "big") for i in range(0, 64, 4)]
    digest = b"".join(w.to_bytes(4, "big") for w in sha2.chain([words], 32))
    assert digest == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("w", [8, 16, 32])
def test_sha2_matches_the_program_model(w):
    from sha2cq_tpu_torch.models.sha import sha256 as model
    rng = random.Random(w)
    blocks = [[rng.getrandbits(w) for _ in range(16)] for _ in range(3)]
    state = model.h_constants(w)
    for b in blocks:
        state = model.sha_compress_final(state, b, w)
    assert sha2.chain(blocks, w) == state


def test_kzg_commitment_matches_the_program_msm():
    from sha2cq_tpu_torch.ops import msm as M
    from sha2cq_tpu_torch.poly.kzg import params as KP
    s, n = 0x1234567890ABCDEF, 300
    rng = random.Random(1)
    coeffs = [rng.randrange(C.R) for _ in range(n)]
    g = KP._g1_powers_of_s(s, n)
    assert kzg_commit.commitment(kzg_commit.evaluate(coeffs, s)) == M.msm_host(coeffs, g)


def test_lagrange_basis_sums_to_one():
    basis = plonk_verify.lagrange_at(987654321, 16)
    assert sum(basis) % C.R == 1
