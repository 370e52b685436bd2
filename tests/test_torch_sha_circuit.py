"""The port's generic-limb SHA-2 circuit (models/sha/circuit.py) and round
model (models/sha/reference.py) against the JAX package's: the cases of
tests/test_sha_circuit.py and tests/test_sha_tables.py through the port.
The MINI_LIMBS proof at k=7 -- h on the device path (here the CPU) and on
the host path -- is the JAX package's proof byte for byte under the same
rng."""
import random

import pytest

from sha2cq_tpu.dev.mock_prover import MockProver as JMockProver
from sha2cq_tpu.dev.mock_prover import emit_failures as j_emit
from sha2cq_tpu.models.sha import reference as JR
from sha2cq_tpu.models.sha import tables as JT
from sha2cq_tpu.models.sha.circuit import Sha2CqCircuit as JSha
from sha2cq_tpu.models.sha.setup import build_sha_setup as j_setup
from sha2cq_tpu.plonk import create_proof as j_create_proof
from sha2cq_tpu.plonk import keygen_pk as j_keygen_pk
from sha2cq_tpu.plonk import keygen_vk as j_keygen_vk
from sha2cq_tpu.poly.kzg.params import ParamsKZG as JParams
from sha2cq_tpu_torch.dev.mock_prover import MockProver, emit_failures
from sha2cq_tpu_torch.fields.host import FR_MOD as P
from sha2cq_tpu_torch.models.sha import reference as R
from sha2cq_tpu_torch.models.sha.circuit import Sha2CqCircuit
from sha2cq_tpu_torch.models.sha.setup import build_sha_setup
from sha2cq_tpu_torch.models.sha.tables import (MINI_LIMBS, SHORT_LIMBS,
                                                TEST_LIMBS, create_ch_table,
                                                create_decomposition_table,
                                                create_maj_table,
                                                create_rot0_table,
                                                create_rot1_table)
from sha2cq_tpu_torch.plonk import (create_proof, keygen_pk, keygen_vk,
                                    verify_proof)
from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
from sha2cq_tpu_torch.poly.kzg.strategy import AccumulatorStrategy
from sha2cq_tpu_torch.utils.transcript import Blake2bRead
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

K = 7  # 128 rows: 64 rounds + 4 shift rows + blinding
SEED = 0x5AA


class MiniShaCircuit(Sha2CqCircuit):
    LIMBS = MINI_LIMBS


class JMiniShaCircuit(JSha):
    LIMBS = JT.MINI_LIMBS


# cache=False: both packages would share one pickle of the setup (same
# cache key), and each must build its own objects here
@pytest.fixture(scope="module")
def sha_setup():
    s = random.Random(SEED).randrange(P)
    tables, configs, b0_bound, _srs = build_sha_setup(MINI_LIMBS, 1 << K, s,
                                                       cache=False)
    return s, tables, configs, b0_bound, ParamsKZG.setup_from_toxic_waste(K, s)


@pytest.fixture(scope="module")
def jax_sha_setup():
    s = random.Random(SEED).randrange(P)
    tables, configs, b0_bound, _srs = j_setup(JT.MINI_LIMBS, 1 << K, s,
                                               cache=False)
    return s, tables, configs, b0_bound, JParams.setup_from_toxic_waste(K, s)


def _message(seed):
    w = MINI_LIMBS.word_len
    rng = random.Random(seed)
    return [rng.randrange(1 << w) for _ in range(16)]


def test_sha_circuit_mock(sha_setup, jax_sha_setup):
    tables, jtables = sha_setup[1], jax_sha_setup[1]
    msg = _message(1)
    circuit = MiniShaCircuit(msg, tables)
    digest = circuit.expected_digest()
    assert digest == JMiniShaCircuit(msg, jtables).expected_digest()
    MockProver.run(K, circuit, [digest]).assert_satisfied()
    bad = list(digest)
    bad[0] ^= 1
    failures = MockProver.run(K, circuit, [bad]).verify()
    assert failures, "wrong digest must not satisfy"
    ref = JMockProver.run(K, JMiniShaCircuit(msg, jtables), [bad]).verify()
    assert emit_failures(failures) == j_emit(ref)


def test_sha_circuit_proof_matches_reference(sha_setup, jax_sha_setup):
    s, tables, configs, b0_bound, params = sha_setup
    _, jtables, jconfigs, jb0, jparams = jax_sha_setup
    msg = _message(2)
    circuit = MiniShaCircuit(msg, tables)
    digest = circuit.expected_digest()
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0_bound, vk, circuit)

    def rng():
        r = random.Random(SEED)
        r.randrange(P)                  # the draw of s, as the JAX test's
        return r

    proof_dev = create_proof(params, pk, [circuit], [[digest]], rng=rng(),
                             h_device=True, device="cpu")
    proof_host = create_proof(params, pk, [circuit], [[digest]], rng=rng(),
                              h_device=False)
    jcircuit = JMiniShaCircuit(msg, jtables)
    jvk = j_keygen_vk(jparams, jcircuit)
    jpk = j_keygen_pk(jparams, jconfigs, jb0, jvk, jcircuit)
    proof_ref = j_create_proof(jparams, jpk, [jcircuit], [[digest]],
                               rng=rng())
    assert proof_dev == proof_host == proof_ref

    batcher = verify_proof(params, vk, AccumulatorStrategy(params, rng=rng()),
                           [[digest]], Blake2bRead(proof_dev))
    assert batcher.check(), "SHA proof failed pairing check"
    bad = list(digest)
    bad[3] = (bad[3] + 1) % (1 << MINI_LIMBS.word_len)
    batcher = verify_proof(params, vk, AccumulatorStrategy(params, rng=rng()),
                           [[bad]], Blake2bRead(proof_dev))
    assert not batcher.check(), "wrong digest must not verify"


# ------------------------------ test_sha_tables ---------------------------

def test_rot0_vectors():
    table = create_rot0_table(TEST_LIMBS)
    assert len(table) == 256 and (0, 0, 0, 0) in table
    assert (0b0000_1100, 0b01, 0b00, 0b0000_0100) in table
    assert (0b0000_1010, 0b01, 0b10, 0b0000_0110) in table


def test_rot1_vectors():
    table = create_rot1_table(TEST_LIMBS)
    assert len(table) == 256 and (0, 0, 0, 0) in table
    assert (0b0000_1100, 0b01, 0b00, 0b1110_1001) in table
    assert (0b0000_1010, 0b01, 0b10, 0b0001_1101) in table


def test_maj_ch_vectors():
    maj = create_maj_table(TEST_LIMBS)
    assert len(maj) == 256
    assert (0b0000_1100, 0b01, 0b00, 0b0000_0000) in maj
    assert (0b0000_1010, 0b01, 0b10, 0b0000_0010) in maj
    ch = create_ch_table(TEST_LIMBS)
    assert (0b0000_1100, 0b01, 0b00, 0b0000_0000) in ch
    assert (0b0000_1010, 0b01, 0b10, 0b0000_0000) in ch


def test_decomposition_vectors():
    table = create_decomposition_table(TEST_LIMBS, 10)
    assert len(table) == 1024 and (0, 0, 0, 0) in table
    assert (0b10_1010_1010, 0b0000_1010, 0b10, 0b10) in table
    assert (0b11_1011_0110, 0b0000_1011, 0b01, 0b10) in table


def test_short_limbs_table_sizes():
    assert len(create_rot0_table(SHORT_LIMBS)) == 1 << 16
    assert len(create_decomposition_table(SHORT_LIMBS, 17)) == 1 << 17


def test_sha_round_model():
    """sha-reference lib.rs:45-80 test_single_round at L=2, through both
    packages' models."""
    for mod in (R, JR):
        s = mod.Octet(a=0b00, b=0b01, c=0b10, d=0b11, e=0b00, f=0b01,
                      g=0b10, h=0b11)
        out = mod.sha_round(s, bits=2)
        assert (out.a, out.b, out.c, out.d) == (0b01, 0b00, 0b01, 0b10)
        assert (out.e, out.f, out.g, out.h) == (0b10, 0b00, 0b01, 0b10)


def test_tables_consistent_with_model():
    l = TEST_LIMBS
    table = {(x, y, z): f for x, y, z, f in create_rot0_table(l)}
    for w in [0b1100_0101, 0b0110_1001, 0xFF, 0x01]:
        x = w >> (2 * l.second)
        y = (w >> l.second) & ((1 << l.second) - 1)
        z = w & ((1 << l.second) - 1)
        assert table[(x, y, z)] == R.rot_0(w, l.word_len) == \
            JR.rot_0(w, l.word_len)
