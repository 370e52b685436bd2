"""Port prover (sha2cq_tpu_torch.plonk.create_proof) with h on the device
path -- here the CPU, i.e. the plain versions of kernels K1-K3 -- against
the JAX package's host-path create_proof under the same random.Random seed:
the proofs must be byte-identical, and the port's verifier accepts them."""
import pytest

from sha2cq_tpu_torch import compat as C
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401


def _check(ref_case, port_case, seed):
    proof_ref = C.prove(C.REFERENCE, ref_case, seed)
    proof_port = C.prove(C.PORT, port_case, seed, h_device=True, device="cpu")
    assert proof_port == proof_ref
    assert C.verify(C.PORT, port_case, proof_port, seed)
    assert C.verify(C.REFERENCE, ref_case, proof_port, seed)
    return proof_port


def test_sha256_circuit32_scheme8_k9_matches_reference():
    """ext = 1024 at k = 9: the c2e/e2c plans run a 512-wide twiddle level
    and a butterfly residual; the l2c plan is one 512 matmul."""
    ref = C.build_sha256(C.REFERENCE, 9, 1, 0x5256)
    port = C.build_sha256(C.PORT, 9, 1, 0x5256)
    proof = _check(ref, port, 3)
    assert len(proof) == 26144


def test_simple_circuit_matches_reference():
    _check(C.build_simple(C.REFERENCE, 4, 12), C.build_simple(C.PORT, 4, 12), 4)


def test_two_circuit_proof_matches_reference():
    """Two circuits in one proof: h runs once per circuit on the device
    path and the quotients are y^T-combined on host."""
    _check(C.build_simple(C.REFERENCE, 4, 13, n_circuits=2),
           C.build_simple(C.PORT, 4, 13, n_circuits=2), 5)


def test_port_host_path_matches_reference():
    case_ref = C.build_simple(C.REFERENCE, 4, 14)
    case_port = C.build_simple(C.PORT, 4, 14)
    assert C.prove(C.PORT, case_port, 6) == C.prove(C.REFERENCE, case_ref, 6)


def test_device_path_needs_an_explicit_device():
    case = C.build_simple(C.PORT, 4, 15)
    with pytest.raises(ValueError, match="explicit device"):
        C.prove(C.PORT, case, 7, h_device=True)


def test_prewarm_builds_the_module_once():
    from sha2cq_tpu_torch.plonk import prewarm_prover
    case = C.build_simple(C.PORT, 4, 16)
    fn = prewarm_prover(case.pk, "cpu")
    assert prewarm_prover(case.pk, "cpu") is fn
    assert fn.prog.instrs.shape[1] == 4


def test_device_msm_is_not_ported():
    from sha2cq_tpu_torch.ops import msm
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        msm.msm([1] * msm.HOST_THRESHOLD, [])
