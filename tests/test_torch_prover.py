"""Port prover (sha2cq_tpu_torch.plonk.create_proof) with h on the device
path -- here the CPU, i.e. the plain versions of kernels K1-K3 -- against
the JAX package's host-path create_proof under the same random.Random seed:
the proofs must be byte-identical, and the port's verifier accepts them."""
import pytest
import torch

from sha2cq_tpu_torch import compat as C
from tests import test_torch_compat as R
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401


def _check(ref_case, port_case, seed):
    proof_ref = R.prove(ref_case, seed)
    proof_port = C.prove(port_case, seed, h_device=True, device="cpu")
    assert proof_port == proof_ref
    assert C.verify(port_case, proof_port, seed)
    assert R.verify(ref_case, proof_port, seed)
    return proof_port


def test_sha256_circuit32_scheme8_k9_matches_reference():
    """ext = 1024 at k = 9: the c2e/e2c plans run a 512-wide twiddle level
    and a butterfly residual; the l2c plan is one 512 matmul."""
    ref = R.build_sha256(9, 1, 0x5256)
    port = C.build_sha256(9, 1, 0x5256)
    proof = _check(ref, port, 3)
    assert len(proof) == 26144


def test_simple_circuit_matches_reference():
    _check(R.build_simple(4, 12), C.build_simple(4, 12), 4)


def test_two_circuit_proof_matches_reference():
    """Two circuits in one proof: h runs once per circuit on the device
    path and the quotients are y^T-combined on host."""
    _check(R.build_simple(4, 13, n_circuits=2),
           C.build_simple(4, 13, n_circuits=2), 5)


def test_port_host_path_matches_reference():
    case_ref = R.build_simple(4, 14)
    case_port = C.build_simple(4, 14)
    assert C.prove(case_port, 6, h_device=False) == \
        R.prove(case_ref, 6)


def test_device_path_needs_an_explicit_device():
    """device=None is refused, and the default device is the card: with
    no card the call raises torch's CUDA error before any work and builds
    no h module anywhere (no fallback to the CPU)."""
    case = C.build_simple(4, 15)
    with pytest.raises(ValueError, match="explicit device"):
        C.prove(case, 7, device=None)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            C.prove(case, 7)
        assert "_torch_h_fns" not in case.pk.__dict__


def test_prewarm_builds_the_module_once():
    from sha2cq_tpu_torch.plonk import prewarm_prover
    case = C.build_simple(4, 16)
    fn = prewarm_prover(case.pk, "cpu")
    assert prewarm_prover(case.pk, "cpu") is fn
    assert fn.prog.instrs.shape[1] == 4


def test_msm_sends_large_inputs_to_the_device(monkeypatch):
    """msm() hands exactly the MSMs of HOST_THRESHOLD points or more to
    msm_device (with the caller's packed basis), and smaller ones to
    msm_host: recording stubs, no 2^20-point computation."""
    from sha2cq_tpu_torch.ops import msm
    calls = []
    monkeypatch.setattr(msm, "msm_host", lambda s, p, packed=None:
                        calls.append(("host", len(s), packed)))
    monkeypatch.setattr(msm, "msm_device", lambda s, p, packed=None:
                        calls.append(("device", len(s), packed)))
    for n in (0, 1, msm.HOST_THRESHOLD - 1, msm.HOST_THRESHOLD,
              msm.HOST_THRESHOLD + 1):
        msm.msm([1] * n, [], packed=n)
    t = msm.HOST_THRESHOLD
    assert calls == [("host", 0, 0), ("host", 1, 1), ("host", t - 1, t - 1),
                     ("device", t, t), ("device", t + 1, t + 1)]


def test_device_msm_without_a_card_raises():
    """msm_device runs on the card unless the caller asks for the CPU:
    with no card it raises torch's CUDA error before any work, and does
    not fall back to the CPU."""
    from sha2cq_tpu_torch.curves import host as CH
    from sha2cq_tpu_torch.ops import msm
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            msm.msm_device([3, 5], [CH.G1_GEN, CH.G1_GEN])
    assert msm.msm_device([3, 5], [CH.G1_GEN, CH.G1_GEN], device="cpu") == \
        CH.g1_mul(CH.G1_GEN, 8)
