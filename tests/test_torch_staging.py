"""The port prover's staged h inputs (plonk/device_eval.StagedStacks): the
advice, instance and CQ f stacks are packed and copied on threads while the
host phases run.  Proofs with staging -- the default -- are byte-identical
to the same proofs with the staging function monkeypatched away, to the
port's host path and to the JAX package's; a staging thread that raises
makes create_proof raise."""
import random

import pytest

import tests.test_e2e_cq as E
from sha2cq_tpu.plonk import create_proof as j_create_proof
from sha2cq_tpu.plonk import keygen_pk as j_keygen_pk
from sha2cq_tpu.plonk import keygen_vk as j_keygen_vk
from sha2cq_tpu.plonk import static_lookup as JSL
from sha2cq_tpu_torch.fields.host import FR_MOD as P
from sha2cq_tpu_torch.plonk import (create_proof, keygen_pk, keygen_vk,
                                    verify_proof)
from sha2cq_tpu_torch.plonk import device_eval as DE
from sha2cq_tpu_torch.plonk import static_lookup as SL
from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
from sha2cq_tpu_torch.poly.kzg.strategy import AccumulatorStrategy
from sha2cq_tpu_torch.utils.transcript import Blake2bRead
from tests.test_torch_dev_tools import PORT, api_circuit
from tests.test_torch_fixtures import MyCircuit
from tests.test_torch_keyio_poseidon import _setup
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401


@pytest.fixture
def staged_keys(monkeypatch):
    """Records the keys each staging thread is given, and stages them."""
    keys = []
    real = DE.stage_stacks

    def recording(out, stacks, n, device):
        keys.extend(stacks)
        real(out, stacks, n, device)

    monkeypatch.setattr(DE, "stage_stacks", recording)
    return keys


def no_staging(monkeypatch):
    monkeypatch.setattr(DE, "stage_stacks", lambda out, stacks, n, device: None)


def test_staged_f_coeff_path_matches_host(monkeypatch, staged_keys):
    """Twin of tests/test_device_prover.py::test_staged_f_coeff_path_
    matches_host: the batched CQ commit (BATCH_MIN_N = 8) makes f_coeff
    before beta, so the f stack is staged too; the staged proof equals the
    port's host-path proof and the JAX package's device-path proof."""
    monkeypatch.setattr(SL, "BATCH_MIN_N", 8)
    monkeypatch.setattr(JSL, "BATCH_MIN_N", 8)
    _, _, t1, t2, params, configs, b0 = _setup(3)
    circuit = MyCircuit(t1, t2)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)
    proof_host = create_proof(params, pk, [circuit], [[]],
                              rng=random.Random(9), h_device=False)
    assert staged_keys == []
    proof_dev = create_proof(params, pk, [circuit], [[]],
                             rng=random.Random(9), h_device=True,
                             device="cpu", h_mxu=True)
    assert staged_keys == [(0, "advice"), (0, "instance"), (0, "static_f")]
    assert proof_dev == proof_host

    _, _, jt1, jt2, jparams, jconfigs, jb0 = E._setup(3)
    jcircuit = E.MyCircuit(jt1, jt2)
    jvk = j_keygen_vk(jparams, jcircuit)
    jpk = j_keygen_pk(jparams, jconfigs, jb0, jvk, jcircuit)
    proof_ref = j_create_proof(jparams, jpk, [jcircuit], [[]],
                               rng=random.Random(9), h_device=True,
                               h_mxu=True)
    assert proof_dev == proof_ref
    assert verify_proof(params, vk,
                        AccumulatorStrategy(params, rng=random.Random(9)),
                        [[]], Blake2bRead(proof_dev)).check()


def _api_key(k):
    rng = random.Random(4242)
    params = ParamsKZG.setup_from_toxic_waste(k, rng.randrange(P))
    a, b = [3, 7, 5], [4, 3, 11]
    circuit = api_circuit(PORT)(a, b)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, {}, [], vk, circuit)
    return params, pk, circuit, [[a[0] * b[0] % P]]


def test_k10_proof_same_bytes_with_and_without_staging(monkeypatch,
                                                       staged_keys):
    """tests/test_plonk_api.py's circuit at k=10 (native column buffers, the
    butterfly h route): staged and unstaged proofs are the same bytes, and
    the host path's."""
    from sha2cq_tpu_torch.utils.profiling import profiler
    params, pk, circuit, inst = _api_key(10)
    profiler.reset()
    profiler.enable()
    try:
        staged = create_proof(params, pk, [circuit], [inst],
                              rng=random.Random(8), device="cpu")
        packed_staged = set(profiler.timings())
        profiler.reset()
        no_staging(monkeypatch)
        unstaged = create_proof(params, pk, [circuit], [inst],
                                rng=random.Random(8), device="cpu")
        packed_unstaged = set(profiler.timings())
    finally:
        profiler.disable()
        profiler.reset()
    assert staged_keys == [(0, "advice"), (0, "instance")]
    # the h phase packs what was not staged, and only that
    assert {"h_stage/advice", "h_stage/instance", "h_pack_inputs/z",
            "create_proof/h_stage_advice", "create_proof/h_stage_f"} <= \
        packed_staged
    assert "h_pack_inputs/advice" not in packed_staged
    assert {"h_pack_inputs/advice", "h_pack_inputs/instance"} <= \
        packed_unstaged
    host = create_proof(params, pk, [circuit], [inst], rng=random.Random(8),
                        h_device=False)
    assert staged == unstaged == host


def test_two_circuits_stage_their_own_stacks(staged_keys):
    """A two-circuit proof stages each circuit's advice and instance
    stacks under its own index; the proof is the host path's."""
    params, pk, c1, inst1 = _api_key(5)
    c2 = api_circuit(PORT)([2, 6, 9], [8, 2, 3])
    inst2 = [[2 * 8 % P]]
    proof = create_proof(params, pk, [c1, c2], [inst1, inst2],
                         rng=random.Random(3), device="cpu")
    assert staged_keys == [(0, "advice"), (0, "instance"),
                           (1, "advice"), (1, "instance")]
    assert proof == create_proof(params, pk, [c1, c2], [inst1, inst2],
                                 rng=random.Random(3), h_device=False)


def test_a_failing_staging_thread_fails_the_proof(monkeypatch):
    """No quiet repack: the exception a staging thread meets is raised by
    create_proof where the h phase takes the stacks."""
    class StageFault(RuntimeError):
        pass

    def failing(out, stacks, n, device):
        raise StageFault("pinned allocation failed")

    monkeypatch.setattr(DE, "stage_stacks", failing)
    params, pk, circuit, inst = _api_key(5)
    with pytest.raises(StageFault, match="pinned allocation failed"):
        create_proof(params, pk, [circuit], [inst], rng=random.Random(1),
                     device="cpu")


def test_staged_stacks_equal_packed_stacks():
    """StagedStacks on the CPU hands back what stack_columns packs, for
    buffer columns, int-list columns and an empty stack."""
    from sha2cq_tpu_torch.native_loader import fr_buf
    rng = random.Random(2)
    n = 1024
    bufs = [fr_buf([rng.randrange(P) for _ in range(n)]) for _ in range(3)]
    ints = [[rng.randrange(P) for _ in range(n)] for _ in range(2)]
    stage = DE.StagedStacks(n, "cpu")
    stage.start({(0, "advice"): bufs})
    stage.start({(0, "instance"): ints, (0, "static_f"): []})
    got = stage.take()
    assert sorted(got) == [(0, "advice"), (0, "instance"), (0, "static_f")]
    for key, cols in (((0, "advice"), bufs), ((0, "instance"), ints),
                      ((0, "static_f"), [])):
        want = DE.stack_columns(cols, n, "cpu")
        assert got[key].dtype == want.dtype and got[key].equal(want)
