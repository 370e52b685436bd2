"""The three single-device h routes of the port (sha2cq_tpu_torch.plonk.
device_eval: butterfly, monolithic digit-matmul, coset-streamed
digit-matmul), here on the CPU, i.e. the plain versions of kernels K1-K4:

* the route rule is the JAX package's (device_eval.py:143-148, 457-461);
* create_proof(h_device=True, device="cpu") under each route is
  byte-identical to the JAX package's host-path proof under the same
  random.Random seed, and the port's verifier accepts it;
* on the same seeded inputs the three routes' h modules give bit-identical
  outputs."""
import numpy as np
import pytest

from sha2cq_tpu_torch import compat as C
from sha2cq_tpu_torch.plonk import device_eval as DE
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

ROUTES = {
    DE.BUTTERFLY: {},                                  # auto at k = 9
    DE.MONOLITHIC: {"h_mxu": True},
    DE.COSET: {"h_mxu": True, "h_cosets": True},
}


@pytest.mark.parametrize("k,ext,flags,route", [
    (11, 1 << 12, {}, DE.BUTTERFLY),
    (12, 1 << 13, {}, DE.MONOLITHIC),
    (17, 1 << 18, {}, DE.MONOLITHIC),
    (18, 1 << 19, {}, DE.COSET),
    (11, 1 << 12, {"use_mxu": True}, DE.MONOLITHIC),
    (11, 1 << 12, {"use_mxu": True, "cosets": True}, DE.COSET),
    (12, 1 << 13, {"use_mxu": False}, DE.BUTTERFLY),
    (18, 1 << 19, {"use_mxu": False}, DE.BUTTERFLY),
    (18, 1 << 19, {"cosets": False}, DE.MONOLITHIC),
    (18, 1 << 19, {"use_mxu": False, "cosets": True}, DE.BUTTERFLY),
    (12, 1 << 12, {"cosets": True}, DE.MONOLITHIC),     # ext = n: no cosets
])
def test_route_rule_is_the_reference_rule(k, ext, flags, route):
    assert DE.choose_route(k, ext, **flags) == route


@pytest.fixture(scope="module")
def sha_k9():
    """SHA-256 circuit32 / SCHEME8 at k = 9 (ext = 1024, rs = 2) built by
    both packages from one seed, and the JAX package's host-path proof."""
    ref = C.build_sha256(C.REFERENCE, 9, 1, 0x5256)
    port = C.build_sha256(C.PORT, 9, 1, 0x5256)
    return ref, port, C.prove(C.REFERENCE, ref, 11)


@pytest.mark.parametrize("route", list(ROUTES))
def test_sha256_k9_proof_matches_reference_on_every_route(sha_k9, route):
    ref, port, proof_ref = sha_k9
    proof = C.prove(C.PORT, port, 11, h_device=True, device="cpu",
                    **ROUTES[route])
    assert proof == proof_ref
    assert C.verify(C.PORT, port, proof, 11)
    assert port.pk.__dict__["_torch_h_fns"][("cpu", route)].route == route


def test_two_circuit_proof_on_the_butterfly_route():
    ref = C.build_simple(C.REFERENCE, 4, 21, n_circuits=2)
    port = C.build_simple(C.PORT, 4, 21, n_circuits=2)
    proof = C.prove(C.PORT, port, 22, h_device=True, device="cpu")
    assert DE.get_h_fn(port.pk, "cpu").route == DE.BUTTERFLY
    assert proof == C.prove(C.REFERENCE, ref, 22)
    assert C.verify(C.PORT, port, proof, 22)


def test_jax_call_shape_runs_on_the_port():
    """create_proof(..., h_device=True, h_mxu=True), the reference's call
    shape (plus the port's explicit device), proves on the port; mesh= is
    not ported and says so."""
    ref = C.build_simple(C.REFERENCE, 4, 23)
    port = C.build_simple(C.PORT, 4, 23)
    proof = C.prove(C.PORT, port, 24, h_device=True, h_mxu=True,
                    device="cpu")
    assert proof == C.prove(C.REFERENCE, ref, 24)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        C.prove(C.PORT, port, 24, h_device=True, device="cpu",
                mesh=object())


def test_routes_give_identical_h_on_the_same_inputs():
    """compat.h_forward: the same seeded inputs through each route's h
    module give the same h and advice coefficients, bit for bit."""
    case = C.build_simple(C.PORT, 4, 25)
    outs = {r: C.h_forward(case.pk, "cpu", 7, use_mxu=kw.get("h_mxu"),
                           cosets=kw.get("h_cosets"))
            for r, kw in ROUTES.items()}
    want = [C.to_jax_limbs(t) for t in outs[DE.BUTTERFLY]]
    for route, got in outs.items():
        assert [tuple(t.shape) for t in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(C.to_jax_limbs(g), w,
                                          err_msg=route)


def test_coset_constants_match_the_reference_definitions():
    """The coset route's (rs, 16, n) twist and fixed / sigma coefficient
    stacks equal the JAX package's definitions (device_eval.py:478-499),
    packed by its own field module."""
    from sha2cq_tpu.fields import device as JD
    from sha2cq_tpu.fields import host as JH
    from sha2cq_tpu.ops import ntt as JN
    case = C.build_simple(C.PORT, 4, 26)
    fn = DE.get_h_fn(case.pk, "cpu", use_mxu=True, cosets=True)
    dom = case.pk.vk.domain
    P = JH.FR_MOD
    twist = np.stack([JD.np_pack(JN.powers_host(
        JH.FR_ZETA * pow(dom.extended_omega, t, P) % P, dom.n, P), JD.FR)
        for t in range(dom.extended_n // dom.n)])
    np.testing.assert_array_equal(C.to_jax_limbs(fn.coset_twist), twist)
    assert C.from_jax_limbs(twist, limb_axis=1).equal(fn.coset_twist)
    for got, polys in ((fn.fixed_coeff, case.pk.fixed_polys),
                       (fn.sigma_coeff, case.pk.permutation.polys)):
        want = JD.np_pack([v for c in polys for v in c], JD.FR).reshape(
            16, len(polys), dom.n).astype(np.uint16)
        assert C.from_jax_limbs(want, dtype=got.dtype).equal(got)
