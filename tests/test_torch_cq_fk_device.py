"""The CQ tables' cached quotients on the port's device route
(plonk/static_tables.fk_cached_quotients: the group NTTs and scalar
products of curves/device, kernels K7 and K8 on a card) with CPU tensors,
which run the host's group NTT and jac_mul: against the naive
per-row loop (use_fk=False) at N = 2^3..2^6, the host's native FK at 2^8,
the JAX package's StaticTableValues at 2^5 (three columns in one batched
call) and the benchmark's plain reference (cardbench/reference/
cq_tables.py) at 2^4 and 2^6; group_ntt then its inverse is the identity,
batch_scalar_mul equals curves/host.jac_mul, operands on another device
raise, the route's spans and counters, and which route a column takes."""
import random

import pytest
import torch

from cardbench.reference import bn254, cq_tables
from sha2cq_tpu_torch.curves import device as CD
from sha2cq_tpu_torch.curves import host as CH
from sha2cq_tpu_torch.fields.host import FR_MOD
from sha2cq_tpu_torch.plonk import static_tables as ST
from sha2cq_tpu_torch.poly.kzg import params as KP
from sha2cq_tpu_torch.utils.profiling import profiler

SECRET = 0x5BE0CD191F83D9AB9B05688C510E527FA54FF53A3C6EF372BB67AE856A09E667 % FR_MOD


@pytest.fixture(scope="module")
def srs_g1():
    return KP._g1_powers_of_s(SECRET, 1 << 8)


def column(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(1 << 16) for _ in range(n)]


@pytest.fixture
def device_route(monkeypatch):
    """Every column on the device route, its plain versions on the CPU."""
    monkeypatch.setattr(ST, "fk_device", lambda size: "cpu")


def device_qs(values, srs_g1):
    return ST.StaticTableValues(values, srs_g1).qs


@pytest.mark.parametrize("k", [3, 4, 5, 6])
def test_device_route_equals_the_naive_loop(srs_g1, device_route, k):
    vals = column(1 << k, k)
    naive = ST.StaticTableValues(vals, srs_g1, use_fk=False).qs
    assert device_qs(vals, srs_g1) == naive


def test_device_route_equals_the_host_native_fk(srs_g1, monkeypatch):
    vals = column(1 << 8, 8)
    assert ST.fk_device(1 << 8) is None          # no card: the host route
    host = ST.StaticTableValues(vals, srs_g1).qs
    monkeypatch.setattr(ST, "fk_device", lambda size: "cpu")
    (dev,) = ST.StaticTableValues.many([vals], srs_g1)
    assert dev.qs == host and dev.values == vals
    assert dev.value_index_mapping is None or len(dev.value_index_mapping) == 256


def test_batched_columns_equal_the_jax_package(srs_g1, device_route):
    from sha2cq_tpu.plonk.static_tables import StaticTableValues as JaxTable
    cols = [column(1 << 5, 50 + j) for j in range(3)]
    many = ST.StaticTableValues.many(cols, srs_g1)
    for tv, vals in zip(many, cols):
        ref = JaxTable(vals, srs_g1)
        assert tv.qs == ref.qs
        assert tv.value_index_mapping == ref.value_index_mapping


@pytest.mark.parametrize("k", [4, 6])
def test_plain_reference_equals_the_port(srs_g1, device_route, k):
    vals = column(1 << k, 100 + k)
    qs = device_qs(vals, srs_g1)
    c = cq_tables.quotient_scalars(vals, SECRET)
    assert qs == [bn254.mul(bn254.G1, ci) for ci in c]
    assert cq_tables.combination_holds(qs, c, seed=k)
    assert cq_tables.rows_hold(qs, c, range(0, 1 << k, 5))
    bad = list(qs)
    bad[3] = CH.g1_add(bad[3], bn254.G1)
    assert not cq_tables.combination_holds(bad, c, seed=k)
    assert not cq_tables.rows_hold(bad, c, [3])


def random_points(n, rng):
    return [CH.jac_mul((1, 2, 1), rng.randrange(1, FR_MOD)) for _ in range(n)]


def test_group_ntt_then_its_inverse_is_the_identity():
    rng = random.Random(7)
    m, cols = 16, 2
    g = random_points(m * cols, rng)
    g[5] = CH.JAC_IDENTITY
    pts = CD._device_points(g, (cols, m), "cpu")
    omega = ST._omega_for_k(4)
    fwd = CD.group_ntt(pts, omega)
    back = CD.group_ntt(fwd, pow(omega, FR_MOD - 2, FR_MOD))
    out = CD.batch_scalar_mul(back, CD.raw_limbs([pow(m, FR_MOD - 2, FR_MOD)]))
    assert CD.to_affine_host(out) == CH.jac_batch_to_affine(g)
    # the forward transform is the DFT over the group
    want = []
    for c in range(cols):
        col = g[c * m:(c + 1) * m]
        for kk in range(m):
            acc = CH.JAC_IDENTITY
            for j, p in enumerate(col):
                acc = CH.jac_add(acc, CH.jac_mul(p, pow(omega, j * kk, FR_MOD)))
            want.append(acc)
    assert CD.to_affine_host(fwd) == CH.jac_batch_to_affine(want)


def test_batch_scalar_mul_equals_jac_mul():
    rng = random.Random(11)
    g = random_points(6, rng)
    g[2] = CH.JAC_IDENTITY
    ss = [0, 1, FR_MOD - 1, (1 << 256) - 1] + \
        [rng.randrange(1 << 254) for _ in range(8)]
    pts = CD._device_points(g, (6,), "cpu")
    sc = CD.raw_limbs(ss).reshape(16, 2, 6)
    out = CD.to_affine_host(CD.batch_scalar_mul(pts, sc))    # points broadcast
    assert out == [CH.jac_to_affine(CH.jac_mul(g[e % 6], ss[e]))
                   for e in range(12)]
    pts2 = CD._device_points(g + g[:2], (2, 4), "cpu")
    out = CD.to_affine_host(CD.batch_scalar_mul(pts2, CD.raw_limbs(ss[4:8])))
    assert out == [CH.jac_to_affine(CH.jac_mul((g + g[:2])[e], ss[4 + e % 4]))
                   for e in range(8)]                        # scalars broadcast
    with pytest.raises(ValueError):
        CD.batch_scalar_mul(pts, CD.raw_limbs(ss[:4]))


def test_spans_and_counters(srs_g1, device_route):
    ST._device_srs_cache.clear()
    profiler.enable()
    profiler.clear_log()
    try:
        for _ in range(2):
            ST.StaticTableValues.many([column(8, 1), column(8, 2)], srs_g1)
        spans = profiler.log()
    finally:
        profiler.disable()
        profiler.reset()
        profiler.clear_log()
    roots = [s for s in spans if s.name == "cq_fk" and s.parent is None]
    assert len(roots) == 2
    for i, root in enumerate(roots):
        names = sorted(s.name for s in spans if s.trace == root.trace)
        want = ["cq_fk", "cq_group_ntt", "cq_readback", "cq_scalar_mul",
                "cq_scalar_mul", "cq_table_ntt"] + (["cq_srs_ntt"] if i == 0 else [])
        assert names == sorted(want)
        points = sum(s.counts.get("group_ntt_points", 0) for s in spans
                     if s.trace == root.trace)
        assert points == 2 * (16 + 8) + (16 if i == 0 else 0)


def test_which_route(monkeypatch):
    assert ST.fk_device(1 << 12) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ST.fk_device(ST.DEVICE_MIN_ROWS) == "cuda"
    assert ST.fk_device(ST.DEVICE_MIN_ROWS // 2) is None


def test_operands_on_another_device_raise():
    """Points and scalars on different devices, or on a device with no
    route (meta), raise: the work never moves to the host unasked."""
    g = random_points(4, random.Random(13))
    pts = CD._device_points(g, (4,), "cpu")
    sc = CD.raw_limbs([3, 5, 7, 9])
    meta_pts = tuple(c.to("meta") for c in pts)
    with pytest.raises(ValueError, match="different devices"):
        CD.batch_scalar_mul(meta_pts, sc)
    with pytest.raises(ValueError, match="different devices"):
        CD.batch_scalar_mul(pts, sc.to("meta"))
    with pytest.raises(ValueError, match="no route"):
        CD.batch_scalar_mul(meta_pts, sc.to("meta"))
    with pytest.raises(ValueError, match="no route"):
        CD.group_ntt(meta_pts, ST._omega_for_k(2))
    with pytest.raises(ValueError, match="different devices"):
        CD.group_ntt((pts[0], pts[1], pts[2].to("meta")), ST._omega_for_k(2))
