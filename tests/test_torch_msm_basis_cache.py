"""The device MSM's basis cache (sha2cq_tpu_torch.ops.msm._upload_basis) on
the CPU: a packed basis is uploaded and cut into K5's words once per
device and read from the cache afterwards, with the same commitments as the
host MSM; the words live on the packed buffer and die with it; a host point
list is stored nowhere.  Window bits 2 keep the plain K5/K6 quick at 16 points."""
import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from sha2cq_tpu_torch import native_loader as NL
from sha2cq_tpu_torch.curves import device as PD
from sha2cq_tpu_torch.fields import device as D
from sha2cq_tpu_torch.fields.host import FR_MOD
from sha2cq_tpu_torch.ops import msm as M
from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
from sha2cq_tpu_torch.utils.profiling import profiler

N = 16


@pytest.fixture(scope="module")
def params():
    return ParamsKZG.setup_from_toxic_waste(4, 0xCAC4E)


@pytest.fixture(autouse=True)
def device_path(monkeypatch):
    """The device path from N points."""
    monkeypatch.setattr(M, "HOST_THRESHOLD", N)


def cached(packed):
    """The packed buffer's device words, by device."""
    return packed.__dict__.get("_device_words", {})


def scalars(seed, n=N):
    return [(seed * 0x9E3779B97F4A7C15 + i * 0x5851F42D4C957F2D) % FR_MOD
            for i in range(n)]


def device_msm(sc, points, packed):
    return M.msm_device(sc, points, c=2, packed=packed, device="cpu")


def device_many(sc, points, packed):
    return M.msm_device_many([sc], packed=packed, points=points, c=2,
                             device="cpu")[0]


def traced(call):
    """call()'s result and the counts of its msm_basis span, with the
    profiler on."""
    was = profiler.enabled
    profiler.enable()
    profiler.clear_log()
    try:
        out = call()
        spans = [s.counts for s in profiler.log() if s.name == "msm_basis"]
    finally:
        if not was:
            profiler.disable()
        profiler.clear_log()
        profiler.reset()
    assert len(spans) == 1
    return out, spans[0]


@pytest.mark.parametrize("msm", [device_msm, device_many],
                         ids=["msm_device", "msm_device_many"])
def test_a_second_msm_reads_the_cached_basis(params, msm):
    packed = NL.pack_points_affine(params.g)
    sc = scalars(1)
    first, counts1 = traced(lambda: msm(sc, params.g, packed))
    second, counts2 = traced(lambda: msm(sc, params.g, packed))
    assert counts1 == {"basis_cached": 0}
    assert counts2 == {"basis_cached": 1}
    assert first == second == M.msm_host(sc, params.g)
    assert list(cached(packed)) == ["cpu"]


@pytest.mark.parametrize("msm", [device_msm, device_many],
                         ids=["msm_device", "msm_device_many"])
def test_a_hit_copies_nothing_to_a_card(params, monkeypatch, msm):
    """With every tensor taken for a card's, the fill counts the basis'
    bytes and waits in msm_basis and a hit counts none."""
    monkeypatch.setattr(D, "on_card", lambda t: True)
    packed = NL.pack_points_affine(params.g)
    sc = scalars(2)
    _, fill = traced(lambda: msm(sc, params.g, packed))
    _, hit = traced(lambda: msm(sc, params.g, packed))
    assert fill == {"h2d_bytes": 64 * N + 192, "host_syncs": 5,
                    "basis_cached": 0}
    assert hit == {"basis_cached": 1}


@pytest.mark.parametrize("m", [1, 5, N - 1])
def test_fewer_points_than_the_cached_basis(params, m):
    packed = NL.pack_points_affine(params.g)
    device_msm(scalars(3), params.g, packed)              # fills all N
    sc = scalars(4, m)
    got, counts = traced(lambda: device_msm(sc, params.g, packed))
    assert counts == {"basis_cached": 1}
    assert got == device_msm(sc, params.g[:m], None) == \
        M.msm_host(sc, params.g[:m])
    assert device_many(sc, params.g, packed) == got


def test_a_dead_basis_leaves_the_cache(params):
    packed = NL.pack_points_affine(params.g)
    device_msm(scalars(5), params.g, packed)
    words = weakref.ref(cached(packed)["cpu"])
    del packed
    gc.collect()
    assert words() is None


def test_a_new_basis_at_a_dead_ones_id_is_filled_anew(params):
    """Three bases of one size in turn, each dropped before the next is
    built (so the allocator may hand the next one the same id): each is
    uploaded afresh and gives its own commitments, never an old basis'."""
    sc = scalars(6)
    for points in (params.g, params.g[::-1], params.g_lagrange):
        packed = NL.pack_points_affine(points)
        got, counts = traced(lambda: device_msm(sc, points, packed))
        assert counts == {"basis_cached": 0}
        assert got == M.msm_host(sc, points)
        assert device_msm(sc, points, packed) == got
        assert list(cached(packed)) == ["cpu"]
        del packed
        gc.collect()


def test_two_devices_get_two_entries(params, monkeypatch):
    packed = NL.pack_points_affine(params.g)
    sc = scalars(7)
    on_cpu = device_msm(sc, params.g, packed)
    monkeypatch.setattr(M, "_device_key", lambda dev: "card")
    on_card, counts = traced(lambda: device_msm(sc, params.g, packed))
    assert counts == {"basis_cached": 0}
    assert on_cpu == on_card == M.msm_host(sc, params.g)
    assert sorted(cached(packed)) == ["card", "cpu"]


def test_a_device_key_names_the_device():
    assert M._device_key(torch.device("cpu")) == "cpu"
    assert M._device_key(torch.device("cuda", 1)) == "cuda:1"


def test_a_basis_that_is_not_affine_is_refused_on_the_fill(params):
    packed = NL.pack_points_affine(params.g)
    np.ctypeslib.as_array(packed).reshape(-1, 12)[3, 8] = 2       # z = 2
    for _ in range(2):
        with pytest.raises(ValueError, match="affine"):
            device_msm(scalars(8), params.g, packed)
        assert cached(packed) == {}


def test_a_host_point_list_is_stored_nowhere(params):
    """No basis_cached count and no cache on the points."""
    sc = scalars(9)
    got, counts = traced(lambda: device_msm(sc, params.g, None))
    assert counts == {}
    assert got == M.msm_host(sc, params.g)
    assert device_many(sc, params.g, None) == got
    assert not hasattr(params.g, "_device_words")


def test_threads_fill_one_basis_once(params, monkeypatch):
    """Twenty threads, more than this machine's cores, take one basis'
    words many times with a short switch interval: one upload, and every
    thread reads the same words."""
    fills = []
    real = PD.pack_affine

    def counted(*a, **kw):
        fills.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(PD, "pack_affine", counted)
    packed = NL.pack_points_affine(params.g)
    dev = torch.device("cpu")
    seen, errors = [], []

    def take():
        try:
            for _ in range(50):
                seen.append(M._upload_basis(None, packed, N, dev))
        except Exception as e:          # noqa: BLE001 -- reported below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=take) for _ in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(seen) == 20 * 50
    assert fills == [1]
    want = M.affine_words(real(params.g, device="cpu"))
    assert all(w.data_ptr() == seen[0].data_ptr() for w in seen)
    assert torch.equal(seen[0], want)
