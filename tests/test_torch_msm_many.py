"""The device batch MSM (sha2cq_tpu_torch.ops.msm.msm_device_many) behind
ops/msm.msm_multi and ParamsKZG's batch commits, on the CPU (the plain K5
and K6, window bits 4, HOST_THRESHOLD lowered to the domain): equal to the
native host path point for point on witness-like columns given as (n, 4)
u64 buffers and as lists of ints, batches of one and of five; smaller and
indexed jobs stay on the host; one basis upload a batch; its spans and
counters; and the benchmark's plain Lagrange commitment
(cardbench/reference/kzg_lagrange.py) against the program."""
import functools
import random

import numpy as np
import pytest

from cardbench.reference import kzg_lagrange
from sha2cq_tpu_torch.curves import device as PD
from sha2cq_tpu_torch.fields import device as D
from sha2cq_tpu_torch.fields.host import FR_MOD as R
from sha2cq_tpu_torch.native_loader import fr_buf
from sha2cq_tpu_torch.ops import msm as M
from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
from sha2cq_tpu_torch.utils.profiling import profiler

K = 6
N = 1 << K
SECRET = 0x5EED5678
BLINDED = 12          # circuit32's blinding_factors + 1
KINDS = ["bits", "6-bit", "8-bit", "16-bit", "32-bit", "uniform", "all-zero",
         "blinded"]


def column(kind: str, seed: int) -> list:
    """N values of a witness column's kind; `blinded` is 32-bit words with
    the last BLINDED rows uniform over [0, r), as the prover blinds them."""
    rng = random.Random(f"{kind}:{seed}")
    if kind == "uniform":
        return [rng.randrange(R) for _ in range(N)]
    bits = {"bits": 1, "6-bit": 6, "8-bit": 8, "16-bit": 16, "32-bit": 32,
            "all-zero": 0, "blinded": 32}[kind]
    vals = [rng.randrange(1 << bits) for _ in range(N)]
    if kind == "blinded":
        vals[N - BLINDED:] = [rng.randrange(R) for _ in range(BLINDED)]
    return vals


def form(vals: list, how: str):
    return fr_buf(vals) if how == "buffer" else list(vals)


@pytest.fixture(scope="module")
def params():
    return ParamsKZG.setup_from_toxic_waste(K, SECRET)


@pytest.fixture
def device_path(monkeypatch):
    """HOST_THRESHOLD at N and msm_device_many on the CPU at c = 4; returns
    the columns of each batch it was called with."""
    batches = []
    real = functools.partial(M.msm_device_many, device="cpu", c=4)

    def counted(columns, **kw):
        batches.append(len(columns))
        return real(columns, **kw)
    monkeypatch.setattr(M, "HOST_THRESHOLD", N)
    monkeypatch.setattr(M, "msm_device_many", counted)
    return batches


def host(vals, points):
    return M.msm_host(list(vals), points)


@pytest.mark.parametrize("how", ["buffer", "ints"])
@pytest.mark.parametrize("kind", KINDS)
def test_commit_lagrange_many_on_the_device_path(params, device_path, kind,
                                                 how):
    vals = column(kind, 1)
    got = params.commit_lagrange_many([form(vals, how)])
    assert device_path == [1]
    assert got == [host(vals, params.g_lagrange)]
    if kind == "all-zero":
        assert got == [None]


@pytest.mark.parametrize("how", ["buffer", "ints"])
def test_a_batch_of_five_uploads_its_basis_once(params, device_path,
                                                monkeypatch, how):
    uploads = []
    real = PD.pack_affine

    def counted(*a, **kw):
        pts = real(*a, **kw)
        uploads.append(pts[0].shape[1])
        return pts
    monkeypatch.setattr(PD, "pack_affine", counted)
    # a new packed basis, with no device words yet
    monkeypatch.delitem(params.__dict__, "_g_lagrange_packed", raising=False)
    cols = [column(kind, 2) for kind in
            ("bits", "16-bit", "uniform", "all-zero", "blinded")]
    got = params.commit_lagrange_many([form(v, how) for v in cols])
    assert device_path == [5] and uploads == [N]
    assert got == [host(v, params.g_lagrange) for v in cols]
    lag = kzg_lagrange.lagrange_at(SECRET, N)
    assert got == [kzg_lagrange.commitment(kzg_lagrange.evaluate(v, lag))
                   for v in cols]


def test_msm_multi_keeps_small_and_indexed_jobs_on_the_host(params,
                                                            device_path):
    """Two bases, two device batches; a job one point short of the
    threshold, an indexed job and an empty one stay on the host."""
    gl = M.packed_basis(params, "_g_lagrange_packed", params.g_lagrange)
    g = M.packed_basis(params, "_g_packed", params.g)
    a, b, c = column("32-bit", 3), column("blinded", 3), column("8-bit", 3)
    idx = list(range(N - 1, -1, -1))
    jobs = [(gl, None, fr_buf(a), params.g_lagrange),
            (g, None, b, params.g),
            (gl, None, fr_buf(c[:N - 1]), params.g_lagrange),
            (gl, idx, c, params.g_lagrange),
            (gl, None, [], params.g_lagrange)]
    got = M.msm_multi(jobs)
    assert sorted(device_path) == [1, 1]
    assert got == [host(a, params.g_lagrange), host(b, params.g),
                   host(c[:N - 1], params.g_lagrange),
                   host(c, [params.g_lagrange[i] for i in idx]), None]


def test_commit_coeff_buf_traces_the_batch(params, device_path, monkeypatch):
    """commit_coeff_buf on the device path: the root kzg_commit_many, under
    it msm_device_many (msm_columns 1) with the basis step once and the
    column's steps; msm_nonzero_digits the nonzero 4-bit digits; on a card
    (on_card patched) msm_layout also counts its wait."""
    monkeypatch.setattr(profiler, "_enabled", True)
    monkeypatch.setattr(D, "on_card", lambda t: True)
    coeffs = column("blinded", 4)
    profiler.clear_log()
    try:
        got = params.commit_coeff_buf(fr_buf(coeffs))
        log = profiler.log()
    finally:
        profiler.clear_log()
        profiler.reset()
    assert got == host(coeffs, params.g)
    root, many = log[-1], log[-2]
    assert (root.name, root.parent) == ("kzg_commit_many", None)
    assert many.name == "msm_device_many" and many.parent == root.span
    assert many.counts == {"msm_columns": 1}
    steps = [s for s in log if s.parent == many.span]
    assert [s.name for s in steps] == [
        "msm_basis", "msm_digits", "msm_layout", "msm_bucket_sums",
        "msm_window_reduce", "msm_fold"]
    assert all(s.trace == root.span for s in log)
    words = fr_buf(coeffs).view(np.uint64)
    digits = sum(int((v >> np.uint64(4 * w)) & np.uint64(15) != 0)
                 for row in words for v in row
                 for w in range(16))
    layout = steps[2].counts
    assert layout["msm_nonzero_digits"] == digits
    assert layout["host_syncs"] == 1


def test_the_reference_matches_the_program(params):
    """cardbench/reference/kzg_lagrange.py: L_i(s) against the program's
    Lagrange basis, and commitments of seeded columns, from ints and from
    words, against the program's commit_lagrange (host path)."""
    lag = kzg_lagrange.lagrange_at(SECRET, N)
    assert [kzg_lagrange.commitment(v) for v in lag] == params.g_lagrange
    for kind in KINDS:
        vals = column(kind, 5)
        value = kzg_lagrange.evaluate(vals, lag)
        assert kzg_lagrange.evaluate_words(fr_buf(vals), lag) == value
        assert kzg_lagrange.commitment(value) == params.commit_lagrange(vals)


def test_a_malformed_buffer_is_refused(params):
    with pytest.raises(ValueError, match=r"\(m, 4\) u64"):
        M.msm_device_many([np.zeros((N, 3), np.uint64)],
                          points=params.g_lagrange, device="cpu")
