"""The plain versions of the device MSM's kernels (sha2cq_tpu_torch.ops.msm
.bucket_sums_plain, K5's chunks, tree and finish steps, and
window_reduce_plain, K6's runs and trees) on layouts that put buckets
across K5's chunk edges, against the JAX package's host MSMs
(sha2cq_tpu.ops.msm.msm_host, the native Pippenger, and
sha2cq_tpu.curves.host.g1_msm, the naive sum), affine: skewed columns
(0/1, 16-bit words, one scalar for every point), buckets of exactly S and
S + 1 points and one over three chunks, a repeated point and a P, -P pair
split by a chunk edge, and the identity inside a chunk."""
import random

import pytest

from sha2cq_tpu.curves import host as RCH
from sha2cq_tpu.ops import msm as RM
from sha2cq_tpu_torch import native_loader as NL
from sha2cq_tpu_torch.curves import device as PD
from sha2cq_tpu_torch.curves import host as CH
from sha2cq_tpu_torch.fields.host import FR_MOD
from sha2cq_tpu_torch.ops import msm as M
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

CHUNKS = [4, M.K5_CHUNK]      # a small chunk (deep trees) and the kernel's


def _points(n, seed):
    rng = random.Random(seed)
    jac = NL.native_batch_scalar_mul([CH.jac_from_affine(CH.G1_GEN)] * n,
                                     [rng.randrange(1, FR_MOD) for _ in range(n)])
    if jac is None:
        return [CH.g1_mul(CH.G1_GEN, rng.randrange(1, FR_MOD)) for _ in range(n)]
    return CH.jac_batch_to_affine(jac)


def _plain_msm(sc, pts, c, chunk):
    """K5 (plain, at `chunk`) then K6 (plain) then the host fold."""
    digits = M._scalars_to_digits(NL.fr_buf([s % FR_MOD for s in sc]), c, "cpu")
    order, starts = M.bucket_layout(digits, c)
    words = M.affine_words(PD.pack_affine(pts))
    buckets = M.bucket_sums_plain(words, order, starts, chunk)
    return M._fold_windows(M.window_reduce_plain(buckets), c), starts


def _check(sc, pts, c, chunk):
    got, starts = _plain_msm(sc, pts, c, chunk)
    assert got == RM.msm_host(sc, pts)
    assert got == RCH.g1_msm(sc, pts)
    return starts


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["bits", "words16", "equal"])
def test_skewed_columns(kind, chunk):
    """A witness's kinds of column: 0/1 and one scalar for every point put
    every live point of a window in one bucket, which spans chunks; 16-bit
    words fill windows 0 and 1 alone."""
    rng = random.Random(f"{kind} {chunk}")
    n = 3 * chunk + 5
    pts = _points(n, 21)
    if kind == "bits":
        sc = [rng.randrange(2) for _ in range(n)]
    elif kind == "words16":
        sc = [rng.randrange(1 << 16) for _ in range(n)]
    else:
        sc = [rng.randrange(FR_MOD)] * n
    starts = _check(sc, pts, 8, chunk)
    seg = int((starts[:, 2:] - starts[:, 1:-1]).max())
    assert seg > chunk or kind == "words16"     # a bucket over chunk edges


def _layout(sizes, seed):
    """Scalars below 2^8 (window 0 alone is live at c = 8) whose bucket
    b + 1 holds sizes[b] points, in index order; no digit-0 points, so the
    live range, and chunk 0, starts at sorted position 0."""
    sc = [b + 1 for b, size in enumerate(sizes) for _ in range(size)]
    return sc, _points(len(sc), seed)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("extra", [0, 1])
def test_bucket_of_s_and_s_plus_one_points(chunk, extra):
    """Bucket 1 of exactly S points fills chunk 0 and is written by the
    chunks step; of S + 1 points it reaches into chunk 1, and the finish
    step adds chunk 1's head to chunk 0's."""
    sc, pts = _layout([chunk + extra, 3, 2], 31)
    _check(sc, pts, 8, chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_bucket_over_three_chunks(chunk):
    """Bucket 2 begins in the middle of chunk 0 and ends in chunk 2: a
    tail, a whole chunk and a head, combined by the tree and finish."""
    sc, pts = _layout([chunk // 2, 2 * chunk, 1], 41)
    digits = M._scalars_to_digits(NL.fr_buf(sc), 8, "cpu")
    _order, starts = M.bucket_layout(digits, 8)
    s, e = int(starts[0, 2]), int(starts[0, 3])
    assert s // chunk == 0 and (e - 1) // chunk == 2 and s % chunk
    _check(sc, pts, 8, chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_equal_and_opposite_points_across_a_chunk_edge(chunk):
    """P at the last position of chunk 0 and P at the first of chunk 1, in
    one bucket (the finish step adds P + P: a doubling); R and -R the
    same across the edge of chunks 1 and 2 (their sum is the identity)."""
    sizes = [chunk - 1, 2, chunk - 2, 2]
    sc, pts = _layout(sizes, 51)
    p_at, r_at = chunk - 1, 2 * chunk - 1
    pts[p_at + 1] = pts[p_at]
    pts[r_at + 1] = CH.g1_neg(pts[r_at])
    buckets = M.bucket_sums_plain(
        M.affine_words(PD.pack_affine(pts)),
        *M.bucket_layout(M._scalars_to_digits(NL.fr_buf(sc), 8, "cpu"), 8),
        chunk)
    B = PD.unpack_jacobian(tuple(a[:, 0, :] for a in buckets))
    assert B[2] == CH.g1_add(pts[p_at], pts[p_at]) and B[4] is None
    _check(sc, pts, 8, chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_identity_inside_a_chunk(chunk):
    """Identity points (skipped) inside a bucket, at a chunk's start and at
    a chunk's end."""
    sc, pts = _layout([chunk + 3, 4], 61)
    for i in (1, chunk - 1, chunk, chunk + 4):
        pts[i] = None
    _check(sc, pts, 8, chunk)
