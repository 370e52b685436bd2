"""The port's device MSM (sha2cq_tpu_torch.ops.msm.msm_device) on the CPU,
where it runs the plain versions of kernels K5 (bucket sums) and K6 (window
reduction), against the JAX package's host MSMs (sha2cq_tpu.ops.msm
.msm_host, the native Pippenger, and sha2cq_tpu.curves.host.g1_msm, the
naive sum) -- the answer its slow tests pin the JAX msm_device to -- at
several window sizes and edge cases; the digits against the JAX package's;
K5's and K6's own index arithmetic mirrored in numpy; and the slice,
ParamsKZG.commit through the device path, against the JAX package's
commit."""
import os
import random
import re

import numpy as np
import pytest
import torch

from sha2cq_tpu.curves import host as RCH
from sha2cq_tpu.ops import msm as RM
from sha2cq_tpu_torch import native_loader as NL
from sha2cq_tpu_torch.curves import device as PD
from sha2cq_tpu_torch.curves import host as CH
from sha2cq_tpu_torch.fields.host import FR_MOD
from sha2cq_tpu_torch.ops import msm as M
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401


def _points(n, seed):
    rng = random.Random(seed)
    return [CH.g1_mul(CH.G1_GEN, rng.randrange(1, FR_MOD)) for _ in range(n)]


def _edge_case(n=64, seed=7):
    """Random scalars and points with: zero scalars, a repeated point under
    the same scalar (a bucket doubles), P and -P under the same scalar (a
    bucket cancels), identity points, and scalars >= r."""
    rng = random.Random(seed)
    pts = _points(n, seed)
    sc = [rng.randrange(FR_MOD) for _ in range(n)]
    sc[0] = sc[1] = 0
    pts[5], sc[5] = pts[4], sc[4]
    pts[9], sc[9] = CH.g1_neg(pts[8]), sc[8]
    pts[12] = pts[13] = None
    sc[14] = FR_MOD + 12345
    sc[15] = 2 * FR_MOD - 1
    sc[16] = (1 << 256) - 1
    return sc, pts


@pytest.mark.parametrize("c", [4, 8, 10, None])
def test_plain_device_msm_matches_the_host_msms(c):
    sc, pts = _edge_case()
    got = M.msm_device(sc, pts, c=c, device="cpu")
    assert got == RM.msm_host(sc, pts)
    assert got == RCH.g1_msm(sc, pts)


def test_plain_device_msm_skewed_and_packed():
    """All scalars equal (every point in one bucket of each window), read
    from a native packed basis, and c = 5 (a 256-bit scalar does not fill
    the top window)."""
    pts = _points(48, 8)
    sc = [0x1234567890ABCDEF1234567890ABCDEF * 977] * len(pts)
    packed = NL.pack_points_affine(pts)
    want = RCH.g1_msm(sc, pts)
    assert M.msm_device(sc, pts, c=5, device="cpu") == want
    if packed is not None:
        assert M.msm_device(sc, None, c=8, packed=packed, device="cpu") == want


@pytest.mark.parametrize("c", [4, 8, 13, 14, 15, 16])
def test_digits_match_jax(c):
    rng = random.Random(c)
    sc = [rng.randrange(FR_MOD) for _ in range(30)] + [
        0, 1, FR_MOD - 1, FR_MOD, FR_MOD + 7, (1 << 256) - 1, 1 << 253]
    want = RM._scalars_to_digits(sc, c)
    buf = NL.fr_buf([s % FR_MOD for s in sc])
    got = M._scalars_to_digits(buf, c, "cpu")
    assert got.shape == want.shape == ((256 + c - 1) // c, len(sc))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert M.pick_window_bits_v2(1 << 20) == RM.pick_window_bits_v2(1 << 20)


def test_affine_words_round_trip():
    """K5's point layout holds x and y in eight 32-bit words each and marks
    the identity with zeros; a point that is not affine is refused."""
    pts = _points(5, 10)
    pts[2] = None
    P = PD.pack_affine(pts)
    words = M.affine_words(P)
    assert words.shape == (5, 16) and words.dtype == torch.int32
    assert not words[2].any() and words[0].any()
    back = M._words_to_points(words)
    assert PD.unpack_jacobian(back) == pts
    for a, b in zip(back, P):
        assert a[:, [0, 1, 3, 4]].equal(b[:, [0, 1, 3, 4]])
    doubled = PD.point_double(P)
    with pytest.raises(ValueError, match="affine"):
        M.affine_words(doubled)


def test_window_bits_rule(monkeypatch):
    """Below 2^20 points (HOST_THRESHOLD, where msm() starts to send MSMs
    to the card) the reference's rule; from there the card's measured
    choice, the window size with the least K5 + K6 time at 2^20 points,
    which is not the reference's 14.  The rule follows the MSM's size, not
    HOST_THRESHOLD: lowered, it moves MSMs to the card but not their window
    bits."""
    assert M.HOST_THRESHOLD == 1 << 20
    for n in (1, 64, 5000, 1 << 16, M.HOST_THRESHOLD - 1):
        assert M.pick_window_bits(n) == RM.pick_window_bits_v2(n)
    c = M.pick_window_bits(M.HOST_THRESHOLD)
    assert c == M.DEVICE_WINDOW_BITS and 14 < c <= 16
    assert RM.pick_window_bits_v2(M.HOST_THRESHOLD) == 14
    monkeypatch.setattr(M, "HOST_THRESHOLD", 16)
    assert M.pick_window_bits(32) == RM.pick_window_bits_v2(32) == 8
    assert M.pick_window_bits(1 << 20) == M.DEVICE_WINDOW_BITS == 15
    with pytest.raises(ValueError, match="power of two"):
        M.k6_shape(48)
    assert M.k6_shape(1 << 18) == (16, 128, 128)
    assert M.k6_shape(1 << 10) == (16, 32, 2)     # c = 10: a two-block tree
    with pytest.raises(ValueError, match="above 18"):
        M.k6_shape(1 << 19)


def test_kernel_constants_match_the_source():
    """ops/msm's K5_CHUNK, K6_RUN, K6_THREADS and K6_MAX size the scratch
    and drive the plain versions; they must be csrc/msm.cu's, and the two
    k6_shape rules the same."""
    src = open(os.path.join(os.path.dirname(M.__file__), "..", "csrc",
                            "msm.cu")).read()
    for name in ("K5_CHUNK", "K6_RUN", "K6_THREADS", "K6_MAX"):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == getattr(M, name), name
    assert "if (m / (L * T) > K6_MAX) T = m / (L * K6_MAX);" in src


def _k5_mirror(d, o, s, n, m, chunk, val):
    """K5's three steps (csrc/msm.cu) thread by thread, with integers for
    points (0 the identity, + the addition): returns the (nw, m) bucket
    sums and asserts that every output slot is written exactly once and
    that every head or tail slot read was written."""
    nw = d.shape[0]
    C = -(-n // chunk)
    out = np.full((nw, m), None, dtype=object)
    head = np.full((nw, C), None, dtype=object)
    tail = np.full((nw, C), None, dtype=object)
    key = np.zeros((nw, C), dtype=np.int64)

    def store(w, b, v):
        assert out[w, b] is None
        out[w, b] = v

    for w in range(nw):                   # chunks: thread j of window w
        st = s[w * (m + 1):(w + 1) * (m + 1)]
        for j in range(C):
            k0 = int(st[1]) + j * chunk
            if k0 >= n:
                continue
            k1 = min(k0 + chunk, n)
            lo, hi = 1, m - 1             # bucket_of: binary search
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if st[mid] <= k0 else (lo, mid - 1)
            b = lo
            key[w, j] = b
            first, begun, end, acc = True, st[b] >= k0, int(st[b + 1]), 0
            k = k0
            while True:
                if k == end or k == k1:
                    if begun and end <= k1:
                        store(w, b, acc)
                    else:
                        (head if first else tail)[w, j] = acc
                    if k == k1:
                        break
                    first, begun, acc = False, True, 0
                    b += 1
                    while st[b + 1] <= k:
                        b += 1
                    end = int(st[b + 1])
                assert d[w, o[w * n + k]] == b
                acc += val[o[w * n + k]]
                k += 1
        live = -(-(n - int(st[1])) // chunk)
        lev = 0                           # tree: one launch a level
        while (1 << lev) < C:
            for i in range(0, C, 2 << lev):
                jj = i + (1 << lev)
                if jj < live and key[w, i] == key[w, jj]:
                    head[w, i] = head[w, i] + head[w, jj]
            lev += 1
        for b in range(m):                # finish: one thread a bucket
            if b == 0 or st[b] == st[b + 1]:
                store(w, b, 0)
                continue
            c0 = (int(st[b]) - int(st[1])) // chunk
            c1 = (int(st[b + 1]) - 1 - int(st[1])) // chunk
            if c0 == c1:
                assert out[w, b] is not None
                continue
            if key[w, c0] == b:
                acc, x = head[w, c0], (C if c0 == 0 else c0 + (c0 & -c0))
            else:
                acc, x = tail[w, c0], c0 + 1
            while x <= c1:
                acc = acc + head[w, x]
                x += x & -x
            assert acc is not None
            store(w, b, acc)
    return out


@pytest.mark.parametrize("c, chunk", [(4, 2), (8, 4), (8, 64), (14, 16),
                                      (16, 32)])
def test_k5_chunks_mirror(c, chunk):
    """K5's indexing and combining steps in numpy (_k5_mirror), on uniform
    scalars with a run of 40 equal ones and on a 0/1 column: every bucket
    sum must be the sum of the points whose digit is b, each point added
    once, and bucket 0 the identity."""
    rng = np.random.default_rng(c * 100 + chunk)
    n, m = 300, 1 << c
    val = rng.integers(1, 1 << 40, size=n).astype(object)
    for sc in ([int.from_bytes(rng.bytes(32), "little") % FR_MOD
                for _ in range(n)], [int(v) for v in rng.integers(0, 2, n)]):
        sc[:40] = [sc[40]] * 40                      # a long segment
        digits = M._scalars_to_digits(NL.fr_buf(sc), c, "cpu")
        order, starts = M.bucket_layout(digits, c)
        d, o, s = digits.numpy(), order.numpy().ravel(), starts.numpy().ravel()
        assert starts.shape == (d.shape[0], m + 1) and order.dtype == starts.dtype
        out = _k5_mirror(d, o, s, n, m, chunk, val)
        for w in range(d.shape[0]):
            want = np.zeros(m, dtype=object)
            np.add.at(want, d[w], val)
            want[0] = 0
            assert out[w].tolist() == want.tolist()


@pytest.mark.parametrize("m", [1, 16, 256, 1 << 14, 1 << 16, 1 << 17])
def test_k6_tree_mirror(m):
    """K6's indexing and combining steps in numpy, with integers standing
    for points (add is +, doubling is *2): per window, thread t of block p
    sums buckets p*T*L + j*T + t by running sums (S and sum_j j * B); its
    leaf is (D, V) = (S, T * sum_j j * B); the block tree and, after D is
    scaled by L, the window tree (V = V_l + V_r + D_r, D = 2 (D_l + D_r))
    must give sum_b b * B_b.  At 2^17 buckets k6_shape widens the block
    (T = 64) to keep P at K6_MAX."""
    L, T, P = M.k6_shape(m)
    assert L * T * P == m and max(T, P) <= M.K6_MAX
    rng = np.random.default_rng(m)
    B = rng.integers(0, 1 << 20, size=m).astype(object)

    def tree(D, V):
        while len(D) > 1:
            D, V = ([2 * (D[2 * i] + D[2 * i + 1]) for i in range(len(D) // 2)],
                    [V[2 * i] + V[2 * i + 1] + D[2 * i + 1]
                     for i in range(len(D) // 2)])
        return D[0], V[0]

    blocks = []
    for p in range(P):                    # runs kernel, block p
        D, V = [], []
        for t in range(T):
            run_ = acc = 0
            for j in range(L - 1, 0, -1):
                run_ += B[p * T * L + j * T + t]
                acc += run_
            D.append(run_ + B[p * T * L + t])
            V.append(acc * T)
        blocks.append(tree(D, V))
    _, V = tree([D * L for D, _ in blocks], [V for _, V in blocks])
    assert V == sum(b * B[b] for b in range(m))


def test_plain_kernels_match_jax_window_sums():
    """K5 then K6 (plain) give, per window, the same point as summing
    b * B_b on the host from the JAX package's digits."""
    sc, pts = _edge_case(40, 9)
    c = 4
    digits = RM._scalars_to_digits(sc, c)
    P = PD.pack_affine(pts)
    order, starts = M.bucket_layout(torch.from_numpy(
        digits.astype(np.int32)), c)
    sums = PD.unpack_jacobian(M.msm_window_reduce(
        M.msm_bucket_sums(M.affine_words(P), order, starts)))
    for w in range(digits.shape[0]):
        want = None
        for i, pt in enumerate(pts):
            want = CH.g1_add(want, CH.g1_mul(pt, int(digits[w, i]))
                             if pt is not None else None)
        assert sums[w] == want


def test_commit_through_the_device_path_matches_jax(monkeypatch):
    """The slice: the port's ParamsKZG.commit and commit_lagrange with the
    port's HOST_THRESHOLD lowered (so msm() takes msm_device, here on the
    CPU, reading the packed basis) equal the JAX package's commitments on
    the same SRS and inputs."""
    from sha2cq_tpu.poly.kzg.params import ParamsKZG as RParams
    from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
    calls = []
    device_msm = M.msm_device

    def on_cpu(*a, **kw):
        calls.append(kw.get("packed") is not None)
        return device_msm(*a, device="cpu", **kw)

    monkeypatch.setattr(M, "HOST_THRESHOLD", 16)
    monkeypatch.setattr(M, "msm_device", on_cpu)
    k, s = 5, 0x5EED1234
    rng = random.Random(3)
    coeffs = [rng.randrange(FR_MOD) for _ in range(1 << k)]
    port, ref = ParamsKZG.setup_from_toxic_waste(k, s), \
        RParams.setup_from_toxic_waste(k, s)
    assert port.commit(coeffs) == ref.commit(coeffs)
    assert port.commit(coeffs[:20]) == ref.commit(coeffs[:20])
    assert port.commit_lagrange(coeffs) == ref.commit_lagrange(coeffs)
    assert port.commit(coeffs[:8]) == ref.commit(coeffs[:8])   # host path
    want = [NL.get_lib() is not None] * 3
    assert calls == want


@pytest.mark.parametrize("route", ["library", "fallback"])
def test_device_msm_reduces_every_scalar_and_counts_the_slow_ones(
        monkeypatch, route):
    """Scalars that mix canonical values, negatives, values >= r, a bool and
    an int subclass: msm_device (c = 4) equals msm_host on the same list,
    and its msm_scalars span counts as `scalars_slow` the scalars that were
    not exact ints in [0, r), all of them without the scalar_words
    library."""
    from sha2cq_tpu_torch import scalar_words as SW
    from sha2cq_tpu_torch.utils.profiling import profiler

    class Int(int):
        pass

    if route == "fallback":
        monkeypatch.setattr(SW, "_lib", None)
        monkeypatch.setattr(SW, "_tried", True)
    rng = random.Random(11)
    pts = _points(24, 12)
    sc = [rng.randrange(FR_MOD) for _ in pts]
    sc[1], sc[4], sc[6] = -sc[1], sc[4] + FR_MOD, -1
    sc[9], sc[13], sc[17] = (1 << 256) - 1, True, Int(sc[17])
    slow = 6 if route == "library" else len(sc)
    monkeypatch.setattr(profiler, "_enabled", True)
    profiler.clear_log()
    try:
        got = M.msm_device(sc, pts, c=4, device="cpu")
        counts = [s.counts for s in profiler.log() if s.name == "msm_scalars"]
    finally:
        profiler.clear_log()
        profiler.reset()
    assert got == M.msm_host(sc, pts)
    assert counts == [{"scalars_slow": slow}]
