"""K4's shared-memory pass structure (sha2cq_tpu_torch.ops.ntt: k4_passes,
the split rule the wrapper launches, and ntt_passes_plain, the plain mirror
of csrc/ntt_radix2.cu's index formulas) against the JAX package's
ops/ntt.py on the same seeded inputs: exact (tolerance 0, field arithmetic
is exact).  The JAX side runs on the CPU as in test_torch_ntt: its jitted
ntt_last_axis up to k = 3, above that its host NTT (the same module's
oracle; canonical forms are unique, so equal values are equal limbs)."""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.ops import ntt as JN
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.ops import cuda_field as CF
from sha2cq_tpu_torch.ops import ntt as TN
from tests.test_torch_mxu_ntt import _omega, one_torch_thread  # noqa: F401
from tests.test_torch_ntt import JIT_MAX_K, _canonical, _host


@functools.lru_cache(maxsize=None)
def _case(k, cols):
    """Seeded (16, cols, 2^k) limbs and the JAX package's NTT of them."""
    a = _canonical(np.random.default_rng(100 * k + cols), (cols, 1 << k))
    w = _omega(k)
    if k <= JIT_MAX_K:
        want = np.asarray(JN.ntt_last_axis(jnp.asarray(a.astype(np.uint32)),
                                           JN.twiddle_table(w, k), k))
    else:
        want = np.stack([_host(JN.ntt_host, a[:, c], w) for c in range(cols)],
                        axis=1)
    return a, want


def _splits(k, cols):
    """Every cut into one or two passes, one three-pass cut, and the
    wrapper's own."""
    out = {(0, k)} | {(0, a, k) for a in range(1, k)}
    if k >= 3:
        out.add((0, 1, k - 1, k))
    out.add((0,) + tuple(s1 for _s0, s1, _r in TN.k4_passes(k, cols)))
    return sorted(out)


@pytest.mark.parametrize("k", range(1, 13))
def test_pass_mirror_matches_jax_at_every_split(k):
    tw = TN.twiddle_table(_omega(k), k)
    for cols in (1, 3):
        a, want = _case(k, cols)
        for dtype in (torch.int16, torch.int32):
            x = compat.from_jax_limbs(a, dtype=dtype)
            for bounds in _splits(k, cols):
                got = TN.ntt_passes_plain(x, tw, k, bounds)
                assert got.dtype == torch.int32 and got.shape == (16, cols, 1 << k)
                np.testing.assert_array_equal(compat.to_jax_limbs(got), want,
                                              err_msg=f"bounds {bounds}")


def test_pass_mirror_keeps_leading_axes():
    """A (16, 2, 3, n) stack is transformed column by column."""
    k = 5
    tw = TN.twiddle_table(_omega(k), k)
    a = compat.from_jax_limbs(_canonical(np.random.default_rng(9), (2, 3, 32)))
    got = TN.ntt_passes_plain(a, tw, k, (0, 2, 5))
    assert torch.equal(got, TN.ntt_last_axis_plain(a, tw, k))


def test_pass_mirror_rejects_bad_bounds():
    tw = TN.twiddle_table(_omega(4), 4)
    a = torch.zeros((16, 16), dtype=torch.int32)
    for bounds in ((0, 3), (1, 4), (0, 2, 2, 4)):
        with pytest.raises(ValueError):
            TN.ntt_passes_plain(a, tw, 4, bounds)


@pytest.mark.parametrize("k", range(1, 21))
def test_k4_passes_rule(k):
    """The split rule the wrapper launches: contiguous passes covering
    0..k, one up to k = 11, then passes of at most 8 stages (two up to
    k = 16, three up to 24), stages shared evenly (larger first), at most
    2^11 points a block, groups a block growing with the column count up
    to 2^3 beyond one pass."""
    for cols in (1, 3, 64, 212):
        passes = TN.k4_passes(k, cols)
        assert [p[0] for p in passes] == [0] + [p[1] for p in passes[:-1]]
        assert passes[-1][1] == k
        assert len(passes) == (1 if k <= TN.K4_TILE_LOG else 2 if k <= 16 else 3)
        sizes = [s1 - s0 for s0, s1, _r in passes]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
        if len(passes) > 1:
            assert max(sizes) <= TN.K4_TILE_LOG - TN.K4_RUN_LOG
            assert all(rlog <= TN.K4_RUN_LOG for _s0, _s1, rlog in passes)
        for s0, s1, rlog in passes:
            assert rlog >= 0 and (s1 - s0) + rlog <= TN.K4_TILE_LOG
            groups = cols << (k - (s1 - s0))
            assert rlog == 0 or groups >> rlog >= 256
        assert TN.k4_passes(k, cols * 256)[0][2] >= passes[0][2]


def test_k4_passes_at_the_path_shapes():
    """The passes of the shapes chip_smoke.py times: the k=9 route's
    NTTs in one launch, the k=13 c2e batch in two and the k=18 extended
    chunk in three with 8 groups a block, a lone 2^14 column in two with
    one group a block."""
    assert TN.k4_passes(9, 132) == ((0, 9, 0),)
    assert TN.k4_passes(10, 212) == ((0, 10, 0),)
    assert TN.k4_passes(10, 1) == ((0, 10, 0),)
    assert TN.k4_passes(14, 212) == ((0, 7, 3), (7, 14, 3))
    assert TN.k4_passes(14, 1) == ((0, 7, 0), (7, 14, 0))
    assert TN.k4_passes(19, 64) == ((0, 7, 3), (7, 13, 3), (13, 19, 3))
    assert len(TN.k4_passes(24)) == 3 and len(TN.k4_passes(25)) == 4
    assert len(TN.k4_passes(30)) == 4
    with pytest.raises(ValueError):
        TN.k4_passes(0)


def test_twiddle_words_layout_and_cache():
    """K4 reads each twiddle as one 32-byte row of eight 32-bit words:
    word w = limb 2w | limb 2w+1 << 16.  twiddle_table builds them once,
    beside the cached limb table; a table from elsewhere gets the same
    words from twiddle_words."""
    k = 6
    tw = TN.twiddle_table(_omega(k), k)
    words = tw.k4_words
    assert words.shape == (32, 8) and words.dtype == torch.int32
    limbs = compat.to_jax_limbs(tw).astype(np.uint64)
    want = limbs[0::2] | (limbs[1::2] << np.uint64(16))
    np.testing.assert_array_equal(words.numpy().view(np.uint32).T, want)
    assert TN.twiddle_table(_omega(k), k).k4_words is words
    other = tw.clone()
    assert getattr(other, "k4_words", None) is None
    assert torch.equal(CF.twiddle_words(other), words)


def test_k4_tile_matches_the_kernel():
    """The split rule's tile (ops/ntt.K4_TILE_LOG) is the most points a
    block of csrc/ntt_radix2.cu may hold (its K4_MAX_LOG), the bound its
    C entry checks every pass against."""
    src = (Path(TN.__file__).parent.parent / "csrc" / "ntt_radix2.cu").read_text()
    found = re.findall(r"constexpr int K4_MAX_LOG = (\d+);", src)
    assert found == [str(TN.K4_TILE_LOG)]
