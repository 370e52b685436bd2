"""The device MSM's host fold (sha2cq_tpu_torch.ops.msm._fold_windows: one
read-back of the window sums' X, Y and Z, a Jacobian fold from the top
window down, one inversion) against the affine fold it replaced, kept here
as the oracle, and against the JAX package's naive sum
(sha2cq_tpu.curves.host.g1_msm) of the windows weighted by 2^(c w): window
sums in Montgomery limbs with Z other than one, zero top windows (a column
with no blinding rows), every window zero, only window 0 nonzero, and a
window equal to +-2^c times the total above it, which takes jac_add's
doubling branch or gives the identity mid-fold."""
import random

import pytest

from sha2cq_tpu.curves import host as RCH
from sha2cq_tpu_torch.curves import device as PD
from sha2cq_tpu_torch.curves import host as CH
from sha2cq_tpu_torch.fields import device as D
from sha2cq_tpu_torch.fields.device import FQ
from sha2cq_tpu_torch.fields.host import FQ_MOD, FR_MOD
from sha2cq_tpu_torch.ops import msm as M


def affine_fold(sums, c):
    """The fold before: each window made affine, then affine doublings and
    additions, an inversion in each."""
    total = None
    for win in reversed(PD.unpack_jacobian(sums)):
        if total is not None:
            for _ in range(c):
                total = CH.g1_add(total, total)
        total = CH.g1_add(total, win)
    return total


def window_sums(windows, rng):
    """Affine windows (None: the identity) -> the device's (X, Y, Z) batch,
    each point at a random Z; an identity gets Z = 0 under random X, Y."""
    cols = ([], [], [])
    for pt in windows:
        if pt is None:
            xyz = (rng.randrange(FQ_MOD), rng.randrange(FQ_MOD), 0)
        else:
            z = rng.randrange(2, FQ_MOD)
            xyz = (pt[0] * z * z % FQ_MOD, pt[1] * z ** 3 % FQ_MOD, z)
        for col, v in zip(cols, xyz):
            col.append(v)
    return tuple(D.pack(col, FQ) for col in cols)


def _random_windows(nw, rng):
    return [CH.g1_mul(CH.G1_GEN, rng.randrange(1, FR_MOD)) for _ in range(nw)]


def _with_window(windows, w, c, sign):
    """windows with window w set to sign * 2^c * (the fold of the windows
    above it): the total that meets window w, up to its sign."""
    above = None
    for pt in reversed(windows[w + 1:]):
        above = CH.g1_add(CH.g1_mul(above, 1 << c) if above else None, pt)
    target = CH.g1_mul(above, 1 << c)
    out = list(windows)
    out[w] = target if sign > 0 else CH.g1_neg(target)
    return out


def _case(name, rng):
    """(windows, c, what jac_add must meet: "double", "cancel" or None)."""
    if name == "random_c15":
        return _random_windows(18, rng), 15, None
    if name == "random_c4":
        return _random_windows(9, rng), 4, None
    if name == "top_zero":
        return _random_windows(13, rng) + [None] * 5, 15, None
    if name == "all_zero":
        return [None] * 18, 15, None
    if name == "only_window0":
        return _random_windows(1, rng) + [None] * 17, 15, None
    if name == "double":
        return _with_window(_random_windows(18, rng), 7, 15, +1), 15, "double"
    if name == "cancel":
        return _with_window(_random_windows(18, rng), 7, 15, -1), 15, "cancel"
    if name == "cancel_last":
        return _with_window(_random_windows(6, rng), 0, 4, -1), 4, "cancel"
    raise ValueError(name)


CASES = ["random_c15", "random_c4", "top_zero", "all_zero", "only_window0",
         "double", "cancel", "cancel_last"]


@pytest.mark.parametrize("name", CASES)
def test_jacobian_fold_matches_the_affine_fold(name, monkeypatch):
    rng = random.Random(CASES.index(name) + 21)
    windows, c, meets = _case(name, rng)
    sums = window_sums(windows, rng)
    met = []
    add = CH.jac_add

    def spy(p, q):
        out = add(p, q)
        if p[2] and q[2]:
            same = CH.jac_to_affine(p) == CH.jac_to_affine(q)
            met.append("double" if same else "cancel" if out[2] == 0 else "")
        return out

    monkeypatch.setattr(CH, "jac_add", spy)
    got = M._fold_windows(sums, c)
    monkeypatch.undo()
    assert got == affine_fold(sums, c)
    weights = [1 << (c * w) for w in range(len(windows))]
    assert got == RCH.g1_msm(weights, windows)
    if name == "all_zero" or name == "cancel_last":
        assert got is None
    if meets:
        assert meets in met
    else:
        assert "double" not in met and "cancel" not in met
