"""create_proof with the prover's commitments of a domain's size on the
device path: the SHA-256 circuit32 / SCHEME8 (one block) with
HOST_THRESHOLD lowered to the domain, so that the advice and permutation z
batches (commit_lagrange_many) and the CQ f commitments (msm_multi) go
through ops/msm.msm_device_many, and the single commitments through
msm_device, its one-column call, on the CPU, gives the host path's proof bytes under the same
seeded rng: at k=7, its smallest domain, where the prover commits lists of
ints, and at k=10, where it commits (n, 4) u64 buffers as at k=20.

K5 and K6 stand in as their sums in host arithmetic (each window's sum
sum_b b * B_b as a native MSM of the window's digits, read back from K5's
layout and words): their plain versions take about a second a column on
the CPU, a proof commits 123 to 131 columns, and test_torch_msm_many.py
holds the plain versions on the same path.  Everything else of the path
runs as on a card: the buffers' and lists' digits, the layout, the basis
words, the fold."""
import functools

import pytest

from sha2cq_tpu_torch import compat as C
from sha2cq_tpu_torch.curves import device as PD
from sha2cq_tpu_torch.ops import msm as M


def host_bucket_sums(words, order, starts):
    """K5's inputs, kept for host_window_reduce."""
    return (words, order, starts)


def host_window_reduce(k5):
    """Per window sum_i digit_i * point_i, the window sum K6 gives, from
    K5's words (the affine points) and layout (digit b for the sorted
    positions starts[w, b] .. starts[w, b + 1]), as a device batch."""
    words, order, starts = k5
    pts = PD.unpack_jacobian(M._words_to_points(words))
    sums = []
    for w in range(order.shape[0]):
        digits = [0] * len(pts)
        st = starts[w].tolist()
        for b in range(1, len(st) - 1):
            for i in order[w, st[b]:st[b + 1]].tolist():
                digits[i] = b
        live = [(d, p) for d, p in zip(digits, pts) if d and p is not None]
        sums.append(M.msm_host([d for d, _ in live], [p for _, p in live])
                    if live else None)
    return PD.pack_affine(sums, device="cpu")


@pytest.mark.parametrize("k", [7, 10])
def test_device_batch_commits_give_the_host_proof(k, monkeypatch):
    case = C.build_sha256(k, 1, 0x5256)
    host = C.prove(case, 3, h_device=False)
    calls = []
    real = functools.partial(M.msm_device_many, device="cpu", c=4)

    def counted(columns, **kw):
        calls.append([type(col).__name__ for col in columns])
        return real(columns, **kw)
    monkeypatch.setattr(M, "HOST_THRESHOLD", 1 << k)
    monkeypatch.setattr(M, "msm_device_many", counted)
    monkeypatch.setattr(M, "msm_device", functools.partial(
        M.msm_device, device="cpu", c=4))
    monkeypatch.setattr(M, "msm_bucket_sums", host_bucket_sums)
    monkeypatch.setattr(M, "msm_window_reduce", host_window_reduce)
    proof = C.prove(case, 3, h_device=False)
    assert proof == host
    # the advice batch; from k=10 also the permutation's z batch (below,
    # a z column at a time through commit_lagrange and msm_device)
    batches = [batch for batch in calls if len(batch) > 1]
    assert [len(batch) for batch in batches] == ([123] if k < 10 else
                                                 [123, 8])
    kinds = {kind for batch in batches for kind in batch}
    assert kinds == ({"list"} if k < 10 else {"ndarray"})
    # the single commitments: msm_device is msm_device_many of one column
    singles = [batch for batch in calls if len(batch) == 1]
    assert singles and all(batch == ["list"] for batch in singles)
    assert C.verify(case, proof, 3)
