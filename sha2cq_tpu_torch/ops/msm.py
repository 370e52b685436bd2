"""Multi-scalar multiplication of the port (counterpart of
sha2cq_tpu/ops/msm.py).

msm() sends an MSM of fewer than HOST_THRESHOLD points to the native host
Pippenger (native/fieldops.c) and a larger one to the device Pippenger
msm_device, exactly as the reference does.  msm_multi, the prover's batch
of commitments, sends its non-indexed jobs of HOST_THRESHOLD points or more
to msm_device_many (the jobs that share a basis in one call) and the rest
to one native call.  msm_device is msm_device_many of one column, so a
commit and a batch take the same steps.

A native packed basis (packed_basis, fixed for its owner's life) is
uploaded, checked and cut into K5's words once per device, on the first MSM
over it there (_upload_basis); every later MSM over it on that device reads
the words from a cache kept on the packed buffer, so they die with it.

The device Pippenger, per window of c scalar bits:
  digits                     (_scalars_to_digits: tensor ops on the device)
  point indices sorted by digit, bucket offsets   (bucket_layout: torch.sort)
  bucket sums B_b            (msm_bucket_sums: kernel K5 on a card, over
                              the points in affine_words' layout)
  sum_{b >= 1} b * B_b       (msm_window_reduce: kernel K6 on a card)
then the 2^c-weighted fold of the nw window sums on the host, as in the
reference (_fold_windows: one read-back, a Jacobian fold, one inversion).
A CPU tensor takes the plain versions (bucket_sums_plain,
window_reduce_plain, built on curves/device.py), which add in the kernels'
order, so a kernel's output equals its plain version's limb for limb.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..curves import device as PD
from ..curves import host as CH
from ..fields import device as D
from ..fields import host as H
from ..fields.device import FQ, LIMB, NLIMB
from ..utils.profiling import profiler

# Same threshold as the reference: below it the host Pippenger is used.
HOST_THRESHOLD = 1 << 20

# Window bits of the device MSM from 2^20 points, the size they were chosen
# at on the card (PERF.md, K5/K6 by window size; larger n unmeasured):
# K5 + K6 took 4.86 ms at 15 against 5.11 at the reference's 14 and 5.18 at
# 16 (NVIDIA H100 80GB HBM3, 700 W, uniform scalars, one call): 14 has 9%
# more live digits for K5, 16 twice the buckets for K6.  The chunked K5 no
# longer slows down at 14, where the top window puts every point in 4
# buckets (within 1.07x of its time at 15).  Below 2^20 points the
# reference's rule holds, wherever HOST_THRESHOLD lies.
DEVICE_WINDOW_BITS = 15

# csrc/msm.cu's constants of the same names (a test holds them equal)
K5_CHUNK = 32       # sorted positions a K5 thread adds
K6_RUN = 16         # buckets a K6 thread sums
K6_THREADS = 32     # threads of a K6 block
K6_MAX = 128        # most threads of a K6 block


def msm_host(scalars: Sequence[int], points, packed=None) -> CH.G1Affine:
    """Host Pippenger (c=8): native C kernel when available, else the
    pure-Python Jacobian accumulation.

    packed: optional pre-marshalled basis buffer (native_loader
    .pack_points_affine) covering at least len(scalars) points — skips the
    per-call point marshalling for fixed commitment bases."""
    n = len(scalars)
    if n == 0:
        return None
    if packed is not None:
        from ..native_loader import native_msm_packed
        res = native_msm_packed([s % H.FR_MOD for s in scalars], packed, n)
        if res is not None:
            return CH.jac_to_affine(res)
    from ..native_loader import native_msm
    jac = [CH.jac_from_affine(pt) for pt in points[:n]]
    res = native_msm([s % H.FR_MOD for s in scalars], jac)
    if res is not None:
        return CH.jac_to_affine(res)
    c = 8 if n >= 32 else 4
    nw = (256 + c - 1) // c
    total = CH.JAC_IDENTITY
    for w in range(nw - 1, -1, -1):
        if total != CH.JAC_IDENTITY:
            for _ in range(c):
                total = CH.jac_double(total)
        buckets: dict = {}
        for s, pt in zip(scalars, points):
            if pt is None:
                continue
            d = ((s % H.FR_MOD) >> (c * w)) & ((1 << c) - 1)
            if d:
                if d in buckets:
                    buckets[d] = CH.jac_add_affine(buckets[d], pt)
                else:
                    buckets[d] = CH.jac_from_affine(pt)
        run = CH.JAC_IDENTITY
        acc = CH.JAC_IDENTITY
        for d in range(max(buckets) if buckets else 0, 0, -1):
            if d in buckets:
                run = CH.jac_add(run, buckets[d])
            acc = CH.jac_add(acc, run)
        total = CH.jac_add(total, acc)
    return CH.jac_to_affine(total)


def msm(scalars: Sequence[int], points, packed=None) -> CH.G1Affine:
    """Dispatch: tiny MSMs on the host, big ones on the card."""
    if len(scalars) < HOST_THRESHOLD:
        return msm_host(scalars, points, packed=packed)
    return msm_device(scalars, points, packed=packed)


# ------------------------------ device MSM ----------------------------------

def pick_window_bits_v2(n: int) -> int:
    """The reference's window size: balance the O(n) work per window
    against the O((2c+3) * 2^c) bucket-side work."""
    c = 8
    while c < 16 and (1 << (c + 1)) * (2 * (c + 1) + 3) <= n:
        c += 1
    return c


def pick_window_bits(n: int) -> int:
    """The device MSM's window size: the reference's rule below 2^20
    points, DEVICE_WINDOW_BITS from there."""
    if n >= 1 << 20:
        return DEVICE_WINDOW_BITS
    return pick_window_bits_v2(n)


def _scalars_to_digits(buf, c: int, device=None) -> torch.Tensor:
    """(n, 4) canonical u64 scalar buffer (native_loader.fr_buf) ->
    (ceil(256/c), n) int32 c-bit windows, the reference's digits, computed
    with tensor ops on `device`."""
    words = torch.from_numpy(np.ascontiguousarray(buf).view(np.int64))
    w32 = D.to_device(words, device).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    w32 = torch.cat([w32, torch.zeros_like(w32[:, :1])], dim=1)   # (n, 9)
    mask = (1 << c) - 1
    rows = []
    for w in range((256 + c - 1) // c):
        j, sh = divmod(c * w, 32)
        d = w32[:, j] >> sh
        if sh + c > 32:
            d = d | (w32[:, j + 1] << (32 - sh))
        rows.append(d & mask)
    return torch.stack(rows).to(torch.int32)


def bucket_layout(digits: torch.Tensor, c: int):
    """(order, starts) of (nw, n) digits: each window's point indices sorted
    by digit (stable, so a bucket adds its points in index order), and
    starts[w, b] the offset of bucket b's segment (starts[w, 2^c] = n);
    both int32."""
    nw = digits.shape[0]
    sorted_d, order = torch.sort(digits, dim=1, stable=True)
    edges = torch.arange((1 << c) + 1, dtype=sorted_d.dtype,
                         device=digits.device).expand(nw, -1).contiguous()
    starts = torch.searchsorted(sorted_d.contiguous(), edges)
    return order.to(torch.int32).contiguous(), starts.to(torch.int32)


def affine_words(points: PD.PointArray) -> torch.Tensor:
    """K5's point layout: (n, 16) int32, the eight 32-bit words of x then
    of y (Montgomery), all zero for the identity ((0, 0) is on no curve
    y^2 = x^3 + 3).  Every Z must be 0 or Montgomery one (K5 adds affine
    points)."""
    check_affine(points)
    return _pack_affine_words(points)


def check_affine(points: PD.PointArray) -> None:
    """Raise unless every Z is 0 or Montgomery one (one host sync)."""
    Z = points[2]
    if D.on_card(Z):
        profiler.count("host_syncs")
    if not bool((D.is_zero(Z) | D.eq(Z, D.ones((1,), FQ, Z.device))).all()):
        raise ValueError("K5 adds affine points: each Z must be 0 or one")


def _pack_affine_words(points: PD.PointArray) -> torch.Tensor:
    """affine_words without the check (no host sync)."""
    X, Y, Z = points
    ident = D.is_zero(Z)
    xy = torch.cat([X, Y]).to(torch.int64)
    w = xy[0::2] | (xy[1::2] << 16)                    # (16, n)
    w = torch.where(ident, 0, w)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(LIMB).t().contiguous()


def _words_to_points(words: torch.Tensor) -> PD.PointArray:
    """affine_words' inverse: a Jacobian batch with Z = one, or Z = 0 (and
    x = y = 0) for the identity."""
    w = words.t().to(torch.int64) & 0xFFFFFFFF                # (16, n)
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(32, -1).to(LIMB)
    one = D.ones((words.shape[0],), FQ, words.device)
    Z = D.select(D.is_zero(limbs), torch.zeros_like(one), one)
    return (limbs[:NLIMB], limbs[NLIMB:], Z)


def _lowbit(x: torch.Tensor) -> torch.Tensor:
    return x & -x


def bucket_sums_plain(words: torch.Tensor, order: torch.Tensor,
                      starts: torch.Tensor, chunk: int = K5_CHUNK
                      ) -> PD.PointArray:
    """Plain version of K5: B[w, b] = the sum of the points in bucket b of
    window w (identity for b = 0 and for empty buckets), as a Jacobian
    batch over (nw, 2^c).  It takes K5's three steps in K5's order
    (csrc/msm.cu), over every chunk of `chunk` sorted positions at once:

    chunks: step i adds the i-th point of every chunk of the live range
      [starts[w, 1], n) into its lane's sum, after closing the lane's piece
      where the digit changes (a bucket inside the chunk goes to the
      output, the chunk's first and last pieces of buckets that cross its
      edges to head and tail); identity points are skipped;
    tree: level l adds head[i + 2^l] into head[i] for i a multiple of
      2^(l+1) when chunks i and i + 2^l start in the same bucket;
    finish: a bucket spanning chunks c0 < c1 is tail[c0] (head[c0] when it
      begins at c0's start) plus head[x] for x = c0 + 1, x += lowbit(x),
      while x <= c1.
    So it takes at most chunk + 1 + 2 log2(chunks) eager steps, whatever
    the digits are.  chunk is the kernel's K5_CHUNK; tests pass a smaller
    one to put chunk edges inside small layouts."""
    points = _words_to_points(words)
    live = ~PD.is_identity(points)
    nw, n = order.shape
    m = starts.shape[1] - 1
    dev = order.device
    st = starts.long()
    C = -(-n // chunk)
    out = PD.identity_like((nw * m,), dev)
    if C == 0:
        return tuple(a.reshape(NLIMB, nw, m) for a in out)
    head = PD.identity_like((nw * C,), dev)
    tail = PD.identity_like((nw * C,), dev)
    rows = torch.arange(nw, device=dev)[:, None]
    s1 = st[:, 1:2]                                             # (nw, 1)
    # the bucket of each sorted position: the largest b with st[b] <= k
    bucket_at = torch.searchsorted(
        st.contiguous(), torch.arange(n, device=dev).expand(nw, n).contiguous(),
        right=True) - 1
    flat_order = order.long().reshape(-1)

    def put(dst, idx, val, mask):
        sel = torch.nonzero(mask).squeeze(1)
        return tuple(d.index_copy(1, idx[sel], v[:, sel])
                     for d, v in zip(dst, val))

    # ---- chunks: one lane a chunk
    k0 = s1 + chunk * torch.arange(C, device=dev)[None, :]     # (nw, C)
    valid = (k0 < n).reshape(-1)
    k0 = k0.clamp(max=n - 1).reshape(-1)
    k1 = torch.minimum(k0 + chunk, torch.full_like(k0, n))
    win = rows.expand(nw, C).reshape(-1)
    cur = bucket_at[win, k0]
    key = cur.clone()
    first = torch.ones_like(valid)
    begun = st[win, cur] >= k0
    end = st[win, cur + 1]
    done = ~valid
    lane = torch.arange(nw * C, device=dev)
    acc = PD.identity_like((nw * C,), dev)
    for i in range(chunk + 1):
        k = k0 + i
        close = ~done & ((k == end) | (k == k1))
        whole = close & begun & (end <= k1)
        out = put(out, win * m + cur, acc, whole)
        head = put(head, lane, acc, close & ~whole & first)
        tail = put(tail, lane, acc, close & ~whole & ~first)
        done = done | (close & (k == k1))
        step = close & ~done
        first = first & ~step
        begun = begun | step
        cur = torch.where(step, bucket_at[win, k.clamp(max=n - 1)], cur)
        end = st[win, cur + 1]
        acc = PD.select_point(step, PD.identity_like((nw * C,), dev), acc)
        idx = flat_order[win * n + k.clamp(max=n - 1)]
        adding = torch.nonzero(~done & live[idx]).squeeze(1)
        if adding.numel():
            new = PD.point_add(tuple(a[:, adding] for a in acc),
                               tuple(a[:, idx[adding]] for a in points))
            acc = tuple(a.index_copy(1, adding, b) for a, b in zip(acc, new))

    # ---- tree over each window's chunks
    n_live = (n - s1 + chunk - 1) // chunk                      # (nw, 1)
    key = key.reshape(nw, C)
    lev = 0
    while (1 << lev) < C:
        i = torch.arange(0, C, 2 << lev, device=dev)[None, :]
        j = i + (1 << lev)
        jc = j.clamp(max=C - 1)
        pair = (j < n_live) & (key.gather(1, i.expand(nw, -1)) ==
                               key.gather(1, jc.expand(nw, -1)))
        w_, t_ = torch.nonzero(pair, as_tuple=True)
        if w_.numel():
            a_ = w_ * C + i[0, t_]
            b_ = w_ * C + j[0, t_]
            new = PD.point_add(tuple(h[:, a_] for h in head),
                               tuple(h[:, b_] for h in head))
            head = tuple(h.index_copy(1, a_, v) for h, v in zip(head, new))
        lev += 1

    # ---- finish: buckets that span chunks
    b_all = torch.arange(m, device=dev)[None, :]
    s, e = st[:, :-1], st[:, 1:]
    c0 = (s - s1) // chunk
    c1 = (e - 1 - s1) // chunk
    w_, b_ = torch.nonzero((b_all >= 1) & (e > s) & (c0 < c1), as_tuple=True)
    if w_.numel():
        c0, c1 = c0[w_, b_], c1[w_, b_]
        begins = key[w_, c0] == b_
        at = w_ * C + c0
        acc = PD.select_point(begins, tuple(h[:, at] for h in head),
                              tuple(t[:, at] for t in tail))
        x = torch.where(begins, torch.where(c0 == 0, C, c0 + _lowbit(c0)),
                        c0 + 1)
        while True:
            act = torch.nonzero(x <= c1).squeeze(1)
            if not act.numel():
                break
            new = PD.point_add(tuple(a[:, act] for a in acc),
                               tuple(h[:, w_[act] * C + x[act]] for h in head))
            acc = tuple(a.index_copy(1, act, v) for a, v in zip(acc, new))
            x = x.index_put((act,), x[act] + _lowbit(x[act]))
        out = tuple(o.index_copy(1, w_ * m + b_, v) for o, v in zip(out, acc))
    return tuple(a.reshape(NLIMB, nw, m) for a in out)


def msm_bucket_sums(words: torch.Tensor, order: torch.Tensor,
                    starts: torch.Tensor) -> PD.PointArray:
    """Bucket sums of every window (see bucket_sums_plain): kernel K5 on a
    card, the plain version on the CPU.  words: (n, 16) affine points
    (affine_words); order (nw, n) and starts (nw, 2^c + 1) int32 from
    bucket_layout."""
    if not order.is_cuda:
        return bucket_sums_plain(words, order, starts)
    from . import cuda_field as CF
    from . import kernels as K
    nw, n = order.shape
    m = starts.shape[1] - 1
    if order.dtype != torch.int32 or starts.dtype != torch.int32 or \
            starts.shape[0] != nw or m < 2 or n >= 1 << 31:
        raise ValueError(f"K5: order (nw, n) and starts (nw, m + 1) int32, "
                         f"got {tuple(order.shape)} {order.dtype}, "
                         f"{tuple(starts.shape)} {starts.dtype}")
    if words.shape != (n, 16) or words.dtype != LIMB or \
            words.device != order.device:
        raise ValueError(f"K5: words must be ({n}, 16) int32 on "
                         f"{order.device}, got {tuple(words.shape)} "
                         f"{words.dtype} on {words.device}")
    words, order, starts = (t.contiguous() for t in (words, order, starts))
    dev = order.device
    C = -(-n // K5_CHUNK)
    out = torch.empty((3, NLIMB, nw, m), dtype=LIMB, device=dev)
    head = torch.empty((nw, C, 24), dtype=LIMB, device=dev)
    tail = torch.empty((nw, C, 24), dtype=LIMB, device=dev)
    key = torch.empty((nw, C), dtype=torch.int32, device=dev)
    p8, n0 = K.field_words(FQ)
    lib = K.get_lib()
    CF.count_launch("msm_bucket_sums")     # one call: 2 + log2(C) kernels
    K.check(lib.k5_msm_bucket_sums(
        words.data_ptr(), order.data_ptr(), starts.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        head.data_ptr(), tail.data_ptr(), key.data_ptr(), nw, n, m,
        p8, n0, K.one_words(FQ), K.stream_ptr(order)), "k5_msm_bucket_sums")
    return (out[0], out[1], out[2])


def k6_shape(m: int):
    """(L, T, P) of K6 for 2^c = m buckets a window, csrc/msm.cu's
    k6_shape: L = K6_RUN buckets a thread's run and T = K6_THREADS threads
    a block, fewer for a small window, and T larger where P = m / (L T)
    blocks a window would exceed K6_MAX; so c is at most 18."""
    if m < 1 or m & (m - 1):
        raise ValueError(f"K6: the bucket count {m} is not a power of two")
    L = min(K6_RUN, m)
    T = min(K6_THREADS, m // L)
    if m // (L * T) > K6_MAX:
        T = m // (L * K6_MAX)
    if T > K6_MAX:
        raise ValueError(f"K6: {m} buckets a window is beyond "
                         f"{K6_RUN * K6_MAX ** 2} (window bits above 18)")
    return L, T, m // (L * T)


def _dbl_n(p: PD.PointArray, k: int) -> PD.PointArray:
    for _ in range(k):
        p = PD.point_double(p)
    return p


def _halves(p: PD.PointArray):
    """Adjacent pairs along the last axis: (even entries, odd entries)."""
    return tuple(a[..., 0::2] for a in p), tuple(a[..., 1::2] for a in p)


def _k6_tree(D: PD.PointArray, V: PD.PointArray):
    """K6's tree over the last axis: node i of a level combines entries 2i
    and 2i + 1 as V = (V_l + V_r) + D_r, D = 2 (D_l + D_r); returns the
    root's (D, V) with the axis dropped."""
    while D[0].shape[-1] > 1:
        (DL, DR), (VL, VR) = _halves(D), _halves(V)
        V = PD.point_add(PD.point_add(VL, VR), DR)
        D = PD.point_double(PD.point_add(DL, DR))
    return tuple(tuple(a[..., 0] for a in x) for x in (D, V))


def window_reduce_plain(buckets: PD.PointArray) -> PD.PointArray:
    """Plain version of K6: per window sum_{b >= 1} b * B_b of a Jacobian
    batch over (nw, m), as a batch over (nw,).  It takes K6's steps in
    K6's order (k6_shape): thread t of block p sums buckets p*T*L + j*T +
    t (j < L) by running sums into S and sum_j j * B_j; its leaf is D = S,
    V = T * sum_j j * B_j (log2 T doublings); the tree over the block's T
    threads (_k6_tree) gives D = T * S_p and V_p; then D = T * L * S_p
    (log2 L doublings) and the tree over the window's P blocks leaves the
    window's sum in the root's V."""
    nw, m = buckets[0].shape[1:]
    L, T, P = k6_shape(m)
    dev = buckets[0].device
    B = [a.reshape(NLIMB, nw, P, L, T) for a in buckets]

    def row(j):
        return tuple(a[..., j, :] for a in B)

    run_ = acc = PD.identity_like((nw, P, T), dev)
    for j in range(L - 1, 0, -1):
        run_ = PD.point_add(run_, row(j))
        acc = PD.point_add(acc, run_)
    run_ = PD.point_add(run_, row(0))
    D, V = _k6_tree(run_, _dbl_n(acc, T.bit_length() - 1))     # (nw, P)
    return _k6_tree(_dbl_n(D, L.bit_length() - 1), V)[1]


def msm_window_reduce(buckets: PD.PointArray) -> PD.PointArray:
    """Per window sum_{b >= 1} b * B_b of bucket sums over (nw, 2^c):
    kernel K6 on a card, the plain version on the CPU."""
    X = buckets[0]
    if not X.is_cuda:
        return window_reduce_plain(buckets)
    from . import cuda_field as CF
    from . import kernels as K
    if X.dim() != 3 or X.shape[0] != NLIMB or any(
            a.shape != X.shape or a.device != X.device or a.dtype != LIMB
            for a in buckets):
        raise ValueError("K6: buckets are three (16, nw, m) int32 tensors")
    nw, m = X.shape[1:]
    P = k6_shape(m)[2]
    bx, by, bz = (a.contiguous() for a in buckets)
    part = torch.empty((nw, P, 2, 24), dtype=LIMB, device=X.device)
    out = torch.empty((3, NLIMB, nw), dtype=LIMB, device=X.device)
    p8, n0 = K.field_words(FQ)
    lib = K.get_lib()
    CF.count_launch("msm_window_reduce")     # one call: two CUDA kernels
    K.check(lib.k6_msm_window_reduce(
        bx.data_ptr(), by.data_ptr(), bz.data_ptr(), part.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), nw, m, p8,
        n0, K.one_words(FQ), K.stream_ptr(X)),
        "k6_msm_window_reduce")
    return (out[0], out[1], out[2])


def _fold_windows(sums: PD.PointArray, c: int) -> CH.G1Affine:
    """The reference's host fold of the nw window sums (Jacobian, Montgomery
    limbs) into one affine point (None for the identity): one read-back of
    X, Y and Z together (one host wait on a card), then, from the top window
    down, total = 2^c * total + window in Jacobian coordinates (a window
    whose Z is 0 is the identity, as on the device), and one inversion at
    the end."""
    xyz = D.unpack(torch.stack(sums, dim=1), FQ)        # X's, Y's, then Z's
    nw = len(xyz) // 3
    total = CH.JAC_IDENTITY
    for w in range(nw - 1, -1, -1):
        for _ in range(c):
            total = CH.jac_double(total)
        total = CH.jac_add(total, tuple(xyz[w::nw]))
    return CH.jac_to_affine(total)


def msm_device(scalars: Sequence[int], points, c: Optional[int] = None,
               packed=None, device="cuda") -> CH.G1Affine:
    """Pippenger MSM on `device` (the card unless the caller asks for the
    CPU): sum_i scalars[i] * points[i] (scalars reduced mod r) as a host
    affine point (None for the identity); msm_device_many of one column,
    whose docstring gives the arguments, steps, spans and counters."""
    return msm_device_many([scalars], packed=packed, points=points, c=c,
                           device=device)[0]


_BASIS_LOCK = threading.Lock()      # one fill of a basis a device


def _upload_basis(points, packed, n: int, dev) -> torch.Tensor:
    """K5's words (affine_words) of the first n points of a basis on `dev`.

    A native packed basis is uploaded, checked (pack_affine's z = 1 test,
    check_affine's Z test) and cut into K5's words once per device, all of
    its points, under a lock; every later call over it on `dev` slices the
    cached words, with no copy and no host wait.  Counts `basis_cached`: 0
    on the fill, 1 on a hit.  The words are kept on the packed buffer itself
    (its `_device_words`, one entry a device), so they die with it.  A host
    affine list (packed None) is uploaded and checked every call and stored
    nowhere."""
    if packed is None:
        return affine_words(PD.pack_affine(points[:n], device=dev))
    cache = packed.__dict__.setdefault("_device_words", {})
    key = _device_key(dev)
    words = cache.get(key)
    cached = words is not None
    if not cached:
        with _BASIS_LOCK:
            words = cache.get(key)
            cached = words is not None
            if not cached:
                pts = PD.pack_affine(device=dev, packed=packed)
                words = _pack_affine_words(pts)
                # the check's host wait comes after the words are made, so
                # they are complete for any stream that reads them next
                check_affine(pts)
                cache[key] = words
    profiler.count("basis_cached", int(cached))
    return words[:n]


def _device_key(dev: torch.device) -> str:
    """The cache's name for a device: a card's index made explicit, so that
    "cuda" and "cuda:0" share an entry."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def msm_device_many(columns, packed=None, points=None, c: Optional[int] = None,
                    device="cuda") -> list:
    """Pippenger MSMs of many scalar columns over one basis on `device` (the
    card unless the caller asks for the CPU): per column sum_i column[i] *
    basis[i], a host affine point (None for the identity).  A column is an
    (m, 4) little-endian u64 buffer (native_loader.fr_buf's layout, the
    prover's columns) or a sequence of ints (reduced mod r); a buffer's
    words go to digits as they are (every basis point has order r, so words
    of s + r give the point of s).  packed: a native basis
    (native_loader.pack_points_affine) covering the longest column, read in
    place of points, the host affine list.  c: window bits, by default
    pick_window_bits of each column's length.

    One profiler phase msm_device_many around the batch, counting
    msm_columns; under it a phase a step, timed on the host (a phase around
    a launch times the launch, not the kernel):
      msm_basis, once a batch: K5's words of the basis (_upload_basis: a
        packed basis is uploaded and cut into them once per device, then
        read from the cache, counting basis_cached 0, then 1; a host list
        is uploaded every batch);
    then per column:
      msm_scalars, for a column of ints: its canonical words
        (scalar_words.fr_words), counting scalars_slow, the scalars that
        were not exact ints in [0, r) and so were reduced in Python;
      msm_digits: the c-bit window digits (_scalars_to_digits);
      msm_layout: bucket_layout; while the profiler is on it counts
        msm_nonzero_digits, the nonzero window digits K5 adds (one more
        host wait on a card);
      msm_bucket_sums (K5), msm_window_reduce (K6), and msm_fold, the
        host fold of the window sums (_fold_windows: one read-back of X,
        Y and Z, counted as one host wait on a card, a Jacobian fold and
        one inversion)."""
    dev = torch.device(device)
    torch.empty(0, device=dev)       # no card: torch's CUDA error, here
    for col in columns:
        if isinstance(col, np.ndarray) and (
                col.ndim != 2 or col.shape[1] != 4 or col.dtype.itemsize != 8):
            raise ValueError(f"a scalar buffer is (m, 4) u64 words, got "
                             f"{col.shape} {col.dtype}")
    out: list = [None] * len(columns)
    with profiler.phase("msm_device_many"):
        profiler.count("msm_columns", len(columns))
        n = max((len(col) for col in columns), default=0)
        if n == 0:
            return out
        with profiler.phase("msm_basis"):
            words = _upload_basis(points, packed, n, dev)
        for j, col in enumerate(columns):
            m = len(col)
            if m == 0:
                continue
            cj = c or pick_window_bits(m)
            if not isinstance(col, np.ndarray):
                from ..scalar_words import fr_words
                with profiler.phase("msm_scalars"):
                    col, slow = fr_words(col)
                    profiler.count("scalars_slow", slow)
            with profiler.phase("msm_digits"):
                digits = _scalars_to_digits(col, cj, dev)
            with profiler.phase("msm_layout"):
                order, starts = bucket_layout(digits, cj)
                if profiler.enabled:
                    if D.on_card(starts):
                        profiler.count("host_syncs")
                    profiler.count("msm_nonzero_digits", int(
                        digits.shape[0] * m - starts[:, 1].sum()))
            del digits
            with profiler.phase("msm_bucket_sums"):
                buckets = msm_bucket_sums(words[:m], order, starts)
            with profiler.phase("msm_window_reduce"):
                sums = msm_window_reduce(buckets)
            with profiler.phase("msm_fold"):
                out[j] = _fold_windows(sums, cj)
    return out


def packed_basis(obj, attr: str, points):
    """Lazily cache a pre-marshalled native basis buffer on `obj` (None when
    the native lib is unavailable).

    Big bases (>= 2^14 points) are also disk-cached as raw limb bytes:
    marshalling a 2^18-point Lagrange basis costs seconds of Python bigint
    `to_bytes` per fresh process (most of the cold-process cq_msms tax),
    while reading the 24 MB blob back is ~30 ms."""
    if attr not in obj.__dict__:
        from ..native_loader import pack_points_affine
        pts = points() if callable(points) else points
        packed = None
        if len(pts) >= DISK_BASIS_MIN and not any(p is None for p in pts):
            packed = _packed_basis_disk(pts)
        if packed is None:
            packed = pack_points_affine(pts)
        obj.__dict__[attr] = packed
    return obj.__dict__[attr]


DISK_BASIS_MIN = 1 << 14  # smallest basis worth a disk round trip


def _packed_basis_disk(points):
    """Disk-backed pack_points_affine: raw bytes keyed on (len, 16 sample
    points), written atomically.  Returns None without the native library."""
    import ctypes
    import hashlib
    import os

    from ..native_loader import get_lib, pack_points_affine
    if get_lib() is None:
        return None
    n = len(points)
    sample = [points[(i * (n - 1)) // 15] for i in range(16)]
    key = hashlib.sha256(repr((n, sample)).encode()).hexdigest()[:20]
    cache_dir = os.path.expanduser(
        os.environ.get("SHA2CQ_CACHE", "~/.cache/sha2cq_jax"))
    path = os.path.join(cache_dir, f"packedbasis_{key}.bin")
    try:
        with open(path, "rb") as f:
            raw = f.read()
        if len(raw) == 96 * n:
            return (ctypes.c_uint64 * (12 * n)).from_buffer_copy(raw)
    except OSError:
        pass                     # no cache entry yet: pack and write one
    packed = pack_points_affine(points)
    if packed is not None:
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            os.makedirs(cache_dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(bytes(packed))
            os.replace(tmp, path)
        except OSError:
            pass                 # a read-only cache costs speed, not results
    return packed


def msm_multi(jobs) -> list:
    """Many independent MSMs — the prover's per-phase commitment batches.
    jobs: list of (packed_basis, indices_or_None, scalars, fallback_points),
    scalars a list of ints or an (m, 4) u64 buffer.  Non-indexed jobs of
    HOST_THRESHOLD points or more run on the card, msm_device_many over each
    basis they share; the rest in ONE native call (g1_msm_unified, OpenMP
    across jobs), falling back to the per-job host path when native is
    unavailable; raises MemoryError when the native side could not allocate
    a job.  Returns G1Affine (or None for empty jobs) per job."""
    out: list = [None] * len(jobs)
    by_basis: dict = {}
    host = []
    for j, job in enumerate(jobs):
        if job[1] is None and len(job[2]) >= HOST_THRESHOLD:
            by_basis.setdefault((id(job[0]), id(job[3])), []).append(j)
        elif len(job[2]) > 0:
            host.append((j, job))
    for js in by_basis.values():
        packed, _, _, pts = jobs[js[0]]
        res = msm_device_many([jobs[j][2] for j in js], packed=packed,
                              points=pts)
        for j, point in zip(js, res):
            out[j] = point
    native = [(j, job) for j, job in host if job[0] is not None]
    rest = [(j, job) for j, job in host if job[0] is None]
    if native:
        from ..native_loader import native_msm_multi
        res = native_msm_multi([job[:3] for _, job in native])
        if res is not None:
            for (j, _), jac in zip(native, res):
                out[j] = CH.jac_to_affine(jac)
        else:
            rest = native + rest
    for j, (packed, indices, scalars, pts) in rest:
        if isinstance(scalars, np.ndarray):
            from ..native_loader import fr_unbuf
            scalars = fr_unbuf(scalars)
        if indices is None:
            out[j] = msm_host(list(scalars), pts, packed=packed)
        else:
            out[j] = msm_indexed(scalars, indices, pts, packed=packed)
    return out


def msm_combined(jobs, gjobs) -> list:
    """Plain/indexed jobs + grouped jobs in ONE native OpenMP region
    (g1_msm_unified), so the grouped b0/p batch fills the tail-idle cores
    of the indexed batch instead of running strictly after it.  Returns
    results in jobs + gjobs order.  A job the native side could not
    allocate raises MemoryError; an absent native lib (or an unpacked
    basis) takes the split paths."""
    uni = [("p", p, i, s) for (p, i, s, _pts) in jobs] + \
          [("g", p, r, st, sc) for (p, r, st, sc) in gjobs]
    from ..native_loader import raise_on_failed_jobs, native_msm_unified
    res = raise_on_failed_jobs(native_msm_unified(uni), "msm_combined")
    if res is not None:
        return [CH.jac_to_affine(jac) for jac in res]
    out_p = msm_multi(jobs)
    out_g = msm_grouped_multi(gjobs) if gjobs else []
    return out_p + out_g


def msm_grouped_multi(jobs) -> list:
    """Many grouped sparse MSMs in ONE native call: per job
    (packed_basis, rows, starts, scalars) computes
    sum_g scalars[g] * (sum_{i in rows[starts[g]:starts[g+1]]} basis[rows[i]]).
    Native-only — callers gate on get_lib(); group sums are one mixed add
    per row, then Pippenger over the (much smaller) per-group sums."""
    from ..native_loader import native_msm_grouped_multi
    res = native_msm_grouped_multi(jobs)
    if res is None:
        raise RuntimeError("msm_grouped_multi requires the native library")
    return [CH.jac_to_affine(jac) for jac in res]


def msm_indexed(scalars: Sequence[int], indices: Sequence[int], points,
                packed=None) -> CH.G1Affine:
    """sum_i scalars[i] * points[indices[i]]; native indexed kernel over a
    packed basis when available, else gather + host path."""
    if packed is not None:
        from ..native_loader import native_msm_indexed
        res = native_msm_indexed([s % H.FR_MOD for s in scalars],
                                 list(indices), packed)
        if res is not None:
            return CH.jac_to_affine(res)
    return msm_host(list(scalars), [points[i] for i in indices])
