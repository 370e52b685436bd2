"""CQ static-table preprocessing (reference plonk/static_lookup.rs:31-157).

StaticTableValues holds the prover half: value->index map plus the cached
quotient commitments  qs[i] = [ (T(X) - T(w^i)) / (X - w^i) * w^i/N ]_1.
StaticCommittedTable holds the verifier half: [Z_V]_2, [T]_2 and the
B0-degree-bound point.

The reference computes qs with an O(N^2) per-root kate_division loop and
flags "THIS SHOULD BE DONE WITH FK METHOD" (static_lookup.rs:107).  We
implement both: the naive loop (oracle, small N) and the Feist-Khovratovich
all-openings algorithm (O(N log N) group ops via two size-2N group NTTs),
which is what makes 2^20+ tables preprocessable.  FK runs on the card
(`fk_cached_quotients`: K7 and K8, csrc/fk.cu) where CUDA is present and a
column has DEVICE_MIN_ROWS rows or more, and on the host
(`fk_all_quotient_commitments`, native OpenMP) otherwise; both give the
same points.  `StaticTableValues.many` preprocesses one table's columns in
one call, which shares the SRS side of FK between them.

Note: the reference's `commit` derives the G2 table commitment from
`value_index_mapping.keys()` — i.e. the *sorted* values — which only matches
the prover's polynomial when the table happens to be sorted (true for all its
tests).  We commit the original-order polynomial, which is correct for any
table.

The port's own copy of sha2cq_tpu/plonk/static_tables.py.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..curves import device as CD
from ..curves import host as CH
from ..fields import device as D
from ..fields import host as H
from ..ops import msm as M
from ..ops import ntt as NTT
from ..poly import arith as A
from ..utils.profiling import profiler

P = H.FR_MOD

# The smallest column whose cached quotients go to the card when one is
# present (fk_device).
DEVICE_MIN_ROWS = 1 << 10


@dataclass
class StaticCommittedTable:
    zv: CH.G2Affine          # [x^N - 1]_2
    t: CH.G2Affine           # [T(x)]_2
    x_b0_bound: CH.G2Affine  # [x^{srs_len-1-(n-2)}]_2
    size: int                # srs g1 length


@dataclass
class StaticTableConfig:
    size: int
    g1_lagrange: List[CH.G1Affine]
    g_lagrange_opening_at_0: List[CH.G1Affine]
    # zk static-lookup blinding material (None => zk mode unavailable for
    # this size): [Z_V]_1 = [x^N - 1]_1 and [x^{N-1}]_1
    zv_g1: CH.G1Affine = None
    xn1_g1: CH.G1Affine = None


class StaticTableValues:
    """Prover-side preprocessed table."""

    def __init__(self, values: List[int], srs_g1: List[CH.G1Affine], use_fk: bool = True):
        """FK runs where fk_device says: on the card for a column of
        DEVICE_MIN_ROWS rows or more when CUDA is present, else on the
        host."""
        self._set_values(values)
        size = self.size
        dev = fk_device(size) if use_fk else None
        if dev is not None:
            self.qs = fk_cached_quotients([self.values], srs_g1, dev)[0]
            return

        k = size.bit_length() - 1
        omega = _omega_for_k(k)
        n_inv = pow(size, P - 2, P)
        table_coeffs = NTT.intt_host(self.values, omega, P)

        if use_fk and size >= 4:
            # qs[i] scaled by w^i / N inside the FK pipeline
            # (reference static_lookup.rs:108-119)
            scales = []
            wi = 1
            for _ in range(size):
                scales.append(wi * n_inv % P)
                wi = wi * omega % P
            self.qs = fk_all_quotient_commitments(
                table_coeffs, srs_g1, omega, out_scales=scales)
        else:
            self.qs = []
            wi = 1
            for i in range(size):
                quotient = A.kate_division(table_coeffs, wi)
                scaled = [c * wi % P * n_inv % P for c in quotient]
                self.qs.append(M.msm(scaled, srs_g1[: len(scaled)]))
                wi = wi * omega % P

    def _set_values(self, values: List[int]) -> None:
        size = len(values)
        assert size & (size - 1) == 0, "table size must be a power of two"
        self.size = size
        self.values = [v % P for v in values]
        # value -> index map; None when values repeat (then the CQ prover
        # resolves row indices jointly across the vector lookup's tables —
        # the reference's BTreeMap asserts uniqueness and so cannot express
        # its own multi-column SHA tables; we lift that restriction)
        mapping: Dict[int, int] = {v: i for i, v in enumerate(self.values)}
        self.value_index_mapping = mapping if len(mapping) == size else None

    @classmethod
    def many(cls, columns: List[List[int]],
             srs_g1: List[CH.G1Affine]) -> List["StaticTableValues"]:
        """One table's columns (of one length) preprocessed together: on
        the device route in one fk_cached_quotients call, which transforms
        the SRS once for all of them; on the host route column by
        column."""
        size = len(columns[0])
        if any(len(c) != size for c in columns):
            raise ValueError("a table's columns have one length")
        dev = fk_device(size)
        if dev is None:
            return [cls(v, srs_g1) for v in columns]
        out = [cls.__new__(cls) for _ in columns]
        for tv, values in zip(out, columns):
            tv._set_values(values)
        qs = fk_cached_quotients([tv.values for tv in out], srs_g1, dev)
        for tv, q in zip(out, qs):
            tv.qs = q
        return out

    def commit(self, srs_g1_len: int, srs_g2: List[CH.G2Affine], circuit_domain: int) -> StaticCommittedTable:
        k = self.size.bit_length() - 1
        omega = _omega_for_k(k)
        zv = CH.g2_add(srs_g2[self.size], CH.g2_neg(srs_g2[0]))
        table_coeffs = NTT.intt_host(self.values, omega, P)
        from ..native_loader import native_g2_msm
        t = native_g2_msm(table_coeffs, srs_g2[: len(table_coeffs)])
        if t is None and any(table_coeffs):
            for c, g in zip(table_coeffs, srs_g2):
                t = CH.g2_add(t, CH.g2_mul(g, c))
        b0_bound_index = srs_g1_len - 1 - (circuit_domain - 2)
        # NOTE: the reference stores srs_g1_len here (static_lookup.rs:150-155)
        # but its verifier uses `size` as the table-domain N in the sumcheck
        # (static_lookup/verifier.rs:203-213) — only consistent when the SRS
        # is exactly table-sized.  We store the actual table size so tables
        # smaller than the master SRS verify correctly.
        return StaticCommittedTable(
            zv=zv, t=t, x_b0_bound=srs_g2[b0_bound_index], size=self.size)


@dataclass
class StaticTable:
    opened: Optional[StaticTableValues]
    committed: Optional[StaticCommittedTable]


def _omega_for_k(k: int) -> int:
    w = H.FR_ROOT_OF_UNITY
    for _ in range(k, H.FR_S):
        w = w * w % P
    return w


def _group_ntt_jac(points: List, omega: int) -> List:
    """Radix-2 NTT over G1 points in Jacobian coords (host; no inversions).
    Same butterfly structure as the scalar NTT."""
    n = len(points)
    if n == 1:
        return list(points)
    w2 = omega * omega % P
    even = _group_ntt_jac(points[0::2], w2)
    odd = _group_ntt_jac(points[1::2], w2)
    out = [None] * n
    w = 1
    for i in range(n // 2):
        t = CH.jac_mul(odd[i], w)
        neg_t = (t[0], (-t[1]) % H.FQ_MOD, t[2])  # coords are in Fq, not Fr
        out[i] = CH.jac_add(even[i], t)
        out[i + n // 2] = CH.jac_add(even[i], neg_t)
        w = w * omega % P
    return out


def _group_ntt(points: List[CH.G1Affine], omega: int) -> List[CH.G1Affine]:
    jac = [CH.jac_from_affine(p) for p in points]
    return CH.jac_batch_to_affine(_group_ntt_jac(jac, omega))


def _group_ntt_any(points_jac: List, omega: int, k: int) -> List:
    """Group NTT dispatch: native C (OpenMP, windowed twiddle muls) when
    available, else the pure-Python recursion.  Points in/out Jacobian."""
    from ..native_loader import native_group_ntt
    n = 1 << k
    tw = [1] * max(n // 2, 1)
    for i in range(1, len(tw)):
        tw[i] = tw[i - 1] * omega % P
    res = native_group_ntt(points_jac, tw, k)
    if res is not None:
        return res
    return _group_ntt_jac(points_jac, omega)


def _np_twiddles(omega: int, n: int):
    from ..native_loader import _np_u64_limbs
    tw = [1] * max(n // 2, 1)
    for i in range(1, len(tw)):
        tw[i] = tw[i - 1] * omega % P
    return _np_u64_limbs(tw, 4)


# SRS-side NTT cache: B_hat depends only on the SRS, not the table, so one
# FK run per SRS pays it and every further table of that size reuses it.
# Held as a (2N, 12) uint64 canonical-Jacobian numpy buffer — the earlier
# Python-tuple form cost minutes of int<->limb conversion per table.
_srs_ntt_cache: dict = {}


def fk_all_quotient_commitments(table_coeffs: List[int], srs_g1: List[CH.G1Affine],
                                omega: int, out_scales: List[int] = None) -> List[CH.G1Affine]:
    """Feist-Khovratovich all-openings in O(N log N) group ops.

    q_i = [ (T(X) - T(w^i)) / (X - w^i) ]_1 = sum_{j=0}^{N-1} h_j * w^{ij}
    where h_j = sum_{m=j+1}^{N-1} t_m [x^{m-1-j}]_1.

    h is a correlation of the coefficient vector with the SRS powers,
    computed as a size-2N cyclic convolution using group NTTs, then the N
    outputs q_i are one more size-N group NTT of h.  The whole pipeline is
    numpy-buffer-resident on the native OpenMP kernels (g1_group_ntt /
    g1_batch_scalar_mul) when available — this turns the reference's
    "SHOULD BE DONE WITH FK METHOD" TODO (static_lookup.rs:107) into
    minutes for 2^16+ tables.  out_scales, when given, multiplies output i
    by out_scales[i] inside the same native pass (the w^i/N factor).
    """
    from ..native_loader import (_np_u64_limbs, native_batch_scalar_mul_np,
                                 native_group_ntt_np, np_jac_from_tuples,
                                 np_jac_to_tuples)

    n = len(table_coeffs)
    m2 = 2 * n
    k2 = m2.bit_length() - 1
    omega2 = _omega_for_k(k2)

    use_native = True
    cache_key = (n, srs_g1[1] if n > 1 else None)
    B_hat = _srs_ntt_cache.get(cache_key)
    if B_hat is None:
        # B_i = A_{-i mod 2N} with A_k = [x^k]_1 for 0 <= k <= N-2
        B = np.zeros((m2, 12), dtype=np.uint64)
        pts = np_jac_from_tuples(
            [(pt[0], pt[1], 1) for pt in srs_g1[: n - 1]])
        idx = (-np.arange(n - 1)) % m2
        B[idx] = pts
        if not native_group_ntt_np(B, _np_twiddles(omega2, m2), k2):
            use_native = False
        if use_native:
            _srs_ntt_cache[cache_key] = B

    if not use_native or B_hat is False:
        # pure-Python fallback (tiny tables / no toolchain)
        Bt = [CH.JAC_IDENTITY] * m2
        for kk in range(0, n - 1):
            Bt[(-kk) % m2] = CH.jac_from_affine(srs_g1[kk])
        t_pad = list(table_coeffs) + [0] * (m2 - n)
        t_hat = NTT.ntt_host(t_pad, omega2, P)
        m2_inv = pow(m2, P - 2, P)
        B_hat_t = _group_ntt_jac(Bt, omega2)
        prod = [CH.jac_mul(b, sc * m2_inv % P) for b, sc in zip(B_hat_t, t_hat)]
        conv = _group_ntt_jac(prod, pow(omega2, P - 2, P))
        h = [conv[(1 + j) % m2] for j in range(n)]
        q = _group_ntt_jac(h, omega)
        if out_scales is not None:
            q = [CH.jac_mul(pt, sc) for pt, sc in zip(q, out_scales)]
        return CH.jac_batch_to_affine(q)

    if B_hat is None:
        B_hat = _srs_ntt_cache[cache_key]

    t_pad = list(table_coeffs) + [0] * (m2 - n)
    t_hat = NTT.ntt_host(t_pad, omega2, P)
    m2_inv = pow(m2, P - 2, P)
    scales = _np_u64_limbs([sc * m2_inv % P for sc in t_hat], 4)
    prod = native_batch_scalar_mul_np(B_hat, scales)
    native_group_ntt_np(prod, _np_twiddles(pow(omega2, P - 2, P), m2), k2)
    h = np.ascontiguousarray(prod[(1 + np.arange(n)) % m2])
    native_group_ntt_np(h, _np_twiddles(omega, n), n.bit_length() - 1)
    if out_scales is not None:
        h = native_batch_scalar_mul_np(h, _np_u64_limbs(out_scales, 4))
    return CH.jac_batch_to_affine(np_jac_to_tuples(h))


# ---------------------------- the device route ------------------------------

def fk_device(size: int):
    """Where FK of a `size`-row column runs: the card for size >=
    DEVICE_MIN_ROWS when CUDA is present, else None (the host route).
    Tests put "cpu" here to run the device route's plain versions."""
    return "cuda" if size >= DEVICE_MIN_ROWS and torch.cuda.is_available() \
        else None


# B_hat on a device, the SRS side of FK: keyed by (N, the SRS's points
# [x]_1 and [x^{N-2}]_1, device), never by a table's values; a few sizes.
_device_srs_cache: dict = {}
_DEVICE_SRS_SIZES = 4


def _settle(device) -> None:
    """With the profiler on, wait for the card at a span's end, so that
    the span holds its device work (one host wait, counted)."""
    if profiler.enabled and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        profiler.count("host_syncs")


def _device_srs_ntt(srs_g1: List[CH.G1Affine], n: int, device):
    """B_hat = the group NTT of size 2N of B_i = [x^{-i mod 2N}]_1 (zero
    where -i mod 2N > N - 2) with omega_2N, on `device`, cached."""
    from ..native_loader import pack_points_affine
    key = (n, srs_g1[1], srs_g1[n - 2], D.device_key(device))
    hit = _device_srs_cache.get(key)
    if hit is not None:
        return hit
    with profiler.phase("cq_srs_ntt"):
        m2 = 2 * n
        packed = pack_points_affine(srs_g1[: n - 1])
        pts = CD.pack_affine(srs_g1[: n - 1], device) if packed is None \
            else CD.pack_affine(packed=packed, device=device)
        B = tuple(c.clone() for c in CD.identity_like((m2,), device))
        idx = torch.from_numpy((-np.arange(n - 1)) % m2).to(B[0].device)
        for c, v in zip(B, pts):
            c[:, idx] = v
        hit = CD.group_ntt(B, _omega_for_k(m2.bit_length() - 1))
        _settle(device)
    if len(_device_srs_cache) >= _DEVICE_SRS_SIZES:
        _device_srs_cache.pop(next(iter(_device_srs_cache)))
    _device_srs_cache[key] = hit
    return hit


@functools.lru_cache(maxsize=8)
def _out_scales(n: int, device: str):
    """(16, N) canonical limbs of w^i / N, the cached quotients' scales."""
    omega, n_inv = _omega_for_k(n.bit_length() - 1), pow(n, P - 2, P)
    scales, wi = [], n_inv
    for _ in range(n):
        scales.append(wi)
        wi = wi * omega % P
    return D.pack(scales, D.FR, mont=False, device=device)


def _pack_values(columns: List[List[int]], device):
    """(16, cols, N) Montgomery limbs of the columns' values (each below
    r).  Values below 2^64 go up as one word each and are cut into limbs
    and made Montgomery on the device (K1 on a card); others through
    D.pack."""
    flat = [v for col in columns for v in col]
    shape = (D.NLIMB, len(columns), len(columns[0]))
    try:
        words = np.array(flat, dtype=np.uint64)
    except OverflowError:
        return D.pack(flat, D.FR, device=device).reshape(shape)
    w = D.to_device(torch.from_numpy(words.view(np.int64)), device)
    limbs = w.view(torch.int16).reshape(-1, 4).t().to(D.LIMB) & D.MASK
    limbs = torch.cat([limbs, torch.zeros((D.NLIMB - 4, len(flat)),
                                          dtype=D.LIMB, device=w.device)])
    return D.to_mont(limbs, D.FR).reshape(shape)


def fk_cached_quotients(columns: List[List[int]], srs_g1: List[CH.G1Affine],
                        device) -> List[List[CH.G1Affine]]:
    """Each column's cached quotients qs[i] = [(T(X) - T(w^i)) / (X - w^i)
    * w^i / N]_1 by FK on `device`, the columns (values mod r, one length N,
    a power of two >= 4) in one batch: the tables' NTTs (K4), t_hat *
    B_hat / 2N (K7), the inverse group NTT of 2N (K8), h_j = conv[j + 1],
    the group NTT of N (K8), the scaling by w^i / N (K7), then affine and
    one read-back.  The same points as fk_all_quotient_commitments.  A CPU
    device runs the plain versions (tests).  Spans: cq_fk around it, and
    cq_srs_ntt (a B_hat fill), cq_table_ntt, cq_scalar_mul, cq_group_ntt,
    cq_readback inside."""
    n, cols = len(columns[0]), len(columns)
    k = n.bit_length() - 1
    m2 = 2 * n
    omega, omega2 = _omega_for_k(k), _omega_for_k(k + 1)
    with profiler.phase("cq_fk"):
        B_hat = _device_srs_ntt(srs_g1, n, device)
        with profiler.phase("cq_table_ntt"):
            vals = _pack_values(columns, device)
            coeffs = NTT.intt(vals, pow(omega, P - 2, P), k, pow(n, P - 2, P))
            t_hat = NTT.ntt(torch.cat([coeffs, torch.zeros_like(coeffs)], -1),
                            omega2, k + 1)
            # out of Montgomery form and by 1/2N in one product
            scal = D.mont_mul(t_hat, D.pack_scalar(
                pow(m2, P - 2, P), D.FR, mont=False,
                device=device).reshape(D.NLIMB, 1, 1), D.FR)
            _settle(device)
        with profiler.phase("cq_scalar_mul"):
            prod = CD.batch_scalar_mul(B_hat, scal)
            _settle(device)
        with profiler.phase("cq_group_ntt"):
            conv = CD.group_ntt(prod, pow(omega2, P - 2, P))
            idx = torch.from_numpy((1 + np.arange(n)) % m2).to(conv[0].device)
            q = CD.group_ntt(tuple(c.index_select(-1, idx) for c in conv),
                             omega)
            _settle(device)
        with profiler.phase("cq_scalar_mul"):
            q = CD.batch_scalar_mul(q, _out_scales(n, D.device_key(device)))
            _settle(device)
        with profiler.phase("cq_readback"):
            pts = CD.to_affine_host(q)
    return [pts[c * n:(c + 1) * n] for c in range(cols)]
