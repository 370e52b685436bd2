"""CQ static lookup argument prover + verifier.

Reference: plonk/static_lookup/{prover,verifier}.rs.  Proof cost per lookup:
7 G1 points (f, m, a, qa, a0, b0, p) + 3 scalars (b0(x), f(x), A(0)), plus
three pairing identities registered into the global PairingBatcher:
  (1) e(a,[T]_2) = e(qa,[Z_V]_2) * e(m - beta*a, [1]_2)
  (2) e(b0,[x^bound]_2) = e(p,[1]_2)
  (3) e(a - [A(0)]_1, [1]_2) = e(a0, [x]_2)

zk mode (cs.zk_static_lookups, off by default — the reference's CQ is
explicitly non-zk, prover.rs:122-124).  The committed functions are blinded
with multiples of the vanishing polynomials, so every identity above still
holds as a polynomial identity while the commitments/evals become
simulatable:

  table side (blinders r, c; V = table domain, Z_V = X^N - 1):
    A'  = A + r*Z_V          -> a'  = a  + r*[Z_V]_1
    M'  = M + c*Z_V          -> m'  = m  + c*[Z_V]_1
    Q'  = Q + r*(T~+beta)-c  -> qa' = qa + r*[T~]_1 + (r*beta-c)*[1]_1
    (A'-A'(0))/X             -> a0' = a0 + r*[x^{N-1}]_1
    A'(0) = A(0) - r         (Z_V(0) = -1)
  circuit side (H = proof domain, n rows, bf = blinding_factors()):
    B's (bf+1) inactive rows are RANDOM subject to sum = (bf+1)/beta - r*N,
    which keeps deg(B) <= n-1 (the b0 degree bound is untouched) and makes
    the existing sumcheck link n*B(0) = N*A(0)+(bf+1)/beta emit exactly the
    blinded A'(0).  The h gate term becomes l_active*(B*(f+beta)-1) — same
    degree as the reference's B*(l_active*f+beta)-1, identical on active
    rows, but imposing nothing on the blinding rows.

  [T~]_1 is the theta-compressed G1 commitment of the table polynomials
  (lazily one MSM per table, cached); [Z_V]_1/[x^{N-1}]_1 come from
  StaticTableConfig (requires the SRS's extra power [x^N]_1, TableSRS.g1_xn).

The port's own copy of sha2cq_tpu/plonk/static_lookup.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..curves import host as CH
from ..fields.host import FR_MOD, batch_inv, inv_mod
from ..ops import msm as M
from ..poly import arith as A
from ..poly.kzg.gwc import ProverQuery, VerifierQuery
from .evaluation import evaluate_expr_lagrange

P = FR_MOD

# ---- vectorized table-row resolution ---------------------------------------
# The reference resolves every circuit row's table index through a BTreeMap
# (static_lookup/prover.rs:132-161); at ~40 lookup arguments x 8k rows per
# SHA-256 proof that is millions of Python dict operations here.  Instead the
# (value tuple) -> row-index map is a sorted array of 64-bit limb hashes:
# rows resolve with one searchsorted + exact limb verification, and only
# hash-collision/missing rows (≈never) fall back to the dict.

_MIX = np.array([0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
                 0x165667B19E3779F9, 0x27D4EB2F165667C5], dtype=np.uint64)
_FINAL = np.uint64(0xFF51AFD7ED558CCD)
_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _limb_hash(buf: np.ndarray) -> np.ndarray:
    """(n, 4) u64 limb buffer -> (n,) u64 mixed hash (wraparound u64 math)."""
    with np.errstate(over="ignore"):
        h = buf[:, 0] * _MIX[0]
        for j in range(1, 4):
            h = h ^ (buf[:, j] * _MIX[j])
        h = h * _FINAL
        h = h ^ (h >> np.uint64(33))
    return h


def _table_limbs(table) -> np.ndarray:
    """Cached (N, 4) u64 limb array of a static table's values."""
    arr = table.__dict__.get("_values_np")
    if arr is None:
        from ..native_loader import fr_buf
        arr = table.__dict__["_values_np"] = fr_buf(table.values)
    return arr


def _joint_hash_index(pk, tables):
    """Cached (sorted joint hashes, argsort order) for a tuple of component
    tables; the joint hash Horner-combines per-table row hashes so the same
    value in different vector positions hashes differently."""
    cache = pk.__dict__.setdefault("_joint_np", {})
    key = tuple(id(t) for t in tables)
    ent = cache.get(key)
    if ent is None:
        jh = None
        with np.errstate(over="ignore"):
            for t in tables:
                rh = _limb_hash(_table_limbs(t))
                jh = rh if jh is None else jh * _GOLD + rh
        order = np.argsort(jh, kind="stable")
        ent = cache[key] = (jh[order], order)
    return ent


def _joint_dict(pk, tables) -> dict:
    """Exact (value tuple) -> row index map; fallback for hash collisions and
    for error reporting on missing rows.  Built once per table tuple."""
    cache = pk.__dict__.setdefault("_joint_maps", {})
    key = tuple(id(t) for t in tables)
    joint = cache.get(key)
    if joint is None:
        joint = {}
        for i in range(tables[0].size):
            joint[tuple(t.values[i] for t in tables)] = i
        cache[key] = joint
    return joint


def _resolve_rows(pk, arg, tables, eval_bufs, evaluated, usable_rows):
    """Row index of every usable circuit row in the (joint) table, via
    sorted-hash searchsorted + exact verification (SURVEY §7 stage 7:
    'value->index lookup as sorted-table searchsorted/gather').

    evaluated: the exact per-expression int lists, or a zero-arg callable
    producing them (only materialized for collision/missing-row fallback)."""
    jh_sorted, order = _joint_hash_index(pk, tables)
    jh = None
    with np.errstate(over="ignore"):
        for buf in eval_bufs:
            rh = _limb_hash(buf[:usable_rows])
            jh = rh if jh is None else jh * _GOLD + rh
    pos = np.searchsorted(jh_sorted, jh)
    np.clip(pos, 0, len(jh_sorted) - 1, out=pos)
    cand = order[pos]
    ok = jh_sorted[pos] == jh
    for t, buf in zip(tables, eval_bufs):
        ok &= (_table_limbs(t)[cand] == buf[:usable_rows]).all(axis=1)
    if not ok.all():
        joint = _joint_dict(pk, tables)
        if callable(evaluated):
            evaluated = evaluated()
        for r in np.nonzero(~ok)[0]:
            key = tuple(vals[int(r)] % P for vals in evaluated)
            index = joint.get(key)
            if index is None:
                raise ValueError(
                    f"{key} not a row of tables "
                    f"{[t.name for t in arg.table_ids]}")
            cand[int(r)] = index
    return cand


def static_lookup_commit(arg, pk, params, theta, challenges, advice, fixed,
                         instance, transcript, rng=None,
                         column_commitments: Optional[dict] = None) -> dict:
    """prover.rs:51-183: evaluate+compress inputs into f, count sparse
    multiplicities m, commit f and m (sparse over the table's Lagrange
    basis).

    column_commitments: optional {("advice"|"fixed", col_index): G1} map of
    the already-transcribed column commitments.  When every input expression
    is a plain rotation-0 column query, commit_lagrange is linear so
    [f]_1 = sum_t theta^{T-1-t} [col_t]_1 — a T-point fold instead of an
    n-point MSM per argument (the prover writes one such MSM per advice
    column anyway, prover.rs:299-391)."""
    tables = [pk.static_table_mapping[tid] for tid in arg.table_ids]
    assert all(t.size == tables[0].size for t in tables), \
        "Tables should all be of the same size"
    table_config = pk.static_table_configs[tables[0].size]

    from ..utils.profiling import profiler

    n = params.n
    with profiler.phase("eval_inputs"):
        evaluated = [
            evaluate_expr_lagrange(e, n, fixed, advice, instance, challenges)
            for e in arg.input_expressions
        ]
    from ..native_loader import fr_buf, fr_unbuf, get_lib, native_fr_fold_buf
    with profiler.phase("f_fold"):
        eval_bufs = [fr_buf([v % P for v in vals]) for vals in evaluated]
        if get_lib() is not None and n >= 1024:
            # theta-compression as native Horner folds over (n, 4) buffers
            acc = np.zeros((n, 4), dtype="<u8")
            for buf in eval_bufs:
                native_fr_fold_buf(acc, buf, theta)
            f = fr_unbuf(acc)
        else:
            f = [0] * n
            for vals in evaluated:
                f = [(a * theta + v) % P for a, v in zip(f, vals)]

    bf = pk.vk.cs.blinding_factors()
    usable_rows = n - (bf + 1)
    with profiler.phase("m_rows"):
        row_idx = _resolve_rows(pk, arg, tables, eval_bufs, evaluated,
                                usable_rows)
        counts_full = np.bincount(row_idx, minlength=tables[0].size)
        idxs = np.nonzero(counts_full)[0]
        counts = counts_full[idxs]

    zk = getattr(pk.vk.cs, "zk_static_lookups", False)
    zk_c = 0
    if zk:
        if getattr(table_config, "zv_g1", None) is None or rng is None:
            raise ValueError("zk static lookups need StaticTableConfig "
                             "zv_g1/xn1_g1 (TableSRS.g1_xn) and a prover rng")
        zk_c = rng.randrange(P)
    with profiler.phase("f_m_commits"):
        f_cm = None
        if column_commitments is not None:
            f_cm = _f_commit_linear(arg, theta, column_commitments)
        if f_cm is None:
            f_cm = params.commit_lagrange(f)
        m_cm = M.msm_indexed(
            counts.tolist(), idxs.tolist(), table_config.g1_lagrange,
            packed=M.packed_basis(table_config, "_g1l_packed",
                                  table_config.g1_lagrange))
        if zk:
            m_cm = CH.g1_add(m_cm, CH.g1_mul(table_config.zv_g1, zk_c))
    transcript.write_point(f_cm)
    transcript.write_point(m_cm)
    return {
        "f": f,
        "idxs": idxs,
        "counts": counts,
        "table_ids": arg.table_ids,
        "zk_c": zk_c,
        "zk_rng": rng,
    }


def _f_commit_linear(arg, theta, column_commitments) -> Optional[CH.G1Affine]:
    """[f]_1 as the theta-fold of already-computed column commitments; None
    when any input expression is not a plain rotation-0 column query."""
    cms = []
    for e in arg.input_expressions:
        if e.kind not in ("advice", "fixed") or e.rotation != 0:
            return None
        cm = column_commitments.get((e.kind, e.column.index))
        if cm is None:
            return None
        cms.append(cm)
    f_cm = cms[0]
    for cm in cms[1:]:
        f_cm = CH.g1_add(CH.g1_mul(f_cm, theta), cm)
    return f_cm


def static_lookup_commit_log_derivatives(committed: dict, pk, params, domain,
                                         beta, theta, transcript) -> dict:
    """prover.rs:187-343."""
    tables = [pk.static_table_mapping[tid] for tid in committed["table_ids"]]
    table_config = pk.static_table_configs[tables[0].size]

    # A_i = m_i / (T_i + beta) over the distinct touched indices; the three
    # sparse commitments are Pippenger MSMs (native), with the theta
    # compression of the per-table quotients moved OUTSIDE the point sum:
    #   qa = sum_i A_i (sum_t theta^{T-1-t} qs_t[i])
    #      = sum_t theta^{T-1-t} (sum_i A_i qs_t[i])
    from ..utils.profiling import profiler

    idxs_np = committed["idxs"]
    idxs = idxs_np.tolist()
    with profiler.phase("a_vals"):
        # T_i at the touched indices: theta-Horner over the gathered table
        # value columns (the resolved row's tuple IS the tables' row tuple)
        from ..native_loader import fr_unbuf, get_lib, native_fr_fold_buf
        if get_lib() is not None and len(tables) > 1:
            acc = _table_limbs(tables[0])[idxs_np].copy()
            for t in tables[1:]:
                native_fr_fold_buf(acc, _table_limbs(t)[idxs_np], theta)
            tvs = fr_unbuf(acc)
        else:
            tvs = [0] * len(idxs)
            for t in tables:
                vals = t.values
                tvs = [(tv * theta + vals[i]) % P for tv, i in zip(tvs, idxs)]
        denom_invs = batch_inv([(tv + beta) % P for tv in tvs], P)
        a_vals = [int(c) * dv % P
                  for c, dv in zip(committed["counts"], denom_invs)]
    zk = getattr(pk.vk.cs, "zk_static_lookups", False)
    zk_r = 0
    if zk:
        rng = committed["zk_rng"]
        zk_r = rng.randrange(P)
    with profiler.phase("a_commits"):
        a_cm = M.msm_indexed(
            a_vals, idxs, table_config.g1_lagrange,
            packed=M.packed_basis(table_config, "_g1l_packed",
                                  table_config.g1_lagrange))
        a0_cm = M.msm_indexed(
            a_vals, idxs, table_config.g_lagrange_opening_at_0,
            packed=M.packed_basis(table_config, "_g1l0_packed",
                                  table_config.g_lagrange_opening_at_0))
        qa_cm = None
        for table in tables:
            part = M.msm_indexed(
                a_vals, idxs, table.qs,
                packed=M.packed_basis(table, "_qs_packed", table.qs))
            qa_cm = CH.g1_add(CH.g1_mul(qa_cm, theta) if qa_cm else None, part)
        if zk:
            # a' = a + r[Z_V]; a0' = a0 + r[x^{N-1}];
            # qa' = qa + r[T~]_1 + (r*beta - c)[1]_1  (see module docstring)
            t1_bar = None
            for table in tables:
                t1 = getattr(table, "_t1_commit", None)
                if t1 is None:
                    t1 = M.msm(table.values, table_config.g1_lagrange,
                               packed=M.packed_basis(
                                   table_config, "_g1l_packed",
                                   table_config.g1_lagrange))
                    table._t1_commit = t1
                t1_bar = CH.g1_add(
                    CH.g1_mul(t1_bar, theta) if t1_bar else None, t1)
            a_cm = CH.g1_add(a_cm, CH.g1_mul(table_config.zv_g1, zk_r))
            a0_cm = CH.g1_add(a0_cm, CH.g1_mul(table_config.xn1_g1, zk_r))
            qa_cm = CH.g1_add(qa_cm, CH.g1_mul(t1_bar, zk_r))
            qa_cm = CH.g1_add(qa_cm, CH.g1_mul(
                CH.G1_GEN, (zk_r * beta - committed["zk_c"]) % P))

    bf = pk.vk.cs.blinding_factors()
    n = params.n
    usable_rows = n - (bf + 1)
    with profiler.phase("b_side"):
        beta_inv = inv_mod(beta, P)
        bs = batch_inv([(fi + beta) % P for fi in committed["f"][:usable_rows]], P)
        if zk:
            # random blinding rows constrained so the sumcheck link emits
            # the blinded A'(0) = A(0) - r: sum = (bf+1)/beta - r*N
            blind = [rng.randrange(P) for _ in range(bf)]
            total = ((bf + 1) * beta_inv - zk_r * tables[0].size) % P
            blind.append((total - sum(blind)) % P)
            bs += blind
        else:
            bs += [beta_inv] * (bf + 1)
        b_poly = domain.lagrange_to_coeff_host(bs)

    b0_coeffs = b_poly[1:]
    with profiler.phase("b0_p_commits"):
        p_cm = M.msm(b0_coeffs, pk.b0_g1_bound[: len(b0_coeffs)],
                     packed=M.packed_basis(pk, "_b0_bound_packed", pk.b0_g1_bound))
        b0_poly = b0_coeffs + [0]

        transcript.write_point(a_cm)
        transcript.write_point(qa_cm)
        transcript.write_point(a0_cm)
        b0_cm = params.commit(b0_poly)
        transcript.write_point(b0_cm)
        transcript.write_point(p_cm)

    # Sumcheck link: A(0) = (n * B(0) - (blinders+1) * beta^{-1}) / N
    b_at_zero = b_poly[0]
    n_table_inv = inv_mod(tables[0].size, P)
    a_at_zero = ((b_at_zero * n - (bf + 1) * beta_inv) % P) * n_table_inv % P

    with profiler.phase("f_ifft"):
        f_poly = domain.lagrange_to_coeff_host(committed["f"])
    return {"b": b_poly, "b0": b0_poly, "f": f_poly, "a_at_zero": a_at_zero}


# ---- sparse b0/p commitment bases ------------------------------------------
# B's Lagrange vector is 1/beta on every row where f is zero (inactive rows
# and the enforced blinding tail), so B = beta^{-1}*1 + sum_{i in support}
# corr_i * L_i with corr_i = B_i - beta^{-1} and support = {i : f_i != 0}.
# Since sum_i L_i = 1 and L_i(0) = 1/n, both degree-bound commitments become
# SUPPORT-sized MSMs over precomputed bases:
#   [b0]_1 = sum corr_i [(L_i(x) - 1/n)/x]_1
#   [p]_1  = sum corr_i [(L_i(x) - 1/n) x^{s-1}]_1      (s = bound shift)
# and each basis is one group-iNTT of an identity-padded power window:
# (L_i(X) - 1/n)/X = sum_{j>=1} c_ij X^{j-1} with c_ij the iDFT matrix whose
# j=0 column is exactly the subtracted 1/n — so feeding [O, W_1..W_{n-1}]
# to the group iNTT yields the basis with no extra SRS points.  This turns
# the prover's 2-per-lookup DENSE n-point MSMs (the largest share of the
# CQ phase) into ~active-row-count ones.

def _b0_sparse_bases(pk, params):
    """((b0_packed, b0_pts), (p_packed, p_pts)) or None when unavailable.
    Built once per (params/pk), disk-cached (a native group-iNTT each)."""
    cached = pk.__dict__.get("_b0_sparse_cache", False)
    if cached is not False:
        return cached
    from ..native_loader import get_lib
    res = None
    n = params.n
    if (get_lib() is not None and n >= 1024
            and len(pk.b0_g1_bound) >= n - 1):
        b0_pts = _opening_basis_from_window(params.g, n, "g")
        p_pts = _opening_basis_from_window(pk.b0_g1_bound, n, "bound")
        if b0_pts is not None and p_pts is not None:
            res = ((M.packed_basis(params, "_b0sparse_packed", b0_pts),
                    b0_pts),
                   (M.packed_basis(pk, "_psparse_packed", p_pts), p_pts))
    pk.__dict__["_b0_sparse_cache"] = res
    return res


def _opening_basis_from_window(window, n, tag):
    """group-iNTT (times n — the 1/n folds into the MSM scalars) of
    [identity, window[0], ..., window[n-2]]."""
    import hashlib
    import os
    import pickle

    from .static_tables import _group_ntt_any, _omega_for_k

    if len(window) < n - 1:
        return None
    key = hashlib.sha256(
        repr((tag, n, window[0], window[1], window[n - 2])).encode()
    ).hexdigest()[:20]
    cache_dir = os.path.expanduser(
        os.environ.get("SHA2CQ_CACHE", "~/.cache/sha2cq_jax"))
    path = os.path.join(cache_dir, f"openbasis_{key}.pkl")
    try:
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
    except Exception:
        pass
    k = n.bit_length() - 1
    omega_inv = inv_mod(_omega_for_k(k), P)
    jac = [CH.JAC_IDENTITY] + [CH.jac_from_affine(p) for p in window[: n - 1]]
    out = _group_ntt_any(jac, omega_inv, k)
    pts = CH.jac_batch_to_affine(out)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(pts, f, protocol=4)
        os.replace(tmp, path)
    except Exception:
        pass
    return pts


# ---- batched prover phases --------------------------------------------------
# The flagship SHA-256 circuit runs ~40 static lookup arguments per proof;
# per-argument native calls leave cores idle between commitments.  The *_all
# variants below produce byte-identical transcripts while batching across
# arguments: one concatenated batch inversion per side, one multi-NTT call
# for every B/f lagrange_to_coeff, and ONE g1_msm_multi over all sparse and
# dense commitment MSMs (VERDICT r3 item 1).

# native batched CQ phases engage at this circuit size (tests lower it
# to cover the batched/staged path at toy sizes)
BATCH_MIN_N = 1024

# group the sparse b0/p commitments by table row when the distinct-value
# count is below this fraction of the support (the grouping pass costs one
# mixed add per support row, the Pippenger it feeds shrinks to |distinct|);
# tests pin byte-equality by forcing it to 2.0 (always) / 0.0 (never)
GROUP_MAX_RATIO = 0.9


def static_lookup_commit_all(args, pk, params, theta, challenges, advice,
                             fixed, instance, transcript, rng=None,
                             column_commitments: Optional[dict] = None,
                             column_buffers: Optional[dict] = None
                             ) -> List[dict]:
    from ..native_loader import fr_buf, fr_unbuf, get_lib, native_fr_fold_buf
    from ..utils.profiling import profiler
    args = list(args)
    if not args:
        return []
    zk = getattr(pk.vk.cs, "zk_static_lookups", False)
    if zk or get_lib() is None or params.n < BATCH_MIN_N:
        # zk draws rng per argument interleaved with commits; keep the
        # audited per-argument path for it (and for tiny/no-native runs)
        return [static_lookup_commit(
                    arg, pk, params, theta, challenges, advice, fixed,
                    instance, transcript, rng=rng,
                    column_commitments=column_commitments)
                for arg in args]

    n = params.n
    bf = pk.vk.cs.blinding_factors()
    usable_rows = n - (bf + 1)
    results: List[dict] = []
    jobs = []        # interleaved [f_job?, m_job] per argument
    job_of = []      # (arg_index, kind)
    for a_i, arg in enumerate(args):
        tables = [pk.static_table_mapping[tid] for tid in arg.table_ids]
        assert all(t.size == tables[0].size for t in tables), \
            "Tables should all be of the same size"
        table_config = pk.static_table_configs[tables[0].size]
        with profiler.phase("f_fold"):
            # plain rotation-0 column queries reuse the witness-phase limb
            # buffers; anything else evaluates + packs per expression
            eval_bufs = []
            for e in arg.input_expressions:
                buf = None
                if (column_buffers is not None and e.rotation == 0
                        and e.kind in ("advice", "fixed")):
                    buf = column_buffers.get((e.kind, e.column.index))
                if buf is None:
                    vals = evaluate_expr_lagrange(e, n, fixed, advice,
                                                  instance, challenges)
                    buf = fr_buf([v % P for v in vals])
                eval_bufs.append(buf)
            acc = np.zeros((n, 4), dtype="<u8")
            for buf in eval_bufs:
                native_fr_fold_buf(acc, buf, theta)

        def evaluated():
            # exact int lists, only materialized for hash-collision /
            # missing-row fallback reporting in _resolve_rows
            return [evaluate_expr_lagrange(e, n, fixed, advice, instance,
                                           challenges)
                    for e in arg.input_expressions]

        with profiler.phase("m_rows"):
            row_idx = _resolve_rows(pk, arg, tables, eval_bufs, evaluated,
                                    usable_rows)
            counts_full = np.bincount(row_idx, minlength=tables[0].size)
            idxs = np.nonzero(counts_full)[0]
            counts = counts_full[idxs]
        f_cm = None
        if column_commitments is not None:
            f_cm = _f_commit_linear(arg, theta, column_commitments)
        if f_cm is None:
            jobs.append((M.packed_basis(params, "_g_lagrange_packed",
                                        params.g_lagrange),
                         None, acc, params.g_lagrange))
            job_of.append((a_i, "f"))
        counts_buf = np.zeros((len(counts), 4), dtype="<u8")
        counts_buf[:, 0] = counts
        jobs.append((M.packed_basis(table_config, "_g1l_packed",
                                    table_config.g1_lagrange),
                     idxs, counts_buf, table_config.g1_lagrange))
        job_of.append((a_i, "m"))
        results.append({
            "f_buf": acc,
            "f_cm": f_cm,
            "idxs": idxs,
            "counts": counts,
            # per-row table position: the log-derivative phase groups the
            # sparse b0/p commitments by it (equal value => equal scalar)
            "row_idx": row_idx,
            "table_ids": arg.table_ids,
            "zk_c": 0,
            "zk_rng": rng,
        })
    with profiler.phase("f_m_commits"):
        cms = M.msm_multi(jobs)
    for (a_i, kind), cm in zip(job_of, cms):
        results[a_i]["f_cm" if kind == "f" else "m_cm"] = cm
    for r in results:
        transcript.write_point(r["f_cm"])
        transcript.write_point(r.pop("m_cm"))
        r.pop("f_cm")
    with profiler.phase("f_coeffs"):
        # f's lagrange->coeff iNTT runs HERE (before beta) rather than in
        # the log-derivative phase: the coeff polys are an h-program input,
        # and converting them now lets the prover start their host->device
        # transfer ~two native phases earlier (prover.py h staging)
        from ..native_loader import native_fr_ntt_multi
        from ..ops.ntt import _host_twiddle_buf
        f_coeffs = [r["f_buf"].copy() for r in results]
        omega_inv = pow(_omega_for_n(n), P - 2, P)
        native_fr_ntt_multi(f_coeffs, _host_twiddle_buf(omega_inv, n, P),
                            n.bit_length() - 1, ninv=inv_mod(n, P))
        for r, fc in zip(results, f_coeffs):
            r["f_coeff"] = fc
    return results


def _omega_for_n(n: int) -> int:
    from .static_tables import _omega_for_k
    return _omega_for_k(n.bit_length() - 1)


def static_lookup_log_derivatives_all(committed_list, pk, params, domain,
                                      beta, theta, transcript) -> List[dict]:
    from ..native_loader import (fr_buf, fr_unbuf, get_lib,
                                 native_fr_fold_buf, native_fr_ntt_multi)
    from ..ops.ntt import _host_twiddle_buf
    from ..utils.profiling import profiler
    committed_list = list(committed_list)
    if not committed_list:
        return []
    zk = getattr(pk.vk.cs, "zk_static_lookups", False)
    if zk or get_lib() is None or params.n < BATCH_MIN_N:
        return [static_lookup_commit_log_derivatives(
                    c, pk, params, domain, beta, theta, transcript)
                for c in committed_list]

    n = params.n
    bf = pk.vk.cs.blinding_factors()
    usable_rows = n - (bf + 1)
    beta_inv = inv_mod(beta, P)

    # ---- A side: gathered T_i folds, ONE concatenated batch inversion,
    # counts*inverse as ONE elementwise native multiply — the whole side
    # stays (n,4) limb buffers (no bigint round trips; at k=15 the Python
    # per-element path cost ~2 s of the warm prove)
    with profiler.phase("a_vals"):
        from ..native_loader import (native_fr_batch_inv_buf,
                                     native_fr_vec_mul_buf)
        per_tables = []
        bufs = []
        split = [0]
        for c in committed_list:
            tables = [pk.static_table_mapping[tid] for tid in c["table_ids"]]
            idxs_np = c["idxs"]
            acc = _table_limbs(tables[0])[idxs_np].copy()
            for t in tables[1:]:
                native_fr_fold_buf(acc, _table_limbs(t)[idxs_np], theta)
            bufs.append(acc)
            split.append(split[-1] + acc.shape[0])
            per_tables.append(tables)
        cc_a = np.concatenate(bufs) if bufs else np.zeros((0, 4), "<u8")
        beta_tile = np.tile(fr_buf([beta]), (cc_a.shape[0], 1))
        native_fr_fold_buf(cc_a, beta_tile, 1)      # += beta
        native_fr_batch_inv_buf(cc_a)               # 1/(T+beta)

        # Grouped sparse b0/p prep: the per-row scalar (1/(f+beta)-1/beta)/n
        # depends only on the table row the witness row resolves to, so rows
        # sharing a value share a scalar.  Group the opening-basis points by
        # table row (CSR over argsorted row_idx) and run Pippenger over the
        # |distinct| per-group sums instead of |support| rows — the A side
        # above already computed 1/(T+beta) per distinct row, reused here.
        sparse_bases = _b0_sparse_bases(pk, params)
        grouped: List[Optional[tuple]] = [None] * len(committed_list)
        # the grouped kernel is native-only, so also require both PACKED
        # buffers (pack_points_affine refuses a basis containing the
        # identity — astronomically unlikely but possible); the row-sparse
        # path below degrades gracefully through msm_multi's host fallback
        if (sparse_bases is not None
                and sparse_bases[0][0] is not None
                and sparse_bases[1][0] is not None):
            from ..native_loader import native_fr_scale_buf
            n_inv_g = inv_mod(n, P)
            minus_binv_g = fr_buf([(P - beta_inv) % P])
            for i, c in enumerate(committed_list):
                ri = c.get("row_idx")
                if ri is None:
                    continue
                m_keep = bufs[i].any(axis=1)   # folded T != 0 <=> f != 0
                counts = c["counts"]
                support = int(counts[m_keep].sum())
                s_dist = int(m_keep.sum())
                if support and s_dist > GROUP_MAX_RATIO * support:
                    continue        # few repeated values: row path is tighter
                order = np.argsort(ri, kind="stable").astype(np.int64)
                if m_keep.all():
                    kept = counts
                else:
                    order = order[np.repeat(m_keep, counts)]
                    kept = counts[m_keep]
                starts = np.zeros(len(kept) + 1, dtype=np.int64)
                np.cumsum(kept, out=starts[1:])
                sc = cc_a[split[i]:split[i + 1]][m_keep]   # copies
                tile = np.tile(minus_binv_g, (sc.shape[0], 1))
                native_fr_fold_buf(sc, tile, 1)   # B - 1/beta
                native_fr_scale_buf(sc, n_inv_g)  # * 1/n
                grouped[i] = (order, starts, sc)

        counts_cat = np.zeros((cc_a.shape[0], 4), dtype="<u8")
        counts_cat[:, 0] = np.concatenate(
            [c["counts"] for c in committed_list]) if committed_list else 0
        native_fr_vec_mul_buf(cc_a, counts_cat)     # m_i/(T_i+beta)
        a_vals_per = [cc_a[split[i]:split[i + 1]]
                      for i in range(len(committed_list))]

    # ---- B side: buffer-resident all the way — ONE concatenated (f+beta)
    # inversion, ONE multi-iNTT; the resulting coeff polys stay (n, 4) limb
    # buffers for the MSM jobs / x-evals / multiopen folds downstream
    with profiler.phase("b_side"):
        from ..native_loader import native_fr_batch_inv_buf
        # per-argument support (rows with f != 0) for the sparse b0/p
        # commitments, read before f_buf is consumed; grouped args resolved
        # their support in the a_vals phase
        supports = [None if grouped[i] is not None else
                    np.nonzero(c["f_buf"][:usable_rows].any(axis=1))[0]
                    for i, c in enumerate(committed_list)]
        cc = np.concatenate([c["f_buf"][:usable_rows] for c in committed_list])
        beta_tile = np.tile(fr_buf([beta]), (cc.shape[0], 1))
        native_fr_fold_buf(cc, beta_tile, 1)          # cc = f + beta
        native_fr_batch_inv_buf(cc)
        # corr_i = (B_i - 1/beta)/n over the support rows (the 1/n that the
        # un-normalized group-iNTT bases fold into the scalars)
        corr_per = None
        if sparse_bases is not None:
            from ..native_loader import native_fr_scale_buf
            n_inv = inv_mod(n, P)
            minus_binv = fr_buf([(P - beta_inv) % P])
            corr_per = []
            for i, sup in enumerate(supports):
                if sup is None:
                    corr_per.append(None)
                    continue
                rows = cc[i * usable_rows + sup]     # fancy index -> copy
                tile = np.tile(minus_binv, (rows.shape[0], 1))
                native_fr_fold_buf(rows, tile, 1)    # B_i - 1/beta
                native_fr_scale_buf(rows, n_inv)     # * 1/n
                corr_per.append(rows)

        omega_inv = pow(domain.omega, P - 2, P)
        tw_inv = _host_twiddle_buf(omega_inv, n, P)
        n_inv = inv_mod(n, P)
        tail = np.tile(fr_buf([beta_inv]), (bf + 1, 1))
        b_bufs = [np.concatenate([cc[i * usable_rows:(i + 1) * usable_rows],
                                  tail])
                  for i in range(len(committed_list))]
        # f coeffs were produced in the commit phase (so their device
        # transfer could start early); NTT only the beta-dependent b side
        late_f = [c["f_buf"] for c in committed_list
                  if "f_coeff" not in c]     # fallback: convert in place
        native_fr_ntt_multi(b_bufs + late_f, tw_inv, domain.k, ninv=n_inv)
        b_polys = b_bufs
        f_polys = [c.get("f_coeff", c["f_buf"]) for c in committed_list]

    # ---- every commitment MSM of the phase in ONE native call
    with profiler.phase("cq_msms"):
        jobs = []
        job_of = []
        gjobs = []      # grouped sparse b0/p jobs (see a_vals phase)
        gjob_of = []
        g_packed = M.packed_basis(params, "_g_packed", params.g)
        bound_packed = M.packed_basis(pk, "_b0_bound_packed", pk.b0_g1_bound)
        for i, c in enumerate(committed_list):
            tables = per_tables[i]
            table_config = pk.static_table_configs[tables[0].size]
            idxs = c["idxs"]                      # int64 array: pointer-passed
            a_vals = a_vals_per[i]                # (s,4) limb buffer
            jobs.append((M.packed_basis(table_config, "_g1l_packed",
                                        table_config.g1_lagrange),
                         idxs, a_vals, table_config.g1_lagrange))
            job_of.append((i, "a"))
            jobs.append((M.packed_basis(table_config, "_g1l0_packed",
                                        table_config.g_lagrange_opening_at_0),
                         idxs, a_vals, table_config.g_lagrange_opening_at_0))
            job_of.append((i, "a0"))
            for t_i, table in enumerate(tables):
                jobs.append((M.packed_basis(table, "_qs_packed", table.qs),
                             idxs, a_vals, table.qs))
                job_of.append((i, ("qa", t_i)))
            if grouped[i] is not None:
                rows_i, starts_i, sc_i = grouped[i]
                (b0p, _b0pts), (pp, _ppts) = sparse_bases
                gjobs.append((b0p, rows_i, starts_i, sc_i))
                gjob_of.append((i, "b0"))
                gjobs.append((pp, rows_i, starts_i, sc_i))
                gjob_of.append((i, "p"))
            elif corr_per is not None and len(supports[i]):
                sup = supports[i]
                (b0p, b0pts), (pp, ppts) = sparse_bases
                jobs.append((b0p, sup, corr_per[i], b0pts))
                job_of.append((i, "b0"))
                jobs.append((pp, sup, corr_per[i], ppts))
                job_of.append((i, "p"))
            else:
                b0_coeffs = b_polys[i][1:]   # (n-1, 4) contiguous view
                jobs.append((g_packed, None, b0_coeffs, params.g))
                job_of.append((i, "b0"))
                jobs.append((bound_packed, None, b0_coeffs,
                             pk.b0_g1_bound[: b0_coeffs.shape[0]]))
                job_of.append((i, "p"))
        # workload decomposition counters (BASELINE round-5: the phase is
        # A-side-dominated — a/qa/a0 are |distinct|-sized by construction,
        # so the grouped redesign only shrinks the b0/p share)
        profiler.count("cq_pts_indexed",
                       sum(len(j[2]) for j in jobs))
        profiler.count("cq_pts_grouped_rows",
                       sum(len(j[1]) for j in gjobs))
        profiler.count("cq_pts_grouped_groups",
                       sum(len(j[2]) - 1 for j in gjobs))
        if gjobs:
            # one native call, one OpenMP region: grouped b0/p jobs fill
            # the tail-idle cores of the indexed batch
            with profiler.phase("native_call"):
                cms = M.msm_combined(jobs, gjobs)
            job_of = job_of + gjob_of
        else:
            with profiler.phase("native_call"):
                cms = M.msm_multi(jobs)

    out: List[dict] = []
    by_arg: List[dict] = [dict() for _ in committed_list]
    for (i, kind), cm in zip(job_of, cms):
        if isinstance(kind, tuple):
            by_arg[i].setdefault("qa_parts", {})[kind[1]] = cm
        else:
            by_arg[i][kind] = cm
    n_table_inv_cache: Dict[int, int] = {}
    for i, c in enumerate(committed_list):
        got = by_arg[i]
        qa_cm = None
        for t_i in range(len(per_tables[i])):
            part = got["qa_parts"][t_i]
            qa_cm = CH.g1_add(CH.g1_mul(qa_cm, theta) if qa_cm else None,
                              part)
        transcript.write_point(got["a"])
        transcript.write_point(qa_cm)
        transcript.write_point(got["a0"])
        transcript.write_point(got["b0"])
        transcript.write_point(got["p"])
        b_buf = b_polys[i]
        size = per_tables[i][0].size
        n_t_inv = n_table_inv_cache.get(size)
        if n_t_inv is None:
            n_t_inv = n_table_inv_cache[size] = inv_mod(size, P)
        b_at_zero = int.from_bytes(b_buf[0].tobytes(), "little")
        a_at_zero = ((b_at_zero * n - (bf + 1) * beta_inv) % P) * n_t_inv % P
        # "b"/"f" stay limb buffers; "b0"'s Horner eval is unchanged by the
        # trailing zero the list form carried
        out.append({"b": b_buf, "b0": b_buf[1:], "f": f_polys[i],
                    "a_at_zero": a_at_zero})
    return out


def static_lookup_evaluate(constructed: dict, x: int, transcript) -> dict:
    b0_eval = A.eval_polynomial(constructed["b0"], x)
    f_eval = A.eval_polynomial(constructed["f"], x)
    transcript.write_scalar(b0_eval)
    transcript.write_scalar(f_eval)
    transcript.write_scalar(constructed["a_at_zero"])
    return constructed


def static_lookup_open(constructed: dict, x: int) -> List[ProverQuery]:
    return [
        ProverQuery(x, constructed["b0"]),
        ProverQuery(x, constructed["f"]),
    ]


# ------------------------------- verifier -----------------------------------

def static_lookup_read_committed(arg, transcript) -> dict:
    return {
        "f": transcript.read_point(),
        "m": transcript.read_point(),
        "table_ids": arg.table_ids,
    }


def static_lookup_read_log_derivative(committed: dict, transcript) -> dict:
    return {
        **committed,
        "a": transcript.read_point(),
        "qa": transcript.read_point(),
        "a0": transcript.read_point(),
        "b0": transcript.read_point(),
        "p": transcript.read_point(),
    }


def static_lookup_verifier_evaluate(committed: dict, transcript) -> dict:
    return {
        **committed,
        "b0_eval": transcript.read_scalar(),
        "f_eval": transcript.read_scalar(),
        "a_at_zero": transcript.read_scalar(),
    }


def static_lookup_register_pairings(ev: dict, vk, params, batcher, beta, theta) -> None:
    """verifier.rs:117-180: the three pairing identities, one add_pairing.

    The theta compression of the table commitments happens on the G1 side:
    e(a, sum_t theta^i [T_t]_2) = prod_t e(theta^i a, T_t), so each table
    contributes a cheap native G1 mul instead of a per-lookup G2 MSM (14
    G2 MSMs were ~50% of k=7 SHA verify), and the batcher merges the pairs
    of lookups that share a component table into one Miller-loop term."""
    tables = [vk.static_table_mapping[tid] for tid in ev["table_ids"]]
    # m - beta * a
    m_minus_beta_a = CH.g1_add(ev["m"], CH.g1_neg(CH.g1_mul(ev["a"], beta)))
    a_at_zero_cm = CH.g1_mul(CH.G1_GEN, ev["a_at_zero"])
    table_pairs = []
    for i, table in enumerate(tables):
        th = pow(theta, len(tables) - 1 - i, FR_MOD)
        table_pairs.append((CH.g1_mul(ev["a"], th), table.t))
    batcher.add_pairing(table_pairs + [
        (CH.g1_neg(ev["qa"]), tables[0].zv),
        (CH.g1_neg(m_minus_beta_a), params.g2),
        (ev["b0"], tables[0].x_b0_bound),
        (CH.g1_neg(ev["p"]), params.g2),
        (CH.g1_add(ev["a"], CH.g1_neg(a_at_zero_cm)), params.g2),
        (CH.g1_neg(ev["a0"]), params.s_g2),
    ])


def static_lookup_expressions(ev: dict, vk, l_last, l_blind, beta, x) -> List[int]:
    """verifier.rs:182-221: contribute B(x)(l_active f(x) + beta) - 1; in zk
    mode l_active(B(x)(f(x) + beta) - 1) (identical on active rows, nothing
    imposed on B's blinding rows — see module docstring)."""
    active_rows = (1 - (l_last + l_blind)) % P
    tables = [vk.static_table_mapping[tid] for tid in ev["table_ids"]]
    # NOTE: reference uses the SRS g1 length stored in committed table `size`;
    # the actual table row count equals the g1 length of its SRS.
    table_size = tables[0].size
    bf = vk.cs.blinding_factors()
    beta_inv = inv_mod(beta, P)
    n_inv = inv_mod(vk.domain.n, P)
    b_at_zero = ((table_size * ev["a_at_zero"] + (bf + 1) * beta_inv) % P) * n_inv % P
    b_eval = (ev["b0_eval"] * x + b_at_zero) % P
    if getattr(vk.cs, "zk_static_lookups", False):
        return [active_rows * (b_eval * ((ev["f_eval"] + beta) % P) - 1) % P]
    return [(b_eval * ((active_rows * ev["f_eval"] + beta) % P) - 1) % P]


def static_lookup_queries(ev: dict, x: int) -> List[VerifierQuery]:
    return [
        VerifierQuery(x, ev["b0"], ev["b0_eval"]),
        VerifierQuery(x, ev["f"], ev["f_eval"]),
    ]
