"""A plain verifier of PLONK proofs with CQ static lookups and GWC
multi-openings over BN254, for an SRS whose secret s is known.

It judges a proof by what the proof says: the transcript is replayed with
Blake2b, every gate, permutation and lookup expression is evaluated at the
challenge x from the proof's own evaluations, the quotient identity
h(x) (x^n - 1) = sum_i y^i e_i(x) is checked, and every KZG opening and every
CQ pairing identity is checked in G1 with s in place of the pairing: a
pairing check e(A, [s]_2) = e(B, [1]_2) holds exactly when s A = B.  All the
G1 equations are folded into one multi-scalar multiplication with weights
from a hash of the proof, which is zero for a sound proof and, for a
proof that breaks any one equation, zero only with negligible chance.

Its input is a `key`: plain lists and integers stating the circuit (gate
expressions as nested lists, queries, permutation columns, lookups and
their tables' values), the fixed and permutation columns' values on the
domain, the verifying key's transcript hash and its commitments, and the
SRS secret.  The verifier derives every commitment it needs from s and
those values itself, and checks the key's own commitments against them
(`prepare`).  It imports nothing of the program under test.

Expression nodes: ["const", v], ["fixed" | "advice" | "instance", query
index], ["challenge", index], ["neg", a], ["sum", a, b], ["prod", a, b],
["scaled", a, v].
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

from . import bn254 as C

R = C.R


class Reject(Exception):
    """The proof is not valid; the message says which check it failed."""


# ---- transcript -------------------------------------------------------------

class Transcript:
    """Blake2b-512 Fiat-Shamir transcript, personalization
    "Halo2-Transcript": prefix 0 squeezes, 1 absorbs a point as x||y (32
    bytes little-endian each, the identity as (0, 0)), 2 a scalar (32 bytes
    little-endian).  A challenge is the 64-byte digest mod r."""

    def __init__(self, proof: bytes):
        self.h = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")
        self.proof = proof
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.proof):
            raise Reject("the proof ends early")
        out = self.proof[self.pos:self.pos + n]
        self.pos += n
        return out

    def common_scalar(self, v: int) -> None:
        self.h.update(b"\x02" + (v % R).to_bytes(32, "little"))

    def common_point(self, p) -> None:
        x, y = p if p is not None else (0, 0)
        self.h.update(b"\x01" + x.to_bytes(32, "little") + y.to_bytes(32, "little"))

    def point(self):
        try:
            p = C.decompress(self._take(32))
        except ValueError as e:
            raise Reject(f"bad point at byte {self.pos - 32}: {e}")
        self.common_point(p)
        return p

    def points(self, n: int) -> list:
        return [self.point() for _ in range(n)]

    def scalar(self) -> int:
        v = int.from_bytes(self._take(32), "little")
        if v >= R:
            raise Reject(f"non-canonical scalar at byte {self.pos - 32}")
        self.common_scalar(v)
        return v

    def scalars(self, n: int) -> List[int]:
        return [self.scalar() for _ in range(n)]

    def challenge(self) -> int:
        self.h.update(b"\x00")
        return int.from_bytes(self.h.copy().digest(), "little") % R


# ---- the key, prepared ------------------------------------------------------

def lagrange_at(s: int, n: int) -> List[int]:
    """L_j(s) for the n-th roots of unity: w^j (s^n - 1) / (n (s - w^j))."""
    w = C.root_of_unity(n.bit_length() - 1)
    pows = [1] * n
    for j in range(1, n):
        pows[j] = pows[j - 1] * w % R
    common = (pow(s, n, R) - 1) * C.inv(n) % R
    invs = C.batch_inv([(s - p) % R for p in pows])
    return [common * p % R * i % R for p, i in zip(pows, invs)]


def dot(values: Sequence[int], basis: Sequence[int]) -> int:
    return sum(v * b for v, b in zip(values, basis)) % R


def blinding_factors(key: dict) -> int:
    return max(3, max(key["num_advice_queries"], default=1), 1) + 2


def prepare(key: dict) -> dict:
    """The scalars the checks use in place of commitments: f(s) for every
    fixed column, sigma(s) for every permutation column, and T(s) with the
    size of every table; raises ValueError where the key's own commitments
    are not the commitments of its values under s."""
    s, n = key["secret"] % R, key["n"]
    basis = lagrange_at(s, n)
    fixed = [dot(col, basis) for col in key["fixed_values"]]
    sigma = [dot(col, basis) for col in key["sigma_values"]]
    for name, scalars, commits in (
            ("fixed", fixed, key["fixed_commitments"]),
            ("permutation", sigma, key["permutation_commitments"])):
        if len(scalars) != len(commits):
            raise ValueError(f"{name}: {len(scalars)} columns, "
                             f"{len(commits)} commitments")
        for i, (v, cm) in enumerate(zip(scalars, commits)):
            if C.mul(C.G1, v) != (tuple(cm) if cm is not None else None):
                raise ValueError(f"the key's {name} commitment {i} is not "
                                 "the commitment of its column")
    bases: Dict[int, List[int]] = {}
    tables = {}
    for name, values in key["tables"].items():
        size = len(values)
        if size not in bases:
            bases[size] = lagrange_at(s, size)
        tables[name] = (dot(values, bases[size]), size)
    return {"fixed": fixed, "sigma": sigma, "tables": tables,
            "bf": blinding_factors(key), "omega": C.root_of_unity(key["k"])}


# ---- the verifier -----------------------------------------------------------

def evaluate(node, fixed, advice, instance, challenges) -> int:
    kind = node[0]
    if kind == "const":
        return node[1] % R
    if kind == "fixed":
        return fixed[node[1]]
    if kind == "advice":
        return advice[node[1]]
    if kind == "instance":
        return instance[node[1]]
    if kind == "challenge":
        return challenges[node[1]]
    if kind == "neg":
        return -evaluate(node[1], fixed, advice, instance, challenges) % R
    if kind == "scaled":
        return evaluate(node[1], fixed, advice, instance, challenges) * node[2] % R
    a = evaluate(node[1], fixed, advice, instance, challenges)
    b = evaluate(node[2], fixed, advice, instance, challenges)
    if kind == "sum":
        return (a + b) % R
    if kind == "prod":
        return a * b % R
    raise ValueError(f"unknown expression node {kind!r}")


def verify(key: dict, prep: dict, instance: Sequence[Sequence[int]],
           proof: bytes) -> None:
    """Raises Reject unless `proof` is a valid proof of one circuit with the
    instance columns `instance` under `key` (prepared by `prepare`)."""
    n, s = key["n"], key["secret"] % R
    omega = prep["omega"]
    omega_inv = C.inv(omega)
    bf = prep["bf"]
    chunk = key["cs_degree"] - 2
    perm_cols = key["permutation_columns"]
    nsets = -(-len(perm_cols) // chunk) if perm_cols else 0
    if key["lookups"]:
        raise ValueError("the plain verifier has no dynamic lookups")
    if len(instance) != key["num_instance"]:
        raise Reject("wrong number of instance columns")

    def rot(v: int, r: int) -> int:
        return v * pow(omega if r >= 0 else omega_inv, abs(r), R) % R

    def l_range(x: int, xn: int, rots) -> List[int]:
        invs = C.batch_inv([(x - rot(1, r)) % R for r in rots])
        common = (xn - 1) * C.inv(n) % R
        return [rot(i * common % R, r) for r, i in zip(rots, invs)]

    t = Transcript(proof)
    t.common_scalar(key["transcript_repr"])
    for col in instance:
        for v in col:
            t.common_scalar(v)

    advice_cm = [None] * key["num_advice"]
    challenges = [0] * len(key["challenge_phase"])
    for phase in sorted(set([0] + key["advice_phase"])):
        for i, ph in enumerate(key["advice_phase"]):
            if ph == phase:
                advice_cm[i] = t.point()
        for i, ph in enumerate(key["challenge_phase"]):
            if ph == phase:
                challenges[i] = t.challenge()
    theta = t.challenge()
    cq = [{"f": t.point(), "m": t.point()} for _ in key["static_lookups"]]
    beta = t.challenge()
    gamma = t.challenge()
    perm_cm = t.points(nsets)
    for arg in cq:
        for name in ("a", "qa", "a0", "b0", "p"):
            arg[name] = t.point()
    random_cm = t.point()
    y = t.challenge()
    h_cm = t.points(key["quotient_pieces"])
    x = t.challenge()
    xn = pow(x, n, R)

    # instance evaluations, by Lagrange interpolation of the columns
    rots = [r for _, r in key["instance_queries"]]
    max_rot, min_rot = max([0] + rots), min([0] + rots)
    longest = max((len(c) for c in instance), default=0)
    ls = l_range(x, xn, list(range(-max_rot, longest + abs(min_rot))))
    instance_evals = []
    for col, r in key["instance_queries"]:
        off = max_rot - r
        instance_evals.append(sum(v * l for v, l in zip(
            instance[col], ls[off:off + len(instance[col])])) % R)

    advice_evals = t.scalars(len(key["advice_queries"]))
    fixed_evals = t.scalars(len(key["fixed_queries"]))
    random_eval = t.scalar()
    sigma_evals = t.scalars(len(perm_cols))
    sets = []
    for i in range(nsets):
        ev, nxt = t.scalar(), t.scalar()
        sets.append((ev, nxt, t.scalar() if i < nsets - 1 else None))
    for arg in cq:
        arg["b0_eval"], arg["f_eval"], arg["a0_at_zero"] = t.scalars(3)

    # ---- the quotient identity at x
    l_ev = l_range(x, xn, list(range(-(bf + 1), 1)))
    l_last, l_blind, l_0 = l_ev[0], sum(l_ev[1:1 + bf]) % R, l_ev[1 + bf]
    active = (1 - l_last - l_blind) % R
    exprs = [evaluate(g, fixed_evals, advice_evals, instance_evals, challenges)
             for g in key["gates"]]
    query_of = {}
    for kind, queries in (("advice", key["advice_queries"]),
                          ("fixed", key["fixed_queries"]),
                          ("instance", key["instance_queries"])):
        for qi, (col, r) in enumerate(queries):
            query_of.setdefault((kind, col, r), qi)
    evals_of = {"advice": advice_evals, "fixed": fixed_evals,
                "instance": instance_evals}
    if sets:
        exprs.append(l_0 * (1 - sets[0][0]) % R)
        exprs.append((sets[-1][0] * sets[-1][0] - sets[-1][0]) * l_last % R)
        for i in range(1, nsets):
            exprs.append((sets[i][0] - sets[i - 1][2]) * l_0 % R)
        dlt = C.delta()
        for ci, start in enumerate(range(0, len(perm_cols), chunk)):
            cols = perm_cols[start:start + chunk]
            ev, nxt, _ = sets[ci]
            left, right = nxt, ev
            cur = beta * x % R * pow(dlt, start, R) % R
            for (kind, col), sig in zip(cols, sigma_evals[start:start + chunk]):
                v = evals_of[kind][query_of[(kind, col, 0)]]
                left = left * ((v + beta * sig + gamma) % R) % R
                right = right * ((v + cur + gamma) % R) % R
                cur = cur * dlt % R
            exprs.append((left - right) * active % R)
    beta_inv, n_inv = C.inv(beta), C.inv(n)
    for arg, lk in zip(cq, key["static_lookups"]):
        size = prep["tables"][lk[0]][1]
        b_zero = (size * arg["a0_at_zero"] + (bf + 1) * beta_inv) % R * n_inv % R
        b_eval = (arg["b0_eval"] * x + b_zero) % R
        if key["zk_static_lookups"]:
            exprs.append(active * (b_eval * (arg["f_eval"] + beta) - 1) % R)
        else:
            exprs.append((b_eval * (active * arg["f_eval"] + beta) - 1) % R)
    h_eval = 0
    for e in exprs:
        h_eval = (h_eval * y + e) % R
    if xn == 1:
        raise Reject("x is a root of unity")
    h_eval = h_eval * C.inv(xn - 1) % R

    # ---- the openings: (point, [(scalar, G1 point) | (scalar, None = G)], eval)
    def commit(cm):
        return [(1, cm)]

    queries: List[Tuple[int, list, int]] = []
    for qi, (col, r) in enumerate(key["advice_queries"]):
        queries.append((rot(x, r), commit(advice_cm[col]), advice_evals[qi]))
    for i, (ev, nxt, last) in enumerate(sets):
        queries.append((x, commit(perm_cm[i]), ev))
        queries.append((rot(x, 1), commit(perm_cm[i]), nxt))
    for i, (ev, nxt, last) in enumerate(sets[:-1]):
        queries.append((rot(x, -(bf + 1)), commit(perm_cm[i]), last))
    for arg in cq:
        queries.append((x, commit(arg["b0"]), arg["b0_eval"]))
        queries.append((x, commit(arg["f"]), arg["f_eval"]))
    for qi, (col, r) in enumerate(key["fixed_queries"]):
        queries.append((rot(x, r), [(prep["fixed"][col], "G")], fixed_evals[qi]))
    for sig, ev in zip(prep["sigma"], sigma_evals):
        queries.append((x, [(sig, "G")], ev))
    h_terms = [(pow(xn, i, R), cm) for i, cm in enumerate(h_cm)]
    queries.append((x, h_terms, h_eval))
    queries.append((x, commit(random_cm), random_eval))

    groups: List[Tuple[int, list]] = []
    for q in queries:
        for g in groups:
            if g[0] == q[0]:
                g[1].append(q)
                break
        else:
            groups.append((q[0], [q]))
    v = t.challenge()
    w = t.points(len(groups))
    u = t.challenge()
    if t.pos != len(proof):
        raise Reject(f"{len(proof) - t.pos} bytes after the last opening")

    # s * sum_i u^i W_i == sum_i u^i (z_i W_i + sum_j v^j C_ij - sum_j v^j e_ij G)
    # as one weighted sum that must vanish, with the CQ identities beside it
    seed = hashlib.blake2b(proof, digest_size=32, person=b"cardbench-fold").digest()
    rho = [int.from_bytes(hashlib.blake2b(seed + i.to_bytes(4, "little"),
                                          digest_size=32).digest(), "little") % R
           for i in range(3 * len(cq) + 1)]
    terms: Dict[object, int] = {}

    def add(point, k: int) -> None:
        if point is not None:           # the identity adds nothing
            terms[point] = (terms.get(point, 0) + k) % R

    wt = rho[-1]
    pu = 1
    for (z, qs), wi in zip(groups, w):
        add(wi, wt * pu % R * (s - z))
        pv = 1
        for _, cms, ev in qs:
            for k, pt in cms:
                add(pt, -wt * pu % R * pv % R * k)
            add("G", wt * pu % R * pv % R * ev)
            pv = pv * v % R
        pu = pu * u % R
    # CQ, per argument: T(s) a - Z_V(s) qa - (m - beta a) = 0,
    # s^bound b0 - p = 0 and a - A(0) G - s a0 = 0
    bound = pow(s, key["srs_len"] - 1 - (n - 2), R)
    for i, (arg, lk) in enumerate(zip(cq, key["static_lookups"])):
        r1, r2, r3 = rho[3 * i:3 * i + 3]
        tsum = 0
        for j, name in enumerate(lk):
            tsum = (tsum + pow(theta, len(lk) - 1 - j, R) * prep["tables"][name][0]) % R
        zv = (pow(s, prep["tables"][lk[0]][1], R) - 1) % R
        add(arg["a"], r1 * (tsum + beta))
        add(arg["qa"], -r1 * zv)
        add(arg["m"], -r1)
        add(arg["b0"], r2 * bound)
        add(arg["p"], -r2)
        add(arg["a"], r3)
        add("G", -r3 * arg["a0_at_zero"])
        add(arg["a0"], -r3 * s)
    g = terms.pop("G", 0)
    total = C.msm([(k, p) for p, k in terms.items()] + [(g, C.G1)])
    if total is not None:
        raise Reject("an opening or a lookup identity does not hold")
