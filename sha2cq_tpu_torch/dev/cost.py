"""CircuitCost: live proof-cost model.

The reference ships a cost model (dev/cost.rs) that is dead code — written
for the pre-fork API and not compiled (SURVEY.md §2.2).  This one is wired
to the current protocol and counts exactly what create_proof/verify_proof
produce: commitments (G1 points), evaluations (scalars), the extended-domain
size driving evaluate_h, and MSM/NTT totals.

The port's own copy of sha2cq_tpu/dev/cost.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from ..plonk.circuit_ir import ConstraintSystem
from ..poly.domain import EvaluationDomain


@dataclass
class CircuitCost:
    k: int
    n: int
    extended_n: int
    degree: int
    blinding_factors: int
    advice_commitments: int
    permutation_z_commitments: int
    lookup_commitments: int          # dynamic: 3 per argument
    static_lookup_commitments: int   # CQ: 7 per argument
    vanishing_commitments: int       # random poly + h pieces
    multiopen_commitments: int       # GWC: one per distinct point
    evaluations: int
    proof_bytes: int
    ntts_per_proof: int
    msms_per_proof: int

    @staticmethod
    def measure(k: int, circuit_cls, multiopen: str = "gwc") -> "CircuitCost":
        cs = ConstraintSystem()
        circuit_cls.configure(cs)
        # selector conversion happens at keygen; selectors become fixed cols,
        # degrees unchanged
        degree = cs.degree()
        domain = EvaluationDomain(degree, k)
        n = 1 << k
        bf = cs.blinding_factors()

        chunk = max(degree - 2, 1)
        perm_cols = len(cs.permutation.columns)
        num_sets = (perm_cols + chunk - 1) // chunk if perm_cols else 0

        advice = cs.num_advice_columns
        lookups = len(cs.lookups)
        statics = len(cs.static_lookups)
        h_pieces = domain.quotient_poly_degree

        # distinct opening points: x, wx always; w^-1 x if dynamic lookups;
        # w^last x if chained permutation sets; plus rotations from queries
        rotations = {rot for _, rot in
                     cs.advice_queries + cs.fixed_queries + cs.instance_queries}
        rotations |= {0, 1}
        if lookups:
            rotations.add(-1)
        points = len(rotations) + (1 if num_sets > 1 else 0)

        if multiopen == "gwc":
            mo_commitments = points
        else:
            mo_commitments = 2

        evals = (len(cs.advice_queries) + len(cs.fixed_queries)
                 + 1                             # vanishing random eval
                 + perm_cols                     # sigma evals
                 + (3 * num_sets - 1 if num_sets else 0)
                 + 5 * lookups
                 + 3 * statics)

        commitments = (advice + num_sets + 3 * lookups + 7 * statics
                       + 1 + h_pieces + mo_commitments)
        proof_bytes = 32 * (commitments + evals)

        # NTT counts: instance+advice+fixed lagrange->coeff; coeff->extended
        # for everything entering evaluate_h; lookup/CQ iFFTs; h conversions
        ntts = (advice + cs.num_instance_columns          # to coeff
                + advice + cs.num_instance_columns        # to extended
                + 3 * lookups + 2 * statics
                + 3 * num_sets
                + 2)                                      # h: iFFT + truncate
        msms = commitments

        return CircuitCost(
            k=k, n=n, extended_n=domain.extended_n, degree=degree,
            blinding_factors=bf,
            advice_commitments=advice,
            permutation_z_commitments=num_sets,
            lookup_commitments=3 * lookups,
            static_lookup_commitments=7 * statics,
            vanishing_commitments=1 + h_pieces,
            multiopen_commitments=mo_commitments,
            evaluations=evals,
            proof_bytes=proof_bytes,
            ntts_per_proof=ntts,
            msms_per_proof=msms,
        )

    def summary(self) -> str:
        return (
            f"k={self.k} n={self.n} extended_n={self.extended_n} "
            f"degree={self.degree}\n"
            f"commitments: advice={self.advice_commitments} "
            f"perm_z={self.permutation_z_commitments} "
            f"lookup={self.lookup_commitments} "
            f"cq={self.static_lookup_commitments} "
            f"vanishing={self.vanishing_commitments} "
            f"multiopen={self.multiopen_commitments}\n"
            f"evaluations={self.evaluations} proof≈{self.proof_bytes}B "
            f"ntts={self.ntts_per_proof} msms={self.msms_per_proof}"
        )
