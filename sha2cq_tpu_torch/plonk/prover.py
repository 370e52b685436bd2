"""create_proof — the prover pipeline (reference plonk/prover.rs:51-779).

Transcript-ordered phases:
  1. vk hash; instance values absorbed as common scalars
  2. witness synthesis per phase; blind rows; commit advice; phase challenges
  3. theta; dynamic lookups commit_permuted; CQ lookups commit (f, m)
  4. beta, gamma; permutation grand products; lookup products;
     CQ log-derivatives (a, qa, a0, b0, p)
  5. vanishing random commit; y; evaluate_h; h piece commits
  6. x; advice/fixed evals; vanishing eval; permutation common + set evals;
     lookup evals; CQ evals
  7. GWC multiopen over the assembled query set

This is the PyTorch port's prover (counterpart of sha2cq_tpu/plonk/
prover.py).  With h_device=True the h computation -- every basis conversion,
the h fold, the vanishing quotient and the return to coefficients -- runs on
an explicit torch device through plonk/device_eval.HFn; everything else is
the shared host protocol and the native C layer.  Proofs are byte-identical
to the reference's under the same rng.
"""
from __future__ import annotations

import secrets
from typing import List, Optional, Sequence

from ..circuit import Value, planner_for
from ..fields.host import FR_MOD
from ..poly import arith as A
from ..poly.kzg.gwc import ProverQuery, gwc_create_proof
from ..utils.profiling import profiler
from ..utils.transcript import Blake2bWrite
from .circuit_ir import Column, ConstraintSystem, Selector, StaticTableId
from .evaluation import evaluate_h
from .keys import ProvingKey
from .lookup_arg import (lookup_commit_permuted, lookup_commit_product,
                         lookup_evaluate, lookup_open)
from .permutation import (permutation_commit, permutation_evaluate,
                          permutation_open, permutation_pk_evaluate,
                          permutation_pk_open)
from .static_lookup import (static_lookup_commit_all,
                            static_lookup_evaluate, static_lookup_open,
                            static_lookup_log_derivatives_all)
from .vanishing import (vanishing_commit, vanishing_construct,
                        vanishing_evaluate, vanishing_open)

P = FR_MOD


class _SystemRng:
    def randrange(self, n: int) -> int:
        return secrets.randbelow(n)


def _fixed_poly_bufs(pk, n: int):
    """pk.fixed_polys as cached (n, 4) limb buffers (arith.as_coeff_list
    form) — they are opened at x in every proof, so the one-time pack saves
    a per-proof bigint conversion in the eval + multiopen phases."""
    bufs = pk.__dict__.get("_fixed_poly_bufs")
    if bufs is None:
        from ..native_loader import fr_buf, get_lib
        if get_lib() is None or n < 1024:
            bufs = pk.fixed_polys
        else:
            bufs = [fr_buf([c % P for c in poly]) for poly in pk.fixed_polys]
        pk.__dict__["_fixed_poly_bufs"] = bufs
    return bufs


class _WitnessCollection:
    """Assignment sink for witness generation (prover.rs:139-392)."""

    def __init__(self, cs: ConstraintSystem, n: int, usable_rows: int,
                 instances: Sequence[Sequence[int]], current_phase: int,
                 challenges: dict):
        self.cs = cs
        self.n = n
        self.usable_rows = usable_rows
        self.instances = instances
        self.current_phase = current_phase
        self.challenges = challenges
        self.advice = [[0] * n for _ in range(cs.num_advice_columns)]

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def register_static_table(self, table_id: StaticTableId, table):
        pass  # only keygen cares

    def enable_selector(self, selector: Selector, row: int):
        pass

    def query_instance(self, column: Column, row: int) -> Value:
        if row >= self.usable_rows:
            raise ValueError("not enough rows available")
        return Value.known(self.instances[column.index][row])

    def assign_advice(self, column: Column, row: int, value: Value):
        if column.phase != self.current_phase:
            return
        if row >= self.usable_rows:
            raise ValueError("not enough rows available")
        self.advice[column.index][row] = value.assign()

    def assign_advice_slice(self, column: Column, row0: int, values):
        if column.phase != self.current_phase:
            return
        if row0 + len(values) > self.usable_rows:
            raise ValueError("not enough rows available")
        self.advice[column.index][row0:row0 + len(values)] = \
            [v % P for v in values]

    def assign_fixed_slice(self, column: Column, row0: int, values):
        pass

    def assign_fixed(self, column: Column, row: int, value: Value):
        pass

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass

    def get_challenge(self, challenge) -> Value:
        v = self.challenges.get(challenge.index)
        return Value.known(v) if v is not None else Value.unknown()

    def next_phase(self):
        pass


def prewarm_prover(pk, device, h_mxu: Optional[bool] = None,
                   h_cosets: Optional[bool] = None):
    """Build the device h module for this proving key on `device` (per-pk
    constants, NTT plans, the h program) for the route h_mxu / h_cosets
    select (as in create_proof) and, on a CUDA device, build and load the
    kernel library, so the first create_proof(h_device=True) runs at the
    warm rate.  Idempotent per (pk, device, route); returns the module."""
    import torch

    from .device_eval import get_h_fn
    fn = get_h_fn(pk, device, h_mxu, h_cosets)
    if torch.device(device).type == "cuda":
        from ..ops import kernels
        kernels.get_lib()
    return fn


def create_proof(params, pk: ProvingKey, circuits: Sequence, instances,
                 rng=None, transcript: Optional[Blake2bWrite] = None,
                 multiopen: str = "gwc", h_device: bool = False,
                 device=None, mesh=None, h_mxu: Optional[bool] = None,
                 h_cosets: Optional[bool] = None) -> bytes:
    """instances: per-circuit list of per-column instance value lists.

    h_device: evaluate h on the torch `device` ("cuda", "cuda:0", "cpu"),
    which must then be given explicitly: nothing probes for a card, and
    nothing moves to the CPU unasked.

    h_mxu: force the digit-matmul NTT route of the device h on or off
    (None = auto: on for k >= 12, the butterfly NTT below), as in the
    reference.  h_cosets: force the coset-streamed digit-matmul h on or off
    (None = auto: on at extended size >= 2^19); it takes the place of the
    reference's SHA2CQ_H_COSETS environment switch.  The proof's bytes do
    not depend on the route.

    mesh: multi-device proving is not ported (ROADMAP, multi-device on
    torch.distributed) and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "create_proof(mesh=...): multi-device proving is not ported "
            "(ROADMAP: multi-device on torch.distributed)")
    if h_device and device is None:
        raise ValueError("create_proof(h_device=True) needs an explicit device")
    rng = rng or _SystemRng()
    transcript = transcript or Blake2bWrite()
    cs = pk.vk.cs
    domain = pk.vk.domain
    n = params.n

    if len(circuits) != len(instances):
        raise ValueError("one instance list per circuit")
    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise ValueError("InvalidInstances")

    mark = profiler.marker("create_proof")

    pk.vk.hash_into(transcript)

    # instance values -> lagrange + coeff polys; raw values absorbed into the
    # transcript up front (prover.rs:100-131 / verifier.rs:52-55 order)
    instance_singles = []
    for inst in instances:
        values = []
        polys = []
        for col in inst:
            if len(col) > n - (cs.blinding_factors() + 1):
                raise ValueError("InstanceTooLarge")
            v = list(col) + [0] * (n - len(col))
            values.append(v)
            polys.append(domain.lagrange_to_coeff_host(v))
        instance_singles.append({"values": values, "polys": polys})
        for col in inst:
            for v in col:
                transcript.common_scalar(v % P)

    # ---- witness generation --------------------------------------------
    # Phase-major over circuits (prover.rs:299-391): within each phase every
    # circuit synthesizes and commits its advice, THEN the phase challenges
    # are squeezed — so multi-circuit proofs share challenges correctly.
    unusable_rows_start = n - (cs.blinding_factors() + 1)
    phases = cs.phases()
    challenges: dict = {}
    configs = [type(c).configure(ConstraintSystem()) for c in circuits]
    witnesses = [
        _WitnessCollection(cs, n, unusable_rows_start, inst_single["values"],
                           phases[0], challenges)
        for inst_single in instance_singles
    ]
    advice_singles = [
        {"values": [[0] * n for _ in range(cs.num_advice_columns)],
         "bufs": [None] * cs.num_advice_columns,
         "commitments": [None] * cs.num_advice_columns}
        for _ in circuits
    ]
    from ..native_loader import fr_buf, get_lib
    use_bufs = get_lib() is not None and n >= 1024
    for phase in phases:
        for c_idx, circuit in enumerate(circuits):
            witness = witnesses[c_idx]
            witness.current_phase = phase
            planner_for(circuit).synthesize(
                witness, circuit, configs[c_idx], cs.constants)
            # blind every phase column (rng order preserved), then commit
            # them all in ONE native multi-MSM call before transcribing in
            # column order (prover.rs:299-391 batches the same way).  Each
            # column is limb-packed ONCE; the buffer is reused by the CQ
            # f-fold and the device h-path input pack.
            phase_cols = []
            for col_idx, col_phase in enumerate(cs.advice_column_phase):
                if col_phase != phase:
                    continue
                col = list(witness.advice[col_idx])
                for row in range(unusable_rows_start, n):
                    col[row] = rng.randrange(P)
                advice_singles[c_idx]["values"][col_idx] = col
                if use_bufs:
                    buf = fr_buf([v % P for v in col])
                    advice_singles[c_idx]["bufs"][col_idx] = buf
                    phase_cols.append((col_idx, buf))
                else:
                    phase_cols.append((col_idx, col))
            cms = params.commit_lagrange_many([c for _, c in phase_cols])
            for (col_idx, _), cm in zip(phase_cols, cms):
                advice_singles[c_idx]["commitments"][col_idx] = cm
                transcript.write_point(cm)
        for ch_idx, ch_phase in enumerate(cs.challenge_phase):
            if ch_phase == phase:
                challenges[ch_idx] = transcript.squeeze_challenge()

    mark("witness_and_advice_commit")
    challenges_list = [challenges[i] for i in range(cs.num_challenges)]

    # ---- theta; lookups + CQ commit ------------------------------------
    theta = transcript.squeeze_challenge()

    lookups_permuted = []
    for inst_single, adv in zip(instance_singles, advice_singles):
        lookups_permuted.append([
            lookup_commit_permuted(
                arg, pk, params, theta, adv["values"], pk.fixed_values,
                inst_single["values"], challenges_list, rng, transcript)
            for arg in cs.lookups
        ])

    mark("lookup_permute")
    static_committed = []
    for inst_single, adv in zip(instance_singles, advice_singles):
        # rotation-0 column-query inputs reuse the transcribed column
        # commitments for [f]_1 (commit_lagrange is linear in the values)
        col_cms = {("advice", i): cm
                   for i, cm in enumerate(adv["commitments"]) if cm is not None}
        col_cms.update({("fixed", i): cm
                        for i, cm in enumerate(pk.vk.fixed_commitments)})
        col_bufs = {("advice", i): b
                    for i, b in enumerate(adv["bufs"]) if b is not None}
        static_committed.append(static_lookup_commit_all(
            cs.static_lookups, pk, params, theta, challenges_list,
            adv["values"], pk.fixed_values, inst_single["values"],
            transcript, rng=rng, column_commitments=col_cms,
            column_buffers=col_bufs))

    mark("cq_commit_f_m")
    # ---- beta, gamma; permutations; products; CQ log derivatives --------
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    permutations = []
    for inst_single, adv in zip(instance_singles, advice_singles):
        permutations.append(permutation_commit(
            pk, params, adv["values"], pk.fixed_values, inst_single["values"],
            beta, gamma, rng, transcript))

    mark("permutation_grand_products")
    lookups_committed = [
        [lookup_commit_product(pm, pk, params, beta, gamma, rng, transcript)
         for pm in per_circuit]
        for per_circuit in lookups_permuted
    ]

    mark("lookup_grand_products")
    static_log = [
        static_lookup_log_derivatives_all(
            per_circuit, pk, params, domain, beta, theta, transcript)
        for per_circuit in static_committed
    ]

    mark("cq_log_derivatives")
    # ---- vanishing + y + h ----------------------------------------------
    vanishing = vanishing_commit(params, domain, rng, transcript)
    y = transcript.squeeze_challenge()

    if h_device:
        # Device path: the HFn module runs every basis conversion, the h
        # fold, the vanishing quotient and the return to coefficients for
        # one circuit.  Multi-circuit proofs run it once per circuit and
        # combine the per-circuit quotients on host: every VM term folds the
        # accumulator by y exactly once and the quotient pipeline is linear,
        # so h = sum_c h_c * y^{T*(nc-1-c)} with T the program's fold count
        # (the reference's circuit-major loop, evaluation.rs:285-374).
        import torch

        from ..fields import device as Dv
        from .device_eval import get_h_fn, prepare_h_inputs
        from .vanishing import vanishing_construct_from_coeffs

        dev = torch.device(device)
        with profiler.phase("h_fn_build"):
            h_fn = get_h_fn(pk, dev, h_mxu, h_cosets)
        ncols = cs.num_advice_columns
        h_bufs = []
        advice_coeff = []
        for c_idx, adv in enumerate(advice_singles):
            with profiler.phase("h_pack_inputs"):
                adv_cols = [b if b is not None else v
                            for b, v in zip(adv["bufs"], adv["values"])]
                inputs = prepare_h_inputs(
                    pk, adv_cols, instance_singles[c_idx]["values"],
                    lookups_committed[c_idx], static_log[c_idx],
                    permutations[c_idx], dev)
                scal = h_fn.scalar_table(y, beta, gamma, theta,
                                         challenges_list)
            with profiler.phase("h_device"):
                h_dev, advice_coeff_dev = h_fn(
                    inputs["advice"], inputs["instance"], inputs["z"],
                    inputs["lookups"], inputs["static_b"],
                    inputs["static_f"], scal)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            with profiler.phase("h_unpack"):
                h_bufs.append(Dv.unpack_buf(h_dev, Dv.FR))
                # the advice coefficients are the l2c intermediate of the
                # same program; the x-evals and the multiopen consume them
                # as (n, 4) limb buffers
                flat = Dv.unpack_buf(advice_coeff_dev, Dv.FR)
                advice_coeff.append(
                    {"polys": [flat[i * n:(i + 1) * n] for i in range(ncols)]})
        with profiler.phase("h_commit"):
            from ..native_loader import fr_unbuf, native_fr_fold_buf
            h_acc = h_bufs[0]
            if len(h_bufs) > 1:
                from ..native_loader import fr_buf
                from .h_vm import program_y_fold_count
                y_t = pow(y, program_y_fold_count(pk), P)
                for nxt in h_bufs[1:]:
                    if not native_fr_fold_buf(h_acc, nxt, y_t):
                        h_acc = fr_buf([
                            (a * y_t + b) % P
                            for a, b in zip(fr_unbuf(h_acc), fr_unbuf(nxt))])
            vanishing = vanishing_construct_from_coeffs(
                vanishing, params, domain, fr_unbuf(h_acc), transcript)
    else:
        advice_coeff = [
            {"polys": [domain.lagrange_to_coeff_host(v) for v in adv["values"]]}
            for adv in advice_singles
        ]
        advice_cosets = [
            [domain.coeff_to_extended_host(p) for p in adv["polys"]]
            for adv in advice_coeff
        ]
        instance_cosets = [
            [domain.coeff_to_extended_host(p) for p in inst["polys"]]
            for inst in instance_singles
        ]

        h_values = evaluate_h(
            pk, advice_cosets, instance_cosets, challenges_list, y, beta, gamma,
            theta, lookups_committed, static_log, permutations)

        vanishing = vanishing_construct(vanishing, params, domain, h_values, rng, transcript)

    mark("h_eval_and_commit")
    # ---- x; evals --------------------------------------------------------
    x = transcript.squeeze_challenge()
    xn = pow(x, n, P)

    fixed_polys = _fixed_poly_bufs(pk, n)
    for adv in advice_coeff:
        for column, rot in cs.advice_queries:
            transcript.write_scalar(
                A.eval_polynomial(adv["polys"][column.index], domain.rotate_omega(x, rot)))
    for column, rot in cs.fixed_queries:
        transcript.write_scalar(
            A.eval_polynomial(fixed_polys[column.index], domain.rotate_omega(x, rot)))

    vanishing = vanishing_evaluate(vanishing, x, xn, domain, transcript)
    permutation_pk_evaluate(pk, x, transcript)
    for perm in permutations:
        permutation_evaluate(perm, pk, x, transcript)
    for per_circuit in lookups_committed:
        for lk in per_circuit:
            lookup_evaluate(lk, pk, x, transcript)
    for per_circuit in static_log:
        for sl in per_circuit:
            static_lookup_evaluate(sl, x, transcript)

    mark("point_evals")
    # ---- multiopen -------------------------------------------------------
    queries: List[ProverQuery] = []
    for adv, inst_single, perm, lks, sls in zip(
            advice_coeff, instance_singles, permutations, lookups_committed, static_log):
        for column, rot in cs.advice_queries:
            queries.append(ProverQuery(
                domain.rotate_omega(x, rot), adv["polys"][column.index]))
        queries.extend(permutation_open(perm, pk, x))
        for lk in lks:
            queries.extend(lookup_open(lk, pk, x))
        for sl in sls:
            queries.extend(static_lookup_open(sl, x))
    for column, rot in cs.fixed_queries:
        queries.append(ProverQuery(
            domain.rotate_omega(x, rot), fixed_polys[column.index]))
    queries.extend(permutation_pk_open(pk, x))
    queries.extend(vanishing_open(vanishing, x))

    if multiopen == "gwc":
        gwc_create_proof(params, queries, transcript)
    elif multiopen == "shplonk":
        from ..poly.kzg.shplonk import shplonk_create_proof
        shplonk_create_proof(params, queries, transcript)
    else:
        raise ValueError(f"unknown multiopen scheme {multiopen!r}")
    mark("multiopen")
    return transcript.finalize()
