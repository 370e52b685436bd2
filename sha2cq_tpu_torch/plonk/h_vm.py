"""h-fold bytecode VM of the port (counterpart of sha2cq_tpu/plonk/h_vm.py).

The assembler is the reference's, unchanged (pure Python): the constraint
fold is compiled once per proving key into a linear instruction stream over
a register file, with common-subexpression elimination and last-use
register reuse, so the port runs the reference's own program and the y-fold
order -- and with it the proof bytes -- stays identical.

Execution (`vm_run`): the reference scans the program with one lax.switch
step per instruction over the whole (16, ext) register file.  The port runs
the plain version below on CPU tensors (a Python loop over instructions) and
kernel K3 (csrc/h_vm.cu) on CUDA tensors: one thread per extended row walks
the whole program with its registers in local memory, so a prove issues one
launch instead of one per instruction.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..fields import device as D
from ..fields import host as H
from ..fields.device import FR, LIMB, NLIMB
from ..ops import cuda_field as CF
from ..ops import kernels as K

P = H.FR_MOD

# opcodes ---------------------------------------------------------------------
LOAD_ADVICE, LOAD_INSTANCE, LOAD_FIXED, LOAD_SIGMA = 0, 1, 2, 3
LOAD_Z, LOAD_LK, LOAD_ST, LOAD_AUX = 4, 5, 6, 7
LOADS = 8            # dst <- broadcast scalar S[b]
ADD, SUB, MUL = 9, 10, 11          # dst <- r[a] (op) r[b]
ADDS, SUBS, MULS = 12, 13, 14      # dst <- r[a] (op) S[b]
SUBS_R = 15                        # dst <- S[b] - r[a]
N_OPS = 16

# aux column slots (group LOAD_AUX)
AUX_L0, AUX_L_LAST, AUX_L_ACTIVE, AUX_ZTC = 0, 1, 2, 3

_LOAD_OPS = frozenset(range(8))


class Program(NamedTuple):
    """Host-assembled h-fold program (device arrays built per pk)."""
    instrs: np.ndarray          # (N, 4) int32: op, a, b, dst
    n_reg: int
    out_reg: int
    const_scalars: List[int]    # appended after runtime scalar slots
    n_runtime: int              # y,beta,gamma,theta + challenges


class _Asm:
    """SSA assembler with CSE; finalized by linear-scan register allocation.

    Values are ('r', ssa_id) or ('s', scalar_idx); scalar-scalar arithmetic
    materializes one operand with LOADS (runtime scalars can't be folded
    host-side).  Mirrors the reference GraphEvaluator's ValueSource dedup
    (evaluation.rs:63-174)."""

    def __init__(self, n_runtime: int):
        self.instrs: List[Tuple[int, int, int]] = []   # SSA: dst == index
        self._cse: Dict[tuple, int] = {}
        self.n_runtime = n_runtime
        self.consts: List[int] = []
        self._cidx: Dict[int, int] = {}

    # -- scalars
    def sconst(self, v: int) -> Tuple[str, int]:
        v %= P
        if v not in self._cidx:
            self._cidx[v] = self.n_runtime + len(self.consts)
            self.consts.append(v)
        return ("s", self._cidx[v])

    # -- raw emit with CSE
    def _emit(self, op: int, a: int, b: int, key: Optional[tuple]) -> int:
        if key is not None and key in self._cse:
            return self._cse[key]
        self.instrs.append((op, a, b))
        rid = len(self.instrs) - 1
        if key is not None:
            self._cse[key] = rid
        return rid

    # -- loads
    def load(self, op: int, col: int, shift: int) -> Tuple[str, int]:
        return ("r", self._emit(op, col, shift, (op, col, shift)))

    def _as_reg(self, v) -> int:
        if v[0] == "r":
            return v[1]
        return self._emit(LOADS, 0, v[1], (LOADS, v[1]))

    # -- arithmetic on ('r'|'s', idx) operands
    def add(self, x, y):
        if x[0] == "s" and y[0] == "s":
            x = ("r", self._as_reg(x))
        if x[0] == "s":
            x, y = y, x
        if y[0] == "s":
            return ("r", self._emit(ADDS, x[1], y[1], (ADDS, x[1], y[1])))
        a, b = sorted((x[1], y[1]))
        return ("r", self._emit(ADD, a, b, (ADD, a, b)))

    def mul(self, x, y):
        if x[0] == "s" and y[0] == "s":
            x = ("r", self._as_reg(x))
        if x[0] == "s":
            x, y = y, x
        if y[0] == "s":
            return ("r", self._emit(MULS, x[1], y[1], (MULS, x[1], y[1])))
        a, b = sorted((x[1], y[1]))
        return ("r", self._emit(MUL, a, b, (MUL, a, b)))

    def sub(self, x, y):
        if y[0] == "s":
            x = ("r", self._as_reg(x)) if x[0] == "s" else x
            return ("r", self._emit(SUBS, x[1], y[1], (SUBS, x[1], y[1])))
        if x[0] == "s":
            return ("r", self._emit(SUBS_R, y[1], x[1], (SUBS_R, y[1], x[1])))
        return ("r", self._emit(SUB, x[1], y[1], (SUB, x[1], y[1])))

    def neg(self, x):
        return self.sub(self.sconst(0), x)

    # -- finalize
    def finish(self, out) -> Program:
        out_ssa = self._as_reg(out)
        n = len(self.instrs)
        last_use = [-1] * n
        for i, (op, a, b) in enumerate(self.instrs):
            if op in _LOAD_OPS or op == LOADS:
                continue
            last_use[a] = i
            if op in (ADD, SUB, MUL):
                last_use[b] = i
        last_use[out_ssa] = n  # result stays live
        phys = [-1] * n
        free: List[int] = []
        n_reg = 0
        final = np.zeros((n, 4), dtype=np.int32)
        for i, (op, a, b) in enumerate(self.instrs):
            if op in _LOAD_OPS or op == LOADS:
                pa, pb = a, b
            elif op in (ADD, SUB, MUL):
                pa, pb = phys[a], phys[b]
            else:
                pa, pb = phys[a], b
            # free operands whose last use is here (dst may reuse them)
            if op not in _LOAD_OPS and op != LOADS:
                if last_use[a] == i:
                    free.append(phys[a])
                if op in (ADD, SUB, MUL) and last_use[b] == i and phys[b] not in free:
                    free.append(phys[b])
            if free:
                pd = free.pop()
            else:
                pd = n_reg
                n_reg += 1
            phys[i] = pd
            final[i] = (op, pa, pb, pd)
        return Program(instrs=final, n_reg=max(n_reg, 1),
                       out_reg=phys[out_ssa],
                       const_scalars=list(self.consts),
                       n_runtime=self.n_runtime)


# ----------------------------- program assembly ------------------------------

def program_y_fold_count(pk) -> int:
    """Number of y-Horner folds the h program performs for ONE circuit —
    each `fold` below multiplies the whole accumulator by y exactly once, so
    a multi-circuit proof combines per-circuit quotients as
    h = sum_c h_c * y^{T*(nc-1-c)} (the prover's circuit-major accumulation,
    reference evaluation.rs:285-374).  Must mirror assemble_h_program's (and
    evaluate_h's) term emission exactly."""
    cs = pk.vk.cs
    t = sum(len(g.polys) for g in cs.gates)
    columns = cs.permutation.columns
    chunk_len = max(pk.vk.cs_degree - 2, 1)
    num_sets = (len(columns) + chunk_len - 1) // chunk_len if columns else 0
    if num_sets:
        t += 2 + (num_sets - 1) + num_sets
    t += 5 * len(cs.lookups)
    t += len(cs.static_lookups)
    return t


def assemble_h_program(pk, rot_scale: "int | None" = None) -> Program:
    """Compile pk's constraint system into a VM program.  Term order matches
    plonk/device_eval.build_h_fn exactly (gates, permutation head/boundaries/
    sets, dynamic lookups, CQ static lookups — the host evaluate_h order), so
    resulting h values — and proofs — are identical.

    rot_scale: roll step per base-domain rotation.  Default = ext/n (the
    program runs over the full extended coset).  The coset-streamed h
    (device_eval.HFn's coset route) passes 1: each of the ext/n
    cosets is a rotation-closed n-row slice, so base rotations roll by
    exactly one row within it."""
    cs = pk.vk.cs
    domain = pk.vk.domain
    if rot_scale is None:
        rot_scale = 1 << (domain.extended_k - domain.k)
    n_runtime = 4 + cs.num_challenges
    A = _Asm(n_runtime)
    Y, BETA, GAMMA, THETA = ("s", 0), ("s", 1), ("s", 2), ("s", 3)
    ONE = A.sconst(1)

    def shift(rot: int) -> int:
        return -rot * rot_scale

    def chal(idx: int):
        return ("s", 4 + idx)

    def eval_expr(expr):
        return expr.evaluate({
            "const": lambda v: A.sconst(v),
            "selector": lambda e: (_ for _ in ()).throw(ValueError("selector")),
            "fixed": lambda e: A.load(LOAD_FIXED, e.column.index, shift(e.rotation)),
            "advice": lambda e: A.load(LOAD_ADVICE, e.column.index, shift(e.rotation)),
            "instance": lambda e: A.load(LOAD_INSTANCE, e.column.index, shift(e.rotation)),
            "challenge": lambda e: chal(e.value),
            "neg": lambda a: A.neg(a),
            "sum": lambda a, b: A.add(a, b),
            "prod": lambda a, b: A.mul(a, b),
            "scaled": lambda a, v: A.mul(a, A.sconst(v)),
        })

    values = A.sconst(0)

    def fold(acc, term):
        return A.add(A.mul(acc, Y), term)

    def col_val(column, sh=0):
        if column.kind == "advice":
            return A.load(LOAD_ADVICE, column.index, sh)
        if column.kind == "fixed":
            return A.load(LOAD_FIXED, column.index, sh)
        return A.load(LOAD_INSTANCE, column.index, sh)

    l0 = lambda: A.load(LOAD_AUX, AUX_L0, 0)
    l_last = lambda: A.load(LOAD_AUX, AUX_L_LAST, 0)
    l_active = lambda: A.load(LOAD_AUX, AUX_L_ACTIVE, 0)

    # gates
    for gate in cs.gates:
        for poly in gate.polys:
            values = fold(values, eval_expr(poly))

    # permutation argument (device_eval emit_perm_* order)
    bf = cs.blinding_factors()
    chunk_len = max(pk.vk.cs_degree - 2, 1)
    columns = cs.permutation.columns
    num_sets = (len(columns) + chunk_len - 1) // chunk_len if columns else 0
    if num_sets:
        first = A.load(LOAD_Z, 0, 0)
        last = A.load(LOAD_Z, num_sets - 1, 0)
        values = fold(values, A.mul(A.sub(ONE, first), l0()))
        values = fold(values, A.mul(
            A.sub(A.mul(last, last), last), l_last()))
        for i in range(1, num_sets):
            term = A.sub(A.load(LOAD_Z, i, 0),
                         A.load(LOAD_Z, i - 1, shift(-(bf + 1))))
            values = fold(values, A.mul(term, l0()))
        for ci in range(num_sets):
            z = A.load(LOAD_Z, ci, 0)
            cols = columns[ci * chunk_len:(ci + 1) * chunk_len]
            left = A.load(LOAD_Z, ci, shift(1))
            for j, column in enumerate(cols):
                sigma = A.load(LOAD_SIGMA, ci * chunk_len + j, 0)
                vals = col_val(column)
                left = A.mul(left, A.add(
                    A.add(vals, A.mul(BETA, sigma)), GAMMA))
            right = z
            delta_pow = pow(H.FR_DELTA, ci * chunk_len, P)
            cur_delta = A.mul(A.mul(A.load(LOAD_AUX, AUX_ZTC, 0), BETA),
                              A.sconst(delta_pow))
            for column in cols:
                vals = col_val(column)
                right = A.mul(right, A.add(A.add(vals, cur_delta), GAMMA))
                cur_delta = A.mul(cur_delta, A.sconst(H.FR_DELTA))
            values = fold(values, A.mul(A.sub(left, right), l_active()))

    # dynamic lookups (device_eval emit_lookup order)
    for n_lk, arg in enumerate(cs.lookups):
        product = A.load(LOAD_LK, 3 * n_lk, 0)
        inp = A.load(LOAD_LK, 3 * n_lk + 1, 0)
        tab = A.load(LOAD_LK, 3 * n_lk + 2, 0)
        comp_in = A.sconst(0)
        for e in arg.input_expressions:
            comp_in = A.add(A.mul(comp_in, THETA), eval_expr(e))
        comp_tab = A.sconst(0)
        for e in arg.table_expressions:
            comp_tab = A.add(A.mul(comp_tab, THETA), eval_expr(e))
        a_minus_s = A.sub(inp, tab)
        values = fold(values, A.mul(A.sub(ONE, product), l0()))
        values = fold(values, A.mul(
            A.sub(A.mul(product, product), product), l_last()))
        table_value = A.mul(A.add(comp_in, BETA), A.add(comp_tab, GAMMA))
        left = A.mul(A.mul(A.load(LOAD_LK, 3 * n_lk, shift(1)),
                           A.add(inp, BETA)), A.add(tab, GAMMA))
        values = fold(values, A.mul(
            A.sub(left, A.mul(product, table_value)), l_active()))
        values = fold(values, A.mul(a_minus_s, l0()))
        values = fold(values, A.mul(
            A.mul(a_minus_s, A.sub(inp, A.load(LOAD_LK, 3 * n_lk + 1, shift(-1)))),
            l_active()))

    # CQ static lookups (device_eval emit_cq order); zk mode gates the term
    # by l_active (static_lookup.py module docstring)
    for i in range(len(cs.static_lookups)):
        b_coset = A.load(LOAD_ST, 2 * i, 0)
        f_coset = A.load(LOAD_ST, 2 * i + 1, 0)
        if getattr(cs, "zk_static_lookups", False):
            term = A.mul(b_coset, A.add(f_coset, BETA))
            values = fold(values, A.mul(A.sub(term, ONE), l_active()))
        else:
            term = A.mul(b_coset, A.add(A.mul(f_coset, l_active()), BETA))
            values = fold(values, A.sub(term, ONE))

    return A.finish(values)


# ------------------------------- execution ----------------------------------

GROUPS = ("advice", "instance", "fixed", "sigma", "z", "lk", "st", "aux")


def vm_run_plain(instrs, groups: Dict[str, torch.Tensor], scal: torch.Tensor,
                 n_reg: int, out_reg: int) -> torch.Tensor:
    """Plain version of K3: the reference's per-instruction semantics, one
    (16, n) tensor op per instruction.  groups: GROUPS-keyed (16, C, n)
    limb stacks (int32, or int16 storage); scal (16, NS) limbs.  A load
    rolls its column like jnp.roll: out[j] = col[(j - b) mod n]."""
    ins = np.asarray(instrs)
    n = groups["aux"].shape[2]
    regs: List[Optional[torch.Tensor]] = [None] * n_reg
    sc = [scal[:, i:i + 1] for i in range(scal.shape[1])]

    def bcast(i):
        return sc[i].expand(NLIMB, n)

    for op, a, b, dst in ins.tolist():
        if op < LOADS:
            col = CF.as_limbs32(groups[GROUPS[op]][:, a])
            out = torch.roll(col, b, dims=1)
        elif op == LOADS:
            out = bcast(b).contiguous()
        elif op == ADD:
            out = D.add(regs[a], regs[b], FR)
        elif op == SUB:
            out = D.sub(regs[a], regs[b], FR)
        elif op == MUL:
            out = D.mont_mul_plain(regs[a], regs[b], FR)
        elif op == ADDS:
            out = D.add(regs[a], bcast(b), FR)
        elif op == SUBS:
            out = D.sub(regs[a], bcast(b), FR)
        elif op == MULS:
            out = D.mont_mul_plain(regs[a], sc[b], FR)
        elif op == SUBS_R:
            out = D.sub(bcast(b), regs[a], FR)
        else:
            raise ValueError(f"unknown opcode {op}")
        regs[dst] = out
    return regs[out_reg]


K3_MAX_REG = 256     # register file size the kernel is compiled for


class LoadedProgram(NamedTuple):
    """An h program checked against the widths of its column groups and
    scalar table, and on their device (K3 indexes all of them unchecked,
    so vm_run takes only a program that went through load_program)."""
    instrs: torch.Tensor        # (N, 4) int32
    cols: Tuple[int, ...]       # column count of each group, GROUPS order
    n_scal: int
    n_reg: int
    out_reg: int


def check_program(ins: np.ndarray, cols, n_scal: int, n_reg: int,
                  out_reg: int) -> None:
    """Raise unless every instruction stays inside the register file, the
    scalar table and its load group's columns.  cols: the column count of
    each group, in GROUPS order."""
    if ins.ndim != 2 or ins.shape[1] != 4:
        raise ValueError(f"program must be (N, 4), got {ins.shape}")
    op, a, b, dst = ins.T.astype(np.int64)

    def inside(v, hi):
        return bool(((v >= 0) & (v < hi)).all())

    load = op < LOADS
    reads_rb = (op >= ADD) & (op <= MUL)
    reads_sb = (op == LOADS) | (op >= ADDS)
    if not (inside(op, N_OPS) and inside(dst, n_reg) and
            inside(np.array([out_reg]), n_reg) and
            inside(a[op > LOADS], n_reg) and inside(b[reads_rb], n_reg) and
            inside(b[reads_sb], n_scal) and
            inside(a[load], np.asarray(cols)[op[load]])):
        raise ValueError("h program indexes outside its registers, scalars "
                         "or column groups")


def _widths(groups: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
    return tuple(groups[name].shape[1] for name in GROUPS)


def load_program(prog: Program, groups: Dict[str, torch.Tensor],
                 scal: torch.Tensor) -> LoadedProgram:
    """Check an assembled program against these groups' and this scalar
    table's widths and copy it to their device (once per proving key: the
    h module keeps the result)."""
    cols = _widths(groups)
    check_program(np.asarray(prog.instrs), cols, scal.shape[1], prog.n_reg,
                  prog.out_reg)
    instrs = torch.from_numpy(np.ascontiguousarray(prog.instrs, dtype=np.int32))
    return LoadedProgram(instrs.to(groups["aux"].device), cols, scal.shape[1],
                         prog.n_reg, prog.out_reg)


def vm_run(prog: LoadedProgram, groups: Dict[str, torch.Tensor],
           scal: torch.Tensor) -> torch.Tensor:
    """Run a loaded h program over every extended row; returns the (16, n)
    limbs of register out_reg.  The groups and scalar table must have the
    widths the program was checked against.  CPU tensors take vm_run_plain,
    CUDA tensors kernel K3."""
    if _widths(groups) != prog.cols or scal.shape[1] != prog.n_scal:
        raise ValueError(
            f"groups {_widths(groups)} / {scal.shape[1]} scalars differ from "
            f"the {prog.cols} / {prog.n_scal} the program was checked against")
    aux = groups["aux"]
    if not aux.is_cuda:
        return vm_run_plain(prog.instrs.numpy(), groups, scal, prog.n_reg,
                            prog.out_reg)
    if prog.n_reg > K3_MAX_REG:
        raise NotImplementedError(
            f"h program needs {prog.n_reg} registers; K3 holds {K3_MAX_REG}")
    n = aux.shape[2]
    dev = aux.device
    instrs = prog.instrs
    scal = CF.as_limbs32(scal).contiguous()
    for t, what in ((instrs, "program"), (scal, "scalar table")):
        if t.device != dev:
            raise ValueError(f"{what} on {t.device}, groups on {dev}")
    if scal.dim() != 2 or scal.shape[0] != NLIMB:
        raise ValueError(f"scalar table must be (16, NS), got {tuple(scal.shape)}")
    ptrs, is16 = [], []
    keep = []
    for name in GROUPS:
        g = groups[name]
        if g.device != dev or g.dim() != 3 or g.shape[0] != NLIMB or \
                g.shape[2] != n:
            raise ValueError(f"group {name}: {tuple(g.shape)} on {g.device}")
        if g.dtype not in (torch.int16, torch.int32):
            raise TypeError(f"group {name}: dtype {g.dtype}")
        g = g.contiguous()
        keep.append(g)
        ptrs.append(g.data_ptr())
        is16.append(1 if g.dtype == torch.int16 else 0)
    out = torch.empty((NLIMB, n), dtype=LIMB, device=dev)
    p8, n0 = K.field_words(FR)
    lib = K.get_lib()
    CF.launches["h_vm_run"] += 1
    K.check(lib.k3_h_vm_run(
        instrs.data_ptr(), instrs.shape[0], scal.data_ptr(), scal.shape[1],
        (ctypes.c_uint64 * 8)(*ptrs), (ctypes.c_int * 8)(*prog.cols),
        (ctypes.c_int * 8)(*is16), out.data_ptr(), n, prog.out_reg,
        prog.n_reg, p8, n0, K.stream_ptr(out)), "k3_h_vm_run")
    return out


def build_groups(state: Dict[str, torch.Tensor],
                 consts: Dict[str, torch.Tensor],
                 size: int) -> Dict[str, torch.Tensor]:
    """The VM's column groups, GROUPS-keyed, from converted coset state
    ("advice", "instance", "z", "lk", "st") and per-pk constants ("fixed",
    "sigma" and the stacked (16, 4, size) "aux": l0, l_last, l_active,
    ZETA * coset points), each (16, C, size).  An empty group becomes one
    zero column, as in the reference's _build_groups (the program never
    loads it; K3 indexes every group)."""
    def pad1(a):
        if a.shape[1]:
            return a
        return torch.zeros((NLIMB, 1, size), dtype=a.dtype, device=a.device)

    src = {**consts, **state}
    return {name: pad1(src[name]) for name in GROUPS}


def run_program(prog: LoadedProgram, state: Dict[str, torch.Tensor],
                consts: Dict[str, torch.Tensor], scal: torch.Tensor,
                size: int) -> torch.Tensor:
    """Evaluate a loaded program against converted coset state and per-pk
    constants over `size` rows; returns the (16, size) h values (before the
    quotient).  The counterpart of the reference's run_program."""
    return vm_run(prog, build_groups(state, consts, size), scal)
