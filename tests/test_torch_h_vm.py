"""Port h-fold VM (sha2cq_tpu_torch.plonk.h_vm): the assembler emits the
reference's program, and the plain version of kernel K3 equals the
reference's _vm_run on the same inputs: exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields import device as JD
from sha2cq_tpu.fields.host import FR_MOD as P
from sha2cq_tpu.plonk import h_vm as JV
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.plonk import h_vm as TV
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

K_SHA = 9


@pytest.fixture(scope="module")
def sha_pks():
    """The SHA-256 circuit32 / SCHEME8 proving key built by each package
    from the same seed."""
    return (compat.build_sha256(compat.REFERENCE, K_SHA, 1, 0x56).pk,
            compat.build_sha256(compat.PORT, K_SHA, 1, 0x56).pk)


@pytest.mark.parametrize("rot_scale", [None, 1])
def test_assembler_matches_reference(sha_pks, rot_scale):
    jpk, tpk = sha_pks
    want = JV.assemble_h_program(jpk, rot_scale=rot_scale)
    got = TV.assemble_h_program(tpk, rot_scale=rot_scale)
    np.testing.assert_array_equal(got.instrs, want.instrs)
    assert (got.n_reg, got.out_reg, got.n_runtime) == \
        (want.n_reg, want.out_reg, want.n_runtime)
    assert got.const_scalars == want.const_scalars
    assert TV.program_y_fold_count(tpk) == JV.program_y_fold_count(jpk)
    if rot_scale is None:
        assert want.instrs.shape == (1322, 4) and want.n_reg == 32


def test_assembler_matches_reference_simple():
    jpk = compat.build_simple(compat.REFERENCE, 4, 3).pk
    tpk = compat.build_simple(compat.PORT, 4, 3).pk
    np.testing.assert_array_equal(TV.assemble_h_program(tpk).instrs,
                                  JV.assemble_h_program(jpk).instrs)


def test_plain_vm_matches_reference_vm(sha_pks):
    """The SHA program over random canonical column groups (advice and
    fixed stored narrow, as the h path stores them) and scalars."""
    jpk, _ = sha_pks
    prog = JV.assemble_h_program(jpk)
    n = 256
    rng = np.random.default_rng(9)
    ncols = {g: 1 for g in TV.GROUPS}
    for op, a, _b, _d in prog.instrs.tolist():
        if op < 8:
            ncols[TV.GROUPS[op]] = max(ncols[TV.GROUPS[op]], a + 1)

    def rand_limbs(count):
        vals = [int.from_bytes(rng.bytes(32), "little") % P
                for _ in range(count)]
        return JD.np_pack(vals, JD.FR)

    groups = {g: rand_limbs(c * n).reshape(16, c, n) for g, c in ncols.items()}
    scal = rand_limbs(4 + jpk.vk.cs.num_challenges + len(prog.const_scalars))
    regs0 = jnp.zeros((16, prog.n_reg, n), dtype=jnp.uint32)
    want = np.asarray(JV._vm_run(
        jnp.asarray(prog.instrs), regs0,
        {g: jnp.asarray(v) for g, v in groups.items()},
        jnp.asarray(scal)))[:, prog.out_reg]
    tgroups = {g: compat.from_jax_limbs(v) for g, v in groups.items()}
    for g in ("advice", "fixed"):
        tgroups[g] = tgroups[g].to(torch.int16)
    tscal = compat.from_jax_limbs(scal)
    loaded = TV.load_program(prog, tgroups, tscal)
    got = TV.vm_run(loaded, tgroups, tscal)
    np.testing.assert_array_equal(compat.to_jax_limbs(got), want)
    # a program runs only on groups of the widths it was checked against
    tgroups["sigma"] = tgroups["sigma"][:, :-1]
    with pytest.raises(ValueError, match="checked against"):
        TV.vm_run(loaded, tgroups, tscal)


@pytest.mark.parametrize("field", [
    None, "op", "dst", "a_reg", "b_reg", "b_scal", "a_col"])
def test_program_check_rejects_out_of_range_indices(sha_pks, field):
    """K3 indexes registers, scalars and columns unchecked, so load_program
    checks the program first: the SHA program passes, one index past its
    table fails."""
    jpk = sha_pks[0]
    prog = JV.assemble_h_program(jpk)
    ins = prog.instrs.copy()
    op = ins[:, 0]
    cols = [1] * len(TV.GROUPS)
    for o, a in ins[op < TV.LOADS, :2].tolist():
        cols[o] = max(cols[o], a + 1)
    nsc = 4 + jpk.vk.cs.num_challenges + len(prog.const_scalars)
    if field is None:
        TV.check_program(ins, cols, nsc, prog.n_reg, prog.out_reg)
        return
    row, col, value = {
        "op": (0, 0, TV.N_OPS),
        "dst": (0, 3, prog.n_reg),
        "a_reg": (np.flatnonzero(op > TV.LOADS)[0], 1, prog.n_reg),
        "b_reg": (np.flatnonzero((op >= TV.ADD) & (op <= TV.MUL))[0], 2, -1),
        "b_scal": (np.flatnonzero(op >= TV.ADDS)[0], 2, nsc),
        "a_col": (np.flatnonzero(op == TV.LOAD_ADVICE)[0], 1,
                  cols[TV.LOAD_ADVICE]),
    }[field]
    ins[row, col] = value
    with pytest.raises(ValueError, match="outside"):
        TV.check_program(ins, cols, nsc, prog.n_reg, prog.out_reg)
