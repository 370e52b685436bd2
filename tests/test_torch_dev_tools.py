"""The port's dev tools (plonk/assigned, dev/cost, dev/gates, dev/layout,
dev/mock_prover) and its V1 floor planner against the JAX package's: the
cases of tests/test_dev_tools.py, tests/test_layout.py and
tests/test_v1_planner.py, each run through both packages on the same
circuits, with MockProver failures compared as emitted text, renderings as
strings and proofs as bytes."""
import os
import random
import types

import pytest

import sha2cq_tpu.circuit as JCI
import sha2cq_tpu.dev.cost as JCO
import sha2cq_tpu.dev.gates as JGA
import sha2cq_tpu.dev.layout as JLA
import sha2cq_tpu.dev.mock_prover as JMP
import sha2cq_tpu.models.simple as JSI
import sha2cq_tpu.plonk as JPL
import sha2cq_tpu.plonk.assigned as JAS
import sha2cq_tpu.plonk.circuit_ir as JIR
import sha2cq_tpu.poly.kzg.params as JPA
import sha2cq_tpu.poly.kzg.strategy as JST
import sha2cq_tpu.utils.transcript as JTR
import sha2cq_tpu_torch.circuit as TCI
import sha2cq_tpu_torch.dev.cost as TCO
import sha2cq_tpu_torch.dev.gates as TGA
import sha2cq_tpu_torch.dev.layout as TLA
import sha2cq_tpu_torch.dev.mock_prover as TMP
import sha2cq_tpu_torch.models.simple as TSI
import sha2cq_tpu_torch.plonk as TPL
import sha2cq_tpu_torch.plonk.assigned as TAS
import sha2cq_tpu_torch.plonk.circuit_ir as TIR
import sha2cq_tpu_torch.poly.kzg.params as TPA
import sha2cq_tpu_torch.poly.kzg.strategy as TST
import sha2cq_tpu_torch.utils.transcript as TTR
from sha2cq_tpu_torch.fields.host import FR_MOD as P
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401


def _ns(ci, co, ga, la, mp, si, pl, asg, ir, pa, st, tr, **kw):
    return types.SimpleNamespace(
        circuit=ci, cost=co, gates=ga, layout=la, mock=mp, simple=si,
        plonk=pl, assigned=asg, ir=ir, params=pa, strategy=st,
        transcript=tr, Value=ci.Value, **kw)


JAX = _ns(JCI, JCO, JGA, JLA, JMP, JSI, JPL, JAS, JIR, JPA, JST, JTR,
          prove_kw={})
PORT = _ns(TCI, TCO, TGA, TLA, TMP, TSI, TPL, TAS, TIR, TPA, TST, TTR,
           prove_kw={"device": "cpu"})


def _failure_text(pkg, k, circuit, instance):
    return pkg.mock.emit_failures(
        pkg.mock.MockProver.run(k, circuit, instance).verify())


# ----------------------------- circuits, per package ----------------------

def api_circuit(pkg):
    """tests/test_plonk_api.py's ApiCircuit on pkg's classes."""
    table_vals = list(range(12))

    class ApiCircuit:
        def __init__(self, a_vals, b_vals):
            self.a_vals, self.b_vals = a_vals, b_vals

        @classmethod
        def configure(cls, meta):
            a, b, c = (meta.advice_column() for _ in range(3))
            q_mul = meta.fixed_column()
            table = meta.lookup_table_column()
            inst = meta.instance_column()
            for col in (a, b, c, inst):
                meta.enable_equality(col)
            meta.create_gate("mul", lambda cells: [
                cells.query_fixed(q_mul, 0)
                * (cells.query_advice(a, 0) * cells.query_advice(b, 0)
                   - cells.query_advice(c, 0))])
            meta.lookup("range", lambda cells: [
                (cells.query_advice(a, 0), table)])
            return {"a": a, "b": b, "c": c, "q_mul": q_mul, "table": table,
                    "inst": inst}

        def synthesize(self, cfg, layouter):
            def fill_table(table):
                for i, v in enumerate(table_vals):
                    table.assign_cell(cfg["table"], i, pkg.Value.known(v))
            layouter.assign_table("range", fill_table)
            cells = {}

            def assign(region):
                for i, (av, bv) in enumerate(zip(self.a_vals, self.b_vals)):
                    region.assign_fixed(cfg["q_mul"], i, pkg.Value.known(1))
                    ca = region.assign_advice(cfg["a"], i, pkg.Value.known(av))
                    cb = region.assign_advice(cfg["b"], i, pkg.Value.known(bv))
                    cc = region.assign_advice(cfg["c"], i,
                                              pkg.Value.known(av * bv % P))
                    cells[i] = (ca, cb, cc)
                region.constrain_equal(cells[0][0].cell, cells[1][1].cell)
                return cells

            got = layouter.assign_region("rows", assign)
            layouter.constrain_instance(got[0][2].cell, cfg["inst"], 0)

    return ApiCircuit


def challenge_circuit(pkg, misphased):
    """b (phase 1) must equal a (phase 0) * challenge c."""
    ir = pkg.ir

    class ChallengeCircuit:
        @classmethod
        def configure(cls, meta):
            a = meta.advice_column(ir.FIRST_PHASE)
            b = meta.advice_column(ir.SECOND_PHASE)
            q = meta.fixed_column()
            ch = meta.challenge_usable_after(ir.FIRST_PHASE)
            meta.create_gate("b=a*c", lambda cells: [
                cells.query_fixed(q, 0)
                * (cells.query_advice(b, 0)
                   - cells.query_advice(a, 0) * cells.query_challenge(ch))])
            return {"a": a, "b": b, "q": q, "ch": ch}

        def __init__(self, a_val):
            self.a_val = a_val

        def synthesize(self, cfg, layouter):
            def assign(region):
                region.assign_fixed(cfg["q"], 0, pkg.Value.known(1))
                region.assign_advice(cfg["a"], 0, pkg.Value.known(self.a_val))
                cv = region.get_challenge(cfg["ch"])
                if misphased:
                    region.assign_advice(cfg["b"], 0, pkg.Value.known(12345))
                else:
                    b = cv.map(lambda c: self.a_val * c % P)
                    region.assign_advice(cfg["b"], 0, b if b.is_known()
                                         else pkg.Value.known(0))
            layouter.assign_region("r", assign)

    return ChallengeCircuit


def incomplete_circuit(pkg):
    class Incomplete:
        @classmethod
        def configure(cls, meta):
            a, b = meta.advice_column(), meta.advice_column()
            q = meta.fixed_column()
            meta.create_gate("a=b", lambda cells: [
                cells.query_fixed(q, 0)
                * (cells.query_advice(a, 0) - cells.query_advice(b, 0))])
            return {"a": a, "b": b, "q": q}

        def synthesize(self, cfg, layouter):
            def assign(region):
                region.assign_fixed(cfg["q"], 0, pkg.Value.known(1))
                region.assign_advice(cfg["a"], 0, pkg.Value.known(0))
            layouter.assign_region("r", assign)

    return Incomplete


def two_lane_circuit(pkg):
    """tests/test_v1_planner.py's TwoLaneCircuit: column-disjoint regions
    that the V1 planner packs from row 0."""

    class TwoLaneCircuit:
        FLOOR_PLANNER = pkg.circuit.V1FloorPlanner

        @classmethod
        def configure(cls, meta):
            a0, a1 = meta.advice_column(), meta.advice_column()
            q0, q1 = meta.fixed_column(), meta.fixed_column()
            meta.enable_equality(a0)
            meta.enable_equality(a1)
            for a, q, name in ((a0, q0, "sq0"), (a1, q1, "sq1")):
                meta.create_gate(name, lambda c, a=a, q=q: [
                    c.query_fixed(q, 0) * (c.query_advice(a, 0)
                                           * c.query_advice(a, 0)
                                           - c.query_advice(a, 1))])
            return {"a0": a0, "a1": a1, "q0": q0, "q1": q1}

        def synthesize(self, cfg, layouter):
            def lane(col, qcol, base):
                def assign(region):
                    v = base
                    for i in range(4):
                        if i < 3:
                            region.assign_fixed(qcol, i, pkg.Value.known(1))
                        c = region.assign_advice(col, i, pkg.Value.known(v))
                        v = v * v % P
                    return c
                return assign

            ca = layouter.assign_region("laneA", lane(cfg["a0"], cfg["q0"], 3))
            cb = layouter.assign_region("laneB", lane(cfg["a1"], cfg["q1"], 3))

            def tie(region):
                x = region.assign_advice(cfg["a0"], 0,
                                         pkg.Value.known(pow(3, 8, P)))
                region.constrain_equal(x.cell, ca.cell)
                region.constrain_equal(x.cell, cb.cell)

            layouter.assign_region("tie", tie)

    return TwoLaneCircuit


# ------------------------------- test_dev_tools ---------------------------

def test_assigned_matches_field_arithmetic():
    rng = random.Random(21)
    A, J = TAS.Assigned, JAS.Assigned
    for _ in range(100):
        a, b = rng.randrange(P), rng.randrange(P)
        d1, d2 = rng.randrange(1, P), rng.randrange(1, P)
        x, y = A.rational(a, d1), A.rational(b, d2)
        jx, jy = J.rational(a, d1), J.rational(b, d2)
        xa = a * pow(d1, P - 2, P) % P
        ya = b * pow(d2, P - 2, P) % P
        got = [(x + y).evaluate(), (x - y).evaluate(), (x * y).evaluate(),
               (-x).evaluate(), x.square().evaluate(), x.invert().evaluate()]
        assert got == [(xa + ya) % P, (xa - ya) % P, xa * ya % P, (-xa) % P,
                       xa * xa % P, pow(xa, P - 2, P)]
        assert got == [(jx + jy).evaluate(), (jx - jy).evaluate(),
                       (jx * jy).evaluate(), (-jx).evaluate(),
                       jx.square().evaluate(), jx.invert().evaluate()]
    assert A.rational(5, 0).evaluate() == 0
    assert A.trivial(7).evaluate() == 7


def test_batch_invert_assigned():
    rng = random.Random(22)
    raw = [[(rng.randrange(P), rng.randrange(1, P)) for _ in range(10)],
           [(3, 1), (0, 1), (4, 0)]]
    outs = []
    for mod in (TAS, JAS):
        cols = [[mod.Assigned.rational(n, d) for n, d in col] for col in raw]
        out = mod.batch_invert_assigned(cols)
        for col_in, col_out in zip(cols, out):
            assert col_out == [a.evaluate() for a in col_in]
        outs.append(out)
    assert outs[0] == outs[1]


def test_simple_circuit_mock():
    TMP.MockProver.run(3, TSI.SimpleCircuit(a0=5, b0=9),
                       [[9, 5]]).assert_satisfied()
    text = _failure_text(PORT, 3, TSI.SimpleCircuit(a0=5, b0=9), [[9, 6]])
    assert text
    assert text == _failure_text(JAX, 3, JSI.SimpleCircuit(a0=5, b0=9),
                                 [[9, 6]])


def test_gates_printer():
    text = TGA.CircuitGates.collect(TSI.SimpleCircuit).render()
    assert "gate 'cross'" in text and "= 0" in text
    assert "permutation over:" in text
    assert text == JGA.CircuitGates.collect(JSI.SimpleCircuit).render()


@pytest.mark.parametrize("multiopen", ["gwc", "shplonk"])
def test_circuit_cost(multiopen):
    cost = TCO.CircuitCost.measure(3, TSI.SimpleCircuit, multiopen=multiopen)
    assert cost.n == 8 and cost.advice_commitments == 2
    assert cost.proof_bytes > 0 and "commitments" in cost.summary()
    if multiopen == "shplonk":
        assert cost.multiopen_commitments == 2
    ref = JCO.CircuitCost.measure(3, JSI.SimpleCircuit, multiopen=multiopen)
    assert cost.summary() == ref.summary()
    assert vars(cost) == vars(ref)


@pytest.mark.parametrize("misphased", [False, True])
def test_mock_prover_challenge_phases(misphased):
    port = challenge_circuit(PORT, misphased)(7)
    failures = TMP.MockProver.run(4, port, []).verify()
    if misphased:
        assert any(f.kind == "gate" for f in failures)
    else:
        assert failures == []
    assert TMP.emit_failures(failures) == _failure_text(
        JAX, 4, challenge_circuit(JAX, misphased)(7), [])


def test_mock_prover_unassigned_cell():
    failures = TMP.MockProver.run(4, incomplete_circuit(PORT)(), []).verify()
    assert any(f.kind == "unassigned" for f in failures)
    assert TMP.emit_failures(failures) == _failure_text(
        JAX, 4, incomplete_circuit(JAX)(), [])


def test_layout_renderer():
    a, b = [3, 7, 5], [4, 3, 11]
    port, ref = api_circuit(PORT)(a, b), api_circuit(JAX)(a, b)
    svg = TLA.render_svg(5, port)
    assert svg.startswith("<svg") and "rows" in svg
    assert svg == JLA.render_svg(5, ref)
    txt = TLA.render_text(5, port)
    assert "a" in txt.splitlines()[1]
    assert txt == JLA.render_text(5, ref)


@pytest.mark.parametrize("a,b,kinds", [
    ([3, 7, 13], [4, 3, 11], {"lookup"}),              # 13 not in the table
    ([3, 7, 5], [4, 9, 11], {"permutation", "gate"}),  # broken copy
])
def test_api_circuit_mock_failures(a, b, kinds):
    """tests/test_plonk_api.py::test_mock's failing witnesses: the same
    failures in both packages."""
    inst = [[a[0] * b[0] % P]]
    failures = TMP.MockProver.run(5, api_circuit(PORT)(a, b), inst).verify()
    assert {f.kind for f in failures} & kinds
    assert TMP.emit_failures(failures) == _failure_text(
        JAX, 5, api_circuit(JAX)(a, b), inst)


def test_typed_failures_and_emitter():
    c = TSI.SimpleCircuit(a0=5, b0=9)
    failures = TMP.MockProver.run(3, c, [[9, 6]]).verify()
    assert failures
    f = failures[0]
    assert f.kind in ("gate", "permutation")
    assert isinstance(f.location, TMP.FailureLocation)
    assert f.location.region == "simple" and f.location.row == f.row
    perm_fails = [g for g in failures if g.kind == "permutation"]
    assert perm_fails and perm_fails[0].cell_values
    assert perm_fails[0].column is not None
    for g in failures:
        if g.kind == "gate":
            assert g.constraint_index == 0
            assert g.cell_values and all(isinstance(v, int)
                                         for _, v in g.cell_values)
    text = TMP.emit_failures(failures)
    assert "is not satisfied in region 'simple'" in text
    assert "Assigned cell values:" in text
    ref = JMP.MockProver.run(3, JSI.SimpleCircuit(a0=5, b0=9),
                             [[9, 6]]).verify()
    assert [(g.kind, g.row, str(g.location), g.cell_values)
            for g in failures] == \
        [(g.kind, g.row, str(g.location), g.cell_values) for g in ref]


def test_typed_failure_static_lookup_location():
    from tests import test_e2e_cq as E
    from tests.test_torch_fixtures import MyCircuit
    from tests.test_torch_keyio_poseidon import _setup

    texts = []
    for pkg, base, tables in ((PORT, MyCircuit, _setup()[2:4]),
                              (JAX, E.MyCircuit, E._setup()[2:4])):
        sid = pkg.ir.StaticTableId

        class Bad(base):
            def synthesize(self, config, layouter, sid=sid, pkg=pkg):
                layouter.register_static_table(sid("table"), self.table)
                layouter.register_static_table(sid("table_2"), self.table_2)

                def assign(region):
                    region.assign_advice(config[0], 0, pkg.Value.known(7))
                    region.assign_advice(config[1], 0, pkg.Value.known(2))
                layouter.assign_region("lk", assign)

        failures = pkg.mock.MockProver.run(3, Bad(*tables), []).verify()
        sl = [f for f in failures if f.kind == "static_lookup"]
        assert sl and sl[0].location.region == "lk"
        assert sl[0].cell_values == [("input[0]", 7), ("input[1]", 2)]
        texts.append(pkg.mock.emit_failures(failures))
    assert texts[0] == texts[1]


# --------------------------------- test_layout ----------------------------

def test_capture_layout_regions_and_cells():
    cs, cap = TLA.capture_layout(4, TSI.SimpleCircuit(7, 9))
    assert len(cap.regions) == 1
    region = cap.regions[0]
    assert region["name"] == "simple"
    rows = [r for _, _, r in region["cells"]]
    assert min(rows) == 0 and max(rows) == 1
    assert {kind for kind, _, _ in cap.cells} == {"advice", "fixed"}
    assert len(cap.cells) == 4
    _, ref = JLA.capture_layout(4, JSI.SimpleCircuit(7, 9))
    assert cap.cells == ref.cells and cap.regions == ref.regions


def test_render_svg_writes_wellformed_file(tmp_path):
    import xml.etree.ElementTree as ET
    path = os.path.join(tmp_path, "simple.svg")
    svg = TLA.render_svg(4, TSI.SimpleCircuit(7, 9), path=path)
    assert os.path.exists(path)
    assert svg.startswith("<svg") and svg.rstrip().endswith("</svg>")
    assert "simple" in svg
    assert ">a0<" in svg and ">a1<" in svg and ">f0<" in svg and ">i0<" in svg
    ET.fromstring(svg)
    assert svg == JLA.render_svg(4, JSI.SimpleCircuit(7, 9))


def test_render_text_grid_and_dot_graph():
    text = TLA.render_text(4, TSI.SimpleCircuit(7, 9))
    lines = text.splitlines()
    assert lines[0] == "aafi"
    assert lines[1].startswith("aaf") and lines[2][1] == "a"
    assert text == JLA.render_text(4, JSI.SimpleCircuit(7, 9))
    dot = TLA.dot_graph(4, TSI.SimpleCircuit(7, 9))
    assert dot.startswith("digraph circuit {") and dot.endswith("}")
    assert "simple" in dot and "rows 0..1" in dot and "root -> r0;" in dot
    assert dot == JLA.dot_graph(4, JSI.SimpleCircuit(7, 9))


def test_render_png_writes_image(tmp_path):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "layout.png")
    assert TLA.render_png(4, TSI.SimpleCircuit(7, 9), path) == path
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


# ------------------------------ test_v1_planner ---------------------------

def test_slot_in_overlaps_disjoint_columns():
    shapes = []
    for name, cols, rows in (("a", {"colA"}, 4), ("b", {"colB"}, 4),
                             ("c", {"colA", "colB"}, 2)):
        r = TCI._RegionShape(name)
        r.columns, r.rows = cols, rows
        shapes.append(r)
    starts = TCI.slot_in_biggest_first(shapes)
    assert starts[0] == 0 and starts[1] == 0 and starts[2] == 4


def _v1_proof(pkg, seed):
    rng = random.Random(seed)
    params = pkg.params.ParamsKZG.setup_from_toxic_waste(5, rng.randrange(P))
    circuit = two_lane_circuit(pkg)()
    vk = pkg.plonk.keygen_vk(params, circuit)
    pk = pkg.plonk.keygen_pk(params, {}, [], vk, circuit)
    proof = pkg.plonk.create_proof(params, pk, [circuit], [[]], rng=rng,
                                   **pkg.prove_kw)
    ok = pkg.plonk.verify_proof(
        params, vk, pkg.strategy.AccumulatorStrategy(params, rng=rng), [[]],
        pkg.transcript.Blake2bRead(proof)).check()
    return proof, ok


def test_v1_mock_and_proof():
    """The V1-planned circuit is satisfied, and the port's proof (h on the
    device path, here the CPU) is the JAX package's, byte for byte."""
    TMP.MockProver.run(5, two_lane_circuit(PORT)(), []).assert_satisfied()
    proof, ok = _v1_proof(PORT, 55)
    ref, ref_ok = _v1_proof(JAX, 55)
    assert ok and ref_ok and proof == ref
