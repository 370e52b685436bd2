"""The committed crosscheck fixtures regenerated by the port: create_proof
with h on the device path (here the CPU: the butterfly route, k = 3..5,
and the plain versions of kernels K1, K3 and K4) reproduces each
crosscheck/fixtures/*/proof.bin byte for byte, with the seeds of
crosscheck/gen_fixtures.py.  The circuits are rebuilt from the port's
modules (a class has one identity per package), mirroring gen_fixtures.py
and tests/test_e2e_cq.py line for line; the fixtures cover CQ static
lookups, compressed selectors with a dynamic lookup, GWC and SHPLONK, and a
two-circuit proof."""
import os
import random

import pytest

from sha2cq_tpu_torch.circuit import Value
from sha2cq_tpu_torch.curves import host as CH
from sha2cq_tpu_torch.fields.host import FR_MOD as P
from sha2cq_tpu_torch.models.simple import SimpleCircuit
from sha2cq_tpu_torch.plonk import (StaticTable, StaticTableConfig,
                                    StaticTableId, StaticTableValues,
                                    create_proof, keygen_pk, keygen_vk)
from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG, TableSRS
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "crosscheck", "fixtures")

TABLE_VALUES = [0, 1, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32]
TABLE_2_VALUES = [0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _committed(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name, "proof.bin"), "rb") as f:
        return f.read()


def _device_proof(params, pk, circuits, instances, seed, **kw) -> bytes:
    return create_proof(params, pk, circuits, instances,
                        rng=random.Random(seed), h_device=True, device="cpu",
                        **kw)


class MyCircuit:
    """my_test.rs MyCircuit (tests/test_e2e_cq.py): two advice columns, one
    vector static lookup."""

    def __init__(self, table, table_2):
        self.table = table
        self.table_2 = table_2

    @classmethod
    def configure(cls, meta):
        advice = meta.advice_column()
        advice_2 = meta.advice_column()
        meta.lookup_static("lookup_bits", lambda cells: [
            (cells.query_advice(advice, 0), StaticTableId("table")),
            (cells.query_advice(advice_2, 0), StaticTableId("table_2")),
        ])
        return (advice, advice_2)

    def synthesize(self, config, layouter):
        layouter.register_static_table(StaticTableId("table"), self.table)
        layouter.register_static_table(StaticTableId("table_2"), self.table_2)

        def assign(region):
            region.assign_advice(config[0], 0, Value.known(30))
            region.assign_advice(config[0], 1, Value.known(6))
            region.assign_advice(config[1], 0, Value.known(15))
            region.assign_advice(config[1], 1, Value.known(3))

        layouter.assign_region("", assign)


class PlonkApiCircuit:
    """crosscheck/gen_fixtures.py PlonkApiCircuit: a fixed-gated mul gate,
    two compressible selectors, a dynamic lookup, a copy constraint and a
    public instance."""

    TABLE = list(range(12))
    A_VALS = [3, 7, 5, 8, 9]
    B_VALS = [4, 3, 11, 2, 4]

    @classmethod
    def configure(cls, meta):
        a = meta.advice_column()
        b = meta.advice_column()
        c = meta.advice_column()
        q_mul = meta.fixed_column()
        table = meta.lookup_table_column()
        inst = meta.instance_column()
        s_add = meta.selector()
        s_sub = meta.selector()
        for col in (a, b, c, inst):
            meta.enable_equality(col)
        meta.create_gate("mul", lambda cells: [
            cells.query_fixed(q_mul, 0)
            * (cells.query_advice(a, 0) * cells.query_advice(b, 0)
               - cells.query_advice(c, 0))])
        meta.create_gate("add", lambda cells: [
            cells.query_selector(s_add)
            * (cells.query_advice(a, 0) + cells.query_advice(b, 0)
               - cells.query_advice(c, 0))])
        meta.create_gate("sub", lambda cells: [
            cells.query_selector(s_sub)
            * (cells.query_advice(a, 0) - cells.query_advice(b, 0)
               - cells.query_advice(c, 0))])
        meta.lookup("range", lambda cells: [
            (cells.query_advice(a, 0), table)])
        return {"a": a, "b": b, "c": c, "q_mul": q_mul, "table": table,
                "inst": inst, "s_add": s_add, "s_sub": s_sub}

    def __init__(self, a_vals=None, b_vals=None):
        if a_vals is not None:
            self.A_VALS = a_vals
        if b_vals is not None:
            self.B_VALS = b_vals
        assert self.B_VALS[1] == self.A_VALS[0]

    def synthesize(self, cfg, layouter):
        def fill_table(table):
            for i, v in enumerate(self.TABLE):
                table.assign_cell(cfg["table"], i, Value.known(v))
        layouter.assign_table("range", fill_table)

        cells = {}

        def assign(region):
            for i, (av, bv) in enumerate(zip(self.A_VALS, self.B_VALS)):
                if i < 3:
                    region.assign_fixed(cfg["q_mul"], i, Value.known(1))
                    cv = av * bv % P
                elif i == 3:
                    region.enable_selector(cfg["s_add"], i)
                    cv = (av + bv) % P
                else:
                    region.enable_selector(cfg["s_sub"], i)
                    cv = (av - bv) % P
                ca = region.assign_advice(cfg["a"], i, Value.known(av))
                cb = region.assign_advice(cfg["b"], i, Value.known(bv))
                cc = region.assign_advice(cfg["c"], i, Value.known(cv))
                cells[i] = (ca, cb, cc)
            region.constrain_equal(cells[0][0].cell, cells[1][1].cell)
            return cells

        got = layouter.assign_region("rows", assign)
        layouter.constrain_instance(got[0][2].cell, cfg["inst"], 0)


def test_mytest_fixture():
    k, table_size = 3, 16
    s = random.Random(0x6371).randrange(P)
    srs = TableSRS.setup_from_toxic_waste(table_size - 1, table_size, s)
    tables = []
    for values in (TABLE_VALUES, TABLE_2_VALUES):
        tv = StaticTableValues(values, srs.g1)
        tables.append(StaticTable(
            opened=tv, committed=tv.commit(len(srs.g1), srs.g2, 1 << k)))
    params = ParamsKZG.setup_from_toxic_waste(k, s)
    configs = {table_size: StaticTableConfig(
        table_size, srs.g1_lagrange, srs.g_lagrange_opening_at_0,
        zv_g1=CH.g1_add(srs.g1_xn, CH.g1_neg(srs.g1[0])),
        xn1_g1=srs.g1[table_size - 1])}
    circuit = MyCircuit(*tables)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, srs.g1[(1 << k) + 1:], vk, circuit)
    assert _device_proof(params, pk, [circuit], [[]], 0x60) == \
        _committed("mytest")


def test_simple_fixture():
    s = random.Random(0x73696d).randrange(P)
    params = ParamsKZG.setup_from_toxic_waste(4, s)
    circuit = SimpleCircuit(7, 11)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, {}, [], vk, circuit)
    assert _device_proof(params, pk, [circuit], [[[11, 7]]], 0x61) == \
        _committed("simple")


def _plonkapi_key():
    s = random.Random(0x706170).randrange(P)
    params = ParamsKZG.setup_from_toxic_waste(5, s)
    circuit = PlonkApiCircuit()
    vk = keygen_vk(params, circuit, compress_selectors=True)
    pk = keygen_pk(params, {}, [], vk, circuit, compress_selectors=True)
    return params, pk, circuit


@pytest.mark.parametrize("scheme", ["gwc", "shplonk"])
def test_plonkapi_fixture(scheme):
    params, pk, circuit = _plonkapi_key()
    inst = [circuit.A_VALS[0] * circuit.B_VALS[0] % P]
    assert _device_proof(params, pk, [circuit], [[inst]], 0x62,
                         multiopen=scheme) == _committed(f"plonkapi_{scheme}")


def test_plonkapi_multi_circuit_fixture():
    params, pk, c1 = _plonkapi_key()
    a2, b2 = [6, 2, 10, 1, 7], [5, 6, 9, 8, 2]
    c2 = PlonkApiCircuit(a2, b2)
    instances = [[[c1.A_VALS[0] * c1.B_VALS[0] % P]], [[a2[0] * b2[0] % P]]]
    assert _device_proof(params, pk, [c1, c2], instances, 0x63,
                         multiopen="gwc") == _committed("plonkapi_multi")
