"""The port's copies of utils/keyio.py and poseidon/ (and the Poseidon
transcript and setup bundle that reach them) against the JAX package's:
mirrors tests/test_keyio_poseidon.py's six tests, and holds the port's
serialised bytes, Poseidon digests, transcript challenges and proofs equal
to the JAX package's on the same inputs."""
import random

from sha2cq_tpu import plonk as RP
from sha2cq_tpu import poseidon as RPos
from sha2cq_tpu.plonk import create_proof as r_create_proof
from sha2cq_tpu.utils import keyio as RK
from sha2cq_tpu.utils import transcript as RT
from sha2cq_tpu_torch import plonk as TP
from sha2cq_tpu_torch import poseidon as TPos
from sha2cq_tpu_torch.curves import host as CH
from sha2cq_tpu_torch.fields.host import FR_MOD as P
from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG, TableSRS
from sha2cq_tpu_torch.poly.kzg.strategy import AccumulatorStrategy
from sha2cq_tpu_torch.utils import keyio as TK
from sha2cq_tpu_torch.utils import transcript as TT
from tests import test_e2e_cq as E
from tests.test_torch_fixtures import TABLE_2_VALUES, TABLE_VALUES, MyCircuit
from tests.test_torch_mxu_ntt import one_torch_thread  # noqa: F401


def _setup(k=3, seed=0x6371):
    """tests/test_e2e_cq._setup with the port's modules."""
    rng = random.Random(seed)
    s = rng.randrange(P)
    table_size = 16
    srs = TableSRS.setup_from_toxic_waste(table_size - 1, table_size, s)
    tables = []
    for values in (TABLE_VALUES, TABLE_2_VALUES):
        tv = TP.StaticTableValues(values, srs.g1)
        tables.append(TP.StaticTable(
            opened=tv, committed=tv.commit(len(srs.g1), srs.g2, 1 << k)))
    params = ParamsKZG.setup_from_toxic_waste(k, s)
    configs = {table_size: TP.StaticTableConfig(
        table_size, srs.g1_lagrange, srs.g_lagrange_opening_at_0,
        zv_g1=CH.g1_add(srs.g1_xn, CH.g1_neg(srs.g1[0])),
        xn1_g1=srs.g1[table_size - 1])}
    return rng, srs, tables[0], tables[1], params, configs, \
        srs.g1[(1 << k) + 1:]


def _keys(setup, circuit_cls, plonk):
    rng, srs, t1, t2, params, configs, b0 = setup
    circuit = circuit_cls(t1, t2)
    vk = plonk.keygen_vk(params, circuit)
    return circuit, vk, plonk.keygen_pk(params, configs, b0, vk, circuit)


def test_vk_pk_roundtrip_with_static_tables():
    ref, port = E._setup(3), _setup(3)
    r_circ, r_vk, r_pk = _keys(ref, E.MyCircuit, RP)
    circuit, vk, pk = _keys(port, MyCircuit, TP)
    params = port[4]
    assert TK.write_params(params) == RK.write_params(ref[4])
    assert TK.write_vk(vk) == RK.write_vk(r_vk)
    assert TK.write_pk(pk) == RK.write_pk(r_pk)

    params2 = TK.read_params(TK.write_params(params))
    assert params2.g == params.g and params2.s_g2 == params.s_g2
    vk2 = TK.read_vk(TK.write_vk(vk), circuit)
    assert vk2.transcript_repr == vk.transcript_repr
    assert vk2.fixed_commitments == vk.fixed_commitments
    assert set(vk2.static_table_mapping) == set(vk.static_table_mapping)
    pk2 = TK.read_pk(TK.write_pk(pk), circuit)
    rng = port[0]
    proof = TP.create_proof(params2, pk2, [circuit], [[]], rng=rng,
                            device="cpu")
    assert proof == r_create_proof(ref[4], r_pk, [r_circ], [[]], rng=ref[0])
    assert TP.verify_proof(params2, vk2, AccumulatorStrategy(params2, rng=rng),
                           [[]], TT.Blake2bRead(proof)).check()
    for size, cfg in pk.static_table_configs.items():
        assert pk2.static_table_configs[size].zv_g1 == cfg.zv_g1
        assert pk2.static_table_configs[size].xn1_g1 == cfg.xn1_g1


def test_poseidon_permutation_properties():
    p = TPos.Poseidon(t=3, r_f=8, r_p=57)
    r = RPos.Poseidon(t=3, r_f=8, r_p=57)
    assert p.constants == r.constants and p.mds == r.mds
    s1 = p.permute([1, 2, 3])
    assert s1 == r.permute([1, 2, 3])
    assert s1 == TPos.Poseidon(t=3, r_f=8, r_p=57).permute([1, 2, 3])
    assert p.permute([1, 2, 4]) != s1
    assert 0 < p.constants[0][0] < P
    assert all(any(v != 0 for v in row) for row in p.mds)


def test_poseidon_sponge():
    h1 = TPos.hash_elements([1, 2, 3, 4, 5])
    assert h1 == RPos.hash_elements([1, 2, 3, 4, 5])
    assert h1 == TPos.hash_elements([1, 2, 3, 4, 5]) != \
        TPos.hash_elements([1, 2, 3, 4, 6])
    assert 0 < h1 < P
    p = TPos.Poseidon()
    p.update([1, 2])
    p.update([3, 4, 5])
    assert p.squeeze() == h1


def test_table_bundle_roundtrip():
    ref, port = E._setup(3), _setup(3)
    _, srs, t1, t2, _, configs, b0 = port
    bundle = {"sigma": {"hi": t1, "lo": t2}}
    data = TK.write_table_bundle(bundle, configs, b0, srs)
    assert data == RK.write_table_bundle(
        {"sigma": {"hi": ref[2], "lo": ref[3]}}, ref[5], ref[6], ref[1])
    tables2, configs2, b02, srs2 = TK.read_table_bundle(data)
    assert set(tables2) == {"sigma"}
    for comp, orig in (("hi", t1), ("lo", t2)):
        got = tables2["sigma"][comp]
        assert got.opened.values == orig.opened.values
        assert got.opened.qs == orig.opened.qs
        assert got.opened.value_index_mapping == orig.opened.value_index_mapping
        assert got.committed == orig.committed
    for size in configs:
        assert configs2[size].g1_lagrange == configs[size].g1_lagrange
        assert (configs2[size].g_lagrange_opening_at_0
                == configs[size].g_lagrange_opening_at_0)
    assert b02 == b0
    assert srs2.g1 == srs.g1 and srs2.g2 == srs.g2
    assert srs2.g1_lagrange == srs.g1_lagrange
    assert srs2.g_lagrange_opening_at_0 == srs.g_lagrange_opening_at_0


def test_poseidon_transcript_e2e():
    ref, port = E._setup(3), _setup(3)
    r_circ, _, r_pk = _keys(ref, E.MyCircuit, RP)
    circuit, vk, pk = _keys(port, MyCircuit, TP)
    rng, params = port[0], port[4]
    proof = TP.create_proof(params, pk, [circuit], [[]], rng=rng,
                            transcript=TT.PoseidonWrite(), device="cpu")
    assert proof == r_create_proof(ref[4], r_pk, [r_circ], [[]], rng=ref[0],
                                   transcript=RT.PoseidonWrite())
    assert TP.verify_proof(params, vk, AccumulatorStrategy(params, rng=rng),
                           [[]], TT.PoseidonRead(proof)).check()
    try:
        bad = TP.verify_proof(params, vk, AccumulatorStrategy(params, rng=rng),
                              [[]], TT.Blake2bRead(proof)).check()
    except Exception:
        bad = False
    assert not bad
    a, b, r = TT.PoseidonWrite(), TT.Blake2bWrite(), RT.PoseidonWrite()
    for t in (a, b, r):
        t.common_scalar(7)
    ca = a.squeeze_challenge()
    assert ca == r.squeeze_challenge() and ca != b.squeeze_challenge()
    p = TT.PoseidonWrite()
    assert p.squeeze_challenge() != p.squeeze_challenge()


def test_keyio_formats():
    ref, port = E._setup(3), _setup(3)
    r_circ, r_vk, r_pk = _keys(ref, E.MyCircuit, RP)
    circuit, vk, pk = _keys(port, MyCircuit, TP)
    raw = TK.write_pk(pk, fmt="raw")
    for fmt in ("processed", "raw_unchecked"):
        data = TK.write_pk(pk, fmt=fmt)
        assert data == RK.write_pk(r_pk, fmt=fmt)
        pk2 = TK.read_pk(data, circuit)
        assert pk2.vk.transcript_repr == pk.vk.transcript_repr
        assert pk2.fixed_values == pk.fixed_values
        assert pk2.b0_g1_bound == pk.b0_g1_bound
        for tid in pk.static_table_mapping:
            assert (pk2.static_table_mapping[tid].qs
                    == pk.static_table_mapping[tid].qs)
    assert len(TK.write_pk(pk, fmt="processed")) < len(raw)
    vraw = TK.write_vk(vk, fmt="processed")
    assert vraw == RK.write_vk(r_vk, fmt="processed")
    assert TK.read_vk(vraw, circuit).transcript_repr == vk.transcript_repr
