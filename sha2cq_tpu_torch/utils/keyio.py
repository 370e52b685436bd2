"""Key / params (de)serialization — checkpoint & resume.

Mirrors the reference's VK/PK persistence (plonk.rs:93-180, 349-418,
helpers.rs SerdeFormat) with one deliberate improvement: static (CQ) tables
ARE serialized.  The reference stubs them out on read with empty maps
(plonk.rs:161-163, 384-402 — a marked TODO/FIXME), which breaks resume for
exactly the artifacts that are hours of preprocessing at 2^20+; here the
committed halves ride with the VK and the opened halves (including the FK
quotient commitments) with the PK.

Like the reference, reading a key requires the circuit (configure() is
re-run to rebuild the constraint system); the byte payload carries only
what cannot be re-derived.

Formats (SerdeFormat parity, helpers.rs:8-19): every artifact starts with a
1-byte format tag —
  0 = RawBytes          (64B/128B uncompressed points, on-curve validated)
  1 = RawBytesUnchecked (same bytes, no validation — trusted-source fast path)
  2 = Processed         (32B/64B compressed points; decompression is
                         inherently on-curve validating)
plus little-endian u32 length prefixes and 32B LE scalars throughout.

The port's own copy of sha2cq_tpu/utils/keyio.py.
"""
from __future__ import annotations

import io
import struct
from typing import Dict, List

from ..curves.host import G1Affine, G2Affine
from ..fields.host import FR_MOD
from ..plonk.circuit_ir import ConstraintSystem, StaticTableId
from ..plonk.keygen import keygen_vk  # noqa: F401 (doc reference)
from ..plonk.keys import PermutationProvingKey, ProvingKey, VerifyingKey
from ..plonk.static_tables import (StaticCommittedTable, StaticTableConfig,
                                   StaticTableValues)
from ..poly.domain import EvaluationDomain
from ..poly.kzg.params import ParamsKZG
from . import serde


FMT_RAW, FMT_RAW_UNCHECKED, FMT_PROCESSED = 0, 1, 2
_FMT_NAMES = {"raw": FMT_RAW, "raw_unchecked": FMT_RAW_UNCHECKED,
              "processed": FMT_PROCESSED}


class _W:
    def __init__(self, fmt: int = 0):
        self.b = io.BytesIO()
        self.fmt = fmt
        self.b.write(bytes([fmt]))

    def u32(self, v: int):
        self.b.write(struct.pack("<I", v))

    def scalar(self, v: int):
        self.b.write(serde.fr_to_bytes(v))

    def g1(self, pt: G1Affine):
        if self.fmt == FMT_PROCESSED:
            self.b.write(serde.g1_to_bytes(pt))
        else:
            self.b.write(serde.g1_to_raw_bytes(pt))

    def g2(self, pt: G2Affine):
        if self.fmt == FMT_PROCESSED:
            self.b.write(serde.g2_to_bytes(pt))
        else:
            self.b.write(serde.g2_to_raw_bytes(pt))

    def scalars(self, vs):
        self.u32(len(vs))
        for v in vs:
            self.scalar(v)

    def g1s(self, pts):
        self.u32(len(pts))
        for p in pts:
            self.g1(p)

    def string(self, s: str):
        raw = s.encode()
        self.u32(len(raw))
        self.b.write(raw)

    def bytes(self) -> bytes:
        return self.b.getvalue()


class _R:
    def __init__(self, data: bytes):
        self.b = io.BytesIO(data)
        self.fmt = self.b.read(1)[0]
        if self.fmt not in (FMT_RAW, FMT_RAW_UNCHECKED, FMT_PROCESSED):
            raise ValueError(f"unknown keyio format tag {self.fmt}")

    def u32(self) -> int:
        return struct.unpack("<I", self.b.read(4))[0]

    def scalar(self) -> int:
        return serde.fr_from_bytes(self.b.read(32))

    def g1(self) -> G1Affine:
        if self.fmt == FMT_PROCESSED:
            return serde.g1_from_bytes(self.b.read(32))
        return serde.g1_from_raw_bytes(self.b.read(64),
                                       check=self.fmt == FMT_RAW)

    def g2(self) -> G2Affine:
        if self.fmt == FMT_PROCESSED:
            return serde.g2_from_bytes(self.b.read(64))
        return serde.g2_from_raw_bytes(self.b.read(128),
                                       check=self.fmt == FMT_RAW)

    def scalars(self) -> List[int]:
        return [self.scalar() for _ in range(self.u32())]

    def g1s(self) -> List[G1Affine]:
        return [self.g1() for _ in range(self.u32())]

    def string(self) -> str:
        n = self.u32()
        return self.b.read(n).decode()


# ------------------------------- params -------------------------------------

def write_params(params: ParamsKZG, fmt: str = "raw") -> bytes:
    w = _W(_FMT_NAMES[fmt])
    w.u32(params.k)
    w.g1s(params.g)
    w.g1s(params.g_lagrange)
    w.g2(params.g2)
    w.g2(params.s_g2)
    return w.bytes()


def read_params(data: bytes) -> ParamsKZG:
    r = _R(data)
    k = r.u32()
    return ParamsKZG(k=k, n=1 << k, g=r.g1s(), g_lagrange=r.g1s(),
                     g2=r.g2(), s_g2=r.g2())


# --------------------------------- VK ---------------------------------------

def write_vk(vk: VerifyingKey, fmt: str = "raw") -> bytes:
    w = _W(_FMT_NAMES[fmt])
    w.u32(vk.domain.k)
    w.u32(vk.cs_degree)
    w.g1s(vk.fixed_commitments)
    w.g1s(vk.permutation_commitments)
    w.u32(len(vk.selectors))
    for col in vk.selectors:
        w.u32(len(col))
        self_bytes = bytes(1 if b else 0 for b in col)
        w.b.write(self_bytes)
    w.u32(len(vk.static_table_mapping))
    for tid, t in vk.static_table_mapping.items():
        w.string(tid.name)
        w.g2(t.zv)
        w.g2(t.t)
        w.g2(t.x_b0_bound)
        w.u32(t.size)
    return w.bytes()


def read_vk(data: bytes, circuit) -> VerifyingKey:
    r = _R(data)
    k = r.u32()
    _deg = r.u32()
    fixed_commitments = r.g1s()
    permutation_commitments = r.g1s()
    selectors = []
    for _ in range(r.u32()):
        n = r.u32()
        selectors.append([b == 1 for b in r.b.read(n)])
    static = {}
    for _ in range(r.u32()):
        name = r.string()
        static[StaticTableId(name)] = StaticCommittedTable(
            zv=r.g2(), t=r.g2(), x_b0_bound=r.g2(), size=r.u32())

    cs = ConstraintSystem()
    type(circuit).configure(cs)
    cs.convert_selectors_to_fixed(selectors)
    domain = EvaluationDomain(cs.degree(), k)
    return VerifyingKey(domain, fixed_commitments, permutation_commitments,
                        cs, selectors, static)


# --------------------------------- PK ---------------------------------------

def write_pk(pk: ProvingKey, fmt: str = "raw") -> bytes:
    w = _W(_FMT_NAMES[fmt])
    # embed the VK payload without its redundant inner format tag
    w.b.write(write_vk(pk.vk, fmt)[1:])
    for field in (pk.l0, pk.l_last, pk.l_active_row):
        w.scalars(field)
    for group in (pk.fixed_values, pk.fixed_polys, pk.fixed_cosets,
                  pk.permutation.permutations, pk.permutation.polys,
                  pk.permutation.cosets):
        w.u32(len(group))
        for col in group:
            w.scalars(col)
    w.u32(len(pk.static_table_mapping))
    for tid, t in pk.static_table_mapping.items():
        w.string(tid.name)
        w.scalars(t.values)
        w.g1s(t.qs)
    w.u32(len(pk.static_table_configs))
    for size, cfg in pk.static_table_configs.items():
        w.u32(size)
        w.g1s(cfg.g1_lagrange)
        w.g1s(cfg.g_lagrange_opening_at_0)
        # zk blinding material ([Z_V]_1, [x^{N-1}]_1); identity bytes = None
        w.g1(getattr(cfg, "zv_g1", None))
        w.g1(getattr(cfg, "xn1_g1", None))
    w.g1s(pk.b0_g1_bound)
    return w.bytes()


def read_pk(data: bytes, circuit) -> ProvingKey:
    # VK is a prefix; parse it by replaying the reader
    r = _R(data)
    k = r.u32()
    _deg = r.u32()
    fixed_commitments = r.g1s()
    permutation_commitments = r.g1s()
    selectors = []
    for _ in range(r.u32()):
        n = r.u32()
        selectors.append([b == 1 for b in r.b.read(n)])
    static_committed = {}
    for _ in range(r.u32()):
        name = r.string()
        static_committed[StaticTableId(name)] = StaticCommittedTable(
            zv=r.g2(), t=r.g2(), x_b0_bound=r.g2(), size=r.u32())
    cs = ConstraintSystem()
    type(circuit).configure(cs)
    cs.convert_selectors_to_fixed(selectors)
    domain = EvaluationDomain(cs.degree(), k)
    vk = VerifyingKey(domain, fixed_commitments, permutation_commitments,
                      cs, selectors, static_committed)

    l0 = r.scalars()
    l_last = r.scalars()
    l_active = r.scalars()

    def group():
        return [r.scalars() for _ in range(r.u32())]

    fixed_values = group()
    fixed_polys = group()
    fixed_cosets = group()
    sigma_lag = group()
    sigma_polys = group()
    sigma_cosets = group()

    static_opened = {}
    for _ in range(r.u32()):
        name = r.string()
        values = r.scalars()
        qs = r.g1s()
        t = StaticTableValues.__new__(StaticTableValues)
        t.size = len(values)
        t.values = values
        mapping = {v: i for i, v in enumerate(values)}
        t.value_index_mapping = mapping if len(mapping) == len(values) else None
        t.qs = qs
        static_opened[StaticTableId(name)] = t

    configs = {}
    for _ in range(r.u32()):
        size = r.u32()
        configs[size] = StaticTableConfig(size, r.g1s(), r.g1s(),
                                          zv_g1=r.g1(), xn1_g1=r.g1())
    b0 = r.g1s()

    return ProvingKey(
        vk=vk, l0=l0, l_last=l_last, l_active_row=l_active,
        fixed_values=fixed_values, fixed_polys=fixed_polys,
        fixed_cosets=fixed_cosets,
        permutation=PermutationProvingKey(sigma_lag, sigma_polys, sigma_cosets),
        static_table_mapping=static_opened,
        static_table_configs=configs,
        b0_g1_bound=b0,
    )


# --------------------------- CQ setup bundle ---------------------------------
# Shippable artifact for the SHA-256 (circuit32) preprocessing: the reference
# DROPS static-table state on key read (plonk.rs:161-163, 384-402 TODO/FIXME),
# which makes its multi-hour table preprocessing non-checkpointable; the
# pickle caches in models/sha/setup32.py are resume-oriented but Python/
# machine-local.  This is the portable raw-bytes format for the whole
# (static_tables, configs, b0_g1_bound, srs) tuple returned by
# build_sha256_setup — same wire primitives as the key format above.

def _write_static_table(w: _W, t) -> None:
    w.u32(1 if t.opened is not None else 0)
    if t.opened is not None:
        w.scalars(t.opened.values)
        w.g1s(t.opened.qs)
    w.u32(1 if t.committed is not None else 0)
    if t.committed is not None:
        c = t.committed
        w.g2(c.zv)
        w.g2(c.t)
        w.g2(c.x_b0_bound)
        w.u32(c.size)


def _read_static_table(r: _R):
    from ..plonk.static_tables import StaticTable
    opened = None
    if r.u32():
        values = r.scalars()
        qs = r.g1s()
        opened = StaticTableValues.__new__(StaticTableValues)
        opened.size = len(values)
        opened.values = values
        mapping = {v: i for i, v in enumerate(values)}
        opened.value_index_mapping = (mapping if len(mapping) == len(values)
                                      else None)
        opened.qs = qs
    committed = None
    if r.u32():
        committed = StaticCommittedTable(
            zv=r.g2(), t=r.g2(), x_b0_bound=r.g2(), size=r.u32())
    return StaticTable(opened=opened, committed=committed)


def write_table_bundle(static_tables, configs, b0_g1_bound, srs,
                       fmt: str = "raw") -> bytes:
    """static_tables: {family: {component: StaticTable}} (setup32 layout)."""
    w = _W(_FMT_NAMES[fmt])
    w.u32(len(static_tables))
    for fam, columns in static_tables.items():
        w.string(fam)
        w.u32(len(columns))
        for comp, table in columns.items():
            w.string(comp)
            _write_static_table(w, table)
    w.u32(len(configs))
    for size, cfg in configs.items():
        w.u32(size)
        w.g1s(cfg.g1_lagrange)
        w.g1s(cfg.g_lagrange_opening_at_0)
        w.g1(getattr(cfg, "zv_g1", None))
        w.g1(getattr(cfg, "xn1_g1", None))
    w.g1s(b0_g1_bound)
    w.g1s(srs.g1)
    w.g1s(srs.g1_lagrange)
    w.g1s(srs.g_lagrange_opening_at_0)
    w.u32(len(srs.g2))
    for p in srs.g2:
        w.g2(p)
    w.g1(getattr(srs, "g1_xn", None))
    return w.bytes()


def read_table_bundle(data: bytes):
    from ..poly.kzg.params import TableSRS
    r = _R(data)
    static_tables = {}
    for _ in range(r.u32()):
        fam = r.string()
        columns = {}
        for _ in range(r.u32()):
            comp = r.string()
            columns[comp] = _read_static_table(r)
        static_tables[fam] = columns
    configs = {}
    for _ in range(r.u32()):
        size = r.u32()
        configs[size] = StaticTableConfig(size, r.g1s(), r.g1s(),
                                          zv_g1=r.g1(), xn1_g1=r.g1())
    b0 = r.g1s()
    g1 = r.g1s()
    g1_lagrange = r.g1s()
    opening0 = r.g1s()
    g2 = [r.g2() for _ in range(r.u32())]
    g1_xn = r.g1()
    srs = TableSRS(g1=g1, g1_lagrange=g1_lagrange,
                   g_lagrange_opening_at_0=opening0, g2=g2, g1_xn=g1_xn)
    return static_tables, configs, b0, srs
