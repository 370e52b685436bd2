"""The SHA2-on-CQ circuit — the piece the reference never finished.

(Reference state: sha/src/tables.rs has the table generators and
halo2_proofs has the CQ argument, but no circuit wires them together —
SURVEY.md §1-L5.  This module is that circuit, built TPU-side-by-design:
every bitwise op is ONE CQ vector lookup, all additions are field sums
reduced through decomposition-table lookups, and the whole compression is
64 rows + 4 shift rows.)

Layout (row r = state before round r; generic limb scheme first/second):

  state     : limbs of a,b,c,e,f,g (18 advice cols) + d,h word cols
  round     : s0=Sigma0(a), s1=Sigma1(e) via rot tables; per-limb maj/ch
              (3 lookups each, symmetric limb tables); t1sum/esum/asum field
              sums reduced via the 2^{w+3} decomposition table, whose output
              limbs ARE the next state's a/e limbs
  schedule  : W word + limbs (decW lookup), sigma0/sigma1 inputs copied from
              W limbs 15/2 rounds back (copy constraints, so blinding-row
              wraparound can never poison a lookup), wsum gate on rows>=16
  digest    : rows 64..67 shift b,c->d and f,g->h so the 8 final state words
              surface as d/h cells, copy-constrained to the instance column

14 CQ vector lookup arguments run on every row; padding rows are all-zero
tuples, which every table contains.

The port's own copy of sha2cq_tpu/models/sha/circuit.py.
"""
from __future__ import annotations

from typing import List, Sequence

from ...circuit import Value
from ...plonk.circuit_ir import ConstraintSystem, StaticTableId
from . import sha256 as model
from .tables import Limbs


def _limbs(l: Limbs, w: int) -> tuple:
    """word -> (x, y, z) high/mid/low limbs."""
    s = l.second
    return (w >> (2 * s), (w >> s) & ((1 << s) - 1), w & ((1 << s) - 1))


def table_ids(l: Limbs) -> dict:
    """All static table ids used by the circuit, keyed by short name."""
    names = {}
    for t in ("dsum", "rot0", "rot1", "ssig0", "ssig1",
              "majf", "majs", "chf", "chs"):
        names[t] = {c: StaticTableId(f"sha_{t}_{c}") for c in ("a", "x", "y", "z")}
    return names


class Sha2CqCircuit:
    """Proves knowledge of a 16-word message block whose (generic-width)
    SHA-2 compression output equals the public instance digest."""

    # class-level limb scheme; subclass or set before configure
    LIMBS: Limbs = None

    def __init__(self, message_words: Sequence[int], static_tables: dict):
        """static_tables: short-name -> {component -> StaticTable}."""
        self.message = list(message_words)
        assert len(self.message) == 16
        self.static_tables = static_tables

    # ------------------------------------------------------------------
    @classmethod
    def configure(cls, meta: ConstraintSystem):
        l = cls.LIMBS
        S1 = 1 << l.second
        S2 = 1 << (2 * l.second)
        ids = table_ids(l)

        adv = meta.advice_column
        cols = {}
        for name in ("ax ay az bx by bz cx cy cz ex ey ez fx fy fz gx gy gz "
                     "d h s0 s1 mx my mz chx chy chz t1sum t1x t1y t1z "
                     "esum nex ney nez asum nax nay naz "
                     "wword wsum wx wy wz s0inx s0iny s0inz sg0 "
                     "s1inx s1iny s1inz sg1").split():
            cols[name] = adv()
        inst = meta.instance_column()
        q_round = meta.fixed_column()
        q_trans = meta.fixed_column()
        q_first = meta.fixed_column()
        q_sched = meta.fixed_column()
        q_shift = meta.fixed_column()
        k_col = meta.fixed_column()

        for name in ("wx", "wy", "wz", "s0inx", "s0iny", "s0inz",
                     "s1inx", "s1iny", "s1inz", "d", "h"):
            meta.enable_equality(cols[name])
        meta.enable_equality(inst)

        # ---- static lookups (per-row; table columns share row indices)
        def lk(name, table, comps):
            meta.lookup_static(name, lambda c: [
                (c.query_advice(cols[col], 0), ids[table][comp])
                for col, comp in comps
            ])

        lk("rot0", "rot0", [("ax", "x"), ("ay", "y"), ("az", "z"), ("s0", "a")])
        lk("rot1", "rot1", [("ex", "x"), ("ey", "y"), ("ez", "z"), ("s1", "a")])
        lk("ssig0", "ssig0", [("s0inx", "x"), ("s0iny", "y"), ("s0inz", "z"), ("sg0", "a")])
        lk("ssig1", "ssig1", [("s1inx", "x"), ("s1iny", "y"), ("s1inz", "z"), ("sg1", "a")])
        lk("majX", "majf", [("ax", "x"), ("bx", "y"), ("cx", "z"), ("mx", "a")])
        lk("majY", "majs", [("ay", "x"), ("by", "y"), ("cy", "z"), ("my", "a")])
        lk("majZ", "majs", [("az", "x"), ("bz", "y"), ("cz", "z"), ("mz", "a")])
        lk("chX", "chf", [("ex", "x"), ("fx", "y"), ("gx", "z"), ("chx", "a")])
        lk("chY", "chs", [("ey", "x"), ("fy", "y"), ("gy", "z"), ("chy", "a")])
        lk("chZ", "chs", [("ez", "x"), ("fz", "y"), ("gz", "z"), ("chz", "a")])
        lk("decT1", "dsum", [("t1sum", "a"), ("t1x", "x"), ("t1y", "y"), ("t1z", "z")])
        lk("decE", "dsum", [("esum", "a"), ("nex", "x"), ("ney", "y"), ("nez", "z")])
        lk("decA", "dsum", [("asum", "a"), ("nax", "x"), ("nay", "y"), ("naz", "z")])
        lk("decW", "dsum", [("wsum", "a"), ("wx", "x"), ("wy", "y"), ("wz", "z")])

        # ---- gates
        def word(c, x, y, z, rot=0):
            return (c.query_advice(cols[x], rot) * S2
                    + c.query_advice(cols[y], rot) * S1
                    + c.query_advice(cols[z], rot))

        def round_gates(c):
            q = c.query_fixed(q_round, 0)
            CH = word(c, "chx", "chy", "chz")
            T1 = word(c, "t1x", "t1y", "t1z")
            MJ = word(c, "mx", "my", "mz")
            k = c.query_fixed(k_col, 0)
            return [
                q * (c.query_advice(cols["t1sum"], 0)
                     - (c.query_advice(cols["h"], 0) + c.query_advice(cols["s1"], 0)
                        + CH + k + c.query_advice(cols["wword"], 0))),
                q * (c.query_advice(cols["esum"], 0)
                     - (c.query_advice(cols["d"], 0) + T1)),
                q * (c.query_advice(cols["asum"], 0)
                     - (T1 + c.query_advice(cols["s0"], 0) + MJ)),
                q * (c.query_advice(cols["wword"], 0) - word(c, "wx", "wy", "wz")),
            ]

        meta.create_gate("sha_round", round_gates)

        def trans_gates(c):
            q = c.query_fixed(q_trans, 0)
            out = []
            for nxt, cur in [("ax", "nax"), ("ay", "nay"), ("az", "naz"),
                             ("bx", "ax"), ("by", "ay"), ("bz", "az"),
                             ("cx", "bx"), ("cy", "by"), ("cz", "bz"),
                             ("ex", "nex"), ("ey", "ney"), ("ez", "nez"),
                             ("fx", "ex"), ("fy", "ey"), ("fz", "ez"),
                             ("gx", "fx"), ("gy", "fy"), ("gz", "fz")]:
                out.append(q * (c.query_advice(cols[nxt], 1) - c.query_advice(cols[cur], 0)))
            out.append(q * (c.query_advice(cols["d"], 1) - word(c, "cx", "cy", "cz")))
            out.append(q * (c.query_advice(cols["h"], 1) - word(c, "gx", "gy", "gz")))
            return out

        meta.create_gate("sha_transition", trans_gates)

        iv = model.h_constants(l.word_len)
        iv_limbs = {
            "a": _limbs(l, iv[0]), "b": _limbs(l, iv[1]), "c": _limbs(l, iv[2]),
            "e": _limbs(l, iv[4]), "f": _limbs(l, iv[5]), "g": _limbs(l, iv[6]),
        }

        def first_gates(c):
            q = c.query_fixed(q_first, 0)
            out = []
            for wname, (x, y, z) in iv_limbs.items():
                for suffix, v in zip("xyz", (x, y, z)):
                    out.append(q * (c.query_advice(cols[wname + suffix], 0) - v))
            out.append(q * (c.query_advice(cols["d"], 0) - iv[3]))
            out.append(q * (c.query_advice(cols["h"], 0) - iv[7]))
            return out

        meta.create_gate("sha_init", first_gates)

        def sched_gates(c):
            q = c.query_fixed(q_sched, 0)
            return [q * (c.query_advice(cols["wsum"], 0)
                         - (c.query_advice(cols["wword"], -16)
                            + c.query_advice(cols["sg0"], 0)
                            + c.query_advice(cols["wword"], -7)
                            + c.query_advice(cols["sg1"], 0)))]

        meta.create_gate("sha_schedule", sched_gates)

        def shift_gates(c):
            q = c.query_fixed(q_shift, 0)
            out = []
            for nxt, cur in [("ax", "ax"), ("ay", "ay"), ("az", "az"),
                             ("bx", "ax"), ("by", "ay"), ("bz", "az"),
                             ("cx", "bx"), ("cy", "by"), ("cz", "bz"),
                             ("ex", "ex"), ("ey", "ey"), ("ez", "ez"),
                             ("fx", "ex"), ("fy", "ey"), ("fz", "ez"),
                             ("gx", "fx"), ("gy", "fy"), ("gz", "fz")]:
                out.append(q * (c.query_advice(cols[nxt], 1) - c.query_advice(cols[cur], 0)))
            out.append(q * (c.query_advice(cols["d"], 1) - word(c, "cx", "cy", "cz")))
            out.append(q * (c.query_advice(cols["h"], 1) - word(c, "gx", "gy", "gz")))
            return out

        meta.create_gate("sha_digest_shift", shift_gates)

        return {
            "cols": cols, "inst": inst,
            "q_round": q_round, "q_trans": q_trans, "q_first": q_first,
            "q_sched": q_sched, "q_shift": q_shift, "k_col": k_col,
        }

    # ------------------------------------------------------------------
    def synthesize(self, config, layouter):
        l = type(self).LIMBS
        w = l.word_len
        mask = (1 << w) - 1
        cols = config["cols"]
        ids = table_ids(l)

        for t, comps in self.static_tables.items():
            for comp, table in comps.items():
                layouter.register_static_table(ids[t][comp], table)

        K = model.k_constants(w)
        W = model.message_schedule(self.message, w)
        iv = model.h_constants(w)

        def assign_all(region):
            cells = {}

            def put(name, row, value):
                cells[(name, row)] = region.assign_advice(
                    cols[name], row, Value.known(value))

            def putf(col, row, value):
                region.assign_fixed(col, row, Value.known(value))

            # fixed selectors
            for r in range(64):
                putf(config["q_round"], r, 1)
                putf(config["k_col"], r, K[r])
            for r in range(63):
                putf(config["q_trans"], r, 1)
            putf(config["q_first"], 0, 1)
            for r in range(16, 64):
                putf(config["q_sched"], r, 1)
            for r in range(64, 67):
                putf(config["q_shift"], r, 1)

            state = list(iv)  # a,b,c,d,e,f,g,h

            def put_state(row, st):
                a, b, c, d, e, f, g, h = st
                for wname, val in (("a", a), ("b", b), ("c", c),
                                   ("e", e), ("f", f), ("g", g)):
                    x, y, z = _limbs(l, val)
                    put(wname + "x", row, x)
                    put(wname + "y", row, y)
                    put(wname + "z", row, z)
                put("d", row, d)
                put("h", row, h)
                # lookup-consistency columns (checked on every row)
                put("s0", row, model.big_sigma0(a, w))
                put("s1", row, model.big_sigma1(e, w))
                for i, suffix in enumerate("xyz"):
                    put("m" + suffix, row,
                        model.maj(_limbs(l, a)[i], _limbs(l, b)[i], _limbs(l, c)[i]))
                    ch_v = model.ch(_limbs(l, e)[i], _limbs(l, f)[i], _limbs(l, g)[i])
                    put("ch" + suffix, row, ch_v & ((1 << (l.first if i == 0 else l.second)) - 1))

            for r in range(64):
                a, b, c, d, e, f, g, h = state
                put_state(r, state)

                # schedule
                wr = W[r]
                put("wword", r, wr)
                wx, wy, wz = _limbs(l, wr)
                put("wx", r, wx)
                put("wy", r, wy)
                put("wz", r, wz)
                if r >= 16:
                    sg0 = model.small_sigma0(W[r - 15], w)
                    sg1 = model.small_sigma1(W[r - 2], w)
                    s0in = _limbs(l, W[r - 15])
                    s1in = _limbs(l, W[r - 2])
                    wsum = W[r - 16] + sg0 + W[r - 7] + sg1
                else:
                    sg0 = sg1 = 0
                    s0in = s1in = (0, 0, 0)
                    wsum = wr
                put("sg0", r, sg0)
                put("sg1", r, sg1)
                for suffix, v in zip("xyz", s0in):
                    put("s0in" + suffix, r, v)
                for suffix, v in zip("xyz", s1in):
                    put("s1in" + suffix, r, v)
                put("wsum", r, wsum)

                # round computation
                ch_word = model.ch(e, f, g) & mask
                maj_word = model.maj(a, b, c) & mask
                s1_word = model.big_sigma1(e, w)
                s0_word = model.big_sigma0(a, w)
                t1sum = h + s1_word + ch_word + K[r] + wr
                t1 = t1sum & mask
                put("t1sum", r, t1sum)
                for suffix, v in zip("xyz", _limbs(l, t1)):
                    put("t1" + suffix, r, v)
                esum = d + t1
                new_e = esum & mask
                put("esum", r, esum)
                for suffix, v in zip("xyz", _limbs(l, new_e)):
                    put("ne" + suffix, r, v)
                asum = t1 + s0_word + maj_word
                new_a = asum & mask
                put("asum", r, asum)
                for suffix, v in zip("xyz", _limbs(l, new_a)):
                    put("na" + suffix, r, v)

                state = [new_a, a, b, c, new_e, e, f, g]

            # shift rows 64..67: rotate words through d and h
            st = list(state)
            for row in range(64, 68):
                put_state(row, st)
                # zero the round/schedule columns on these rows
                for name in ("t1sum t1x t1y t1z esum nex ney nez asum nax nay "
                             "naz wword wsum wx wy wz s0inx s0iny s0inz sg0 "
                             "s1inx s1iny s1inz sg1").split():
                    put(name, row, 0)
                a, b, c, d, e, f, g, h = st
                # next: b<-a, c<-b, d<-c (a holds); f<-e, g<-f, h<-g (e holds)
                st = [a, a, b, c, e, e, f, g]

            # sigma-input copies (rows 16..63)
            for r in range(16, 64):
                for suffix in "xyz":
                    region.constrain_equal(
                        cells[("s0in" + suffix, r)].cell,
                        cells[("w" + suffix, r - 15)].cell)
                    region.constrain_equal(
                        cells[("s1in" + suffix, r)].cell,
                        cells[("w" + suffix, r - 2)].cell)

            return cells

        cells = layouter.assign_region("sha", assign_all)

        # digest: final state words surface as d/h cells on shift rows
        digest_cells = [
            cells[("d", 67)], cells[("d", 66)], cells[("d", 65)], cells[("d", 64)],
            cells[("h", 67)], cells[("h", 66)], cells[("h", 65)], cells[("h", 64)],
        ]
        for j, cell in enumerate(digest_cells):
            layouter.constrain_instance(cell.cell, config["inst"], j)

    # ------------------------------------------------------------------
    def expected_digest(self) -> List[int]:
        """Final compression state (the public instance)."""
        l = type(self).LIMBS
        return model.compress(model.h_constants(l.word_len), self.message, l.word_len)
