"""The generator of witness-column traffic (traffic/circuit32_advice_*.json),
and the check of one commitment request, importable by the check's worker
processes.

A mix gives `rows` (the domain, 2^k), `used_rows` (the rows the circuit's
blocks fill), `blinded_rows` (blinding_factors + 1, the prover's random
rows at the end of every advice column) and `columns`, one profile per
advice column of the circuit in its configure order: `bits`, the widest
value, and `zero_share`, the share of zero rows among the used rows.
Request i of a seed is column i mod len(columns), drawn from (seed, i)
alone: its used rows zero with that share and else uniform over
[1, 2^bits), the rows up to the blinded ones zero (unassigned), the
blinded rows uniform over [0, r); as (rows, 4) little-endian uint64 words,
the prover's buffer layout.

`derive_profile` reads the profiles off a real witness of the circuit
(the program's mock prover), as the mix's file states.
"""
from __future__ import annotations

import hashlib

import numpy as np

from cardbench import scalars
from cardbench.reference import kzg_lagrange
from cardbench.roofline import work


def column_of(index, traffic: dict) -> dict:
    """The profile of request `index` (the warm-up's is column 0)."""
    cols = traffic["columns"]
    return cols[index % len(cols) if isinstance(index, int) else 0]


def request_words(seed: int, index, traffic: dict) -> np.ndarray:
    """The values of request `index` of `seed` as (rows, 4) words."""
    tag = hashlib.sha256(f"{seed}:{index}:witness".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(tag, "little"))
    n, used = traffic["rows"], traffic["used_rows"]
    blinded = traffic["blinded_rows"]
    if not used <= n - blinded:
        raise ValueError(f"{used} used rows and {blinded} blinded of {n}")
    prof = column_of(index, traffic)
    out = np.zeros((n, 4), dtype=np.uint64)
    vals = rng.integers(1, 1 << prof["bits"], size=used, dtype=np.uint64,
                        endpoint=False) if prof["bits"] > 1 else \
        np.ones(used, dtype=np.uint64)
    vals[rng.random(used) < prof["zero_share"]] = 0
    out[:used, 0] = vals
    out[n - blinded:] = scalars.draw(rng, blinded, "uniform")
    return out


_LAGRANGE = {}


def value_and_live(job) -> tuple:
    """For job (seed, index, traffic, s): sum_i v_i L_i(s) mod r of the
    request's values, and their nonzero digits at the roofline's window
    bits."""
    seed, index, traffic, s = job
    key = (s, traffic["rows"])
    if key not in _LAGRANGE:
        _LAGRANGE.clear()
        _LAGRANGE[key] = kzg_lagrange.lagrange_at(s, traffic["rows"])
    words = request_words(seed, index, traffic)
    nonzero = words[np.flatnonzero(words.any(axis=1))]   # zero rows: no digit
    return (kzg_lagrange.evaluate_words(words, _LAGRANGE[key]),
            work.live_digits(nonzero))


def derive_profile(blocks: int, seed: int) -> list:
    """Each advice column's `name`, `bits` and `zero_share` (rounded to six
    places) over the rows of `blocks` random message blocks, from the
    program's mock-prover witness of circuit32 at 32-bit words."""
    import random

    from sha2cq_tpu_torch.dev.mock_prover import MockProver
    from sha2cq_tpu_torch.models.sha import circuit32
    from sha2cq_tpu_torch.plonk.circuit_ir import ConstraintSystem

    rng = random.Random(seed)
    circ = circuit32.Sha256Circuit(
        [[rng.randrange(1 << 32) for _ in range(16)] for _ in range(blocks)], {})
    rows = circ.rows_needed()
    cs = ConstraintSystem()
    config = circuit32.Sha256Circuit.configure(cs)
    k = max(cs.minimum_rows(), rows + cs.blinding_factors() + 1).bit_length()
    mock = MockProver.run(k, circ, [circ.expected_digest()])
    names = {col.index: name for name, col in config["cols"].items()}
    out = []
    for i in range(cs.num_advice_columns):
        vals = [int(v) for v in mock.a.advice[i][:rows]]
        out.append({"name": names[i],
                    "bits": max(v.bit_length() for v in vals),
                    "zero_share": round(vals.count(0) / rows, 6)})
    return out
