"""Plain lookup tables of the SHA-256 circuit `circuit32`, for words of `w`
bits, built from the SHA-2 functions of sha2.py.

The circuit splits a word into two halves of w/2 bits, four pieces of w/4
bits and six limbs (the first w mod 6 one bit wider than w // 6), and looks
up, for every table family, the columns named here (row r of each in
natural order):
  idh                   i = r, for r < 2^(w/2): a half's range;
  xorp                  x, y, z = x ^ y over every pair of pieces;
  <sigma>h, <sigma>l    i = a half, b0..b3 = the pieces (low first) of the
                        sigma function of that half placed high (h) or low
                        (l) in a word, for bs0, bs1, ss0, ss1 (Sigma0,
                        Sigma1, sigma0, sigma1);
  maj<b>, ch<b>         x, y, z, f = maj or ch of every triple of b-bit
                        limbs, x slowest, for each limb width b.
A column's table is named s256_<w>_<family>_<column>.
"""
from __future__ import annotations

from typing import Dict, List

from . import sha2

SIGMAS = {"bs0": sha2.big_sigma0, "bs1": sha2.big_sigma1,
          "ss0": sha2.small_sigma0, "ss1": sha2.small_sigma1}


def limb_widths(w: int) -> List[int]:
    base, wide = divmod(w, 6)
    return [base + 1] * wide + [base] * (6 - wide)


def tables(w: int) -> Dict[str, List[int]]:
    """Every table column the circuit looks up: name -> values."""
    half, piece = w // 2, w // 4
    pmask = (1 << piece) - 1
    fams: Dict[str, Dict[str, List[int]]] = {}
    fams["idh"] = {"i": list(range(1 << half))}
    pairs = range(1 << (2 * piece))
    fams["xorp"] = {"x": [r >> piece for r in pairs],
                    "y": [r & pmask for r in pairs],
                    "z": [(r >> piece) ^ (r & pmask) for r in pairs]}
    for name, fn in SIGMAS.items():
        for suffix, shift in (("h", half), ("l", 0)):
            vals = [fn(x << shift, w) for x in range(1 << half)]
            cols = {"i": list(range(1 << half))}
            for j in range(4):
                cols[f"b{j}"] = [(v >> (j * piece)) & pmask for v in vals]
            fams[name + suffix] = cols
    for b in sorted(set(limb_widths(w))):
        m = (1 << b) - 1
        xs = [r >> (2 * b) for r in range(1 << (3 * b))]
        ys = [(r >> b) & m for r in range(1 << (3 * b))]
        zs = [r & m for r in range(1 << (3 * b))]
        fams[f"maj{b}"] = {"x": xs, "y": ys, "z": zs,
                           "f": [sha2.maj(x, y, z) for x, y, z in zip(xs, ys, zs)]}
        fams[f"ch{b}"] = {"x": xs, "y": ys, "z": zs,
                          "f": [sha2.ch(x, y, z, b) for x, y, z in zip(xs, ys, zs)]}
    return {f"s256_{w}_{fam}_{col}": vals
            for fam, cols in fams.items() for col, vals in cols.items()}
