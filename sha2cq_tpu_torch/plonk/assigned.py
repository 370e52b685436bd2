"""Assigned: witness values with deferred division (reference plonk/assigned.rs).

The reference defers witness-cell divisions as Zero/Trivial/Rational(num, den)
so whole columns can be resolved with one batch inversion
(poly::batch_invert_assigned).  The same structure is kept here: circuit
gadgets can assign rationals freely and the prover resolves columns with a
single Montgomery-trick pass.

The port's own copy of sha2cq_tpu/plonk/assigned.py.
"""
from __future__ import annotations

from typing import List, Sequence, Union

from ..fields.host import FR_MOD, batch_inv

P = FR_MOD


class Assigned:
    """Zero | Trivial(v) | Rational(num, den)."""

    __slots__ = ("num", "den")

    def __init__(self, num: int = 0, den: int = 1):
        self.num = num % P
        self.den = den % P

    # -- constructors
    @staticmethod
    def zero() -> "Assigned":
        return Assigned(0, 1)

    @staticmethod
    def trivial(v: int) -> "Assigned":
        return Assigned(v, 1)

    @staticmethod
    def rational(num: int, den: int) -> "Assigned":
        return Assigned(num, den)

    def is_zero(self) -> bool:
        return self.num == 0 and self.den != 0

    # -- arithmetic (den tracked lazily; no inversions here)
    def _coerce(self, other) -> "Assigned":
        if isinstance(other, Assigned):
            return other
        return Assigned.trivial(other)

    def __add__(self, other):
        o = self._coerce(other)
        return Assigned((self.num * o.den + o.num * self.den) % P,
                        self.den * o.den % P)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return Assigned((self.num * o.den - o.num * self.den) % P,
                        self.den * o.den % P)

    def __rsub__(self, other):
        return self._coerce(other) - self

    def __mul__(self, other):
        o = self._coerce(other)
        return Assigned(self.num * o.num % P, self.den * o.den % P)

    __rmul__ = __mul__

    def __neg__(self):
        return Assigned((-self.num) % P, self.den)

    def invert(self) -> "Assigned":
        return Assigned(self.den, self.num)

    def square(self) -> "Assigned":
        return self * self

    def __eq__(self, other):
        o = self._coerce(other)
        # cross-multiplied equality (den == 0 treated as value 0, like the
        # reference's evaluate() which maps x/0 -> 0)
        return self.evaluate() == o.evaluate()

    def __hash__(self):
        return hash(self.evaluate())

    def evaluate(self) -> int:
        """Resolve to a field element (inverts den; den == 0 -> 0, matching
        assigned.rs evaluate semantics)."""
        if self.den == 1:
            return self.num
        if self.den == 0 or self.num == 0:
            return 0
        return self.num * pow(self.den, P - 2, P) % P

    def __repr__(self):
        return f"Assigned({self.num}/{self.den})"


def batch_invert_assigned(columns: Sequence[Sequence[Assigned]]) -> List[List[int]]:
    """Resolve grids of Assigned values with one inversion chain per call
    (reference poly::batch_invert_assigned)."""
    dens: List[int] = []
    for col in columns:
        for a in col:
            dens.append(a.den if a.den != 1 else 1)
    inv = batch_inv(dens, P)
    out: List[List[int]] = []
    i = 0
    for col in columns:
        resolved = []
        for a in col:
            d = inv[i]
            i += 1
            if a.den == 1:
                resolved.append(a.num)
            elif d == 0 or a.num == 0:
                resolved.append(0)
            else:
                resolved.append(a.num * d % P)
        out.append(resolved)
    return out
