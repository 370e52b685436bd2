"""Poseidon hash over BN254 Fr (reference primitives/poseidon/).

Bit-faithful reimplementation of the reference's parameter generation and
permutation semantics:
  - Grain LFSR seeding/self-shrinking exactly as grain.rs:30-160 (80-bit
    init header, 160 discarded bits, MSB-first field sampling with rejection
    for round constants, from_bytes_wide without rejection for MDS seeds)
  - Cauchy MDS matrix A[i][j] = 1/(x_i + y_j) (spec.rs:163)
  - permutation in the unoptimized ("SpecRef") form the reference
    cross-tests its sparse-MDS optimization against
    (permutation.rs:59-81): per round add constants, sbox (x^5, full or
    first-element-only), MDS apply
  - the variable-length sponge with trailing-1 padding (poseidon.rs:7-75)

The reference crate is standalone/unused by its pipeline; here it is the
designated algebraic transcript hash for recursion work.

The port's own copy of sha2cq_tpu/poseidon/__init__.py.
"""
from __future__ import annotations

from typing import List, Sequence

from ..fields.host import FR_MOD, batch_inv

P = FR_MOD
NUM_BITS = 254


class _Grain:
    def __init__(self, t: int, r_f: int, r_p: int):
        bits: List[bool] = []

        def append(n, val):
            for i in range(n - 1, -1, -1):
                bits.append((val >> i) & 1 != 0)

        append(2, 1)           # field type: prime
        append(4, 0)           # sbox: alpha
        append(12, NUM_BITS)   # field size
        append(12, t)
        append(10, r_f)
        append(10, r_p)
        append(30, (1 << 30) - 1)
        assert len(bits) == 80
        self.bits = bits
        for _ in range(160):
            self._new_bit()

    def _new_bit(self) -> bool:
        b = self.bits[0]
        for pos in (62, 51, 38, 23, 13):
            b ^= self.bits[pos]
        self.bits.pop(0)
        self.bits.append(b)
        return b

    def _next(self) -> bool:
        # self-shrinking: only emit a bit when the preceding bit is 1
        while not self._new_bit():
            self._new_bit()
        return self._new_bit()

    def _take_int(self) -> int:
        """NUM_BITS bits, MSB first."""
        v = 0
        for _ in range(NUM_BITS):
            v = (v << 1) | (1 if self._next() else 0)
        return v

    def next_field_element(self) -> int:
        while True:
            v = self._take_int()
            if v < P:
                return v

    def next_field_element_without_rejection(self) -> int:
        return self._take_int() % P


def _generate(t: int, r_f: int, r_p: int):
    assert t > 1 and r_f % 2 == 0
    g = _Grain(t, r_f, r_p)
    constants = [[g.next_field_element() for _ in range(t)]
                 for _ in range(r_f + r_p)]
    xs = [g.next_field_element_without_rejection() for _ in range(t)]
    ys = [g.next_field_element_without_rejection() for _ in range(t)]
    denoms = [(x + y) % P for x in xs for y in ys]
    invs = batch_inv(denoms, P)
    mds = [[invs[i * t + j] for j in range(t)] for i in range(t)]
    return constants, mds


class Poseidon:
    """Sponge with rate = t - 1 (reference Poseidon<F, T, RATE>)."""

    def __init__(self, t: int = 3, r_f: int = 8, r_p: int = 57):
        self.t = t
        self.rate = t - 1
        self.r_f = r_f
        self.r_p = r_p
        self.constants, self.mds = _generate(t, r_f, r_p)
        self.state = [0] * t
        self.absorbing: List[int] = []

    # -- permutation (SpecRef semantics)
    def permute(self, state: List[int]) -> List[int]:
        half = self.r_f // 2

        def sbox(x):
            x2 = x * x % P
            return x2 * x2 % P * x % P

        def mds_apply(s):
            return [sum(a * v for a, v in zip(row, s)) % P for row in self.mds]

        for r in range(half):
            state = [(v + c) % P for v, c in zip(state, self.constants[r])]
            state = [sbox(v) for v in state]
            state = mds_apply(state)
        for r in range(half, half + self.r_p):
            state = [(v + c) % P for v, c in zip(state, self.constants[r])]
            state = [sbox(state[0])] + state[1:]
            state = mds_apply(state)
        for r in range(half + self.r_p, self.r_f + self.r_p):
            state = [(v + c) % P for v, c in zip(state, self.constants[r])]
            state = [sbox(v) for v in state]
            state = mds_apply(state)
        return state

    # -- sponge
    def update(self, elements: Sequence[int]) -> None:
        inputs = self.absorbing + [e % P for e in elements]
        self.absorbing = []
        for off in range(0, len(inputs), self.rate):
            chunk = inputs[off:off + self.rate]
            if len(chunk) < self.rate:
                self.absorbing = chunk
                return
            for i, v in enumerate(chunk):
                self.state[i + 1] = (self.state[i + 1] + v) % P
            self.state = self.permute(self.state)

    def squeeze(self) -> int:
        last = list(self.absorbing)
        assert len(last) < self.rate
        last.append(1)  # variable-length padding sign
        for i, v in enumerate(last):
            self.state[i + 1] = (self.state[i + 1] + v) % P
        self.state = self.permute(self.state)
        self.absorbing = []
        return self.state[1]


def hash_elements(elements: Sequence[int], t: int = 3) -> int:
    p = Poseidon(t=t)
    p.update(list(elements))
    return p.squeeze()
