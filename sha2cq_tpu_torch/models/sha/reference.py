"""Executable SHA-2 round model (reference sha-reference/src/{word,lib}.rs).

Generic word length L; NOTE the reference model replaces modular addition
with XOR (`Add for Word` is bitwise xor, word.rs:98-108) and runs 64 rounds
with no message schedule or round constants — it is a cross-check oracle for
the CQ table semantics, not FIPS-180 SHA-256.  The real SHA-256 (with carry
addition, schedule, constants) lives in models/sha/sha256.py.

The port's own copy of sha2cq_tpu/models/sha/reference.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def rotr(w: int, n: int, bits: int) -> int:
    n %= bits
    mask = (1 << bits) - 1
    return ((w >> n) | (w << (bits - n))) & mask


def rot_0(w: int, bits: int) -> int:
    return rotr(w, 2, bits) ^ rotr(w, 13, bits) ^ rotr(w, 22, bits)


def rot_1(w: int, bits: int) -> int:
    return rotr(w, 6, bits) ^ rotr(w, 11, bits) ^ rotr(w, 25, bits)


def majority(a: int, b: int, c: int) -> int:
    return (a & b) ^ (a & c) ^ (b & c)


def choose(a: int, b: int, c: int) -> int:
    return (a & b) ^ (~a & c)


@dataclass(frozen=True)
class Octet:
    a: int
    b: int
    c: int
    d: int
    e: int
    f: int
    g: int
    h: int


def sha_round(s: Octet, bits: int) -> Octet:
    """One xor-model round (lib.rs:18-33): + is XOR."""
    mask = (1 << bits) - 1
    temp = s.h ^ rot_1(s.e, bits) ^ (choose(s.e, s.f, s.g) & mask)
    return Octet(
        a=(temp ^ rot_0(s.a, bits) ^ (majority(s.a, s.b, s.c) & mask)) & mask,
        b=s.a, c=s.b, d=s.c,
        e=(s.d ^ temp) & mask,
        f=s.e, g=s.f, h=s.g,
    )


def sha(s: Octet, bits: int, rounds: int = 64) -> Octet:
    for _ in range(rounds):
        s = sha_round(s, bits)
    return s
