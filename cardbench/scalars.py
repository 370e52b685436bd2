"""The general generator of scalar traffic, and the check of one commitment
request, importable by the check's worker processes.

A mix (traffic/<mix>.json) gives `points` and the `scalars` distribution;
request i of a seed is `points` scalars drawn from (seed, i) alone.
"""
from __future__ import annotations

import hashlib

import numpy as np

from cardbench.reference import bn254, kzg_commit
from cardbench.roofline import work


def draw(rng: np.random.Generator, m: int, kind: str) -> np.ndarray:
    """m scalars of a distribution as (m, 4) little-endian uint64 words:
    `uniform` over [0, r), or `bits`, `bytes`, `words16` (0/1, 8-bit and
    16-bit values)."""
    out = np.zeros((m, 4), dtype=np.uint64)
    if kind in ("bits", "bytes", "words16"):
        out[:, 0] = rng.integers(0, {"bits": 2, "bytes": 256,
                                     "words16": 1 << 16}[kind], size=m,
                                 dtype=np.uint64)
        return out
    if kind != "uniform":
        raise ValueError(f"unknown scalar distribution {kind!r}")
    r = [(bn254.R >> (64 * j)) & (2 ** 64 - 1) for j in range(4)]
    todo = np.arange(m)
    while todo.size:
        words = rng.integers(0, 2 ** 64, size=(todo.size, 4), dtype=np.uint64,
                             endpoint=False)
        words[:, 3] &= np.uint64(2 ** 62 - 1)
        out[todo] = words
        # keep a row below r: compare from the top word down
        less = np.zeros(todo.size, bool)
        equal = np.ones(todo.size, bool)
        for j in (3, 2, 1, 0):
            w = words[:, j]
            less |= equal & (w < np.uint64(r[j]))
            equal &= w == np.uint64(r[j])
        todo = todo[~less]
    return out


def to_ints(words: np.ndarray) -> list:
    raw = np.ascontiguousarray(words).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def request_words(seed: int, index, traffic: dict) -> np.ndarray:
    """The scalars of request `index` of `seed` as (points, 4) words."""
    tag = hashlib.sha256(f"{seed}:{index}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(tag, "little"))
    return draw(rng, traffic["points"], traffic["scalars"])


_POWERS = {}


def value_and_live(job) -> tuple:
    """For job (seed, index, traffic, s): p(s) mod r of the request's
    scalars, and their nonzero digits at the roofline's window bits."""
    seed, index, traffic, s = job
    key = (s, traffic["points"])
    if key not in _POWERS:
        _POWERS.clear()
        _POWERS[key] = kzg_commit.powers(s, traffic["points"])
    words = request_words(seed, index, traffic)
    return (kzg_commit.evaluate_at(to_ints(words), _POWERS[key]),
            work.live_digits(words))
