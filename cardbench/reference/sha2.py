"""Plain SHA-256 compression over words of `w` bits (FIPS 180-4, section
6.2.2), for the instance a SHA-256 prover proves.

At w = 32 this is SHA-256's compression function.  A narrower width runs
the same rounds with every rotation and shift amount taken mod w and every
constant cut to its low w bits: the same circuit shape with smaller tables.
The chaining value of a message is the compression folded over its blocks
from the initial hash value; blocks are 16 words, unpadded.
"""
from __future__ import annotations

from typing import List, Sequence

K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
IV = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def rotr(x: int, n: int, w: int) -> int:
    n %= w
    return ((x >> n) | (x << (w - n))) & ((1 << w) - 1)


def big_sigma0(x: int, w: int) -> int:
    return rotr(x, 2, w) ^ rotr(x, 13, w) ^ rotr(x, 22, w)


def big_sigma1(x: int, w: int) -> int:
    return rotr(x, 6, w) ^ rotr(x, 11, w) ^ rotr(x, 25, w)


def small_sigma0(x: int, w: int) -> int:
    return rotr(x, 7, w) ^ rotr(x, 18, w) ^ (x >> (3 % w))


def small_sigma1(x: int, w: int) -> int:
    return rotr(x, 17, w) ^ rotr(x, 19, w) ^ (x >> (10 % w))


def maj(x: int, y: int, z: int) -> int:
    return (x & y) ^ (x & z) ^ (y & z)


def ch(x: int, y: int, z: int, w: int) -> int:
    return (x & y) ^ (~x & z & ((1 << w) - 1))


def compress(state: Sequence[int], block: Sequence[int], w: int) -> List[int]:
    """One compression with the feed-forward: state + rounds(state, block)."""
    mask = (1 << w) - 1
    sched = list(block)
    for t in range(16, 64):
        sched.append((small_sigma1(sched[t - 2], w) + sched[t - 7]
                      + small_sigma0(sched[t - 15], w) + sched[t - 16]) & mask)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = (h + big_sigma1(e, w) + ch(e, f, g, w) + (K[t] & mask)
              + sched[t]) & mask
        t2 = (big_sigma0(a, w) + maj(a, b, c)) & mask
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & mask, c, b, a, (t1 + t2) & mask
    return [(x + y) & mask for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def chain(blocks: Sequence[Sequence[int]], w: int) -> List[int]:
    """The chaining value after every block, from the initial hash value."""
    state = [v & ((1 << w) - 1) for v in IV]
    for block in blocks:
        if len(block) != 16:
            raise ValueError("a block is 16 words")
        state = compress(state, block, w)
    return state
