"""EvaluationDomain of the port (counterpart of sha2cq_tpu/poly/domain.py).

The 2^k base domain and the ZETA-coset extended domain, with the same
constants and host (int list) transforms as the reference, and its device
transforms over limb tensors on an explicit device (the tensor's own):
`lagrange_to_coeff`, `coeff_to_lagrange`, `coeff_to_extended`,
`extended_to_coeff`, `divide_by_vanishing_poly`, the batched
`lagrange_to_coeff_batch` / `coeff_to_extended_batch`, and
`rotate_extended`.  They run the butterfly NTT of ops/ntt.py (kernel K4 on a
card) and are the h path's butterfly route (plonk/device_eval.py).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..fields import device as D
from ..fields import host as H
from ..fields.host import FR_MOD
from ..ops import ntt as NTT

P = FR_MOD


class EvaluationDomain:
    def __init__(self, j: int, k: int):
        """j = max constraint degree (quotient_poly_degree = j-1), n = 2^k."""
        self.k = k
        self.n = 1 << k
        self.quotient_poly_degree = max(j - 1, 1)
        extended_k = k
        while (1 << extended_k) < self.n * self.quotient_poly_degree:
            extended_k += 1
        self.extended_k = extended_k
        self.extended_n = 1 << extended_k

        # roots of unity, derived by squaring the 2^S root (domain.rs:54-74)
        w = H.FR_ROOT_OF_UNITY
        for _ in range(extended_k, H.FR_S):
            w = w * w % P
        self.extended_omega = w
        for _ in range(k, extended_k):
            w = w * w % P
        self.omega = w
        self.omega_inv = pow(self.omega, P - 2, P)
        self.extended_omega_inv = pow(self.extended_omega, P - 2, P)

        self.g_coset = H.FR_ZETA
        self.g_coset_inv = H.FR_ZETA * H.FR_ZETA % P

        # t(X) = X^n - 1 evaluated on the coset, inverted; period 2^(ext_k-k)
        t_len = 1 << (extended_k - k)
        orig = pow(self.g_coset, self.n, P)
        step = pow(self.extended_omega, self.n, P)
        te = []
        cur = orig
        for _ in range(t_len):
            te.append((cur - 1) % P)
            cur = cur * step % P
        assert cur == orig
        self.t_evaluations_inv = H.batch_inv(te, P)

        self.ifft_divisor = pow(self.n, P - 2, P)
        self.extended_ifft_divisor = pow(self.extended_n, P - 2, P)
        self.barycentric_weight = pow(self.n, P - 2, P)

    # ---------------- host (int list) paths — oracle + small work ----------

    def lagrange_to_coeff_host(self, values: Sequence[int]) -> List[int]:
        assert len(values) == self.n
        return NTT.intt_host(list(values), self.omega, P)

    def coeff_to_lagrange_host(self, coeffs: Sequence[int]) -> List[int]:
        assert len(coeffs) == self.n
        return NTT.ntt_host(list(coeffs), self.omega, P)

    def coeff_to_extended_host(self, coeffs: Sequence[int]) -> List[int]:
        a = self._distribute_zeta_host(list(coeffs), into=True)
        a = a + [0] * (self.extended_n - len(a))
        return NTT.ntt_host(a, self.extended_omega, P)

    def extended_to_coeff_host(self, values: Sequence[int]) -> List[int]:
        assert len(values) == self.extended_n
        a = NTT.intt_host(list(values), self.extended_omega, P)
        a = self._distribute_zeta_host(a, into=False)
        return a[: self.n * self.quotient_poly_degree]

    def divide_by_vanishing_poly_host(self, values: Sequence[int]) -> List[int]:
        t = self.t_evaluations_inv
        return [v * t[i % len(t)] % P for i, v in enumerate(values)]

    def _distribute_zeta_host(self, a: List[int], into: bool) -> List[int]:
        c1, c2 = (self.g_coset, self.g_coset_inv) if into else (self.g_coset_inv, self.g_coset)
        powers = (1, c1, c2)
        return [v * powers[i % 3] % P for i, v in enumerate(a)]

    # ---------------- device ((16, ..., n) limb tensor) paths ---------------
    # Each method runs on its input's device: the butterfly NTT (ops/ntt.py:
    # kernel K4 on CUDA) and the Montgomery multiply (K1 on CUDA); the
    # constants they need are built once per device.

    def lagrange_to_coeff(self, values: torch.Tensor) -> torch.Tensor:
        out = NTT.ntt_last_axis(
            values, NTT.twiddle_table(self.omega_inv, self.k, "Fr", values.device),
            self.k)
        return D.mont_mul(out, self._const(self.ifft_divisor, values.device), D.FR)

    def coeff_to_lagrange(self, coeffs: torch.Tensor) -> torch.Tensor:
        return NTT.ntt(coeffs, self.omega, self.k)

    def coeff_to_extended(self, coeffs: torch.Tensor) -> torch.Tensor:
        a = D.mont_mul(coeffs, self._zeta_pattern(self.n, True, coeffs.device), D.FR)
        a = torch.nn.functional.pad(a, (0, self.extended_n - self.n))
        return NTT.ntt(a, self.extended_omega, self.extended_k)

    def extended_to_coeff(self, values: torch.Tensor) -> torch.Tensor:
        a = NTT.ntt_last_axis(
            values, NTT.twiddle_table(self.extended_omega_inv, self.extended_k,
                                      "Fr", values.device),
            self.extended_k)
        a = D.mont_mul(a, self._const(self.extended_ifft_divisor, values.device), D.FR)
        a = D.mont_mul(a, self._zeta_pattern(self.extended_n, False, values.device),
                       D.FR)
        return a[..., : self.n * self.quotient_poly_degree]

    def divide_by_vanishing_poly(self, values: torch.Tensor) -> torch.Tensor:
        return D.mont_mul(values, self._vanishing_table(values.device), D.FR)

    def lagrange_to_coeff_batch(self, values: torch.Tensor) -> torch.Tensor:
        """(16, C, n) -> coeff form, one batched call for all C columns."""
        out = NTT.ntt_last_axis(
            values, NTT.twiddle_table(self.omega_inv, self.k, "Fr", values.device),
            self.k)
        return D.mont_mul(out, self._const(self.ifft_divisor, values.device)[:, None, :],
                          D.FR)

    def coeff_to_extended_batch(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(16, C, n) -> extended coset evaluations (16, C, extended_n)."""
        a = D.mont_mul(coeffs, self._zeta_pattern(self.n, True, coeffs.device)[:, None, :],
                       D.FR)
        a = torch.nn.functional.pad(a, (0, self.extended_n - self.n))
        return NTT.ntt_last_axis(
            a, NTT.twiddle_table(self.extended_omega, self.extended_k, "Fr", a.device),
            self.extended_k)

    def rotate_extended(self, values: torch.Tensor, rotation: int) -> torch.Tensor:
        shift = (1 << (self.extended_k - self.k)) * rotation
        return torch.roll(values, -shift, dims=1)

    def _zeta_pattern(self, n: int, into: bool, device="cpu") -> torch.Tensor:
        """(16, n) Montgomery limbs of [1, c1, c2, 1, c1, c2, ...]."""
        c1, c2 = (self.g_coset, self.g_coset_inv) if into else \
            (self.g_coset_inv, self.g_coset)
        return self._on_device(("zeta", n, into), device,
                               lambda: ([1, c1, c2] * (n // 3 + 1))[:n])

    def _const(self, v: int, device="cpu") -> torch.Tensor:
        """(16, 1) Montgomery limbs of the scalar v."""
        return self._on_device(("scalar", v % P), device, lambda: [v % P])

    def _vanishing_table(self, device="cpu") -> torch.Tensor:
        """(16, extended_n) Montgomery limbs of t_evaluations_inv, tiled."""
        t = self.t_evaluations_inv
        return self._on_device(("vanishing",), device,
                               lambda: t * (self.extended_n // len(t)))

    def _on_device(self, key: tuple, device, values) -> torch.Tensor:
        """The packed limbs of values() on `device`, built once per (key,
        device): device methods called per prove copy nothing from the
        host."""
        cache = self.__dict__.setdefault("_device_consts", {})
        dkey = (key, D.device_key(device))
        if dkey not in cache:
            cache[dkey] = D.pack(values(), D.FR, device=device)
        return cache[dkey]

    # ---------------- scalar helpers (host ints) ----------------------------

    def rotate_omega(self, value: int, rotation: int) -> int:
        if rotation >= 0:
            return value * pow(self.omega, rotation, P) % P
        return value * pow(self.omega_inv, -rotation, P) % P

    def l_i_range(self, x: int, xn: int, rotations: Sequence[int]) -> List[int]:
        """Barycentric Lagrange-basis evaluations l_i(x) (domain.rs:453-478)."""
        denoms = [(x - self.rotate_omega(1, rot)) % P for rot in rotations]
        denom_invs = H.batch_inv(denoms, P)
        common = (xn - 1) * self.barycentric_weight % P
        return [
            self.rotate_omega(di * common % P, rot)
            for rot, di in zip(rotations, denom_invs)
        ]

    def get_quotient_poly_degree(self) -> int:
        return self.quotient_poly_degree

    def __hash__(self):
        return hash((self.k, self.extended_k))

    def __eq__(self, other):
        return isinstance(other, EvaluationDomain) and (self.k, self.extended_k) == (
            other.k,
            other.extended_k,
        )
