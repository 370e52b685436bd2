"""NTT plans built on the device (sha2cq_tpu_torch.ops.mxu_ntt's card route:
row scans of Montgomery multiplies and byte-shift passes, the JAX package's
_digit_matrix_build_jit / _twiddle_build_jit), run here on CPU tensors with
the plain mont_mul, against the host plans: bit-identical (tolerance 0).
The host digit matrix is itself held against the JAX package's build in
test_torch_mxu_ntt.py."""
import numpy as np
import pytest
import torch

from sha2cq_tpu.fields.host import FR_MOD as P
from sha2cq_tpu.ops import mxu_ntt as JM
from sha2cq_tpu_torch import compat
from sha2cq_tpu_torch.fields import device as TD
from sha2cq_tpu_torch.ops import mxu_ntt as TM
from tests.test_torch_mxu_ntt import _omega, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("m", [8, 64])
def test_card_digit_matrix_equals_host_matrix(m):
    w = _omega(m.bit_length() - 1)
    mat, rowsum = TM.dft_digit_matrix_dev(m, w, TD.FR, "cpu")
    host_mat, host_rowsum = TM._digit_matrix_host(m, w, TD.FR)
    assert mat.dtype == torch.int8 and mat.shape == (32 * m, 32 * m)
    assert rowsum.dtype == torch.int32
    assert torch.equal(mat, host_mat) and torch.equal(rowsum, host_rowsum)


def test_card_digit_matrix_any_omega():
    """The row scan does not need omega to be an m-th root of unity (the
    host's native build does; its big-int build does not)."""
    w = 0x1234567 % P
    mat, _ = TM.dft_digit_matrix_dev(8, w, TD.FR, "cpu")
    assert np.array_equal(mat.numpy(), TM._digit_matrix_bigint(8, w, P))


def test_card_twiddle_tensor_equals_host_tensor():
    """m2*m1 = 2^16: the size from which a card builds the Fr twiddle
    tensor (a k = 17 coset NTT's level), and the JAX host build agrees."""
    w = _omega(17)
    m2, m1 = 512, 128
    assert m2 * m1 >= TM.DEVICE_TWIDDLE_MIN
    got = TM.twiddle_tensor_dev(w, m2, m1, TD.FR, "cpu")
    assert got.shape == (16, m2, m1) and got.dtype == torch.int32
    assert torch.equal(got, TM._twiddle_tensor_host(w, m2, m1, TD.FR))
    want = np.asarray(JM._twiddle_tensor(w, 8, m1, "Fr"))
    np.testing.assert_array_equal(compat.to_jax_limbs(got[:, :8]), want)


def test_cpu_plans_take_the_host_route():
    """plan_on builds a CPU plan on the host (the card route is for CUDA
    devices) and caches it per device; get_plan is that plan."""
    w = _omega(10)
    plan, res = TM.plan_on(1 << 10, w, "cpu", "Fr", 32)
    assert plan is TM.get_plan(1 << 10, w + P, "Fr", 32)[0]
    assert res is None and plan.base_mat.device.type == "cpu"
    host_mat, _ = TM._digit_matrix_host(32, pow(w, 32, P), TD.FR)
    assert torch.equal(plan.base_mat, host_mat)


def test_ntt_scalars_are_packed_once_per_device():
    """The Montgomery one and the iNTT divisor are cached per (value,
    device): an NTT copies no scalar from host memory after its first
    call (a pageable copy would synchronise the stream)."""
    one = TM._scalar(1, TD.FR, "cpu")
    assert TM._scalar(1, TD.FR, torch.device("cpu")) is one
    assert TD.unpack(one, TD.FR) == [1]
    d = TM._scalar(P + 5, TD.FR, "cpu")
    assert d is TM._scalar(5, TD.FR, "cpu") and TD.unpack(d, TD.FR) == [5]
