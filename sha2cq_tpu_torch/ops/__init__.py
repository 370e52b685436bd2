"""Device operators (NTT, MSM dispatch, CUDA kernels) of the port."""
from .. import _overlay

_overlay(__path__, "ops")
