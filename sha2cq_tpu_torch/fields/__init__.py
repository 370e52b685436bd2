"""Field arithmetic: host ints from sha2cq_tpu/fields/host.py, device limbs
in this package's device.py."""
from .. import _overlay

_overlay(__path__, "fields")
