"""Polynomial layer: the port's EvaluationDomain, with arith.py and kzg/
loaded from sha2cq_tpu/poly."""
from .. import _overlay

_overlay(__path__, "poly")
