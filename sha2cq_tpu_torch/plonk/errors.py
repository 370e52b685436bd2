"""Typed protocol errors (reference plonk/error.rs Error enum).

The port's own copy of sha2cq_tpu/plonk/errors.py.
"""
from __future__ import annotations


class PlonkError(ValueError):
    """Base class for protocol errors."""


class SynthesisError(PlonkError):
    """Circuit synthesis failed (missing witness, bad region)."""


class InvalidInstances(PlonkError):
    """Instance column count doesn't match the constraint system."""


class NotEnoughRowsAvailable(PlonkError):
    def __init__(self, k: int):
        super().__init__(f"k = {k} is too small for the circuit")
        self.k = k


class BoundsFailure(PlonkError):
    """Out-of-bounds column/row access."""


class OpeningError(PlonkError):
    """Multiopen verification failed."""


class ConstraintSystemFailure(PlonkError):
    """A constraint is violated."""


class TableError(PlonkError):
    """Static-table registration/lookup failure."""
