"""PLONK protocol layer: the port's prover, h VM and device h path, with the
host protocol modules loaded from sha2cq_tpu/plonk."""
from .. import _overlay

_overlay(__path__, "plonk")

from .circuit_ir import (Challenge, Column, ConstraintSystem, Expression,  # noqa: E402
                         Selector, StaticTableId, TableColumn)
from .keygen import keygen_pk, keygen_vk  # noqa: E402
from .keys import ProvingKey, VerifyingKey  # noqa: E402
from .prover import create_proof, prewarm_prover  # noqa: E402
from .static_tables import (StaticCommittedTable, StaticTable,  # noqa: E402
                            StaticTableConfig, StaticTableValues)
from .verifier import verify_proof  # noqa: E402

__all__ = [
    "Challenge", "Column", "ConstraintSystem", "Expression", "Selector",
    "StaticTableId", "TableColumn", "keygen_pk", "keygen_vk", "ProvingKey",
    "VerifyingKey", "create_proof", "prewarm_prover", "StaticCommittedTable",
    "StaticTable", "StaticTableConfig", "StaticTableValues", "verify_proof",
]
