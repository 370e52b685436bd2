"""CircuitGates: pretty-print every polynomial identity of a circuit
(reference halo2_proofs/src/dev/gates.rs CircuitGates::collect).

The port's own copy of sha2cq_tpu/dev/gates.py.
"""
from __future__ import annotations

from typing import List

from ..plonk.circuit_ir import ConstraintSystem, Expression


def _render(e: Expression) -> str:
    k = e.kind
    if k == "const":
        return hex(e.value) if e.value > 0xFFFF else str(e.value)
    if k == "selector":
        return f"S{e.value}"
    if k in ("fixed", "advice", "instance"):
        prefix = {"fixed": "F", "advice": "A", "instance": "I"}[k]
        rot = "" if e.rotation == 0 else f"@{e.rotation:+d}"
        return f"{prefix}{e.column.index}{rot}"
    if k == "challenge":
        return f"C{e.value}"
    if k == "neg":
        return f"-{_render(e.a)}"
    if k == "sum":
        return f"({_render(e.a)} + {_render(e.b)})"
    if k == "prod":
        return f"{_render(e.a)} * {_render(e.b)}"
    if k == "scaled":
        return f"{e.value} * {_render(e.a)}"
    raise ValueError(k)


class CircuitGates:
    def __init__(self, cs: ConstraintSystem):
        self.cs = cs

    @staticmethod
    def collect(circuit_cls) -> "CircuitGates":
        cs = ConstraintSystem()
        circuit_cls.configure(cs)
        return CircuitGates(cs)

    def render(self) -> str:
        lines: List[str] = []
        for gate in self.cs.gates:
            lines.append(f"gate {gate.name!r}:")
            for i, poly in enumerate(gate.polys):
                lines.append(f"  [{i}] {_render(poly)} = 0  (degree {poly.degree()})")
        for lk in self.cs.lookups:
            lines.append(f"lookup {lk.name!r}:")
            for inp, tab in zip(lk.input_expressions, lk.table_expressions):
                lines.append(f"  {_render(inp)} ∈ {_render(tab)}")
        for sl in self.cs.static_lookups:
            lines.append(f"static lookup {sl.name!r}:")
            for inp, tid in zip(sl.input_expressions, sl.table_ids):
                lines.append(f"  {_render(inp)} ∈ table[{tid.name}]")
        if self.cs.permutation.columns:
            cols = ", ".join(str(c) for c in self.cs.permutation.columns)
            lines.append(f"permutation over: {cols}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()
