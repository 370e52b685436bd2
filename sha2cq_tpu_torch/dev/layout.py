"""Circuit layout renderer (reference dev/graph/layout.rs, dev-graph feature).

Renders the region/column/row occupancy of a circuit to SVG (self-contained,
no plotting dependency) or a compact text grid — the fork uses this via
sha/src/main.rs:10-26 to draw simple_circuit.png; here `render_svg` writes
the same kind of diagram for any circuit.

Column order: advice | fixed | instance.  Regions are colored boxes labeled
by name; per-cell assignment marks are drawn when cell-level detail is on.

The port's own copy of sha2cq_tpu/dev/layout.py.
"""
from __future__ import annotations

import html
from typing import List, Optional, Tuple

from ..circuit import Value, planner_for
from ..plonk.circuit_ir import Column, ConstraintSystem, Selector, StaticTableId


class _LayoutCapture:
    """Assignment sink that records occupancy instead of values."""

    def __init__(self, cs: ConstraintSystem, n: int):
        self.cs = cs
        self.n = n
        self.regions: List[dict] = []
        self.cells: List[Tuple[str, int, int]] = []   # (kind, col, row)
        self.current: Optional[dict] = None

    def enter_region(self, name):
        self.current = {"name": str(name), "cells": []}

    def exit_region(self):
        if self.current and self.current["cells"]:
            self.regions.append(self.current)
        self.current = None

    def _record(self, kind: str, col: int, row: int):
        self.cells.append((kind, col, row))
        if self.current is not None:
            self.current["cells"].append((kind, col, row))

    def assign_advice(self, column: Column, row: int, value: Value):
        self._record("advice", column.index, row)

    def assign_fixed(self, column: Column, row: int, value: Value):
        self._record("fixed", column.index, row)

    def enable_selector(self, selector: Selector, row: int):
        self._record("selector", selector.index, row)

    def query_instance(self, column: Column, row: int) -> Value:
        return Value.unknown()

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass

    def register_static_table(self, table_id: StaticTableId, table):
        pass

    def get_challenge(self, challenge) -> Value:
        return Value.unknown()

    def next_phase(self):
        pass


def capture_layout(k: int, circuit) -> Tuple[ConstraintSystem, _LayoutCapture]:
    cs = ConstraintSystem()
    config = type(circuit).configure(cs)
    cap = _LayoutCapture(cs, 1 << k)
    planner_for(circuit).synthesize(cap, circuit, config, cs.constants)
    return cs, cap


_PALETTE = ["#93c5fd", "#fca5a5", "#86efac", "#fcd34d", "#c4b5fd",
            "#f9a8d4", "#7dd3fc", "#fdba74"]


def render_svg(k: int, circuit, path: Optional[str] = None,
               cell_detail: bool = True) -> str:
    """Render the layout to an SVG string (and optionally write it)."""
    cs, cap = capture_layout(k, circuit)
    n_adv, n_fix = cs.num_advice_columns, cs.num_fixed_columns
    n_inst = cs.num_instance_columns
    ncols = n_adv + n_fix + n_inst
    max_row = max((r for _, _, r in cap.cells), default=0) + 1

    CW, RH, LX, TY = 14, 10, 60, 30
    width = LX + ncols * CW + 20
    height = TY + max_row * RH + 20

    def col_x(kind: str, idx: int) -> int:
        base = {"advice": 0, "fixed": n_adv, "selector": n_adv,
                "instance": n_adv + n_fix}[kind]
        return LX + (base + idx) * CW

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'font-family="monospace" font-size="8">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
    ]
    # column headers
    for i in range(n_adv):
        parts.append(f'<text x="{col_x("advice", i)+2}" y="{TY-4}" fill="#1d4ed8">a{i}</text>')
    for i in range(n_fix):
        parts.append(f'<text x="{col_x("fixed", i)+2}" y="{TY-4}" fill="#b91c1c">f{i}</text>')
    for i in range(n_inst):
        parts.append(f'<text x="{col_x("instance", i)+2}" y="{TY-4}" fill="#15803d">i{i}</text>')
    # region extents
    for ridx, region in enumerate(cap.regions):
        rows = [r for _, _, r in region["cells"]]
        cols = [(kind, c) for kind, c, _ in region["cells"]]
        lo, hi = min(rows), max(rows)
        xs = [col_x(kind, c) for kind, c in cols]
        color = _PALETTE[ridx % len(_PALETTE)]
        parts.append(
            f'<rect x="{min(xs)}" y="{TY + lo * RH}" '
            f'width="{max(xs) - min(xs) + CW}" height="{(hi - lo + 1) * RH}" '
            f'fill="{color}" fill-opacity="0.35" stroke="{color}"/>')
        parts.append(
            f'<text x="{min(xs)}" y="{TY + lo * RH - 1}" fill="#374151">'
            f'{html.escape(region["name"][:24])}</text>')
    # cell marks
    if cell_detail and len(cap.cells) <= 20000:
        for kind, c, r in cap.cells:
            parts.append(
                f'<rect x="{col_x(kind, c)+1}" y="{TY + r * RH + 1}" '
                f'width="{CW-2}" height="{RH-2}" fill="#11182722"/>')
    # row labels every 8
    for r in range(0, max_row, 8):
        parts.append(f'<text x="4" y="{TY + r * RH + 8}" fill="#6b7280">{r}</text>')
    parts.append("</svg>")
    svg = "\n".join(parts)
    if path:
        with open(path, "w") as f:
            f.write(svg)
    return svg


def dot_graph(k: int, circuit) -> str:
    """Region graph in Graphviz dot format (reference dev/graph.rs:
    the gadget/region tree rendered via tabbycat).  Our layouter has a flat
    region list, so the graph is circuit -> region nodes, each labeled with
    its name and row extent."""
    _, cap = capture_layout(k, circuit)
    lines = ["digraph circuit {", '  root [label="circuit", shape=box];']
    for ridx, region in enumerate(cap.regions):
        rows = [r for _, _, r in region["cells"]]
        # dot double-quoted string literal escaping (NOT html.escape: that
        # would render '&quot;' literally and pass backslashes through,
        # corrupting the label)
        label = (region["name"][:32]
                 .replace("\\", "\\\\").replace('"', '\\"')
                 .replace("\n", "\\n"))
        lines.append(
            f'  r{ridx} [label="{label}\\nrows {min(rows)}..{max(rows)}"];')
        lines.append(f"  root -> r{ridx};")
    lines.append("}")
    return "\n".join(lines)


def render_text(k: int, circuit, max_rows: int = 64) -> str:
    """Compact textual occupancy grid: '.' empty, 'a'/'f'/'i' assigned."""
    cs, cap = capture_layout(k, circuit)
    n_adv, n_fix = cs.num_advice_columns, cs.num_fixed_columns
    ncols = n_adv + n_fix + cs.num_instance_columns
    max_row = min(max(((r + 1) for _, _, r in cap.cells), default=0), max_rows)
    grid = [["." for _ in range(ncols)] for _ in range(max_row)]
    for kind, c, r in cap.cells:
        if r >= max_row:
            continue
        base = {"advice": 0, "fixed": n_adv, "selector": n_adv,
                "instance": n_adv + n_fix}[kind]
        grid[r][base + c] = kind[0]
    lines = ["".join(row) for row in grid]
    header = ("a" * n_adv) + ("f" * n_fix) + ("i" * cs.num_instance_columns)
    return "\n".join([header] + lines)


def render_png(k: int, circuit, path: str, cell_detail: bool = True,
               dpi: int = 150) -> str:
    """Render the layout to a PNG file via matplotlib (the reference's
    plotters BitMapBackend output, dev/graph/layout.rs + sha/src/main.rs's
    simple_circuit.png).  Same geometry and palette as render_svg; returns
    the written path.  Raises ImportError when matplotlib is unavailable —
    render_svg/render_text carry the headless need."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    cs, cap = capture_layout(k, circuit)
    n_adv, n_fix = cs.num_advice_columns, cs.num_fixed_columns
    n_inst = cs.num_instance_columns
    ncols = n_adv + n_fix + n_inst
    max_row = max((r for _, _, r in cap.cells), default=0) + 1

    def col_ix(kind: str, idx: int) -> int:
        base = {"advice": 0, "fixed": n_adv, "selector": n_adv,
                "instance": n_adv + n_fix}[kind]
        return base + idx

    fig, ax = plt.subplots(
        figsize=(max(3.0, 0.18 * ncols + 1.0),
                 max(2.5, 0.12 * max_row + 0.8)))
    ax.set_xlim(0, ncols)
    ax.set_ylim(max_row, 0)                     # rows grow downward
    for ridx, region in enumerate(cap.regions):
        rows = [r for _, _, r in region["cells"]]
        cols = [col_ix(kind, c) for kind, c, _ in region["cells"]]
        lo, hi = min(rows), max(rows)
        color = _PALETTE[ridx % len(_PALETTE)]
        ax.add_patch(Rectangle((min(cols), lo), max(cols) - min(cols) + 1,
                               hi - lo + 1, facecolor=color, alpha=0.35,
                               edgecolor=color))
        ax.text(min(cols), lo - 0.15, region["name"][:24], fontsize=6,
                color="#374151")
    if cell_detail and len(cap.cells) <= 20000:
        for kind, c, r in cap.cells:
            ax.add_patch(Rectangle((col_ix(kind, c) + 0.08, r + 0.08),
                                   0.84, 0.84, facecolor="#111827",
                                   alpha=0.13, edgecolor="none"))
    for i in range(ncols):
        kind = ("advice" if i < n_adv else
                "fixed" if i < n_adv + n_fix else "instance")
        label = {"advice": "a", "fixed": "f", "instance": "i"}[kind] + str(
            i - (0 if kind == "advice" else
                 n_adv if kind == "fixed" else n_adv + n_fix))
        ax.text(i + 0.1, -0.3, label, fontsize=6,
                color={"advice": "#1d4ed8", "fixed": "#b91c1c",
                       "instance": "#15803d"}[kind])
    ax.set_xticks([])
    ax.set_yticks(range(0, max_row, 8))
    ax.tick_params(labelsize=6)
    ax.set_frame_on(False)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path
