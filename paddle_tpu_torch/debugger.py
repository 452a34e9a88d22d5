"""Program visualization: the JAX package's `debugger.py` (reference:
python/paddle/fluid/debugger.py draw_block_graphviz +
ir/graph_viz_pass.cc — emit a DOT graph of ops and variables for
debugging). The same DOT text for the same program; the default paths
lie in the temp directory (`tempfile.gettempdir()`, which honours
TMPDIR), where the JAX package names /tmp."""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

from .observability import metrics as _m

DOT_NODES = _m.gauge(
    "paddle_tpu_debugger_dot_nodes",
    "Node count of the most recently rendered DOT graph",
    labelnames=("kind",))


def _esc(s: str) -> str:
    return s.replace('"', '\\"')


def block_to_dot(block, skip_vars: Sequence[str] = (),
                 highlight: Sequence[str] = ()) -> str:
    """DOT source for one block: op nodes (boxes) wired through var nodes
    (ellipses); parameters shaded."""
    lines = ["digraph program {", "  rankdir=TB;",
             '  node [fontsize=10];']
    skip = set(skip_vars)
    hi = set(highlight)
    vars_seen = set()

    def var_node(name):
        if name in vars_seen or name in skip:
            return
        vars_seen.add(name)
        v = block.desc.vars.get(name)
        shape = list(v.shape) if v is not None and v.shape else "?"
        attrs = [f'label="{_esc(name)}\\n{shape}"', "shape=ellipse"]
        if name in hi:
            attrs.append('style=filled, fillcolor="#ffd0d0"')
        elif v is not None and v.is_parameter:
            attrs.append('style=filled, fillcolor="#e0e0ff"')
        # a plain var adds no style attr — joining only what exists keeps
        # the attr list valid DOT (no dangling comma before "];")
        lines.append(f'  "v_{_esc(name)}" [{", ".join(attrs)}];')

    for i, op in enumerate(block.desc.ops):
        lines.append(f'  "op_{i}" [label="{_esc(op.type)}", shape=box, '
                     f'style=filled, fillcolor="#d0ffd0"];')
        for names in op.inputs.values():
            for n in names:
                if n and n not in skip:
                    var_node(n)
                    lines.append(f'  "v_{_esc(n)}" -> "op_{i}";')
        for names in op.outputs.values():
            for n in names:
                if n and n not in skip:
                    var_node(n)
                    lines.append(f'  "op_{i}" -> "v_{_esc(n)}";')
    lines.append("}")
    DOT_NODES.set(len(block.desc.ops), kind="op")
    DOT_NODES.set(len(vars_seen), kind="var")
    return "\n".join(lines)


def draw_block_graphviz(block, highlights: Optional[Sequence[str]] = None,
                        path: Optional[str] = None):
    """reference: debugger.py draw_block_graphviz — write DOT to `path`
    (render with `dot -Tpng`; atomic so a half-written DOT never
    reaches the renderer)."""
    from .resilience import atomic as _atomic

    if path is None:
        path = os.path.join(tempfile.gettempdir(), "temp.dot")
    _atomic.write_text(path, block_to_dot(block, highlight=highlights or ()))
    return path


def draw_program(program, path: Optional[str] = None):
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "program.dot")
    return draw_block_graphviz(program.global_block(), path=path)
