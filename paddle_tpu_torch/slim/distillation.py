# Copied from the JAX package: paddle_tpu/slim/distillation.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Knowledge distillation.

Reference: contrib/slim/distillation/distiller.py — FSPDistiller (flow of
solution procedure matrices between feature-map pairs), L2Distiller
(feature L2), SoftLabelDistiller (temperature-softened KL), and
distillation_strategy.py (merge the teacher program into the student's so
one executor step computes both).

TPU-native: `merge` is a Program splice with a name prefix (one XLA
computation covers student+teacher — the compiler dedups shared input
loads); the teacher subgraph is marked stop_gradient so autodiff never
enters it.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from ..core.framework import Program
from .. import layers


def merge(teacher_program: Program, student_program: Program,
          data_names: Optional[List[str]] = None,
          name_prefix: str = "teacher_") -> Dict[str, str]:
    """Splice the teacher's ops/vars into the student program under a
    prefix. Feed vars (data_names) are shared unprefixed. Returns the
    teacher var name map. Teacher vars are stop_gradient."""
    data_names = set(data_names or [])
    t_desc = teacher_program.global_block().desc
    s_desc = student_program.global_block().desc
    rename: Dict[str, str] = {}
    for name, var in t_desc.vars.items():
        if name in data_names:
            rename[name] = name
            continue
        new = name_prefix + name
        rename[name] = new
        v = copy.deepcopy(var)
        v.name = new
        v.stop_gradient = True
        s_desc.vars[new] = v
    for op in t_desc.ops:
        if op.type in ("feed", "fetch"):
            continue
        new_op = copy.deepcopy(op)
        new_op.inputs = {k: [rename.get(n, n) for n in v]
                         for k, v in op.inputs.items()}
        new_op.outputs = {k: [rename.get(n, n) for n in v]
                          for k, v in op.outputs.items()}
        s_desc.ops.append(new_op)
    student_program._rebuild_from_desc()
    return rename


def soft_label_loss(teacher_logits, student_logits,
                    teacher_temperature: float = 1.0,
                    student_temperature: float = 1.0):
    """KL(teacher softmax^T || student softmax^T) as cross entropy
    (reference: SoftLabelDistiller)."""
    t = layers.softmax(layers.scale(teacher_logits,
                                    scale=1.0 / teacher_temperature))
    s = layers.log_softmax(layers.scale(student_logits,
                                        scale=1.0 / student_temperature))
    neg = layers.scale(layers.elementwise_mul(t, s), scale=-1.0)
    return layers.mean(layers.reduce_sum(neg, dim=-1))


def l2_loss(teacher_feature, student_feature):
    """Feature-map L2 (reference: L2Distiller)."""
    diff = layers.elementwise_sub(student_feature, teacher_feature)
    return layers.mean(layers.elementwise_mul(diff, diff))


def _fsp_matrix(a, b):
    """FSP matrix of two feature maps [N, C1, H, W] x [N, C2, H, W] →
    [N, C1, C2] (reference: fsp op semantics — mean over spatial)."""
    c1 = int(a.shape[1])
    c2 = int(b.shape[1])
    h, w = int(a.shape[2]), int(a.shape[3])
    af = layers.reshape(a, [-1, c1, h * w])
    bf = layers.reshape(b, [-1, c2, h * w])
    prod = layers.matmul(af, layers.transpose(bf, perm=[0, 2, 1]))
    return layers.scale(prod, scale=1.0 / (h * w))


def fsp_loss(teacher_var1, teacher_var2, student_var1, student_var2):
    """L2 between teacher and student FSP matrices (reference:
    FSPDistiller)."""
    tm = _fsp_matrix(teacher_var1, teacher_var2)
    sm = _fsp_matrix(student_var1, student_var2)
    return l2_loss(tm, sm)


def init_teacher_scope(scope, rename: Dict[str, str]):
    """Copy the teacher's initialized variables to their prefixed names in
    `scope` (reference: DistillationStrategy merges the teacher scope into
    the student's on_compression_begin)."""
    for orig, new in rename.items():
        if orig == new:
            continue
        val = scope.find_var(orig)
        if val is not None:
            scope.set_var(new, val)
