# Copied from the JAX package: paddle_tpu/core/ir.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Serializable program IR.

Mirrors the reference's protobuf ProgramDesc/BlockDesc/OpDesc/VarDesc
(reference: paddle/fluid/framework/framework.proto:212,174,43,165) but as plain
dataclasses with JSON serialization — protobuf adds nothing on TPU where the
program is lowered to StableHLO by JAX anyway, and JSON keeps save files
human-debuggable. VarType values follow framework.proto:105.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Var types (reference framework.proto:105 VarType.Type)
# ---------------------------------------------------------------------------


class VarType:
    DENSE_TENSOR = "dense_tensor"  # reference LOD_TENSOR; no LoD on TPU (SURVEY §5)
    SELECTED_ROWS = "selected_rows"  # sparse row-slices (embedding grads)
    TENSOR_ARRAY = "tensor_array"  # reference LOD_TENSOR_ARRAY
    READER = "reader"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"

    # compat aliases
    LOD_TENSOR = DENSE_TENSOR
    LOD_TENSOR_ARRAY = TENSOR_ARRAY


_DTYPE_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "bf16": "bfloat16",
    "int": "int32",
    "long": "int64",
    "bool_": "bool",
}


def normalize_dtype(dtype) -> str:
    """Canonical dtype string ('float32', 'bfloat16', ...)."""
    if dtype is None:
        return "float32"
    name = getattr(dtype, "name", None) or str(dtype)
    name = name.replace("numpy.", "").replace("jnp.", "")
    return _DTYPE_ALIASES.get(name, name)


# ---------------------------------------------------------------------------
# Descs
# ---------------------------------------------------------------------------


@dataclass
class VarDesc:
    """reference: framework.proto:165 VarDesc + VarType.TensorDesc."""

    name: str
    shape: Optional[Tuple[int, ...]] = None  # -1 = dynamic (batch) dim
    dtype: str = "float32"
    type: str = VarType.DENSE_TENSOR
    persistable: bool = False
    stop_gradient: bool = False
    is_parameter: bool = False
    need_check_feed: bool = False
    # Extra serializable metadata (ParamAttr, sharding annotations, etc.)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": self.type,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_parameter": self.is_parameter,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VarDesc":
        return VarDesc(
            name=d["name"],
            shape=tuple(d["shape"]) if d.get("shape") is not None else None,
            dtype=d.get("dtype", "float32"),
            type=d.get("type", VarType.DENSE_TENSOR),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            is_parameter=d.get("is_parameter", False),
            attrs=d.get("attrs", {}),
        )


@dataclass
class OpDesc:
    """reference: framework.proto:43 OpDesc.

    inputs/outputs map slot name -> list of var names ('' allowed = empty slot).
    attrs must be JSON-serializable; a sub-block reference is stored as
    {"__block__": idx} (reference stores BLOCK attr type, framework.proto:27).
    """

    type: str
    inputs: Dict[str, List[str]] = field(default_factory=dict)
    outputs: Dict[str, List[str]] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns if n]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns if n]

    def block_attr(self, name: str) -> Optional[int]:
        v = self.attrs.get(name)
        if isinstance(v, dict) and "__block__" in v:
            return v["__block__"]
        return None

    def sub_block_ids(self) -> List[int]:
        out = []
        for v in self.attrs.values():
            if isinstance(v, dict) and "__block__" in v:
                out.append(v["__block__"])
            elif isinstance(v, list):
                for e in v:
                    if isinstance(e, dict) and "__block__" in e:
                        out.append(e["__block__"])
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonify_attrs(self.attrs),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OpDesc":
        return OpDesc(
            type=d["type"],
            inputs={k: list(v) for k, v in d.get("inputs", {}).items()},
            outputs={k: list(v) for k, v in d.get("outputs", {}).items()},
            attrs=d.get("attrs", {}),
        )


def _jsonify_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            v = v.item()
        elif hasattr(v, "tolist"):
            v = v.tolist()
        out[k] = v
    return out


@dataclass
class BlockDesc:
    """reference: framework.proto:174 BlockDesc."""

    idx: int = 0
    parent_idx: int = -1
    vars: Dict[str, VarDesc] = field(default_factory=dict)
    ops: List[OpDesc] = field(default_factory=list)
    forward_block_idx: int = -1

    def var(self, name: str) -> VarDesc:
        return self.vars[name]

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def to_dict(self) -> Dict[str, Any]:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "BlockDesc":
        b = BlockDesc(idx=d["idx"], parent_idx=d.get("parent_idx", -1))
        b.forward_block_idx = d.get("forward_block_idx", -1)
        for vd in d.get("vars", []):
            v = VarDesc.from_dict(vd)
            b.vars[v.name] = v
        b.ops = [OpDesc.from_dict(od) for od in d.get("ops", [])]
        return b


@dataclass
class ProgramDesc:
    """reference: framework.proto:212 ProgramDesc (+ version :184)."""

    blocks: List[BlockDesc] = field(default_factory=list)
    version: int = 1

    def __post_init__(self):
        if not self.blocks:
            self.blocks.append(BlockDesc(idx=0, parent_idx=-1))

    def block(self, idx: int) -> BlockDesc:
        return self.blocks[idx]

    def append_block(self, parent_idx: int) -> BlockDesc:
        b = BlockDesc(idx=len(self.blocks), parent_idx=parent_idx)
        self.blocks.append(b)
        return b

    def to_dict(self) -> Dict[str, Any]:
        return {"version": self.version, "blocks": [b.to_dict() for b in self.blocks]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def to_bytes(self) -> bytes:
        return self.to_json().encode("utf-8")

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ProgramDesc":
        p = ProgramDesc(blocks=[BlockDesc.from_dict(b) for b in d["blocks"]])
        p.version = d.get("version", 1)
        return p

    @staticmethod
    def from_json(s: str) -> "ProgramDesc":
        return ProgramDesc.from_dict(json.loads(s))

    @staticmethod
    def from_bytes(b: bytes) -> "ProgramDesc":
        return ProgramDesc.from_json(b.decode("utf-8"))

    def clone(self) -> "ProgramDesc":
        return copy.deepcopy(self)


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def is_grad_var(name: str) -> bool:
    return name.endswith(GRAD_SUFFIX)
