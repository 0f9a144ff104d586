"""Model meta-language ("DSL") parser: ``out=op(in1,in2)`` lines (the
port's copy of the JAX package's ``config/dsl.py``).

The [model] section of a config wires architectures, features, labels
and cost/combinator ops into a computation graph. The op vocabulary is
declared in ``proto/model.proto`` and validated here; the parsed
:class:`ModelGraph` is what ``runtime.graph.NetGraph`` executes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List

from .proto import ConfigError, resolve_proto

_LINE3 = re.compile(r"^(.+)=(\w+)\(([^,()]+),([^,()]+),([^,()]+)\)$")
_LINE2 = re.compile(r"^(.+)=(\w+)\(([^,()]+),([^,()]+)\)$")


@dataclass
class ModelOp:
    out: str
    op: str
    inputs: List[str]


class ModelGraph:
    """Validated, ordered list of model ops."""

    def __init__(self, ops: List[ModelOp]):
        self.ops = ops


def _load_op_signatures(model_proto_path: str) -> Dict[str, List[str]]:
    sigs: Dict[str, List[str]] = {}
    with open(resolve_proto(model_proto_path)) as f:
        for line in f:
            m = re.match(r"^(\w+)\(([^)]*)\)\s*$", line.strip())
            if m:
                sigs[m.group(1)] = m.group(2).split(",")
    return sigs


def parse_model_lines(model_field: str, model_proto_path: str,
                      fea_names: List[str], lab_names: List[str],
                      arch_names: List[str]) -> ModelGraph:
    sigs = _load_op_signatures(model_proto_path)
    possible_inputs = list(fea_names)
    ops: List[ModelOp] = []
    for raw in model_field.replace(" ", "").split("\n"):
        if not raw:
            continue
        m = _LINE3.match(raw) or _LINE2.match(raw)
        if not m:
            raise ConfigError(
                "model line %r must look like output=operation(in1,in2)" % raw)
        groups = m.groups()
        out, op, inputs = groups[0], groups[1], list(groups[2:])
        if op not in sigs:
            raise ConfigError("model op %r is not declared in %s"
                              % (op, model_proto_path))
        sig = sigs[op]
        if len(inputs) != len(sig):
            raise ConfigError("model op %r takes %d inputs, got %d in %r"
                              % (op, len(sig), len(inputs), raw))
        for kind, inp in zip(sig, inputs):
            if kind == "architecture" and inp not in arch_names:
                raise ConfigError("architecture %r not defined (have %s)"
                                  % (inp, arch_names))
            elif kind == "label" and inp not in lab_names:
                raise ConfigError("label %r not defined (have %s)"
                                  % (inp, lab_names))
            elif kind == "input" and inp not in possible_inputs:
                raise ConfigError("input %r not defined before this line "
                                  "(available: %s)" % (inp, possible_inputs))
            elif kind in ("float", "lambda", "blk_size"):
                try:
                    float(inp)
                except ValueError:
                    raise ConfigError("input %r of op %r must be numeric"
                                      % (inp, op))
        possible_inputs.append(out)
        ops.append(ModelOp(out, op, inputs))

    joined = "".join(o.out for o in ops)
    if "loss_final" not in joined:
        raise ConfigError("the model must define loss_final")
    if "err_final" not in joined:
        raise ConfigError("the model must define err_final")
    return ModelGraph(ops)
