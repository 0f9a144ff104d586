"""Variables between the two packages.

The JAX package keeps a model's variables as a nested tree
``{"params": {...}, "state": {...}, "masks": {...}}`` of numpy arrays,
e.g. ``params["wfx0"]``, ``params["bn_wfx0"]["gamma"]``,
``state["bn_wfx0"]["mean"]``, ``masks["hcgs_wfx0"]``. The port keeps
the same leaves as tensors under flat keys that join the nested names
with ``/`` (``"bn_wfx0/gamma"``): the key names are the JAX package's.
A graph of nets (``runtime.graph.NetGraph``) keeps one such tree per
architecture name, as the JAX package's graph variables do. HCGS masks
cross as float32 0/1 arrays both ways, so both packages derive the same
block-sparse layouts from them; a trained net's packed v3 weights
(``wh1__bs``, (Nb, bs, R*bs), after ``pack_variables``) cross as leaves
like any other.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

COLLECTIONS = ("params", "state", "masks")


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = prefix + k
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def from_jax_variables(np_tree: Mapping[str, Any]
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX-package variables (numpy or array-likes) -> the port's
    ``{"params","state","masks"}`` of flat-keyed float32 CPU tensors,
    ready for ``AcousticModel.load_variables``."""
    return {c: {k: torch.tensor(np.asarray(v, dtype=np.float32))
                for k, v in flatten(np_tree.get(c, {})).items()}
            for c in COLLECTIONS}


def to_jax_variables(tree: Mapping[str, Mapping[str, torch.Tensor]]
                     ) -> Dict[str, Any]:
    """The inverse: flat-keyed tensors -> the JAX package's nested numpy
    tree."""
    return {c: unflatten({k: v.detach().cpu().numpy()
                          for k, v in tree.get(c, {}).items()})
            for c in COLLECTIONS}


def to_jax_graph_variables(trees: Mapping[str, Mapping[str, Mapping[str,
                                                                  torch.Tensor]]]
                           ) -> Dict[str, Any]:
    """Per-architecture flat trees (``NetGraph.variables()``) -> the JAX
    package's graph variables ``{arch: {"params","state","masks"}}``."""
    return {arch: to_jax_variables(tree) for arch, tree in trees.items()}
