"""Computation-graph executor for the model DSL (the port of the JAX
package's ``runtime/graph.py``).

Given a chunk config and the loaded chunk layout, instantiate every
architecture the [model] section uses (as ``nn.Module``s), then execute
the DSL ops over one batch tensor. Losses and error are padding-masked:
padded frames carry a 0 weight (``frame_mask``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .. import convert
from .._device import DeviceLike, resolve_device
from ..config.dsl import ModelGraph, parse_model_lines
from ..config.experiment import dict_fea_lab_arch
from ..config.proto import strtobool
from ..data.dataset import ChunkData
from ..models import get_model_class


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return values.mean()
    m = mask.reshape(values.shape)
    return (values * m).sum() / torch.clamp(m.sum(), min=1.0)


class NetGraph:
    """Nets + DSL ops for one chunk config.

    Construction walks the compute ops in order, resolving each
    architecture's class through ``arch_library``/``arch_class`` and
    threading output dims. Net *i* (in first-use order) is built from
    ``seed + i``, as ``init_variables(seed)`` rebuilds it."""

    def __init__(self, config, chunk: ChunkData, *, seed: int = 0,
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.to_do = config["exp"]["to_do"]
        fea_streams, lab_streams, arch_secs = dict_fea_lab_arch(config)
        self.fea_cols = {name: (s.col_start, s.col_end)
                         for name, s in chunk.fea_streams.items()}
        self.lab_cols = {name: s.col for name, s in chunk.lab_streams.items()}
        self.arch_secs = arch_secs
        fea_names = (list(chunk.fea_streams) or [f.name for f in fea_streams])
        lab_names = (list(chunk.lab_streams) or [l.name for l in lab_streams])
        self.graph: ModelGraph = parse_model_lines(
            config["model"]["model"], config["model"]["model_proto"],
            fea_names, lab_names, list(arch_secs))

        self.seq_flags: Dict[str, bool] = {}
        self.nets: Dict[str, Any] = {}
        self.net_order: List[str] = []
        dims = {name: c[1] - c[0] for name, c in self.fea_cols.items()}
        for op in self.graph.ops:
            if op.op == "compute":
                arch, inp = op.inputs
                sec = arch_secs[arch]
                options = dict(config.items(sec))
                options["to_do"] = self.to_do
                options["arch_name"] = options.get("arch_name", arch)
                if arch not in self.nets:
                    cls = get_model_class(options["arch_library"],
                                          options["arch_class"])
                    self.nets[arch] = cls(options, dims[inp],
                                          seed=seed + len(self.net_order),
                                          device=self.device)
                    self.net_order.append(arch)
                self.seq_flags[arch] = strtobool(config[sec]["arch_seq_model"])
                dims[op.out] = self.nets[arch].out_dim
            elif op.op == "concatenate":
                dims[op.out] = dims[op.inputs[0]] + dims[op.inputs[1]]
            else:
                dims[op.out] = 1
        self.dims = dims
        self.freeze = {arch: strtobool(config[arch_secs[arch]]["arch_freeze"])
                       for arch in self.nets}

    # ------------------------------------------------------------------
    def init_variables(self, seed: int) -> Dict[str, Any]:
        """Rebuild net *i*'s variables from ``seed + i``."""
        for i, arch in enumerate(self.net_order):
            self.nets[arch].init(seed + i)
        return self.variables()

    def variables(self) -> Dict[str, Any]:
        """Per net, its flat-keyed ``{"params","state","masks"}``."""
        return {arch: self.nets[arch].variables() for arch in self.net_order}

    def jax_variables(self) -> Dict[str, Any]:
        """Per net, the JAX package's nested numpy tree."""
        return convert.to_jax_graph_variables(self.variables())

    # ------------------------------------------------------------------
    def forward(self, inp: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None,
                frame_mask: Optional[torch.Tensor] = None,
                forward_outs: Optional[List[str]] = None
                ) -> Dict[str, torch.Tensor]:
        """Execute the DSL over one batch tensor with the nets as they
        stand (train mode updates their batch-norm statistics in place
        and draws dropout masks from ``generator``; frozen nets run in
        eval mode).

        inp: (T, B, C) for sequential chunks or (N, C) for flat chunks,
        where C = feature columns + label columns. frame_mask: (T, B)
        with 1 on real frames (None = all real)."""
        outs: Dict[str, torch.Tensor] = {}
        is_seq_batch = inp.ndim == 3
        if is_seq_batch:
            T, B = inp.shape[0], inp.shape[1]
        for name, (c0, c1) in self.fea_cols.items():
            outs[name] = inp[..., c0:c1]

        def labels_for(lab_name):
            return inp[..., self.lab_cols[lab_name]].reshape(-1).long()

        to_do = self.to_do
        for op in self.graph.ops:
            if op.op == "compute":
                arch, src = op.inputs
                x = outs[src]
                seq = self.seq_flags[arch]
                if x.ndim == 3 and not seq:
                    x = x.reshape(x.shape[0] * x.shape[1], x.shape[2])
                elif x.ndim == 2 and seq and is_seq_batch:
                    x = x.reshape(T, B, -1)
                net_train = train and not self.freeze[arch]
                outs[op.out] = self.nets[arch].run(x, train=net_train,
                                                   generator=generator)
            elif op.op == "concatenate":
                outs[op.out] = torch.cat(
                    [outs[op.inputs[0]], outs[op.inputs[1]]], dim=-1)
            elif op.op == "cost_nll":
                if to_do == "forward":
                    continue
                out = outs[op.inputs[0]]
                logp = out.reshape(-1, out.shape[-1])
                lab = labels_for(op.inputs[1])
                nll = -logp.gather(1, lab[:, None])[:, 0]
                outs[op.out] = _masked_mean(nll, frame_mask)
            elif op.op == "cost_err":
                if to_do == "forward":
                    continue
                out = outs[op.inputs[0]]
                pred = out.reshape(-1, out.shape[-1]).argmax(dim=1)
                lab = labels_for(op.inputs[1])
                err = (pred != lab).to(torch.float32)
                outs[op.out] = _masked_mean(err, frame_mask)
            elif op.op in ("cost_l1", "cost_l2", "cost_gl"):
                if to_do == "forward":
                    continue
                outs[op.out] = self._regularizer(op)
            elif op.op == "mult":
                outs[op.out] = outs[op.inputs[0]] * outs[op.inputs[1]]
            elif op.op == "sum":
                outs[op.out] = outs[op.inputs[0]] + outs[op.inputs[1]]
            elif op.op == "mult_constant":
                outs[op.out] = outs[op.inputs[0]] * float(op.inputs[1])
            elif op.op == "sum_constant":
                outs[op.out] = outs[op.inputs[0]] + float(op.inputs[1])
            elif op.op == "avg":
                outs[op.out] = (outs[op.inputs[0]] + outs[op.inputs[1]]) / 2
            elif op.op == "mse":
                outs[op.out] = torch.mean(
                    (outs[op.inputs[0]] - outs[op.inputs[1]]) ** 2)
            if to_do == "forward" and forward_outs and op.out == forward_outs[-1]:
                break
        return outs

    # ------------------------------------------------------------------
    def _regularizer(self, op) -> torch.Tensor:
        """cost_l1/l2/gl over the >=2-D params of every net that does not
        skip it: a net drops out once its guided-HCGS phase is on or it
        sets skip_regularization (per net, not gated on the first)."""
        lam = float(op.inputs[1])
        total = torch.zeros((), device=self.device)
        for arch in self.net_order:
            net = self.nets[arch]
            spec = getattr(net, "spec", None)
            if spec is not None and (
                    spec.skip_regularization or
                    (spec.guided_hcgs and spec.apply_guided_hcgs)):
                continue
            for key in sorted(net.params):
                leaf = net.params[key]
                if leaf.ndim < 2:
                    continue
                if op.op == "cost_l1":
                    total = total + leaf.abs().sum()
                elif op.op == "cost_l2":
                    total = total + torch.sqrt((leaf ** 2).sum())
                else:  # cost_gl: block l2 norms over a num_blk x num_blk grid
                    nb = int(float(op.inputs[2]))
                    for rows in torch.tensor_split(leaf, nb, dim=0):
                        for blk in torch.tensor_split(rows, nb, dim=1):
                            total = total + torch.sqrt((blk ** 2).sum() + 1e-12)
        return total * lam

    # ------------------------------------------------------------------
    def trainable_filter(self) -> Dict[str, bool]:
        """Per net: whether the optimizer updates it (frozen nets not)."""
        return {arch: not self.freeze[arch] for arch in self.nets}

    def post_chunk_refresh(self, if_prune: bool, seed: int = 0) -> None:
        """Guided-mask regeneration, pattern refresh and prune baking
        between chunks are not ported yet: a net that needs one raises;
        for every other net this is a no-op."""
        for arch in self.net_order:
            spec = getattr(self.nets[arch], "spec", None)
            if spec is None:
                continue
            if ((spec.guided_hcgs and not spec.apply_guided_hcgs)
                    or spec.if_pattern or (spec.prune and if_prune)):
                raise NotImplementedError(
                    "%s: guided/pattern refresh and prune baking between "
                    "chunks are not ported yet" % arch)
