"""MLP acoustic model (port of ``pytorch_kaldi_cgs_tpu/models/mlp.py``).

A chain of (masked, quantized) matmuls with per-layer batch/layer norm,
activation and dropout. A layer the JAX package's ``mlp_block_sparse``
rule (auto by default) puts on its v3 block-sparse kernels runs on them
here too (``block_sparse.block_sparse_matmul_v3`` at G=1, float32
whatever the compute dtype, the weight quantizer and the level-2 submask
inside the kernels): from the packed ``w<i>__bs`` leaf after
``pack_variables``, else from the kept blocks of the dense weight. Every
other HCGS layer runs dense-masked; the 1944-way and mono heads do under
that rule (their widths are not multiples of 128).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike
from ..sparsity import hcgs as hcgs_mod
from ..sparsity.quantize import bf16_round
from ..ops import block_sparse as BS
from .base import (AcousticModel, CompressionSpec, effective_weight,
                   flag_list, host_mask, maybe_quant_input, opt_bool,
                   v3_projection_layout, v3_submask)
from .layers import (act_fun, batch_norm, batch_norm_params, batch_norm_state,
                     dropout, layer_norm, layer_norm_params,
                     small_uniform_init)


class MLP(AcousticModel):
    def __init__(self, options: Mapping[str, Any], inp_dim: int, *,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__(options, inp_dim, device)
        self.block_sparse_mode = str(
            options.get("mlp_block_sparse", "auto") or "auto").strip()
        self.block_sparse = self.block_sparse_mode.lower() not in (
            "false", "0", "no")
        self._bs_layouts: Dict[int, Any] = {}     # layer -> (layout, sub3)
        self.dnn_lay = [int(v) for v in options["dnn_lay"].split(",")]
        self.dnn_drop = [float(v) for v in options["dnn_drop"].split(",")]
        self.use_batchnorm = flag_list(options, "dnn_use_batchnorm")
        self.use_laynorm = flag_list(options, "dnn_use_laynorm")
        self.use_laynorm_inp = opt_bool(options, "dnn_use_laynorm_inp")
        self.use_batchnorm_inp = opt_bool(options, "dnn_use_batchnorm_inp")
        self.dnn_act = options["dnn_act"].split(",")
        self.spec = CompressionSpec(options, "mlp")
        self.N = len(self.dnn_lay)
        self.out_dim = self.dnn_lay[-1]
        self._acts = [act_fun(a) for a in self.dnn_act]
        self.init(seed)

    def init_variables(self, seed: int) -> Dict[str, Any]:
        rng = np.random.RandomState(seed)
        params: Dict[str, Any] = {}
        state: Dict[str, Any] = {}
        masks: Dict[str, Any] = {}
        if self.use_laynorm_inp:
            params["ln0"] = layer_norm_params(self.input_dim)
        if self.use_batchnorm_inp:
            params["bn0"] = batch_norm_params(self.input_dim)
            state["bn0"] = batch_norm_state(self.input_dim)
        cur = self.input_dim
        for i, out_f in enumerate(self.dnn_lay):
            # U(+-sqrt(0.01/(fan_in+fan_out))), zero bias
            params["w%d" % i] = small_uniform_init(rng, out_f, cur)
            params["b%d" % i] = np.zeros(out_f, np.float32)
            if self.use_laynorm[i]:
                params["ln%d" % i] = layer_norm_params(out_f)
            if self.use_batchnorm[i]:
                params["bn%d" % i] = batch_norm_params(out_f)
                state["bn%d" % i] = batch_norm_state(out_f)
            if self.spec.hcgs:
                masks["hcgs_w%d" % i] = hcgs_mod.hcgs_mask(
                    out_f, cur, self.spec.hcgs_block, self.spec.hcgs_sparse,
                    rng=rng)
            if self.spec.guided_hcgs:
                masks["ghcgs_w%d" % i] = hcgs_mod.guided_hcgs_mask(
                    params["w%d" % i], self.spec.hcgs_block,
                    self.spec.hcgs_sparse, rng=rng)
            cur = out_f
        return {"params": params, "state": state, "masks": masks}

    def prepare_block_sparse(self, variables=None) -> None:
        """The JAX package's rule for its block-sparse matmul path: the
        layouts (and level-2 submasks in the w3 layout) of the layers on
        the v3 kernels; every other layer stays dense-masked."""
        self._bs_layouts = {}
        if not (self.block_sparse and self.spec.hcgs) or \
                self.spec.guided_hcgs or self.spec.if_pattern or self.spec.prune:
            return
        masks = (variables or self.variables())["masks"]
        bs = self.spec.hcgs_block[0] if self.spec.hcgs_block else 0
        for i in range(self.N):
            layout = v3_projection_layout(host_mask(masks, "hcgs_w%d" % i),
                                          bs, self.block_sparse_mode)
            if layout is not None:
                self._bs_layouts[i] = (layout, v3_submask(
                    masks, ["w%d" % i], layout, self.device))

    def _v3_weights(self):
        return [(layout, ["w%d" % i])
                for i, (layout, _) in self._bs_layouts.items()]

    def _bn(self, key: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        return batch_norm(x, self.params[key + "/gamma"],
                          self.params[key + "/beta"], self.state[key + "/mean"],
                          self.state[key + "/var"], train)

    def _ln(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.params[key + "/gamma"],
                          self.params[key + "/beta"])

    def _run(self, x: torch.Tensor, train: bool, carries,
             generator: Optional[torch.Generator]):
        """Frame-wise: x (N, F) -> (N, out_dim); streams trivially (the
        carries come back empty)."""
        if self.use_laynorm_inp:
            x = self._ln("ln0", x)
        if self.use_batchnorm_inp:
            x = self._bn("bn0", x, train)
        for i in range(self.N):
            xin = maybe_quant_input(x, self.spec)
            if i in self._bs_layouts:
                layout, sub3 = self._bs_layouts[i]
                y = BS.block_sparse_matmul_v3(
                    xin, self._v3_w3(["w%d" % i], layout), layout, 1,
                    self.spec.layer_bits(i) if self.spec.quant else 0,
                    sub3)[0] + self.params["b%d" % i]
            else:
                w = effective_weight(self.params["w%d" % i], self.masks,
                                     "w%d" % i, self.spec, i)
                if self.compute_bf16:
                    xin, w = bf16_round(xin), bf16_round(w)
                y = xin @ w.T + self.params["b%d" % i]
            if self.use_laynorm[i]:
                y = self._ln("ln%d" % i, y)
            if self.use_batchnorm[i]:
                y = self._bn("bn%d" % i, y, train)
            y = self._acts[i](y)
            x = dropout(y, self.dnn_drop[i], train, generator)
        return x, ([] if carries is not None else None)
