"""MLP acoustic model (port of ``pytorch_kaldi_cgs_tpu/models/mlp.py``,
the dense path).

A chain of (masked, quantized) matmuls with per-layer batch/layer norm,
activation and dropout. HCGS layers run dense-masked; a layer the JAX
package's ``mlp_block_sparse`` rule (auto by default) would put on its
v3 block-sparse kernels raises in :meth:`MLP.prepare_block_sparse`,
since those kernels are not ported yet. The 1944-way and mono heads stay
dense under that rule: their widths are not multiples of 128.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike
from ..sparsity import hcgs as hcgs_mod
from ..sparsity.quantize import bf16_round
from .base import (AcousticModel, CompressionSpec, effective_weight,
                   flag_list, host_mask, maybe_quant_input, opt_bool,
                   v3_projection_layout)
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
        """The JAX package's rule for its block-sparse matmul path: a
        layer it would run on the v3 kernels raises (not ported yet);
        every other layer stays dense-masked."""
        if not (self.block_sparse and self.spec.hcgs) or \
                self.spec.guided_hcgs or self.spec.if_pattern or self.spec.prune:
            return
        masks = (variables or self.variables())["masks"]
        bs = self.spec.hcgs_block[0] if self.spec.hcgs_block else 0
        for i in range(self.N):
            layout = v3_projection_layout(host_mask(masks, "hcgs_w%d" % i),
                                          bs, self.block_sparse_mode)
            if layout is None:
                continue
            raise NotImplementedError(
                "mlp layer %d: the JAX package runs it (Kb=%d, R=%d, "
                "mlp_block_sparse=%s) on its v3 block-sparse kernels "
                "(ops/block_sparse.py:_make_fwd_v3, _make_dx_v3), which are "
                "not ported yet" % (i, layout.Kb, layout.R,
                                    self.block_sparse_mode))

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
