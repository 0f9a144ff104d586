"""The LSTM acoustic model (port of ``pytorch_kaldi_cgs_tpu/models/
recurrent.py``: ``_RecurrentBase`` and ``LSTM``).

Time-major (T, B, F). Per layer: one fused input projection for the four
gates (HCGS mask + quantizer applied to the weights), batch norm on each
gate projection over the flattened (T*B) axis, then the recurrence. The
recurrence runs the fused LSTM (``ops.fused_lstm``: the CUDA kernels on
the card, their plain twins on the CPU; under autograd the BPTT kernels
give the gradients) whenever the layer has no in-scan layer norm and its
activation is tanh, relu, htanh or linear; otherwise a plain step loop
that autograd differentiates. Streaming passes the (h, c) carries as
arguments and takes the seeded-carry variant.

The block-sparse layouts and sequence parallelism of the JAX package are
not ported yet: HCGS layers run dense-masked.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike
from ..ops import fused_lstm
from ..sparsity import hcgs as hcgs_mod
from ..sparsity.quantize import bf16_round
from .base import (AcousticModel, CompressionSpec, effective_weight,
                   flag_list, maybe_quant_input, opt_bool)
from .layers import (act_fun, batch_norm, batch_norm_params, batch_norm_state,
                     layer_norm, layer_norm_params, orthogonal_init,
                     shared_time_drop_mask, torch_linear_init)


class LSTM(AcousticModel):
    """4-gate LSTM: f/i/o sigmoid gates, candidate through the layer
    activation, per-sequence dropout on the candidate term only,
    optional layer norm on h."""

    prefix = "lstm"
    gates_x = ["wfx", "wix", "wox", "wcx"]
    gates_h = ["ufh", "uih", "uoh", "uch"]

    def __init__(self, options: Mapping[str, Any], inp_dim: int, *,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__(options, inp_dim, device)
        p = self.prefix
        if str(options.get(p + "_block_sparse", "")).strip() in (
                "True", "true", "1"):
            raise NotImplementedError(
                "%s_block_sparse=True: the block-sparse kernels are not "
                "ported yet" % p)
        self.lay = [int(v) for v in options[p + "_lay"].split(",")]
        self.drop = [float(v) for v in options[p + "_drop"].split(",")]
        self.use_batchnorm = flag_list(options, p + "_use_batchnorm")
        self.use_laynorm = flag_list(options, p + "_use_laynorm")
        self.use_laynorm_inp = opt_bool(options, p + "_use_laynorm_inp")
        self.use_batchnorm_inp = opt_bool(options, p + "_use_batchnorm_inp")
        self.act_names = options[p + "_act"].split(",")
        self.orthinit = opt_bool(options, p + "_orthinit", True)
        self.bidir = opt_bool(options, p + "_bidir")
        self.spec = CompressionSpec(options, p)
        self.N = len(self.lay)
        self.out_dim = self.lay[-1] * (2 if self.bidir else 1)
        self.init(seed)

    # -- variables -------------------------------------------------------
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
        for i, H in enumerate(self.lay):
            use_norm = self.use_laynorm[i] or self.use_batchnorm[i]
            for g in self.gates_x:
                w, b = torch_linear_init(rng, H, cur)
                params["%s%d" % (g, i)] = w
                if not use_norm:   # norm replaces the bias
                    params["%s_b%d" % (g, i)] = b
            for g in self.gates_h:
                if self.orthinit:
                    params["%s%d" % (g, i)] = orthogonal_init(rng, H, H)
                else:
                    params["%s%d" % (g, i)] = torch_linear_init(rng, H, H)[0]
            if self.use_batchnorm[i]:
                for g in self.gates_x:
                    params["bn_%s%d" % (g, i)] = batch_norm_params(H)
                    state["bn_%s%d" % (g, i)] = batch_norm_state(H)
            if self.use_laynorm[i]:
                params["ln%d" % i] = layer_norm_params(H)
            # HCGS: one mask shared by all x-gates, one by all h-gates
            if self.spec.hcgs:
                mx = hcgs_mod.hcgs_mask(H, cur, self.spec.hcgsx_block,
                                        self.spec.hcgsx_sparse, rng=rng)
                mh = hcgs_mod.hcgs_mask(H, H, self.spec.hcgsh_block,
                                        self.spec.hcgsh_sparse, rng=rng)
                for g in self.gates_x:
                    masks["hcgs_%s%d" % (g, i)] = mx.copy()
                for g in self.gates_h:
                    masks["hcgs_%s%d" % (g, i)] = mh.copy()
            if self.spec.guided_hcgs:
                for g in self.gates_x:
                    masks["ghcgs_%s%d" % (g, i)] = hcgs_mod.guided_hcgs_mask(
                        params["%s%d" % (g, i)], self.spec.hcgsx_block,
                        self.spec.hcgsx_sparse, rng=rng)
                for g in self.gates_h:
                    masks["ghcgs_%s%d" % (g, i)] = hcgs_mod.guided_hcgs_mask(
                        params["%s%d" % (g, i)], self.spec.hcgsh_block,
                        self.spec.hcgsh_sparse, rng=rng)
            cur = H * (2 if self.bidir else 1)
        return {"params": params, "state": state, "masks": masks}

    # -- helpers ---------------------------------------------------------
    def _stacked(self, names: List[str], i: int) -> torch.Tensor:
        """Effective per-gate weights stacked to (4H, in)."""
        return torch.cat([effective_weight(self.params["%s%d" % (g, i)],
                                           self.masks, "%s%d" % (g, i),
                                           self.spec, i) for g in names])

    def _norm(self, key: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Batch norm over the flattened leading axes."""
        flat = x.reshape(-1, x.shape[-1])
        y = batch_norm(flat, self.params[key + "/gamma"],
                       self.params[key + "/beta"], self.state[key + "/mean"],
                       self.state[key + "/var"], train)
        return y.reshape(x.shape)

    def _gates(self, x: torch.Tensor, i: int, train: bool) -> torch.Tensor:
        """Input projections of the four gates + bias or batch norm ->
        (T, B, 4H) float32, gate order (f, i, o, c)."""
        T, B, F = x.shape
        W = self._stacked(self.gates_x, i)
        xin = maybe_quant_input(x, self.spec)
        if self.compute_bf16:
            xin, W = bf16_round(xin), bf16_round(W)
        outs = list(torch.chunk((xin.reshape(T * B, F) @ W.T)
                                .reshape(T, B, -1), 4, dim=-1))
        for k, g in enumerate(self.gates_x):
            bkey = "%s_b%d" % (g, i)
            if bkey in self.params:
                outs[k] = outs[k] + self.params[bkey]
            if self.use_batchnorm[i]:
                outs[k] = self._norm("bn_%s%d" % (g, i), outs[k], train)
        return torch.cat(outs, dim=-1).contiguous()

    def _recurrence(self, gates: torch.Tensor, U: torch.Tensor,
                    drop: torch.Tensor, i: int, carry):
        """-> (hs, final carry). ``carry`` None = zero initial state, for
        a whole utterance (the final carry is then not returned)."""
        act = self.act_names[i]
        qb = (self.spec.inp_quant[0]
              if (self.spec.quant and self.spec.quant_inp) else 0)
        cdt = "bf16" if self.compute_bf16 else ""
        if not self.use_laynorm[i] and act in fused_lstm.ACTS:
            if carry is None:
                return fused_lstm.lstm_scan_fused(
                    gates, U, drop, act=act, quant_bits=qb,
                    compute_dtype=cdt), None
            return fused_lstm.lstm_scan_fused_stream(
                gates, U, drop, carry[0], carry[1], act=act, quant_bits=qb,
                compute_dtype=cdt)
        return self._steps_plain(gates, U, drop, i, carry, qb)

    def _steps_plain(self, gates, U, drop, i, carry, qb):
        """Plain step loop for the layers the kernel does not take:
        in-scan layer norm on h, or another activation."""
        T, B, G4 = gates.shape
        H = G4 // 4
        actf = act_fun(self.act_names[i])
        Uc = bf16_round(U) if self.compute_bf16 else U
        h, c = carry if carry is not None else (gates.new_zeros((B, H)),) * 2
        hs = []
        for t in range(T):
            h, c, _ = fused_lstm.lstm_cell(gates[t], h, c, Uc, drop, actf,
                                           qb, self.compute_bf16)
            if self.use_laynorm[i]:
                h = layer_norm(h, self.params["ln%d/gamma" % i],
                               self.params["ln%d/beta" % i])
            hs.append(h)
        return torch.stack(hs), (h, c)

    # -- forward ---------------------------------------------------------
    def _run(self, x: torch.Tensor, train: bool, carries,
             generator: Optional[torch.Generator]):
        if self.use_laynorm_inp:
            x = layer_norm(x, self.params["ln0/gamma"],
                           self.params["ln0/beta"])
        if self.use_batchnorm_inp:
            x = self._norm("bn0", x, train)
        carries_out = []
        for i, H in enumerate(self.lay):
            orig_B = x.shape[1]
            if self.bidir:
                x = torch.cat([x, torch.flip(x, [0])], dim=1)
            B = x.shape[1]
            drop = shared_time_drop_mask((B, H), self.drop[i], train,
                                         x.device, generator)
            gates = self._gates(x, i, train)
            U = self._stacked(self.gates_h, i)
            carry = None
            if carries is not None:       # streaming: fresh streams start at 0
                z = x.new_zeros((B, H))
                carry = carries[i] if i < len(carries) else (z, z)
            h, fin = self._recurrence(gates, U, drop, i, carry)
            carries_out.append(fin)
            if self.bidir:
                h = torch.cat([h[:, :orig_B], torch.flip(h[:, orig_B:], [0])],
                              dim=2)
            x = h
        return x, (None if carries is None else carries_out)
