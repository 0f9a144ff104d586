"""The recurrent acoustic models (port of ``pytorch_kaldi_cgs_tpu/models/
recurrent.py``: ``_RecurrentBase``, ``LSTM``, ``GRU``, ``liGRU``,
``minimalGRU`` and ``RNN``, and the cuDNN-class ``_CudnnBase``, ``LSTM_cudnn``,
``GRU_cudnn`` and ``RNN_cudnn``).

Time-major (T, B, F). Per layer: one fused input projection for all the
x-gates (HCGS mask + quantizer applied to the weights), batch norm on
each gate projection named in ``bn_gates`` over the flattened (T*B)
axis, then the cell's recurrence. A cell names its gates and implements
``_recurrence``; everything else lives in :class:`_RecurrentBase`.

A layer's recurrence runs its cell's fused kernels (the CUDA kernels on
the card, their plain twins on the CPU; under autograd the BPTT kernels
give the gradients) whenever the layer has no in-scan layer norm, its
activation is tanh, relu, htanh or linear and its width fits the dense
kernels' shared memory (``_fused_ok``: the forward's, and under autograd
the backward's, ``fused_lstm.dense_max_width``); otherwise a plain step
loop that autograd differentiates, as the JAX package runs its
``lax.scan`` beyond its own size rule. LSTM: ``ops.fused_lstm``,
streaming passes the (h, c) carries to the seeded-carry variant. liGRU,
GRU, minimalGRU and RNN: ``ops.fused_rnn``, in float32 whatever the
compute dtype, as the JAX package's fused liGRU, GRU, minimalGRU and
RNN; streaming passes the h carry to the seeded forward. The JAX
package's VMEM size rules and ``*_fused_scan`` options do not choose
the path here: the kernels take any batch.

Block sparsity (``<prefix>_block_sparse``: auto by default, True or
False), by the JAX package's rules: an LSTM, GRU, liGRU or minimalGRU
layer whose recurrent HCGS mask at 128-multiple blocks drops at least
half the blocks of each row runs its whole-utterance recurrence over the
kept blocks only (``fused_lstm.lstm_scan_fused_sparse``, ``fused_rnn.
gru_scan_fused_sparse``, ``fused_rnn.ligru_scan_fused_sparse``,
``fused_rnn.mgru_scan_fused_sparse``), in float32 whatever the compute
dtype, as the JAX package does, at any batch; they stream on their
dense seeded kernels over the masked U. The RNN takes the same rule
(``fused_rnn.rnn_scan_fused_sparse``). An
x-projection the JAX package puts on its v3 block-sparse kernels (128-
multiple blocks; under auto from 16 column blocks with at least half of
each row's dropped) runs on them here too
(``block_sparse.block_sparse_matmul_v3``, float32 whatever the compute
dtype): from the packed ``<gate><i>__bs`` leaves after
``pack_variables`` (training), else from kept blocks gathered out of the
dense weights (serving); every other HCGS projection runs dense-masked.
Sequence parallelism is not ported.

The cuDNN-class wrappers keep torch's parameter names and gate orders:
``LSTM_cudnn`` permutes (i, f, g, o) onto the fused LSTM's (f, i, o, c),
``RNN_cudnn`` runs the fused RNN; both fold ``b_hh`` into the
projection and take a mask of ones. ``GRU_cudnn`` runs the
torch-semantics GRU kernels in torch's gate order (r, z, n), with
``b_hh`` passed apart: ``b_hn`` sits inside ``r * (U_n h + b_hn)``. A
width the kernels do not take runs a plain step loop of the same cell.
All three run a second direction over the time-flipped input, stream
(unidirectional) on the seeded kernels and ignore the compute dtype, as
in the JAX package. Their inter-layer dropout is inverted and drawn from
the caller's generator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from .._device import DeviceLike
from ..ops import block_sparse as BS
from ..ops import fused_lstm, fused_rnn
from ..sparsity import hcgs as hcgs_mod
from ..sparsity.quantize import bf16_round
from .base import (AcousticModel, CompressionSpec, effective_weight,
                   flag_list, host_mask, maybe_quant_input, opt_bool,
                   v3_projection_layout, v3_submask)
from .layers import (act_fun, batch_norm, batch_norm_params, batch_norm_state,
                     dropout, layer_norm, layer_norm_params, orthogonal_init,
                     shared_time_drop_mask, torch_linear_init)


class _RecurrentBase(AcousticModel):
    """Shared construction and execution of the recurrent cells."""

    prefix: str            # option prefix: lstm / ligru
    cell: str              # the dense kernels' cell (fused_lstm._DENSE_SMEM)
    gates_x: List[str]     # input projection names, e.g. [wfx, wix, wox, wcx]
    gates_h: List[str]     # recurrent projection names, e.g. [ufh, ...]
    bn_gates: List[str]    # which input projections get batch norm

    def __init__(self, options: Mapping[str, Any], inp_dim: int, *,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__(options, inp_dim, device)
        p = self.prefix
        self.block_sparse_mode = str(
            options.get(p + "_block_sparse", "auto") or "auto").strip()
        self.block_sparse = self.block_sparse_mode.lower() not in (
            "false", "0", "no")
        self._rec_layouts: Dict[int, BS.BlockLayout] = {}
        # x-projections on the v3 kernels: layer -> (layout, sub3)
        self._bs_layouts: Dict[int, Any] = {}
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
                for g in self.bn_gates:
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

    # -- block-sparse layouts ---------------------------------------------
    def prepare_block_sparse(self, variables=None) -> None:
        """Derive the static level-1 block layouts from the HCGS masks
        (``variables``, default this model's own), by the JAX package's
        ``prepare_block_sparse`` rules: the recurrent layouts the fused
        sparse recurrence takes, and the x-projections on the v3 kernels
        with their level-2 submasks in the w3 layout (the x-gates'
        stacked along the gate axis)."""
        self._rec_layouts, self._bs_layouts = {}, {}
        if not (self.block_sparse and self.spec.hcgs):
            return
        if self.spec.guided_hcgs or self.spec.if_pattern or self.spec.prune:
            return   # dynamic-mask modes stay on the dense-masked path
        masks = (variables or self.variables())["masks"]
        self._prepare_sparse_recurrence(masks)
        bs = self.spec.hcgsx_block[0] if self.spec.hcgsx_block else 0
        for i in range(self.N):
            layout = v3_projection_layout(
                host_mask(masks, "hcgs_%s%d" % (self.gates_x[0], i)), bs,
                self.block_sparse_mode)
            if layout is not None:
                self._bs_layouts[i] = (layout, v3_submask(
                    masks, self._x_keys(i), layout, self.device))

    def _x_keys(self, i: int) -> List[str]:
        return ["%s%d" % (g, i) for g in self.gates_x]

    def _v3_weights(self):
        return [(layout, self._x_keys(i))
                for i, (layout, _) in self._bs_layouts.items()]

    def _prepare_sparse_recurrence(self, masks) -> None:
        """The block-sparse fused-recurrence layout of each layer over
        its (H, H) recurrent mask, shared by the h-gates: only with a
        real cut (at least half the blocks of a row dropped)."""
        bs = self.spec.hcgsh_block[0] if self.spec.hcgsh_block else 0
        if not bs or bs % 128:
            return
        for i in range(self.N):
            mask = host_mask(masks, "hcgs_%s%d" % (self.gates_h[0], i))
            if mask is None:
                continue
            try:
                layout = BS.pack_layout(mask, bs)
            except ValueError:
                continue
            if layout.R >= 1 and layout.R * 2 <= layout.Kb:
                self._rec_layouts[i] = layout

    def _sparse_rec_layout(self, i: int):
        """Layer ``i``'s block-sparse recurrence layout, or None: no
        layout, in-scan layer norm or another activation. Unlike the JAX
        package the port takes the path at every batch (the sparse
        kernels tile the rows by 8, with no memory limit that grows with
        them) and on every device (its twin on the CPU), as it does the
        dense fused recurrence. The JAX package's size rule
        (``fused_lstm.sparse_scan_fits``) only picks the w3g dtype: bf16
        where it says "bf16", float32 elsewhere, also where it says ""
        and the JAX package runs its float32 ``lax.scan`` over the masked
        U (the same math to float32 rounding)."""
        layout = self._rec_layouts.get(i)
        if (layout is None or self.use_laynorm[i]
                or self.act_names[i] not in fused_lstm.ACTS):
            return None
        return layout

    def _rec_w3g(self, U: torch.Tensor, layout) -> torch.Tensor:
        """The stacked effective (G*H, H) U -> its kept blocks in the w3g
        layout (Nb, G*bs, R*bs), differentiable (the gradient scatters
        back into U)."""
        H, G = U.shape[1], len(self.gates_h)
        gates = [U[g * H:(g + 1) * H] for g in range(G)]
        return BS.v3_from_blocks(BS.gather_blocks_multi(gates, layout),
                                 layout, G)

    # -- helpers ---------------------------------------------------------
    def _stacked(self, names: List[str], i: int) -> torch.Tensor:
        """Effective per-gate weights stacked to (G*H, in)."""
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
        """Input projections of the x-gates + bias, batch norm on the
        ``bn_gates`` -> (T, B, G*H) float32, in ``gates_x`` order. A v3
        layer projects on the block-sparse kernels, with the weight
        quantizer and the level-2 submask applied inside them."""
        T, B, F = x.shape
        xin = maybe_quant_input(x, self.spec).reshape(T * B, F)
        G = len(self.gates_x)
        if i in self._bs_layouts:
            layout, sub3 = self._bs_layouts[i]
            ys = BS.block_sparse_matmul_v3(
                xin, self._v3_w3(self._x_keys(i), layout), layout, G,
                self.spec.layer_bits(i) if self.spec.quant else 0, sub3)
            outs = [y.reshape(T, B, -1) for y in ys]
        else:
            W = self._stacked(self.gates_x, i)
            if self.compute_bf16:
                xin, W = bf16_round(xin), bf16_round(W)
            outs = list(torch.chunk((xin @ W.T).reshape(T, B, -1), G,
                                    dim=-1))
        for k, g in enumerate(self.gates_x):
            bkey = "%s_b%d" % (g, i)
            if bkey in self.params:
                outs[k] = outs[k] + self.params[bkey]
            if self.use_batchnorm[i] and g in self.bn_gates:
                outs[k] = self._norm("bn_%s%d" % (g, i), outs[k], train)
        return torch.cat(outs, dim=-1).contiguous()

    def _rec_qbits(self) -> int:
        """Bits of the recurrent-input quantizer, 0 for none."""
        return (self.spec.inp_quant[0]
                if (self.spec.quant and self.spec.quant_inp) else 0)

    def _fused_ok(self, i: int, grad: bool = False) -> bool:
        """Whether layer ``i``'s recurrence takes the cell's dense fused
        kernels: no in-scan layer norm, an activation they take, and a
        width whose staged rows fit a block's shared memory in the
        forward kernel and, when ``grad``, in the BPTT kernel autograd
        runs. Decided from the shapes alone, on every device: a wider
        layer takes the plain step loop, on the card and on the CPU."""
        limit = fused_lstm.dense_max_width(
            self.cell, fused_lstm.grad_backward(self.cell, grad))
        return (not self.use_laynorm[i] and self.lay[i] <= limit
                and self.act_names[i] in fused_lstm.ACTS)

    def _zero_carry(self, z: torch.Tensor):
        """A fresh stream's carry, from a (B, H) zero tensor."""
        raise NotImplementedError

    def _recurrence(self, gates: torch.Tensor, U: torch.Tensor,
                    drop: torch.Tensor, i: int, carry):
        """-> (hs, final carry). ``carry`` None = zero initial state, for
        a whole utterance (the final carry is then not returned)."""
        raise NotImplementedError

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
                carry = (carries[i] if i < len(carries)
                         else self._zero_carry(x.new_zeros((B, H))))
            h, fin = self._recurrence(gates, U, drop, i, carry)
            carries_out.append(fin)
            if self.bidir:
                h = torch.cat([h[:, :orig_B], torch.flip(h[:, orig_B:], [0])],
                              dim=2)
            x = h
        return x, (None if carries is None else carries_out)


class LSTM(_RecurrentBase):
    """4-gate LSTM: f/i/o sigmoid gates, candidate through the layer
    activation, per-sequence dropout on the candidate term only,
    optional layer norm on h."""

    prefix = cell = "lstm"
    gates_x = ["wfx", "wix", "wox", "wcx"]
    gates_h = ["ufh", "uih", "uoh", "uch"]
    bn_gates = ["wfx", "wix", "wox", "wcx"]

    def _zero_carry(self, z):
        return (z, z)

    def _recurrence(self, gates, U, drop, i, carry):
        act = self.act_names[i]
        qb = self._rec_qbits()
        cdt = "bf16" if self.compute_bf16 else ""
        if carry is None:
            layout = self._sparse_rec_layout(i)
            if layout is not None:
                return fused_lstm.lstm_scan_fused_sparse(
                    gates, self._rec_w3g(U, layout), layout, drop, act=act,
                    quant_bits=qb), None
        if self._fused_ok(i, fused_lstm._needs_grad(gates, U)):
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
        in-scan layer norm on h, another activation, or a width beyond
        the dense kernels'."""
        T, B, G4 = gates.shape
        H = G4 // 4
        actf = act_fun(self.act_names[i])
        rec_u = fused_lstm.dense_u(U, self.compute_bf16)
        h, c = carry if carry is not None else (gates.new_zeros((B, H)),) * 2
        hs = []
        for t in range(T):
            h, c, _ = fused_lstm.lstm_cell(gates[t], h, c, rec_u, drop, actf,
                                           qb, self.compute_bf16)
            if self.use_laynorm[i]:
                h = layer_norm(h, self.params["ln%d/gamma" % i],
                               self.params["ln%d/beta" % i])
            hs.append(h)
        return torch.stack(hs), (h, c)


class GRU(_RecurrentBase):
    """GRU with update and reset gates; gates ordered [h, z, r]
    (candidate first), U stacked [Uh; Uz; Ur], batch norm on all three
    gate projections. The reset gate scales the candidate's recurrent
    input: a = act(g_h + q(r * h) @ Uh.T)."""

    prefix = cell = "gru"
    gates_x = ["wh", "wz", "wr"]
    gates_h = ["uh", "uz", "ur"]
    bn_gates = ["wh", "wz", "wr"]

    def _zero_carry(self, z):
        return z

    def _recurrence(self, gates, U, drop, i, carry):
        act = self.act_names[i]
        qb = self._rec_qbits()
        if carry is None:
            layout = self._sparse_rec_layout(i)
            if layout is not None:
                return fused_rnn.gru_scan_fused_sparse(
                    gates, self._rec_w3g(U, layout), layout, drop, act=act,
                    quant_bits=qb), None
        if self._fused_ok(i, fused_lstm._needs_grad(gates, U)):
            if carry is None:
                return fused_rnn.gru_scan_fused(
                    gates, U, drop, act=act, quant_bits=qb), None
            return fused_rnn.gru_scan_fused_stream(
                gates, U, drop, carry, act=act, quant_bits=qb)
        return self._steps_plain(gates, U, drop, i, carry, qb)

    def _steps_plain(self, gates, U, drop, i, carry, qb):
        """Plain step loop (the JAX package's ``lax.scan`` step) for the
        layers the kernels do not take: in-scan layer norm on h, another
        activation, or a width beyond the dense kernels'; bf16-rounded
        recurrent dots under bf16."""
        T, B, G3 = gates.shape
        H = G3 // 3
        actf = act_fun(self.act_names[i])
        rec_h = fused_lstm.dense_u(U[:H], self.compute_bf16)
        rec_zr = fused_lstm.dense_u(U[H:], self.compute_bf16)
        h = carry if carry is not None else gates.new_zeros((B, H))
        hs = []
        for t in range(T):
            h, _ = fused_rnn.gru_cell(gates[t], h, rec_zr, rec_h, drop, actf,
                                      qb, self.compute_bf16)
            if self.use_laynorm[i]:
                h = layer_norm(h, self.params["ln%d/gamma" % i],
                               self.params["ln%d/beta" % i])
            hs.append(h)
        return torch.stack(hs), h


class liGRU(_RecurrentBase):
    """Light GRU: one update gate z, a candidate through the layer
    activation with per-sequence dropout, no reset gate; gates ordered
    [h, z] (candidate first), U stacked [Uh; Uz]. A layer with a sparse
    recurrent layout runs the block-sparse liGRU kernels at every batch
    (``_sparse_rec_layout``: w3g in bf16 only where the JAX size rule
    says "bf16"; where it says "", the JAX package runs its float32
    ``lax.scan`` over the masked U, the same math to float32 rounding);
    a stream drops the layout and runs the dense seeded forward over the
    masked U, as the JAX package does."""

    prefix = cell = "ligru"
    gates_x = ["wh", "wz"]
    gates_h = ["uh", "uz"]
    bn_gates = ["wh", "wz"]

    def _zero_carry(self, z):
        return z

    def _recurrence(self, gates, U, drop, i, carry):
        act = self.act_names[i]
        qb = self._rec_qbits()
        if carry is None:
            layout = self._sparse_rec_layout(i)
            if layout is not None:
                return fused_rnn.ligru_scan_fused_sparse(
                    gates, self._rec_w3g(U, layout), layout, drop, act=act,
                    quant_bits=qb), None
        if self._fused_ok(i, fused_lstm._needs_grad(gates, U)):
            if carry is None:
                return fused_rnn.ligru_scan_fused(
                    gates, U, drop, act=act, quant_bits=qb), None
            return fused_rnn.ligru_scan_fused_stream(
                gates, U, drop, carry, act=act, quant_bits=qb)
        return self._steps_plain(gates, U, drop, i, carry, qb)

    def _steps_plain(self, gates, U, drop, i, carry, qb):
        """Plain step loop (the JAX package's ``lax.scan`` step) for the
        layers the kernels do not take (layer norm, another activation,
        a width beyond the dense kernels'): the recurrent dots take
        bf16-rounded inputs under bf16 compute."""
        T, B, G2 = gates.shape
        actf = act_fun(self.act_names[i])
        rec_u = fused_lstm.dense_u(U, self.compute_bf16)
        h = carry if carry is not None else gates.new_zeros((B, G2 // 2))
        hs = []
        for t in range(T):
            h, _ = fused_rnn.ligru_cell(gates[t], h, rec_u, drop, actf, qb,
                                        self.compute_bf16)
            if self.use_laynorm[i]:
                h = layer_norm(h, self.params["ln%d/gamma" % i],
                               self.params["ln%d/beta" % i])
            hs.append(h)
        return torch.stack(hs), h


class minimalGRU(_RecurrentBase):
    """Minimal GRU (the reference's neural_networks.py:1602-1777): the
    liGRU's gates, parameter names and batch norm, gates ordered [h, z]
    (candidate first), U stacked [Uh; Uz], with z also gating the
    candidate's recurrent input: a = act(g_h + q(z * h) @ Uh.T). A layer
    with a sparse recurrent layout runs the block-sparse minimalGRU
    kernels at every batch (w3g in bf16 only where the JAX size rule says
    "bf16"); a stream drops the layout and runs the dense seeded forward
    over the masked U, as the JAX package does."""

    prefix, cell = "minimalgru", "mgru"
    gates_x = ["wh", "wz"]
    gates_h = ["uh", "uz"]
    bn_gates = ["wh", "wz"]

    def _zero_carry(self, z):
        return z

    def _recurrence(self, gates, U, drop, i, carry):
        act = self.act_names[i]
        qb = self._rec_qbits()
        if carry is None:
            layout = self._sparse_rec_layout(i)
            if layout is not None:
                return fused_rnn.mgru_scan_fused_sparse(
                    gates, self._rec_w3g(U, layout), layout, drop, act=act,
                    quant_bits=qb), None
        if self._fused_ok(i, fused_lstm._needs_grad(gates, U)):
            if carry is None:
                return fused_rnn.mgru_scan_fused(
                    gates, U, drop, act=act, quant_bits=qb), None
            return fused_rnn.mgru_scan_fused_stream(
                gates, U, drop, carry, act=act, quant_bits=qb)
        return self._steps_plain(gates, U, drop, i, carry, qb)

    def _steps_plain(self, gates, U, drop, i, carry, qb):
        """Plain step loop (the JAX package's ``lax.scan`` step) for the
        layers the kernels do not take: in-scan layer norm on h, another
        activation, or a width beyond the dense kernels'; under bf16
        compute both recurrent dots take
        bf16-rounded inputs, q(z * h) quantized before Uh, as the JAX
        ``_rmm(z * h, Uh)``."""
        T, B, G2 = gates.shape
        H = G2 // 2
        actf = act_fun(self.act_names[i])
        rec_h = fused_lstm.dense_u(U[:H], self.compute_bf16)
        rec_z = fused_lstm.dense_u(U[H:], self.compute_bf16)
        h = carry if carry is not None else gates.new_zeros((B, H))
        hs = []
        for t in range(T):
            h, _ = fused_rnn.mgru_cell(gates[t], h, rec_z, rec_h, drop, actf,
                                       qb, self.compute_bf16)
            if self.use_laynorm[i]:
                h = layer_norm(h, self.params["ln%d/gamma" % i],
                               self.params["ln%d/beta" % i])
            hs.append(h)
        return torch.stack(hs), h


class RNN(_RecurrentBase):
    """Vanilla RNN: h = act(g + q(h) @ U.T) * drop, where the dropout
    scales the whole hidden state (at eval the scalar 1 - p, not
    inverted); one gate projection with batch norm. A layer with a
    sparse recurrent layout runs the block-sparse RNN kernels at every
    batch (w3g in bf16 only where the JAX size rule says "bf16"; where it
    says "", the JAX package runs its dense float32 recurrence over the
    masked U, the same math to float32 rounding); a stream drops the
    layout and runs the dense seeded forward over the masked U, as the
    JAX package does."""

    prefix = cell = "rnn"
    gates_x = ["wh"]
    gates_h = ["uh"]
    bn_gates = ["wh"]

    def _zero_carry(self, z):
        return z

    def _recurrence(self, gates, U, drop, i, carry):
        act = self.act_names[i]
        qb = self._rec_qbits()
        if carry is None:
            layout = self._sparse_rec_layout(i)
            if layout is not None:
                return fused_rnn.rnn_scan_fused_sparse(
                    gates, self._rec_w3g(U, layout), layout, drop, act=act,
                    quant_bits=qb), None
        if self._fused_ok(i, fused_lstm._needs_grad(gates, U)):
            if carry is None:
                return fused_rnn.rnn_scan_fused(
                    gates, U, drop, act=act, quant_bits=qb), None
            return fused_rnn.rnn_scan_fused_stream(
                gates, U, drop, carry, act=act, quant_bits=qb)
        return self._steps_plain(gates, U, drop, i, carry, qb)

    def _steps_plain(self, gates, U, drop, i, carry, qb):
        """Plain step loop (the JAX package's ``lax.scan`` step) for the
        layers the kernels do not take: in-scan layer norm on h, another
        activation, or a width beyond the dense kernels'; bf16-rounded
        recurrent dots under bf16."""
        T, B, H = gates.shape
        actf = act_fun(self.act_names[i])
        rec_u = fused_lstm.dense_u(U, self.compute_bf16)
        h = carry if carry is not None else gates.new_zeros((B, H))
        hs = []
        for t in range(T):
            h, _ = fused_rnn.rnn_cell(gates[t], h, rec_u, drop, actf, qb,
                                      self.compute_bf16)
            if self.use_laynorm[i]:
                h = layer_norm(h, self.params["ln%d/gamma" % i],
                               self.params["ln%d/beta" % i])
            hs.append(h)
        return torch.stack(hs), h


# ---------------------------------------------------------------------------
# the "cudnn-class" wrappers: plain multi-layer cells with torch's
# parameter names and gate orders, input and recurrent biases, inverted
# inter-layer dropout and a second direction over the time-flipped input.
# As in the JAX package they run the custom cells' fused kernels (b_hh
# folded into the time-batched projection, a mask of ones) and ignore the
# compute dtype.
# ---------------------------------------------------------------------------

class _CudnnBase(AcousticModel):
    """Shared construction and execution of ``LSTM_cudnn``, ``GRU_cudnn``
    and ``RNN_cudnn``: per layer and direction ``w_ih_l<i>[_r]`` (G*H, in),
    ``w_hh_l<i>[_r]`` (G*H, H) and, with ``bias``, ``b_ih_*`` and
    ``b_hh_*`` (G*H,), drawn U(+-1/sqrt(H)) in the JAX package's order."""

    n_gates: int
    cell: str              # the dense kernels' cell (fused_lstm._DENSE_SMEM)

    def __init__(self, options: Mapping[str, Any], inp_dim: int, *,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__(options, inp_dim, device)
        self.hidden_size = int(options["hidden_size"])
        self.num_layers = int(options["num_layers"])
        self.bias = opt_bool(options, "bias", True)
        self.bidirectional = opt_bool(options, "bidirectional", False)
        self.dropout_p = float(options.get("dropout", 0.0) or 0.0)
        self.out_dim = self.hidden_size * (2 if self.bidirectional else 1)
        self.init(seed)

    def init_variables(self, seed: int) -> Dict[str, Any]:
        rng = np.random.RandomState(seed)
        params: Dict[str, Any] = {}
        cur, H = self.input_dim, self.hidden_size
        nd = 2 if self.bidirectional else 1
        k = 1.0 / np.sqrt(H)
        for i in range(self.num_layers):
            for d in range(nd):
                sfx = "l%d%s" % (i, "_r" if d else "")
                params["w_ih_" + sfx] = rng.uniform(
                    -k, k, (self.n_gates * H, cur)).astype(np.float32)
                params["w_hh_" + sfx] = rng.uniform(
                    -k, k, (self.n_gates * H, H)).astype(np.float32)
                if self.bias:
                    params["b_ih_" + sfx] = rng.uniform(
                        -k, k, (self.n_gates * H,)).astype(np.float32)
                    params["b_hh_" + sfx] = rng.uniform(
                        -k, k, (self.n_gates * H,)).astype(np.float32)
            cur = H * nd
        return {"params": params, "state": {}, "masks": {}}

    def _zero_carry(self, z: torch.Tensor):
        raise NotImplementedError

    def _fused_ok(self, *ts: Optional[torch.Tensor]) -> bool:
        """Whether the width fits the cell's dense kernels: the forward's
        and, when any of ``ts`` needs a gradient, the backward's
        (``_RecurrentBase._fused_ok``'s rule); else a plain step loop."""
        return self.hidden_size <= fused_lstm.dense_max_width(
            self.cell, fused_lstm.grad_backward(self.cell,
                                                fused_lstm._needs_grad(*ts)))

    def _scan(self, gates: torch.Tensor, W_hh: torch.Tensor,
              b_hh: Optional[torch.Tensor], carry):
        """The recurrence over the projection (b_ih added) with the
        recurrent bias ``b_hh`` (None without bias) -> (hs, final carry);
        ``carry`` None = zero initial state."""
        raise NotImplementedError

    def _dir(self, x: torch.Tensor, sfx: str, carry):
        proj = x @ self.params["w_ih_" + sfx].T
        b_hh = None
        if self.bias:
            proj = proj + self.params["b_ih_" + sfx]
            b_hh = self.params["b_hh_" + sfx]
        return self._scan(proj.contiguous(), self.params["w_hh_" + sfx], b_hh,
                          carry)

    def _run(self, x: torch.Tensor, train: bool, carries,
             generator: Optional[torch.Generator]):
        carries_out = []
        for i in range(self.num_layers):
            carry = None
            if carries is not None:       # streaming: fresh streams start at 0
                carry = (carries[i] if i < len(carries) else
                         self._zero_carry(x.new_zeros((x.shape[1],
                                                       self.hidden_size))))
            h, fin = self._dir(x, "l%d" % i, carry)
            carries_out.append(fin)
            if self.bidirectional:
                h_r, _ = self._dir(torch.flip(x, [0]), "l%d_r" % i, None)
                h = torch.cat([h, torch.flip(h_r, [0])], dim=2)
            x = h
            if i < self.num_layers - 1:
                x = dropout(x, self.dropout_p, train, generator)
        return x, (None if carries is None else carries_out)


class LSTM_cudnn(_CudnnBase):
    """torch's ``nn.LSTM`` (gates i, f, g, o) on the dense fused LSTM
    kernels: the gates permuted to the kernels' (f, i, o, c)."""

    n_gates, cell = 4, "lstm"
    PERM = [1, 0, 3, 2]       # ifgo -> fioc

    def _zero_carry(self, z):
        return (z, z)

    def _scan(self, gates, W_hh, b_hh, carry):
        B, H = gates.shape[1], self.hidden_size
        gates = gates if b_hh is None else gates + b_hh
        g = torch.cat([gates.chunk(4, dim=-1)[k] for k in self.PERM], dim=-1)
        U = torch.cat([W_hh.chunk(4, dim=0)[k] for k in self.PERM])
        ones = g.new_ones((B, H))
        if not self._fused_ok(g, U):
            rec_u = fused_lstm.dense_u(U, False)
            h, c = carry if carry is not None else (g.new_zeros((B, H)),) * 2
            hs = []
            for t in range(g.shape[0]):
                h, c, _ = fused_lstm.lstm_cell(g[t], h, c, rec_u, ones,
                                               torch.tanh, 0, False)
                hs.append(h)
            return torch.stack(hs), (h, c)
        if carry is None:
            return fused_lstm.lstm_scan_fused(g, U, ones, act="tanh"), None
        return fused_lstm.lstm_scan_fused_stream(g, U, ones, carry[0],
                                                 carry[1], act="tanh")


class GRU_cudnn(_CudnnBase):
    """torch's ``nn.GRU`` (gates r, z, n; ``b_hn`` inside the reset
    product) on the torch-semantics GRU kernels."""

    n_gates, cell = 3, "gru_torch"

    def _zero_carry(self, z):
        return z

    def _scan(self, gates, W_hh, b_hh, carry):
        if not self._fused_ok(gates, W_hh, b_hh):
            bh = fused_rnn._b_hh(b_hh, gates)
            h = (carry if carry is not None
                 else gates.new_zeros((gates.shape[1], self.hidden_size)))
            hs = []
            for t in range(gates.shape[0]):
                h, _ = fused_rnn.gru_torch_cell(gates[t], h, W_hh, bh)
                hs.append(h)
            return torch.stack(hs), h
        if carry is None:
            return fused_rnn.gru_cudnn_scan_fused(gates, W_hh, b_hh), None
        return fused_rnn.gru_cudnn_scan_fused_stream(gates, W_hh, b_hh,
                                                     carry)


class RNN_cudnn(_CudnnBase):
    """torch's ``nn.RNN`` (``nonlinearity`` tanh or relu) on the dense
    fused RNN kernels."""

    n_gates, cell = 1, "rnn"

    def __init__(self, options: Mapping[str, Any], inp_dim: int, **kw):
        super().__init__(options, inp_dim, **kw)
        self.act = ("tanh" if "tanh" in options.get("nonlinearity", "tanh")
                    else "relu")

    def _zero_carry(self, z):
        return z

    def _scan(self, gates, W_hh, b_hh, carry):
        gates = gates if b_hh is None else gates + b_hh
        ones = gates.new_ones((gates.shape[1], self.hidden_size))
        if not self._fused_ok(gates, W_hh):
            rec_u, actf = fused_lstm.dense_u(W_hh, False), fused_lstm.ACTS[
                self.act]
            h = carry if carry is not None else torch.zeros_like(ones)
            hs = []
            for t in range(gates.shape[0]):
                h, _ = fused_rnn.rnn_cell(gates[t], h, rec_u, ones, actf, 0)
                hs.append(h)
            return torch.stack(hs), h
        if carry is None:
            return fused_rnn.rnn_scan_fused(gates, W_hh, ones,
                                            act=self.act), None
        return fused_rnn.rnn_scan_fused_stream(gates, W_hh, ones, carry,
                                               act=self.act)
