"""Model base and the compression wiring shared by the acoustic models.

Models follow the JAX package's construction contract,
``cls(options_dict, inp_dim)`` with ``out_dim``, as ``nn.Module``s:

    model = LSTM(options, inp_dim, seed=0, device="cuda")
    y = model.eval()(x)                       # whole utterance
    y, carries = model.apply_streaming(x_chunk, carries)

A model holds the JAX package's three collections under the same key
names: ``params`` (an ``nn.ParameterDict``), ``state`` (batch-norm
running statistics) and ``masks`` (static 0/1 compression masks), the
last two as buffers. ``init(seed)`` builds them from seeded numpy with
the JAX package's RNG calls, so both packages hold equal arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import convert
from .._device import DeviceLike, resolve_device
from ..config.proto import strtobool
from ..ops import block_sparse as BS
from ..sparsity.quantize import ste_quantize_input, ste_quantize_weight


def opt_bool(options: Mapping[str, Any], key: str, default: bool = False
             ) -> bool:
    if key not in options or options[key] in ("", None):
        return default
    return strtobool(options[key])


def opt_list(options: Mapping[str, Any], key: str, conv, default=None):
    if key not in options or options[key] in ("", None):
        return default if default is not None else []
    return [conv(v) for v in str(options[key]).split(",")]


def flag_list(options: Mapping[str, Any], key: str):
    """Comma-separated per-layer booleans ("True,False")."""
    return [v.strip() in ("True", "true", "1")
            for v in options[key].split(",")]


class CompressionSpec:
    """Per-architecture compression flags parsed from its config section
    (prefix = 'mlp'/'lstm')."""

    def __init__(self, options: Mapping[str, Any], prefix: str):
        self.hcgs = opt_bool(options, prefix + "_hcgs")
        # MLP uses hcgs_block/hcgs_sparse; RNNs use hcgsx_*/hcgsh_*
        self.hcgs_block = opt_list(options, "hcgs_block", int, [])
        self.hcgs_sparse = opt_list(options, "hcgs_sparse", float, [])
        self.hcgsx_block = opt_list(options, "hcgsx_block", int,
                                    self.hcgs_block)
        self.hcgsx_sparse = opt_list(options, "hcgsx_sparse", float,
                                     self.hcgs_sparse)
        self.hcgsh_block = opt_list(options, "hcgsh_block", int,
                                    self.hcgs_block)
        self.hcgsh_sparse = opt_list(options, "hcgsh_sparse", float,
                                     self.hcgs_sparse)
        self.guided_hcgs = opt_bool(options, "guided_hcgs")
        self.apply_guided_hcgs = opt_bool(options, "apply_guided_hcgs")
        self.quant = opt_bool(options, prefix + "_quant")
        self.param_quant = opt_list(options, "param_quant", int, [8])
        self.quant_inp = opt_bool(options, prefix + "_quant_inp")
        self.inp_quant = opt_list(options, "inp_quant", int, [16])
        self.prune = opt_bool(options, prefix + "_prune")
        self.prune_perc = opt_list(options, prefix + "_prune_perc", float,
                                   [0.0])
        self.if_pattern = opt_bool(options, "if_pattern")
        # the net drops out of cost_l1/l2/gl (runtime/graph.py)
        self.skip_regularization = opt_bool(options, "skip_regularization")

    def layer_bits(self, i: int) -> int:
        return self.param_quant[min(i, len(self.param_quant) - 1)]

    def layer_prune_perc(self, i: int) -> float:
        return self.prune_perc[min(i, len(self.prune_perc) - 1)]


def effective_weight(w: torch.Tensor, masks: Mapping[str, torch.Tensor],
                     name: str, spec: CompressionSpec, layer: int
                     ) -> torch.Tensor:
    """Mask pipeline then quantization for one weight matrix, in the
    reference's order: HCGS mask, guided mask (when the guided phase is
    on), pattern mask, magnitude pruning, quantization."""
    m = None
    if spec.hcgs and ("hcgs_" + name) in masks:
        m = masks["hcgs_" + name]
    if spec.guided_hcgs and spec.apply_guided_hcgs and ("ghcgs_" + name) in masks:
        g = masks["ghcgs_" + name]
        m = g if m is None else m * g
    if spec.if_pattern and ("pattern_" + name) in masks:
        p = masks["pattern_" + name]
        m = p if m is None else m * p
    if m is not None:
        w = w * m
    if spec.prune:
        # per-forward global-percentile magnitude mask over this matrix
        # (linear interpolation, as jnp.percentile)
        thresh = torch.quantile(w.abs().flatten(),
                                spec.layer_prune_perc(layer) / 100.0)
        w = torch.where(w.abs() > thresh, w, torch.zeros_like(w))
    if spec.quant:
        w = ste_quantize_weight(w, spec.layer_bits(layer))
    return w


def maybe_quant_input(x: torch.Tensor, spec: CompressionSpec) -> torch.Tensor:
    if spec.quant and spec.quant_inp:
        return ste_quantize_input(x, spec.inp_quant[0])
    return x


def host_mask(masks: Mapping[str, Any], key: str) -> Optional[np.ndarray]:
    """``masks[key]`` as a host numpy array, None when absent."""
    m = masks.get(key)
    if isinstance(m, torch.Tensor):
        return m.detach().cpu().numpy()
    return None if m is None else np.asarray(m)


def v3_submask(masks, keys, layout: BS.BlockLayout, device) -> torch.Tensor:
    """The level-2 submask of the weights ``keys`` in the w3 layout,
    stacked along the gate axis as the v3 kernels read it."""
    return torch.as_tensor(np.concatenate(
        [BS.pack_w3(host_mask(masks, "hcgs_" + k), layout) for k in keys],
        axis=1), dtype=torch.float32, device=device)


def v3_projection_layout(mask: Optional[np.ndarray], bs: int, mode: str
                         ) -> Optional[BS.BlockLayout]:
    """The JAX package's rule (its models' ``prepare_block_sparse``) for
    running a projection on its v3 block-sparse kernels: the layout of a
    128-alignable HCGS mask, padded to whole blocks; under ``auto`` only
    from Kb >= 16 column blocks with at least half of each row's blocks
    dropped. None keeps the projection dense-masked."""
    if mask is None or not bs or bs % 128 or mask.shape[0] % bs:
        return None
    auto = mode.lower() == "auto"
    if auto and -(-mask.shape[1] // bs) < 16:
        return None
    try:
        layout = BS.pack_layout(mask, bs, pad_k=True)
    except ValueError:          # irregular layout
        return None
    if layout.R < 1 or (auto and not (layout.Kb >= 16
                                      and layout.R * 2 <= layout.Kb)):
        return None
    return layout


class TensorDict(nn.Module):
    """A dict of buffers (batch-norm state, masks): moves with the
    module and is saved in its ``state_dict``."""

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._buffers[key]

    def __setitem__(self, key: str, value: torch.Tensor) -> None:
        self.register_buffer(key, value)

    def __contains__(self, key: object) -> bool:
        return key in self._buffers

    def items(self):
        return self._buffers.items()


class AcousticModel(nn.Module):
    """Base: subclasses set ``out_dim`` and implement ``init_variables``
    and ``_run``.

    ``compute_dtype = bf16`` runs the matmul inputs rounded to bf16 with
    float32 accumulation, parameters and carries."""

    out_dim: int

    def __init__(self, options: Mapping[str, Any], inp_dim: int,
                 device: DeviceLike = None):
        super().__init__()
        self.options = options
        self.input_dim = inp_dim
        self.arch_name = options.get("arch_name", self.__class__.__name__)
        cd = str(options.get("compute_dtype", "") or "").lower()
        self.compute_bf16 = cd in ("bf16", "bfloat16")
        self.device = resolve_device(device)
        self.params = nn.ParameterDict()
        self.state = TensorDict()
        self.masks = TensorDict()

    # -- variables -------------------------------------------------------
    def init_variables(self, seed: int) -> Dict[str, Any]:
        """The JAX package's ``init(seed)``: a nested numpy tree."""
        raise NotImplementedError

    def init(self, seed: int) -> "AcousticModel":
        """(Re)build every variable from ``seed``."""
        return self.load_variables(
            convert.from_jax_variables(self.init_variables(seed)))

    def load_variables(self, tree: Mapping[str, Mapping[str, torch.Tensor]]
                       ) -> "AcousticModel":
        """Replace the variables with ``tree`` (flat keys, as
        ``convert.from_jax_variables`` gives), moved to this model's
        device as float32."""
        self.params = nn.ParameterDict({
            k: nn.Parameter(v.to(self.device, torch.float32))
            for k, v in tree.get("params", {}).items()})
        for name in ("state", "masks"):
            coll = TensorDict()
            for k, v in tree.get(name, {}).items():
                coll[k] = v.to(self.device, torch.float32)
            setattr(self, name, coll)
        self.prepare_block_sparse()
        return self

    def prepare_block_sparse(self, variables=None) -> None:
        """Derive the block-sparse layouts from the masks (``variables``,
        default this model's own): the JAX package's host-side step, run
        here whenever the variables load. None by default."""

    def _v3_weights(self):
        """(layout, dense weight keys) of every layer whose projection
        runs on the v3 block-sparse kernels; none by default."""
        return []

    def pack_variables(self) -> None:
        """Move the v3 layers' dense weights into packed storage, as the
        JAX package does before building the optimizer state: ``<key>``
        (N, K) becomes the trainable leaf ``<key>__bs`` (Nb, bs, R*bs),
        the kept blocks only. Idempotent."""
        for layout, keys in self._v3_weights():
            for key in keys:
                if key in self.params:
                    w = self.params.pop(key).detach().cpu().numpy()
                    self.params[key + "__bs"] = nn.Parameter(torch.as_tensor(
                        BS.pack_w3(w, layout), device=self.device))

    def unpack_variables(self) -> None:
        """The inverse of :meth:`pack_variables` (dense weights, dropped
        blocks zero), for export. Idempotent."""
        for layout, keys in self._v3_weights():
            for key in keys:
                if key + "__bs" in self.params:
                    w3 = self.params.pop(key + "__bs").detach().cpu().numpy()
                    self.params[key] = nn.Parameter(torch.as_tensor(
                        BS.unpack_w3(w3, layout), device=self.device))

    def _v3_w3(self, keys, layout) -> torch.Tensor:
        """The kernels' w3 (Nb, G*bs, R*bs) of the weights ``keys``: their
        packed leaves side by side, or (unpacked, as a recognizer keeps
        them) gathered differentiably from the dense weights."""
        if all(k + "__bs" in self.params for k in keys):
            return torch.cat([self.params[k + "__bs"] for k in keys], dim=1)
        return BS.gather_w3([self.params[k] for k in keys], layout)

    def variables(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Flat-keyed tensors of the three collections
        (``convert.to_jax_variables`` gives the JAX tree)."""
        return {"params": {k: v.detach() for k, v in self.params.items()},
                "state": dict(self.state.items()),
                "masks": dict(self.masks.items())}

    # -- forward ---------------------------------------------------------
    def _run(self, x: torch.Tensor, train: bool, carries,
             generator: Optional[torch.Generator]):
        """-> (y, carries_out). ``carries`` is None for a whole utterance
        (zero initial state, no carries returned) or a list (empty for
        fresh streams) for streaming."""
        raise NotImplementedError

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Whole-utterance forward; train mode (``self.training``) uses
        batch statistics, updates the running ones in place and draws
        dropout masks from ``generator``."""
        return self._run(x, self.training, None, generator)[0]

    def run(self, x: torch.Tensor, *, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:meth:`forward` in the mode asked for, whatever
        ``self.training`` says (the graph runs frozen nets in eval)."""
        return self._run(x, train, None, generator)[0]

    def apply_streaming(self, x: torch.Tensor, carries=None):
        """Chunked eval-mode inference with carried recurrent state:
        ``carries`` is what the previous call returned (None for fresh
        streams). Feeding the chunks back to back reproduces the
        whole-utterance eval output."""
        if getattr(self, "bidir", False) or getattr(self, "bidirectional",
                                                    False):
            raise ValueError("bidirectional models cannot stream (%s)"
                             % self.arch_name)
        return self._run(x, False, list(carries or []), None)
