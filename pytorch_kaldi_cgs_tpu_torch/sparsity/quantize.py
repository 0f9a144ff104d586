"""Ceil-based symmetric fake quantization with straight-through gradients.

Same arithmetic, in the same order, as the JAX package's
``sparsity/quantize.py``: ``w + (q(w) - w).detach()`` is the
straight-through estimator.
"""

from __future__ import annotations

import torch


def quantize_weight(w: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Clip to [-1, 1], then |w| -> ceil(|w| * 2^(b-1)) / 2^(b-1), sign
    restored."""
    scale = 2.0 ** (num_bits - 1)
    w = torch.clamp(w, -1.0, 1.0)
    return torch.ceil(w.abs() * scale) / scale * torch.sign(w)


def _quantize_by(x: torch.Tensor, var: torch.Tensor, num_bits: int
                 ) -> torch.Tensor:
    scale = 2.0 ** (num_bits - 1)
    safe = torch.where(var == 0, torch.ones_like(var), var)
    q = torch.ceil(x.abs() / safe * scale) / scale * safe * torch.sign(x)
    return torch.where(var == 0, x, q)


def quantize_input(x: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Normalize by max |x| over the whole tensor, ceil-quantize the
    magnitude to 2^(b-1) levels, rescale. No-op on an all-zero tensor."""
    return _quantize_by(x, x.abs().max(), num_bits)


def quantize_input_per_step(x: torch.Tensor, num_bits: int) -> torch.Tensor:
    """:func:`quantize_input` applied to each (B, H) step of a (T, B, H)
    sequence with that step's own scale max|x_t| (the JAX package's
    ``_q_vmap``): the fused recurrence quantizes h per step, so the
    ``dU`` contraction over the unrolled (T*B) batch must too."""
    return _quantize_by(x, x.abs().amax(dim=tuple(range(1, x.ndim)),
                                        keepdim=True), num_bits)


def ste_quantize_weight(w: torch.Tensor, num_bits: int) -> torch.Tensor:
    return w + (quantize_weight(w, num_bits) - w).detach()


def ste_quantize_input(x: torch.Tensor, num_bits: int) -> torch.Tensor:
    return x + (quantize_input(x, num_bits) - x).detach()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to float32. A product of two such values
    is exact in float32, so a float32 matmul of rounded inputs is the
    JAX package's bf16-input, float32-accumulate dot
    (``preferred_element_type=float32``); ``torch.autocast`` would round
    the output to bf16 as well."""
    return x.to(torch.bfloat16).to(torch.float32)
