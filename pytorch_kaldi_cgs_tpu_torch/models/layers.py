"""Layer helpers for the acoustic models: activations, seeded numpy
initializers, batch/layer norm and the recurrent dropout mask.

The initializers are copies of the JAX package's (``models/layers.py``)
with the same RNG calls, so ``init(seed)`` gives the same arrays in both
packages.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def act_fun(act_type: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if act_type == "relu":
        return torch.relu
    if act_type == "tanh":
        return torch.tanh
    if act_type == "htanh":
        return lambda x: torch.clamp(x, -1.0, 1.0)
    if act_type == "sigmoid":
        return torch.sigmoid
    if act_type == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.2)
    if act_type == "elu":
        return F.elu
    if act_type == "softmax":
        # log-softmax over the feature (last) axis: the NLL cost and the
        # decoder take log-probabilities
        return lambda x: torch.log_softmax(x, dim=-1)
    if act_type == "linear":
        return lambda x: x
    raise ValueError("unknown activation %r" % act_type)


# ---------------------------------------------------------------------------
# initializers (numpy, seeded)
# ---------------------------------------------------------------------------

def torch_linear_init(rng: np.random.RandomState, out_f: int, in_f: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """torch.nn.Linear default init: U(+-1/sqrt(fan_in)) for w and b."""
    bound = 1.0 / math.sqrt(in_f)
    w = rng.uniform(-bound, bound, (out_f, in_f)).astype(np.float32)
    b = rng.uniform(-bound, bound, (out_f,)).astype(np.float32)
    return w, b


def small_uniform_init(rng: np.random.RandomState, out_f: int, in_f: int
                       ) -> np.ndarray:
    """The MLP init U(+-sqrt(0.01/(fan_in+fan_out)))."""
    bound = math.sqrt(0.01 / (in_f + out_f))
    return rng.uniform(-bound, bound, (out_f, in_f)).astype(np.float32)


def orthogonal_init(rng: np.random.RandomState, out_f: int, in_f: int
                    ) -> np.ndarray:
    """Orthogonal init for recurrent matrices."""
    a = rng.randn(out_f, in_f)
    q, r = np.linalg.qr(a if out_f >= in_f else a.T)
    q = q * np.sign(np.diag(r))
    if out_f < in_f:
        q = q.T
    return q[:out_f, :in_f].astype(np.float32)


def layer_norm_params(features: int) -> dict:
    return {"gamma": np.ones(features, np.float32),
            "beta": np.zeros(features, np.float32)}


def batch_norm_params(features: int) -> dict:
    return {"gamma": np.ones(features, np.float32),
            "beta": np.zeros(features, np.float32)}


def batch_norm_state(features: int) -> dict:
    return {"mean": np.zeros(features, np.float32),
            "var": np.ones(features, np.float32)}


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The reference LayerNorm: unbiased std over the last axis, eps
    outside the sqrt."""
    mean = x.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = ((x - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    return gamma * (x - mean) / (torch.sqrt(var) + eps) + beta


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, train: bool,
               momentum: float = 0.05, eps: float = 1e-5) -> torch.Tensor:
    """torch BatchNorm1d semantics over all leading axes (features last).

    Eval normalizes with the running statistics. Train normalizes with
    the batch statistics and updates ``mean``/``var`` in place
    (running = (1-m)*running + m*batch, unbiased variance)."""
    if not train:
        return gamma * ((x - mean) / torch.sqrt(var + eps)) + beta
    axes = tuple(range(x.ndim - 1))
    bmean = x.mean(dim=axes)
    bvar = ((x - bmean) ** 2).mean(dim=axes)
    n = x.numel() // x.shape[-1]
    with torch.no_grad():
        mean.mul_(1 - momentum).add_(momentum * bmean)
        var.mul_(1 - momentum).add_(momentum * bvar * n / max(n - 1, 1))
    return gamma * ((x - bmean) / torch.sqrt(bvar + eps)) + beta


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (the MLP's and the cuDNN-class wrappers'
    inter-layer path). The draw is made on the generator's device and
    moved to ``x``'s, as :func:`shared_time_drop_mask` does."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    src = generator.device if generator is not None else x.device
    mask = (torch.rand(x.shape, generator=generator, device=src) < keep
            ).to(x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def shared_time_drop_mask(shape, rate: float, train: bool,
                          device: torch.device,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """The recurrent per-sequence dropout mask: one Bernoulli(1-p) draw
    shared by all time steps in train mode; at eval the *scalar* (1-p)
    as a (1, 1) tensor — not inverted, like the reference. The draw is
    made on the generator's device and moved to ``device``, so one CPU
    generator gives the same masks to a run on the card and on the
    CPU."""
    if train:
        src = generator.device if generator is not None else device
        keep = torch.rand(shape, generator=generator, device=src) < 1.0 - rate
        return keep.to(device=device, dtype=torch.float32)
    return torch.full((1, 1), 1.0 - rate, dtype=torch.float32, device=device)
