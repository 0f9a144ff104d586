"""Per-architecture optimizers from the ``[architecture*]`` ``opt_*``
fields (the port of the JAX package's ``runtime/optim.py``).

The JAX package writes torch's update rules out by hand (RMSprop with eps
outside the sqrt, L2 decay added to the gradient before the moments);
here the ``torch.optim`` classes are those rules. One optimizer per
architecture; :func:`set_learning_rate` changes the rate in place
between chunks without rebuilding it.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import torch

from ..config.proto import strtobool


def _f(options: Mapping[str, Any], key: str, default: float) -> float:
    return float(options.get(key, default) or default)


def make_optimizer(arch_options: Mapping[str, Any],
                   params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """The optimizer an architecture section asks for (``arch_opt`` in
    sgd, rmsprop, adam), over ``params``, at ``arch_lr``."""
    opt_name = arch_options["arch_opt"]
    lr = float(arch_options["arch_lr"])
    wd = _f(arch_options, "opt_weight_decay", 0.0)
    params = list(params)
    if opt_name == "sgd":
        return torch.optim.SGD(
            params, lr=lr, momentum=_f(arch_options, "opt_momentum", 0.0),
            dampening=_f(arch_options, "opt_dampening", 0.0),
            nesterov=strtobool(arch_options.get("opt_nesterov", "False")),
            weight_decay=wd)
    if opt_name == "rmsprop":
        return torch.optim.RMSprop(
            params, lr=lr, alpha=_f(arch_options, "opt_alpha", 0.95),
            eps=_f(arch_options, "opt_eps", 1e-8),
            momentum=_f(arch_options, "opt_momentum", 0.0),
            centered=strtobool(arch_options.get("opt_centered", "False")),
            weight_decay=wd)
    if opt_name == "adam":
        betas = [float(b) for b in str(arch_options.get(
            "opt_betas", "0.9,0.999")).split(",")]
        return torch.optim.Adam(params, lr=lr, betas=(betas[0], betas[1]),
                                eps=_f(arch_options, "opt_eps", 1e-8),
                                weight_decay=wd)
    raise ValueError("unknown optimizer %r" % opt_name)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float
                      ) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group, keeping the
    optimizer's state (moments, momentum buffers)."""
    for group in opt.param_groups:
        group["lr"] = float(lr)
    return opt
