"""Acoustic models ported so far: LSTM, GRU, liGRU, minimalGRU, RNN, the
cuDNN-class LSTM_cudnn, GRU_cudnn and RNN_cudnn, and MLP.

Configs name a model by ``arch_library`` + ``arch_class``;
:func:`get_model_class` resolves the built-in names to this package's
classes. The JAX package's library name maps here too, so its configs
run unchanged, and never makes that package be imported.
"""

from .base import AcousticModel, CompressionSpec
from .mlp import MLP
from .recurrent import (GRU, LSTM, RNN, GRU_cudnn, LSTM_cudnn, RNN_cudnn,
                        liGRU, minimalGRU)

__all__ = ["AcousticModel", "CompressionSpec", "GRU", "GRU_cudnn", "LSTM",
           "LSTM_cudnn", "MLP", "RNN", "RNN_cudnn", "liGRU", "minimalGRU",
           "get_model_class"]

_REGISTRY = {"MLP": MLP, "LSTM": LSTM, "GRU": GRU, "liGRU": liGRU,
             "minimalGRU": minimalGRU, "RNN": RNN, "LSTM_cudnn": LSTM_cudnn,
             "GRU_cudnn": GRU_cudnn, "RNN_cudnn": RNN_cudnn}

#: Built-in classes that wait on TPU kernels not ported yet.
_WAITING: dict = {}

#: Library names that mean "the built-in models".
BUILTIN_LIBRARIES = ("pytorch_kaldi_cgs_tpu_torch.models",
                     "pytorch_kaldi_cgs_tpu.models", "neural_networks",
                     "models", "")


def get_model_class(arch_library: str, arch_class: str):
    """Built-in names -> this package's classes (a built-in class that
    is not ported yet raises); any other library through importlib, as
    the reference's dynamic import."""
    if arch_library in BUILTIN_LIBRARIES:
        if arch_class in _WAITING:
            raise NotImplementedError(
                "arch_class %r is not ported yet: it needs %s"
                % (arch_class, _WAITING[arch_class]))
        if arch_class not in _REGISTRY:
            raise NotImplementedError(
                "arch_class %r is not ported yet (have %s)"
                % (arch_class, sorted(_REGISTRY)))
        return _REGISTRY[arch_class]
    import importlib
    return getattr(importlib.import_module(arch_library), arch_class)
