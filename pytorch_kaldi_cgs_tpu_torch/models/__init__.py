"""Acoustic models ported so far: LSTM and MLP."""

from .base import AcousticModel, CompressionSpec
from .mlp import MLP
from .recurrent import LSTM

__all__ = ["AcousticModel", "CompressionSpec", "LSTM", "MLP"]
