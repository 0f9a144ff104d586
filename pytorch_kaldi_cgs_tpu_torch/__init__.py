"""pytorch_kaldi_cgs_tpu_torch — the PyTorch/CUDA port of
``pytorch_kaldi_cgs_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports neither JAX
nor anything of it, and keeps its own copies of the numpy helpers it
needs (HCGS masks, initializers) so that the same seed gives the same
arrays in both.

Slice 1 is the serving path: audio -> fbank -> HCGS LSTM -> MLP head ->
prior normalization -> batched phone-loop Viterbi. Its one TPU kernel,
the fused LSTM forward, is a hand-written CUDA kernel for ``sm_90a``
(``ops/csrc/fused_lstm_fwd.cu``), built with ``nvcc`` at first use.

Layout:
  _device.py   device resolution (the card by default; the CPU on request)
  convert.py   JAX {"params","state","masks"} numpy trees <-> port tensors
  sparsity/    HCGS mask generators, ceil quantizers with STE
  models/      layers, AcousticModel base, LSTM, MLP (nn.Modules)
  ops/         fused LSTM forward (CUDA kernel + plain twin), fbank frontend
  decode/      phone-loop HMM, numpy and batched on-device Viterbi
  runtime/     Recognizer, StreamingRecognizer
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
