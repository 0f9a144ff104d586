"""pytorch_kaldi_cgs_tpu_torch — the PyTorch/CUDA port of
``pytorch_kaldi_cgs_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports neither JAX
nor anything of it, and keeps its own copies of the numpy helpers it
needs (HCGS masks, initializers) so that the same seed gives the same
arrays in both.

Slice 1 is the serving path: audio -> fbank -> HCGS LSTM -> MLP head ->
prior normalization -> batched phone-loop Viterbi. Slice 2 is the
training step: chunk config -> NetGraph -> HCGS LSTM with fused BPTT ->
masked NLL -> torch optimizers (ChunkRunner.train_step). Slice 3 is
the block-sparse HCGS recurrence the 2x1024 CGS-16x LSTM serves and
trains through (``lstm_block_sparse=auto``). Their TPU kernels, the
fused LSTM forward and its two BPTT variants, dense and over the kept
HCGS blocks, and the block-sparse weight gradient, are hand-written
CUDA kernels for ``sm_90a`` (``ops/csrc/``), built with ``nvcc`` at
first use.

Layout:
  _device.py   device resolution (the card by default; the CPU on request)
  convert.py   JAX {"params","state","masks"} numpy trees <-> port tensors
  config/      model DSL parser, chunk-config stream parsing, resolve_proto
  proto/       the typed config schemas this package reads (model.proto)
  data/        chunk layout (ChunkData, FeaStream, LabStream)
  sparsity/    HCGS mask generators, ceil quantizers with STE
  models/      layers, AcousticModel base, LSTM, MLP (nn.Modules), registry
  ops/         fused LSTM forward + BPTT, dense and block-sparse (CUDA
               kernels, plain twins, autograd Functions), block-sparse
               layouts and dw, fbank frontend
  decode/      phone-loop HMM, numpy and batched on-device Viterbi
  runtime/     Recognizer, StreamingRecognizer; NetGraph, ChunkRunner,
               optimizers
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
