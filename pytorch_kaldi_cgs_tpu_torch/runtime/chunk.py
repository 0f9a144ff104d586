"""Chunk training, single device: the training half of the JAX package's
``runtime/chunk.py``.

Batches are cut as the JAX package cuts them (same ``RandomState``
calls): whole sentences zero-padded to bucketed lengths with frame
masks for sequential models, flat frame blocks otherwise. A train step
runs the graph's forward, one backward (the LSTM layers through the
fused BPTT kernels) and one optimizer step per unfrozen net. The
forward is never run twice in a step, because train mode updates the
batch-norm statistics in place (so no activation checkpointing).

Not ported yet (the pipeline slice): the mesh and sharding, sequence
parallelism, ``forward_step`` and ``run_nn`` (chunk files, checkpoints,
prefetch, forward arks).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.dataset import ChunkData
from .graph import NetGraph
from .optim import make_optimizer


def _bucket(n: int, step: int = 64) -> int:
    return ((n + step - 1) // step) * step


def make_seq_batches(chunk: ChunkData, batch_size: int, train: bool,
                     rng: np.random.RandomState, bucket: int = 64):
    """Whole-sentence batches (T, B, C) + frame masks (T, B), padded to
    bucketed lengths; random leading-zero placement in train mode.
    Yields (inp, mask, offsets, names), numpy."""
    lengths = chunk.seq_lengths
    n_batches = len(lengths) // batch_size
    starts = np.concatenate([[0], chunk.end_index[:-1]])
    C = chunk.data.shape[1]
    for b in range(n_batches):
        idx = range(b * batch_size, (b + 1) * batch_size)
        max_len = _bucket(int(max(lengths[i] for i in idx)), bucket)
        inp = np.zeros((max_len, batch_size, C), np.float32)
        mask = np.zeros((max_len, batch_size), np.float32)
        offsets = []
        for k, i in enumerate(idx):
            L = int(lengths[i])
            lead = rng.randint(0, max_len - L + 1) if train else 0
            inp[lead:lead + L, k] = chunk.data[starts[i]:starts[i] + L]
            mask[lead:lead + L, k] = 1.0
            offsets.append((lead, L))
        yield inp, mask, offsets, [chunk.names[i] for i in idx]


def make_flat_batches(chunk: ChunkData, batch_size: int):
    """Flat frame batches for non-sequential models."""
    N = chunk.data.shape[0]
    for b in range(N // batch_size):
        yield chunk.data[b * batch_size:(b + 1) * batch_size].astype(np.float32)


class ChunkRunner:
    """Train and eval steps for one chunk config, on the graph's device.

    One optimizer per architecture, from its section's ``opt_*`` fields;
    a frozen net's parameters stop requiring gradients and are never
    stepped."""

    def __init__(self, graph: NetGraph, config):
        self.graph = graph
        self.config = config
        self.optimizers: Dict[str, torch.optim.Optimizer] = {}
        self.init_opt_states()

    def init_opt_states(self) -> Dict[str, torch.optim.Optimizer]:
        """(Re)build every optimizer, with fresh state, over the nets'
        current parameters (call again after ``graph.init_variables``)."""
        g = self.graph
        for arch, net in g.nets.items():
            # block-sparse layouts from the current masks, and packed
            # storage, before the optimizer state mirrors the params (as
            # the JAX package's run_nn does)
            net.prepare_block_sparse()
            net.pack_variables()
            for p in net.params.values():
                p.requires_grad_(not g.freeze[arch])
        self.optimizers = {
            arch: make_optimizer(dict(self.config.items(g.arch_secs[arch])),
                                 net.params.values())
            for arch, net in g.nets.items()}
        return self.optimizers

    def _to_device(self, a) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.as_tensor(a, dtype=torch.float32, device=self.graph.device)

    def train_step(self, inp, mask=None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward, backward and one optimizer step per unfrozen net on
        one batch (numpy or tensor). -> (loss, err), detached."""
        g = self.graph
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)
        outs = g.forward(self._to_device(inp), train=True, generator=generator,
                         frame_mask=self._to_device(mask))
        loss = outs["loss_final"]
        if loss.requires_grad:
            loss.backward()
        for arch, opt in self.optimizers.items():
            if not g.freeze[arch]:
                opt.step()
        return loss.detach(), outs["err_final"].detach()

    @torch.no_grad()
    def eval_step(self, inp, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode forward: -> (loss, err)."""
        outs = self.graph.forward(self._to_device(inp), train=False,
                                  frame_mask=self._to_device(mask))
        return outs["loss_final"], outs["err_final"]
