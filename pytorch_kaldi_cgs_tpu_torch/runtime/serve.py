"""Recognition on the device: raw audio -> fbank -> CMVN -> acoustic
model -> prior-normalized log-posteriors -> batched Viterbi -> phones
(port of ``pytorch_kaldi_cgs_tpu/runtime/serve.py``).

``model`` is an ``AcousticModel``-like ``nn.Module`` on the recognizer's
device: ``model(x)`` gives log-posteriors, and for streaming
``model.apply_streaming(chunk, carries) -> (y, carries)``. Everything
runs in eval mode under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..decode.viterbi import PhoneLoopHMM, batched_viterbi_decode
from ..ops.frontend import Frontend, add_deltas


def _check_on(model: nn.Module, device: torch.device) -> None:
    for t in list(model.parameters()) + list(model.buffers()):
        if t.device.type != device.type:
            raise ValueError("model tensors on %s, recognizer on %s"
                             % (t.device, device))


class Recognizer:
    """Batch recognizer over equal-length (zero-padded) raw waveforms.

    log_priors: class prior log-probabilities for the posterior ->
    likelihood conversion. seq_model: the model takes (T, B, F)
    sequences (else flat (N, F) frames)."""

    def __init__(self, model: nn.Module, hmm: PhoneLoopHMM,
                 frontend: Optional[Frontend] = None,
                 log_priors: Optional[np.ndarray] = None,
                 delta_order: int = 0, acwt: float = 1.0,
                 seq_model: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        _check_on(model, self.device)
        self.model = model.eval()
        self.hmm = hmm
        self.frontend = frontend or Frontend()
        self.log_priors = (None if log_priors is None else torch.as_tensor(
            np.asarray(log_priors, np.float32), device=self.device))
        self.delta_order = delta_order
        self.acwt = acwt
        self.seq_model = seq_model

    @torch.inference_mode()
    def features(self, audio) -> torch.Tensor:
        """(B, samples) waveforms -> (B, T, F) normalized features on the
        device: fbank [+ deltas], then per-utterance mean/variance
        normalization over the padded length."""
        audio = torch.as_tensor(np.asarray(audio, np.float32)
                                if not isinstance(audio, torch.Tensor)
                                else audio, device=self.device,
                                dtype=torch.float32)
        feats = self.frontend.fbank(audio)                    # (B, T, mel)
        if self.delta_order:
            feats = add_deltas(feats, self.delta_order, 2)
        mu = feats.mean(dim=1, keepdim=True)
        sd = torch.clamp(feats.std(dim=1, keepdim=True, correction=0),
                         min=1e-5)
        return (feats - mu) / sd

    @torch.inference_mode()
    def posteriors(self, audio) -> torch.Tensor:
        """(B, samples) waveforms -> (B, T, C) prior-normalized
        log-posteriors on the device."""
        feats = self.features(audio)
        if self.seq_model:
            logp = self.model(feats.transpose(0, 1).contiguous()) \
                .transpose(0, 1)
        else:
            B, T, F = feats.shape
            logp = self.model(feats.reshape(B * T, F)).reshape(B, T, -1)
        if self.log_priors is not None:
            logp = logp - self.log_priors
        return logp

    def frame_lengths(self, B: int, T_samples: int,
                      lengths_samples: Optional[Sequence[int]]) -> np.ndarray:
        if lengths_samples is None:
            return np.full(B, self.frontend.num_frames(T_samples))
        return np.array([max(1, self.frontend.num_frames(int(n)))
                         for n in lengths_samples])

    def recognize(self, audio, lengths_samples: Optional[Sequence[int]] = None
                  ) -> List[List[int]]:
        """audio: (B, samples) float waveforms (zero-padded); optional
        true lengths in samples. -> one phone sequence per utterance."""
        B, T_samples = audio.shape
        logp = self.posteriors(audio)
        return batched_viterbi_decode(
            logp, self.frame_lengths(B, T_samples, lengths_samples),
            self.hmm, acwt=self.acwt)


class StreamingRecognizer:
    """Chunked recognition with carried recurrent state: feed (T_c, B, F)
    feature chunks through :meth:`accept`; the concatenated streamed
    posteriors equal the whole-utterance ones. Greedy partials after
    every chunk; :meth:`finalize` runs batched Viterbi over all of it.

    Feature normalization must be streaming-safe (global CMVN or
    precomputed statistics)."""

    def __init__(self, model: nn.Module, hmm: Optional[PhoneLoopHMM] = None,
                 log_priors: Optional[np.ndarray] = None, acwt: float = 1.0,
                 seq_model: bool = True, device: DeviceLike = None):
        self.device = resolve_device(device)
        _check_on(model, self.device)
        self.model = model.eval()
        self.hmm = hmm
        self.log_priors = (None if log_priors is None else torch.as_tensor(
            np.asarray(log_priors, np.float32), device=self.device))
        self.acwt = acwt
        self.seq_model = seq_model

    def start(self) -> dict:
        """A fresh stream session (per parallel batch of streams)."""
        return {"carries": None, "chunks": [], "partials": None,
                "last_ids": None}

    @torch.inference_mode()
    def _posteriors(self, chunk: torch.Tensor, carries):
        if self.seq_model:
            y, carries = self.model.apply_streaming(chunk, carries)
        else:
            T_c, B, F = chunk.shape
            y, carries = self.model.apply_streaming(
                chunk.reshape(T_c * B, F), carries)
            y = y.reshape(T_c, B, -1)
        if self.log_priors is not None:
            y = y - self.log_priors
        return y, carries

    def accept(self, session: dict, feats_chunk) -> np.ndarray:
        """One (T_c, B, F) feature chunk -> its prior-normalized
        log-posteriors (T_c, B, C) as numpy; advances the session,
        including the incremental greedy partials."""
        chunk = torch.as_tensor(np.asarray(feats_chunk, np.float32)
                                if not isinstance(feats_chunk, torch.Tensor)
                                else feats_chunk, device=self.device,
                                dtype=torch.float32)
        y, session["carries"] = self._posteriors(chunk, session["carries"])
        out = y.cpu().numpy()
        session["chunks"].append(out)
        ids = out.argmax(axis=2)                              # (T_c, B)
        B = ids.shape[1]
        if session["partials"] is None:
            session["partials"] = [[] for _ in range(B)]
            session["last_ids"] = [None] * B
        for b in range(B):
            prev = session["last_ids"][b]
            seq = session["partials"][b]
            for v in ids[:, b]:
                if v != prev:
                    seq.append(int(v))
                    prev = v
            session["last_ids"][b] = prev
        return out

    def partial(self, session: dict) -> List[List[int]]:
        """Greedy (argmax-frame) partial hypotheses, deduped."""
        return session["partials"] or []

    def finalize(self, session: dict,
                 frame_lengths: Optional[Sequence[int]] = None
                 ) -> List[List[int]]:
        """Viterbi decode over everything streamed so far."""
        if self.hmm is None:
            return self.partial(session)
        logp = np.concatenate(session["chunks"], axis=0).transpose(1, 0, 2)
        B, T = logp.shape[0], logp.shape[1]
        if frame_lengths is None:
            frame_lengths = np.full(B, T)
        return batched_viterbi_decode(logp, np.asarray(frame_lengths),
                                      self.hmm, acwt=self.acwt,
                                      device=self.device)
