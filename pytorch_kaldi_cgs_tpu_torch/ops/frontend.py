"""Feature extraction on the device: framing, STFT, log-mel filterbanks,
MFCC, deltas and CMVN (port of ``pytorch_kaldi_cgs_tpu/ops/frontend.py``).

Kaldi defaults: 25 ms windows / 10 ms shift, snip-edges framing, DC
removal, pre-emphasis 0.97, Povey window, HTK-style mel scale, DCT-II
with lifter for MFCC. Functions take a waveform batch ``(..., samples)``
and run on the device the waveform lies on.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def povey_window(frame_length: int) -> np.ndarray:
    n = np.arange(frame_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / (frame_length - 1))) ** 0.85


def hz_to_mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (np.exp(np.asarray(mel) / 1127.0) - 1.0)


def mel_filterbank(num_bins: int, n_fft: int, sample_rate: int,
                   low_freq: float = 20.0, high_freq: Optional[float] = None
                   ) -> np.ndarray:
    """(num_bins, n_fft//2+1) triangular mel filters."""
    if high_freq is None:
        high_freq = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(low_freq), hz_to_mel(high_freq),
                          num_bins + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((num_bins, n_freqs), np.float32)
    for b in range(num_bins):
        lo, ctr, hi = hz_pts[b], hz_pts[b + 1], hz_pts[b + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[b] = np.maximum(0.0, np.minimum(up, down))
    return fb


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthogonal DCT-II rows (num_ceps, num_bins)."""
    m = np.zeros((num_ceps, num_bins), np.float32)
    for k in range(num_ceps):
        m[k] = np.cos(np.pi * k * (2 * np.arange(num_bins) + 1)
                      / (2.0 * num_bins))
    m *= np.sqrt(2.0 / num_bins)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m


def lifter_coeffs(num_ceps: int, q: float = 22.0) -> np.ndarray:
    return (1.0 + 0.5 * q * np.sin(np.pi * np.arange(num_ceps) / q)
            ).astype(np.float32)


class Frontend:
    """Configured fbank/MFCC extractor. Its constant tables are built on
    the host once and copied to each device a waveform comes from."""

    def __init__(self, sample_rate: int = 16000, frame_length_ms: float = 25.0,
                 frame_shift_ms: float = 10.0, num_mel_bins: int = 23,
                 num_ceps: int = 13, preemph: float = 0.97,
                 low_freq: float = 20.0, high_freq: Optional[float] = None,
                 use_energy: bool = False, cepstral_lifter: float = 22.0):
        self.sample_rate = sample_rate
        self.frame_length = int(sample_rate * frame_length_ms / 1000)
        self.frame_shift = int(sample_rate * frame_shift_ms / 1000)
        self.n_fft = _next_pow2(self.frame_length)
        self.num_mel_bins = num_mel_bins
        self.num_ceps = num_ceps
        self.preemph = preemph
        self.use_energy = use_energy
        self._host = {
            "window": povey_window(self.frame_length).astype(np.float32),
            "mel": mel_filterbank(num_mel_bins, self.n_fft, sample_rate,
                                  low_freq, high_freq).T.copy(),
            "dct": dct_matrix(num_ceps, num_mel_bins).T.copy(),
            "lifter": lifter_coeffs(num_ceps, cepstral_lifter),
        }
        self._tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _consts(self, device: torch.device) -> Dict[str, torch.Tensor]:
        if device not in self._tables:
            self._tables[device] = {k: torch.tensor(v, device=device)
                                    for k, v in self._host.items()}
        return self._tables[device]

    def num_frames(self, num_samples: int) -> int:
        return max(0, 1 + (num_samples - self.frame_length) // self.frame_shift)

    def _frames(self, signal: torch.Tensor) -> torch.Tensor:
        """(..., samples) -> (..., frames, frame_length), windowed."""
        n = self.num_frames(signal.shape[-1])
        frames = signal[..., :(n - 1) * self.frame_shift + self.frame_length] \
            .unfold(-1, self.frame_length, self.frame_shift)
        frames = frames - frames.mean(dim=-1, keepdim=True)   # dc offset
        if self.preemph:
            frames = torch.cat(
                [frames[..., :1] * (1.0 - self.preemph),
                 frames[..., 1:] - self.preemph * frames[..., :-1]], dim=-1)
        return frames * self._consts(signal.device)["window"]

    def _log_mel(self, frames: torch.Tensor) -> torch.Tensor:
        spec = torch.fft.rfft(frames, n=self.n_fft, dim=-1)
        pspec = spec.abs() ** 2
        mel = pspec @ self._consts(frames.device)["mel"]
        return torch.log(torch.clamp(mel, min=1e-10))

    def fbank(self, signal: torch.Tensor) -> torch.Tensor:
        """Log-mel filterbank features (..., frames, num_mel_bins)."""
        return self._log_mel(self._frames(signal))

    def mfcc(self, signal: torch.Tensor) -> torch.Tensor:
        """Liftered MFCCs (..., frames, num_ceps); C0 replaced by the log
        energy when ``use_energy``."""
        frames = self._frames(signal)
        c = self._consts(signal.device)
        ceps = (self._log_mel(frames) @ c["dct"]) * c["lifter"]
        if self.use_energy:
            log_e = torch.log(torch.clamp((frames ** 2).sum(dim=-1),
                                          min=1e-10))
            ceps = torch.cat([log_e[..., None], ceps[..., 1:]], dim=-1)
        return ceps


def add_deltas(feats: torch.Tensor, order: int = 2, window: int = 2
               ) -> torch.Tensor:
    """Delta features along the time axis (-2), edges replicated."""
    T = feats.shape[-2]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    idx = torch.arange(T, device=feats.device)
    streams = [feats]
    for _ in range(order):
        prev = streams[-1]
        delta = torch.zeros_like(prev)
        for k in range(-window, window + 1):
            delta = delta + (k / denom) * prev.index_select(
                -2, torch.clamp(idx + k, 0, T - 1))
        streams.append(delta)
    return torch.cat(streams, dim=-1)


def cmvn(feats: torch.Tensor, norm_vars: bool = False) -> torch.Tensor:
    """Per-utterance mean (and variance) normalization over time (-2)."""
    out = feats - feats.mean(dim=-2, keepdim=True)
    if norm_vars:
        out = out / torch.clamp(feats.std(dim=-2, keepdim=True, correction=0),
                                min=1e-10)
    return out
