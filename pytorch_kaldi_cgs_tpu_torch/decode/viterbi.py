"""Phone-loop HMM and Viterbi decoding over HMM state log-likelihoods
(port of ``pytorch_kaldi_cgs_tpu/decode/viterbi.py``).

Each phone is a left-to-right chain of ``states_per_phone`` pdf states
with self-loops; the final state of every phone connects to the initial
state of every phone. Two engines:

  * :func:`viterbi_decode` — numpy, one utterance;
  * :func:`batched_viterbi_decode` — a padded (B, T, S) batch, the delta
    recursion and the backtrace as torch ops on the tensor's device.
    The per-step transition max is (a) elementwise self-loop / forward
    shifts inside a phone and (b) one max over phone-final states
    broadcast to all phone-initial states: O(S) per frame, no dense
    transition matrix.

Ties go to the first maximum in (stay, advance, cross) order, and to the
lowest-index phone-final state, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

NEG = -1e30


class PhoneLoopHMM:
    """Phone-loop topology over pdf states,
    pdf = phone * states_per_phone + state."""

    def __init__(self, num_phones: int, states_per_phone: int,
                 self_loop_prob: float = 0.7,
                 phone_insertion_penalty: float = 0.0):
        self.num_phones = num_phones
        self.states_per_phone = states_per_phone
        self.S = num_phones * states_per_phone
        self.log_self = np.log(self_loop_prob)
        self.log_next = np.log(1.0 - self_loop_prob)
        self.pip = phone_insertion_penalty
        sp = states_per_phone
        self.state_phone = np.arange(self.S) // sp
        self.is_initial = (np.arange(self.S) % sp) == 0
        self.is_final = (np.arange(self.S) % sp) == sp - 1

    @classmethod
    def from_graph_dir(cls, graph_dir: str, **kw) -> "PhoneLoopHMM":
        with open(os.path.join(graph_dir, "graph.json")) as f:
            g = json.load(f)
        if g.get("type") != "phone_loop":
            raise ValueError("graph %s is not a phone_loop graph" % graph_dir)
        return cls(g["num_phones"], g["states_per_phone"], **kw)


def _collapse(path: np.ndarray, hmm: PhoneLoopHMM) -> List[int]:
    """State path -> phone sequence: a new phone segment on a phone
    change, or on re-entry into an initial state from a final one (the
    same phone twice)."""
    phones = hmm.state_phone[path]
    seq = [int(phones[0])]
    for t in range(1, len(path)):
        entering = hmm.is_initial[path[t]] and path[t] != path[t - 1]
        if phones[t] != phones[t - 1] or (entering and
                                          hmm.is_final[path[t - 1]]):
            seq.append(int(phones[t]))
    return seq


def viterbi_decode(loglikes: np.ndarray, hmm: PhoneLoopHMM,
                   acwt: float = 1.0) -> List[int]:
    """Best phone sequence for one utterance (T, S) of log-likelihoods."""
    T, S = loglikes.shape
    if S != hmm.S:
        raise ValueError("loglikes dim %d != HMM states %d" % (S, hmm.S))
    ll = acwt * loglikes
    delta = np.full(S, NEG)
    delta[hmm.is_initial] = ll[0][hmm.is_initial]
    backptr = np.zeros((T, S), dtype=np.int32)
    backptr[0] = np.arange(S)
    idx = np.arange(S)
    prev_in_phone = idx - 1
    final_states = np.where(hmm.is_final)[0]
    for t in range(1, T):
        stay = delta + hmm.log_self
        adv = np.full(S, NEG)
        adv[~hmm.is_initial] = (delta[prev_in_phone[~hmm.is_initial]]
                                + hmm.log_next)
        final_scores = delta[hmm.is_final] + hmm.log_next - hmm.pip
        best_final = int(np.argmax(final_scores))
        cross = np.full(S, NEG)
        cross[hmm.is_initial] = final_scores[best_final]
        stacked = np.stack([stay, adv, cross])
        choice = np.argmax(stacked, axis=0)
        delta = stacked[choice, idx] + ll[t]
        backptr[t] = np.where(choice == 0, idx,
                              np.where(choice == 1, prev_in_phone,
                                       final_states[best_final]))
    state = int(np.argmax(delta))
    path = np.zeros(T, dtype=np.int32)
    for t in range(T - 1, -1, -1):
        path[t] = state
        state = int(backptr[t, state])
    return _collapse(path, hmm)


def batched_viterbi_decode(loglikes: Union[np.ndarray, torch.Tensor],
                           lengths: Sequence[int], hmm: PhoneLoopHMM,
                           acwt: float = 1.0, device: DeviceLike = None
                           ) -> List[List[int]]:
    """Decode a padded batch (B, T, S). A tensor is decoded on its own
    device; a numpy array is moved to ``device`` (the card by default).
    The recursion and the backtrace run there in float32; the host only
    collapses each state path to phones."""
    if not isinstance(loglikes, torch.Tensor):
        loglikes = torch.as_tensor(np.asarray(loglikes, np.float32),
                                   device=resolve_device(device))
    dev = loglikes.device
    B, T, S = loglikes.shape
    if S != hmm.S:
        raise ValueError("loglikes dim %d != HMM states %d" % (S, hmm.S))
    lengths_np = np.asarray(lengths, dtype=np.int64)
    lens = torch.as_tensor(lengths_np, device=dev)
    is_initial = torch.as_tensor(hmm.is_initial, device=dev)
    final_idx = torch.as_tensor(np.where(hmm.is_final)[0], device=dev)
    idx = torch.arange(S, device=dev)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    log_self, log_next = float(hmm.log_self), float(hmm.log_next)

    ll = (loglikes.to(torch.float32) * acwt).transpose(0, 1)  # (T, B, S)
    delta = torch.where(is_initial, ll[0], neg)
    d_last = delta                   # delta at each utterance's last frame
    bps = []
    for t in range(1, T):
        stay = delta + log_self
        adv = torch.where(is_initial, neg,
                          torch.roll(delta, 1, dims=-1) + log_next)
        final_scores = delta[:, final_idx] + log_next - hmm.pip
        best_pos = torch.argmax(final_scores, dim=-1)             # (B,)
        best_state = final_idx[best_pos]
        best_score = final_scores.gather(1, best_pos[:, None])    # (B, 1)
        cross = torch.where(is_initial, best_score, neg)
        # first maximum in (stay, adv, cross) order
        take_adv = adv > stay
        best = torch.where(take_adv, adv, stay)
        take_cross = cross > best
        delta = torch.where(take_cross, cross, best) + ll[t]
        bps.append(torch.where(take_cross, best_state[:, None],
                               torch.where(take_adv, idx - 1, idx)))
        d_last = torch.where((lens - 1 == t)[:, None], delta, d_last)
    end_state = torch.argmax(d_last, dim=-1)                      # (B,)

    # backtrace: at each utterance's last frame (re)start from its end
    state = end_state
    path = [None] * T
    for t in range(T - 1, 0, -1):
        state = torch.where(lens - 1 == t, end_state, state)
        path[t] = state
        state = bps[t - 1].gather(1, state[:, None])[:, 0]
    path[0] = state
    path_np = torch.stack(path).cpu().numpy()                     # (T, B)
    end_np = end_state.cpu().numpy()
    out: List[List[int]] = []
    for b in range(B):
        L = int(lengths_np[b])
        if L <= 1:
            out.append([int(hmm.state_phone[int(end_np[b])])])
        else:
            out.append(_collapse(path_np[:L, b], hmm))
    return out
