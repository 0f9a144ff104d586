#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the serving path and
the training step of the flagship 2x512 LSTM, of the 2x1024 CGS-16x
LSTM through the block-sparse recurrence, of the TIMIT 2x1024 HCGS
Li-GRU through the fused liGRU kernels, of the LibriSpeech 5x1024
bidirectional HCGS GRU through the sparse GRU and v3 projection
kernels, of the TIMIT 4x550 GRU through the dense fused GRU kernels, of
the TIMIT 4x550 relu RNN through the dense fused RNN kernels, and of the
TIMIT 2x1024 Li-GRU at CGS-16x HCGS through the block-sparse liGRU
kernels, and of that cfg's 2x1024 as a minimalGRU through the dense and
(at CGS-16x) the block-sparse minimalGRU kernels, and of the TIMIT RNN
cfg at 4x1024 and CGS-16x through the block-sparse RNN kernels, and of
the LibriSpeech 5x1024 bidirectional Li-GRU through the fused liGRU
kernels, with the cuDNN-class LSTM_cudnn, RNN_cudnn and GRU_cudnn on the
ported kernels; and the legacy v1/v2 block-sparse matmul API on its
three kernels at the shapes of real layers.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build   — nvcc builds every kernel from ``pytorch_kaldi_cgs_tpu_torch/
             ops/csrc`` (one nvcc per source, in parallel) into
             ``build/torch_kernels/``; prints the card.
2. kernels — each kernel against its plain PyTorch twin on the card, in
             every variant: the forward at a small ragged shape and at the
             serving shape; the stash forward and both BPTT kernels at the
             small shape and at the training shape (T=300, B=16, H=512).
3. serve   — ``Recognizer.recognize`` on 8 ragged 4 s utterances through
             the flagship 2x512 HCGS LSTM -> 1944-way MLP head (weights
             from ``init(0)``/``init(1)``), the launch counters read just
             before and after; the same recognizer on the CPU must agree.
4. stream  — ``StreamingRecognizer`` over the same features in chunks of
             100 frames: same posteriors, same phones.
5. entry   — the model forward at ``__graft_entry__.entry()``'s shape
             (T=200, B=8, F=143), kernel against the plain twin.
6. train   — the flagship train step of ``bench.py`` (F=143, 2x512 HCGS +
             8-bit LSTM with BN, 1944-way head, T=300, B=16, RMSprop)
             through ``NetGraph`` + ``ChunkRunner`` on an in-memory chunk
             config: one step on the card against the same step on the
             CPU (loss and every gradient), launch counts per step with
             the stash and with the recompute backward, 10 steps on one
             batch in f32 and in bf16 (the loss must fall).
7. times   — CUDA-event times of every kernel, its twin, its bound and a
             cuDNN yardstick; the recognizer's ms per batch and audio-s/s;
             the train step's ms and frames/s and its device busy share.
8. sparse_kernels — the sparse forward (plain and stash), both sparse
             BPTT kernels and the block-sparse dw kernel against their
             twins: qbits 0/16, tanh/relu, w3g in f32 and in bf16 (the
             bf16 case forced by a small PKC_SPARSE_SCAN_VMEM_MB), dw with
             and without the level-2 submask (and at the training shape
             twice, bit for bit: its M is split), at a small shape, the
             serving shape (T=398, B=8, H=1024) and the training shape
             (T=300, B=16, H=1024), on the CGS-16x recurrent layout; the
             forward and the stash BPTT on the routes their plans name
             (one cooperative launch a call on "persist"), twice bit for
             bit, their step routes forced and bit for bit, their device
             kernels by name, every block shape of their tables.
9. sparse_serve — ``Recognizer.recognize`` over the CGS-16x stack (the
             cfg's 2x1024 LSTM with lstm_block_sparse=auto -> 1944-way
             head, feat_dim 40) on the same audio: card vs CPU, the
             sparse forward's launches; ``StreamingRecognizer`` (the dense
             seeded kernel) in one chunk and in chunks of 100 frames,
             against the sparse whole-utterance posteriors.
10. sparse_train — ``ChunkRunner.train_step`` over the CGS-16x cfg's
             sections (two heads, cd 1944 and mono 48, loss_cd + loss_mono;
             x of width 143, T=300, B=16): card vs CPU, launches per step
             (stash and recompute), 10 steps in f32 and in bf16.
11. sparse_times — the new kernels' times, twins, bounds and yardsticks,
             the dense fused kernels on the same H=1024 layer, and the
             CGS-16x train step and recognize.
12. ligru_kernels — the liGRU forward (plain, stash, seeded) and both
             BPTT kernels against their twins: qbits 0/16 x relu/tanh at
             the small shape, H=550 (T=50, B=8), the serving shape
             (T=398, B=8, H=1024; forward only) and the training shape
             (T=300, B=8, H=1024).
13. ligru_serve — ``Recognizer.recognize`` over the TIMIT Li-GRU stack
             (``cfg/TIMIT_baselines/TIMIT_liGRU_fmllr_hcgs.cfg``'s 2x1024
             liGRU -> 1944-way head, feat_dim 40) on the same audio: card
             vs CPU, 2 x 398 forward launches; again without the 16-bit
             quantizers (``ligru_quant_inp=False``) at TOL_POST.
14. ligru_stream — ``StreamingRecognizer`` on the seeded forward: one
             chunk of the whole utterance against the whole-utterance
             posteriors; chunks of 100 frames against the CPU's stream.
15. ligru_train — ``ChunkRunner.train_step`` over the cfg's sections (x of
             width 40, T=300, B=8, dropout masks from one CPU generator):
             card vs CPU at GRAD_FLIP_K x the CPU's own one-ulp
             sensitivity, launches per step (recompute by default, stash
             under PKC_BWD_STASH_CELLS=ligru), 10 steps in f32 and bf16
             at lr/16, the cfg's rates for 4 steps; the same step without
             the 16-bit quantizers against the CPU at TOL_GRAD_REL.
16. ligru_times — the liGRU kernels' times, twins and bounds, cuDNN's
             nn.GRU(1024, 1024) as a yardstick, the dU matmul, the Li-GRU
             train step (as users run it: masks drawn on the card) and
             recognize.
17. gru_kernels — the sparse GRU forward and BPTT kernels against their
             twins (qbits 0/16, w3g f32/bf16, tanh; relu at the small
             shape) at H=256 (T=13, B=5), the serving shape (T=398, 16
             rows; forward only) and the training shape (T=200, 32 rows,
             H=1024), the BPTT on the route its wrapper picks (named; the
             persistent chain at both shapes), its launches and v3 calls
             checked against the design, one call's device kernels held
             to the route's, two calls bit for bit; the v3 forward and dx kernels at M=6400 (G=3,
             K=2048, R=4, 8-bit, submask; G=1; K-padded 2000 -> 2048;
             plain; the forward also at the serving M=6368); the dw kernel
             at the path's G=3 (v3) and G=1, 2 (dU), and at M=2400 the
             CGS-16x Li-GRU's G=2 and minimalGRU's / RNN's G=1, each split-M
             call twice, bit for bit; the G=3 forward and dw also on their
             scalar-load instantiation (x 4 bytes off a float4).
18. gru_serve — ``Recognizer.recognize`` over the LibriSpeech GRU stack
             (``cfg/LibriSpeech_baselines/libri_GRU_hcgs_multihost.cfg``'s
             5x1024 bidirectional GRU -> 1944-way head, feat_dim 40) on the
             same audio: card vs CPU (TOL_POST, or GRAD_FLIP_K x the CPU's
             own one-ulp sensitivity where the 16-bit quantizers exceed
             it, and then again without them at TOL_POST), 5 x 2 x 398
             sparse forward launches and 4 v3 forwards.
19. gru_train — ``ChunkRunner.train_step`` over the cfg's sections (x of
             width 40, T=200, 16 sentences = 32 rows): card vs CPU as
             shipped (and without the quantizers where those miss
             TOL_GRAD_REL), launches per step (the dw kernel's by G), 10
             steps at the cfg's lr in f32 and bf16.
20. gru_times — the four kernels' times, twins and bounds, cuDNN's
             nn.GRU(1024, 1024) and the dense-masked matmul as yardsticks,
             the libri GRU train step and recognize.
21. timit_gru_kernels — the dense GRU forward (plain, stash, seeded) and
             both BPTT kernels against their twins, each launch counter
             checked: qbits 0/16 x tanh/relu at the small shape, the
             training shape (T=300, B=8, H=550), the serving shape (T=398;
             forward only) and H=1024 (T=6, 96 rows).
22. timit_gru_serve — ``Recognizer.recognize`` over the TIMIT GRU stack
             (``cfg/TIMIT_baselines/TIMIT_GRU_fmllr.cfg``'s 4x550 GRU ->
             1944-way head, feat_dim 40) on the same audio: card vs CPU at
             TOL_POST, 4 x 2 x 398 forward launches.
23. timit_gru_stream — ``StreamingRecognizer`` in chunks of 100 frames on
             the seeded forward against the whole utterance.
24. timit_gru_train — ``ChunkRunner.train_step`` over the cfg's sections
             (x of width 40, T=300, B=8): card vs CPU with the stash
             backward (the default) and the recompute one, launches per
             step, 10 steps at the cfg's lr in f32 and bf16.
25. gru_large_batch — the libri GRU's and the CGS-16x LSTM's first layer
             at 160 rows and the CGS-16x Li-GRU's at 256 (T=398), where
             the JAX size rule keeps them off their sparse kernels: the
             sparse forward alone, with f32 w3g, against the model on its
             twin; the sparse BPTT kernels at those batches.
26. timit_rnn_kernels — the dense RNN forward (plain, stash, seeded,
             and seeded from h_{k-1} against the zero-state run's later
             steps) and both BPTT kernels against their twins, each launch
             counter checked: qbits 0/16 x tanh/relu at the small shape
             (a (B, H) mask and the eval scalar), the training shape
             (T=300, B=8, H=550), the serving shape (T=398, the eval
             scalar; forward only) and H=1024 (T=6, 96 rows).
27. timit_rnn_serve — ``Recognizer.recognize`` over the TIMIT RNN stack
             (``cfg/TIMIT_baselines/TIMIT_RNN_fmllr.cfg``'s 4x550 relu RNN
             -> 1944-way head, feat_dim 40) on the same audio: card vs CPU
             at TOL_POST, 4 x 398 forward launches.
28. timit_rnn_stream — ``StreamingRecognizer`` on the seeded forward: one
             chunk of the whole utterance against the whole-utterance
             posteriors at TOL_STREAM; chunks of 100 frames at TOL_POST
             (cuBLAS sums fewer rows in another order), equal phones.
29. timit_rnn_train — ``ChunkRunner.train_step`` over the cfg's sections
             (x of width 40, T=300, B=8): card vs CPU with the recompute
             backward (the default) and the stash one
             (PKC_BWD_STASH_CELLS=rnn) at GRAD_FLIP_K x the CPU's own
             one-ulp sensitivity (relu flips at 0), and with rnn_act=tanh
             at TOL_GRAD_REL; launches per step; 10 steps in f32 and bf16
             at lr/32 (the cfg's lr diverges, in both packages), the cfg's
             lr for 4 steps.
30. cudnn_wrappers — RNN_cudnn (2x550 relu), LSTM_cudnn (2x512) and
             GRU_cudnn (2x550), all bidirectional, at T=300, B=8: eval and
             a train-mode forward + backward, card vs CPU, launching only
             the ported RNN, LSTM and torch-semantics GRU kernels.
31. timit_gru_times — the dense GRU kernels' times, twins and bounds,
             cuDNN's nn.GRU(550, 550) as a yardstick, the dU matmuls, the
             TIMIT GRU train step and recognize.
32. timit_rnn_times — the dense RNN kernels' times, twins and bounds,
             cuDNN's nn.RNN(550, 550, relu) as a yardstick, the dU matmul,
             the TIMIT RNN train step and recognize.
33. cgs_ligru_kernels — the sparse liGRU forward and BPTT kernels
             against their twins, each launch counter checked: qbits 0/16
             x relu/tanh at 13x5x256 (Kb=2, R=1), 398x8x1024 (forward
             only) and 300x8x1024 (Kb=8, R=2; and w3g in bf16).
34. cgs_ligru_serve — ``Recognizer.recognize`` over the CGS-16x Li-GRU
             stack (``TIMIT_liGRU_fmllr_hcgs.cfg``'s 2x1024 liGRU with the
             16x cfg's HCGS fields -> 1944-way head, feat_dim 40): card vs
             CPU at TOL_POST_Q16, 2 x 398 sparse forward launches and no
             dense liGRU one; again without the 16-bit quantizers at
             TOL_POST.
35. cgs_ligru_stream — the dense seeded forward over the masked U (the
             stream drops the sparse layout, as in the JAX package): one
             chunk against the sparse whole utterance, chunks of 100
             against the CPU's stream, and without the quantizers against
             the whole utterance.
36. cgs_ligru_train — ``ChunkRunner.train_step`` (T=300, B=8): card vs
             CPU at GRAD_FLIP_K x the CPU's own one-ulp sensitivity, the
             sparse kernels alone (and the dw kernel for dU), 10 steps in
             f32 and bf16 at lr/16; without the quantizers at
             TOL_GRAD_REL.
37. gru_torch_kernels — the torch-semantics GRU forward (zero, seeded,
             seeded from h_{k-1} against steps k..T-1) and BPTT kernels
             against their twins at 13x5x18, 300x8x550 (the BPTT on
             the persistent chain) and 20x16x550 (the BPTT on its step
             route); the route named, one call's device kernels held to
             the route's, two calls bit for bit.
38. gru_cudnn — GRU_cudnn 4x550 unidirectional, dropout 0.2, T=300, B=8:
             eval and train card vs CPU (every gradient, b_hh included),
             eval against torch.nn.GRU with the same weights, the stream
             in chunks of 100 against the whole utterance; the
             torch-semantics GRU kernels alone.
39. cgs_ligru_times, gru_torch_times — the four kernels' times, twins,
             bounds and cuDNN nn.GRU yardsticks; the CGS-16x Li-GRU train
             step and recognize.
40. mgru_kernels — the dense minimalGRU forward (plain, stash, seeded,
             seeded from h_{k-1} against steps k..T-1) and both BPTT
             kernels, the sparse forward and BPTT (dg and s; w3g f32, and
             bf16 at the training shape), against their twins, each
             launch counter checked: qbits 0/16 x relu/tanh at 13x5x256
             (sparse Kb=2, R=1), 300x8x1024 and 398x8x1024 (forwards
             only; sparse Kb=8, R=2); the sparse kernels at 256 rows.
41. mgru_serve, mgru_stream, mgru_train — the TIMIT Li-GRU cfg's
             [architecture1] renamed to a minimalGRU (2x1024 relu, the
             cfg's HCGS: the dense kernels alone): ``recognize`` card vs
             CPU (TOL_POST_Q16, and without the 16-bit quantizers at
             TOL_POST), 2 x 2 x 398 forward launches; the stream on the
             seeded forward (one chunk against the whole utterance,
             chunks of 100 against the CPU's stream, and without the
             quantizers against the whole); one train step card vs CPU
             (GRAD_FLIP_K x the CPU's one-ulp sensitivity; without the
             quantizers and with tanh, where relu' cannot flip at 0, at
             TOL_GRAD_REL), launches with the recompute
             backward (the default) and the stash one
             (PKC_BWD_STASH_CELLS=mgru, its gradients against the
             default's at the one-ulp bar, and within MG_STASH_TOL
             without the quantizers), 10 steps in f32 and bf16 at lr/16.
42. cgs_mgru_serve, cgs_mgru_stream, cgs_mgru_train — the same at the
             CGS-16x HCGS fields: both recurrences on the sparse
             minimalGRU kernels (and the dw kernel for dU), the stream on
             the dense seeded forward over the masked U.
43. mgru_large_batch — the CGS-16x minimalGRU's first layer at 256 rows
             (T=398), where the JAX size rule says "": the sparse forward
             alone with f32 w3g against the model on its twin.
44. mgru_stream_tanh — the dense minimalGRU with minimalgru_act = tanh
             and the 16-bit quantizers: chunks of 100 card vs CPU beside
             the relu stream's, naming which of relu or the quantizer
             moves the chunked stream past 1e-3.
45. rnn_sparse_kernels — the sparse RNN forward and BPTT kernels
             (rows 36 and 37) against their twins on the routes their
             plans name, each launch counter checked against the route's
             count: qbits 0/16 x tanh/relu at 13x5x256 (Kb=2, R=1),
             398x8x1024 (forward only) and 300x8x1024 (Kb=8, R=2; w3g
             f32 and bf16), 100 x 256 rows (the step routes; the JAX
             size rule's "", f32 w3g); below 256 rows the step routes
             forced, the forward's hs, the BPTT's dg and its rebuilt
             a_pre bit for bit the persistent route's; device kernels by
             name; every block shape of both tables (rnn_sparse_shapes);
             rnn_scan_fused_sparse with w3g in bf16 under a small
             PKC_SPARSE_SCAN_VMEM_MB.
46. rnn_sparse_serve, rnn_sparse_stream, rnn_sparse_train — the TIMIT
             RNN cfg at rnn_lay = 4 x 1024 with rnn_hcgs, the CGS-16x
             HCGS and quantizer fields (in memory): every recurrence on
             the sparse RNN kernels; ``recognize`` card vs CPU
             (TOL_POST_Q16, and without the 16-bit quantizers at
             TOL_POST); the stream on the dense seeded forward over the
             masked U (one chunk against the whole utterance, chunks of
             100 against the CPU's stream, without the quantizers against
             the whole); one train step card vs CPU (GRAD_FLIP_K x the
             CPU's one-ulp sensitivity; with tanh and no quantizers at
             TOL_GRAD_REL), launches per step, 10 steps in f32 and bf16
             at lr/32.
47. dense_width — every dense wrapper at its width limit (the shared
             memory its blocks stage) and one unit past it (a ValueError);
             a 1 x 2048 LSTM serving on the forward kernel and training
             on the plain step loop, card vs CPU.
48. mgru_times, rnn_sparse_times — the kernels' times, twins and
             bounds, cuDNN's nn.GRU(1024) / nn.RNN(1024, relu) at B=8 as
             yardsticks, the dense kernels on the same masked layer, the
             dU products, the train steps and recognize.
49. legacy_bs_kernels — the legacy v1/v2 block-sparse matmul's three
             kernels (block_sparse_legacy.cu) through their six wrappers
             against their twins, one launch each: the JAX tests' small
             layouts (bs=8, one with uneven columns), the libri GRU's
             x-projection layout (M=6400, G=1 and 3), the CGS-16x LSTM's
             1024 x 1024 (M=4800, G=4), the flagship's 143-wide input
             K-padded to 256 (M=4800, G=4); f32, bf16, bf16 x with f32 w;
             the forward's f32 x runs block_sparse_v3.cu's
             packed_weight_t + v3_fwd_gemm, its bf16 pair fwd_mma, bf16 x
             with f32 w bsl_fwd_tile; the dw also with mixed operands (its
             bsl_dw_tile route; the f32 and bf16 pairs run
             block_sparse_dw.cu's dw_gemm and dw_mma); the dx's f32
             pair runs block_sparse_dx.cu's dx_gemm, its bf16 pair
             dx_mma, the mixed pairs bsl_dx_tile; each forward, dx and
             dw check names its route; both autograd Functions against
             the dense masked product with exact launch counts, again
             with the twins swapped out.
50. libri_ligru_serve, libri_ligru_stream, libri_ligru_train — the
             LibriSpeech Li-GRU cfg (``cfg/LibriSpeech_baselines/
             libri_liGRU_fmllr.cfg``: 5x1024 bidirectional relu liGRU, BN,
             no quantizers -> 1944-way head, feat_dim 40) on the dense
             fused liGRU: ``recognize`` card vs CPU at TOL_POST, 5 x 398
             forward launches; the stream raises (bidirectional); one
             train step (T=200, 32 rows) card vs CPU, launches with the
             recompute and the stash backward, 10 steps in f32 and bf16
             at the cfg's learning rates.
51. legacy_bs_times — the legacy kernels' ms, twins, bounds and the
             dense-masked torch.matmul (dw: torch.bmm) computing the same
             function, at the libri layout (G=1, 3) and the CGS-16x G=4,
             f32 and bf16; the device kernels of one forward, dx and dw
             call (torch.profiler); the v3 kernels at the same G=3 shape, the timed
             v3 forward and dw against their twins, two dw calls bit for
             bit.
52. bs_gemm_times — rows 15 and 13 on their register-blocked tile: the
             dw at every shape a model path launches it (the CGS-16x
             LSTM's G=4, the libri GRU's v3 dw G=3 and dU G=1 and G=2,
             the CGS-16x Li-GRU's G=2 and minimalGRU's / RNN's G=1 at
             M=2400) beside torch.bmm of the same gathered operands and
             its bound; the v3 forward at the libri training and serving
             M, with and without the 8-bit quantizer and the submask,
             beside the dense-masked matmul; row 14 re-timed; rows 7-12
             (the legacy forward, dx and dw, through bsl_fwd / bsl_dx /
             bsl_dw and the _multi wrappers) at the libri G=1 and 3 and
             the CGS-16x G=4 in f32 and bf16 beside the dense-masked
             matmul (the dw: torch.bmm) in the same dtype; the device
             kernels of one call of each, counted by torch.profiler and
             held to the design (v3 forward 2, dw and legacy dw 1 or 2,
             legacy forward 2 in f32 and 1 in bf16, legacy dx 1, or 2
             where its plan splits a column: dx_gemm or dx_mma, then
             dx_reduce).
53. libri_ligru_times — rows 16-18 at the cfg's shapes, the libri
             Li-GRU train step and recognize.

Each phase prints its wall time (``[timing]``).

    python3 chip_smoke.py --gemm-times [DIR]
    python3 chip_smoke.py --rnn-times [DIR]

``--gemm-times`` runs bs_gemm_times and the libri GRU's and the CGS-16x
LSTM's f32 train steps alone and prints one JSON line: with this
checkout's package, or with the package of an earlier tree unpacked into
DIR, a git-ignored directory inside this checkout (``git archive
<commit> | tar -x -C build/parent``; its kernels build under DIR/build).
Run parent, change, change, parent in one call to compare on one card.
With a package that has the legacy dx's plan it also times the dx at
every split the plan weighs beside the one it picks (``dx_plan_sweep``).

``--rnn-times`` runs rnn_turn_times (rows 23 and 33 at their timed
shapes with their routes, plans and device time split into rebuild and
chain; nn.GRU(550) and the port's GRU_cudnn layer backward beside row
23; rows 22, 32, 35, 13 and 15) and the same two
train steps, one JSON line, the same way.

The line before the last pair is the kernels JSON, then the card's
``nvidia-smi`` name and power limit, then ``{"ok": true, ...}``. Needs
no network and one card; exits non-zero without one.
"""

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

SERVE_TBH = (398, 8, 512)        # 4 s at 16 kHz -> 398 frames, B=8, H=512
TRAIN_TBH = (300, 16, 512)       # bench.py's flagship train step
SMALL_TBH = (13, 5, 18)          # ragged: B not a multiple of 8, H of 4
FEAT = 143                       # fMLLR-shaped training input
SR, SECONDS, N_UTT = 16000, 4.0, 8
PHONES, SPP = 648, 3             # S = 1944 = the head's width

# Tolerances of kernel vs plain twin. float32: the recurrent dot sums in
# another order, compounded over the steps; with the 16-bit quantizer a
# one-ulp difference at a ceil step becomes one step (max|h|/2^15).
# bf16: the JAX package's bf16 bar (a one-ulp difference can round h to
# a neighbouring bf16 value).
TOL_F32_SMALL, TOL_F32_SERVE, TOL_BF16 = 1e-5, 1e-4, 2e-2
# Backward kernels vs twins, as a share of the reference's largest
# magnitude (gradients scale with the upstream dhs): float32 1e-5 at the
# small shape, 1e-4 over the 300 reverse steps of the training shape;
# bf16 2e-2 (dg is rounded to bf16 before each dot, and an ulp of
# difference upstream can round it the other way).
# Train step, card vs CPU (cuBLAS vs the CPU's sgemm, BN sums in another
# order, 300 steps each way): loss within 1e-4 relative, each gradient
# within 1e-3 of its largest magnitude.
TOL_LOSS_REL, TOL_GRAD_REL = 1e-4, 1e-3
TRAIN_STEPS = 10
# Recognizer log-posteriors, card vs CPU: cuFFT vs pocketfft, cuBLAS vs
# the CPU's sgemm, then 398 recurrent steps.
TOL_POST = 1e-3
TOL_STREAM = 1e-5                # same kernels, chunked: row-count-dependent GEMMs
# init(1)'s head, U(+-sqrt(0.01/(512+1944))), moves the log-posteriors by
# ~6e-4 across classes: every utterance would decode to one phone. The
# smoke scales that head so its logits spread ~0.6, and the decode is a
# real check.
HEAD_GAIN = 1000.0
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FLOPS = {"f32": 67e12, "bf16": 989e12}   # f32 without tensor cores

# The CGS-16x slice: cfg/TIMIT_CGS/TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg
CGS_CFG = os.path.join(ROOT, "cfg", "TIMIT_CGS",
                       "TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg")
SP_SMALL_TBH = (13, 5, 256)      # 128-blocks: Kb=2, R=1
SP_SERVE_TBH = (398, 8, 1024)    # Kb=8, R=2: a quarter of U's blocks
SP_TRAIN_TBH = (300, 16, 1024)
N_MONO = 48                      # stands in for TIMIT's mono phone count
# The masked 1944-way head sees ~1/16 of its 1024 inputs: a larger gain
# than the flagship's gives its logits a like spread.
CGS_HEAD_GAIN = 4000.0
# PKC_SPARSE_SCAN_VMEM_MB at which the JAX package's size rule reads w3g
# in bf16 at both the serving and the training shape (4.2 MB of w3g)
SP_BF16_VMEM_MB = "4"

# The Li-GRU slice: cfg/TIMIT_baselines/TIMIT_liGRU_fmllr_hcgs.cfg (2x1024
# liGRU, HCGS 128,4 at 25,62.5 on x and h: Kb=8, R=6, so the dense fused
# recurrence)
LIGRU_CFG = os.path.join(ROOT, "cfg", "TIMIT_baselines",
                         "TIMIT_liGRU_fmllr_hcgs.cfg")
LG_MID_TBH = (50, 8, 550)        # the width of the 4x550 TIMIT Li-GRU
LG_SERVE_TBH = (398, 8, 1024)
LG_TRAIN_TBH = (300, 8, 1024)    # the cfg's batch_size_train = 8
LG_STEP_TBH = (20, 48, 1024)     # the BPTT's 192 blocks: the step route
LG_FEAT = 40                     # fMLLR, cw_left = cw_right = 0
# init(1)'s head leaves the Li-GRU's log-posteriors nearly constant over
# time: the x3000 head makes each utterance decode to several phones.
LIGRU_HEAD_GAIN = 3000.0
# Li-GRU log-posteriors card vs CPU as the cfg ships it: its 16-bit
# ceil quantizers turn one-ulp differences between the card's and the
# CPU's sums into whole quantizer steps (max|h|/2^15), which the x3000
# head carries into the log-posteriors at a few 1e-3, still ~1/2000 of
# their per-frame spread; the phones must be equal. The same stack
# without the 16-bit quantizers is held to TOL_POST.
TOL_POST_Q16 = 1e-2
# liGRU kernels vs twins with the 16-bit quantizer: a one-ulp difference
# at a ceil step becomes one step (max|h|/2^15), which the later steps'
# dots carry on
TOL_Q16 = 1e-4
# The Li-GRU train step as the cfg ships it (relu behind 16-bit ceil
# quantizers) has gradients that jump with its inputs: a one-ulp change
# of x moves a quantized value a whole step, which can move a
# pre-activation across 0 and flip relu's derivative there. So that step
# is held to GRAD_FLIP_K times the CPU reference's own worst gradient
# change under a one-ulp change of x (ulp_sensitivity, measured in the
# run; at least TOL_GRAD_REL), which a wrong cotangent chain exceeds
# (O(1)); the same cfg without the 16-bit quantizers is held to
# TOL_GRAD_REL.
GRAD_FLIP_K = 4.0
# The cfg's learning rates (RMSprop 0.0016 / 0.0008) diverge on one batch
# of random 1944-way labels: RMSprop's first steps move every weight by
# ~lr/sqrt(1 - alpha), which blows up the 1024-wide relu recurrence by
# the third or fourth step (the JAX package's step does the same). The
# loss-falls check runs at a sixteenth of them; the cfg's rates are run
# for LG_CFG_LR_STEPS steps and printed.
LG_FALL_LR_SCALE = 1.0 / 16
LG_CFG_LR_STEPS = 4

# The LibriSpeech GRU slice: cfg/LibriSpeech_baselines/
# libri_GRU_hcgs_multihost.cfg (5x1024 bidirectional GRU, HCGS 128,4 at
# 75,50 on x and h: every recurrence Kb=8, R=2 on the sparse GRU kernels;
# layers 1-4's 2048-wide x-projections Kb=16, R=4 on the v3 kernels)
GRU_CFG = os.path.join(ROOT, "cfg", "LibriSpeech_baselines",
                       "libri_GRU_hcgs_multihost.cfg")
GR_SMALL_TBH = (13, 5, 256)      # 128-blocks: Kb=2, R=1; ragged B
GR_SERVE_TBH = (398, 16, 1024)   # 8 utterances, both directions
GR_TRAIN_TBH = (200, 32, 1024)   # start_seq_len_train; 16 x 2 directions
GR_STEP_TBH = (20, 80, 1024)     # the forward's 320 blocks: the step route
GR_FEAT = 40                     # fMLLR, --delta-order=0, cw 0
GR_LAYERS = 5
# init(1)'s head over the GRU's 2048 outputs spreads the logits by only
# ~0.02 across classes and over time even at x1000 (every utterance
# decodes to one phone); x16000 gives 1-4 phones per utterance on the
# CPU, and the CPU's own log-posteriors still move by only 1.3e-4 under
# a one-ulp change of the features (1.9e-6 without the 16-bit quantizers).
GRU_HEAD_GAIN = 16000.0

# The TIMIT GRU slice: cfg/TIMIT_baselines/TIMIT_GRU_fmllr.cfg (4x550 GRU,
# tanh, BN on all three gate projections, dropout 0.2, no HCGS, no
# quantizers, unidirectional: every layer on the dense fused GRU)
TIMIT_GRU_CFG = os.path.join(ROOT, "cfg", "TIMIT_baselines",
                             "TIMIT_GRU_fmllr.cfg")
TG_SERVE_TBH = (398, 8, 550)
TG_TRAIN_TBH = (300, 8, 550)     # the cfg's batch_size_train = 8
# H=1024, the JAX package's bf16-caveat width (its size rule lets a bf16
# GRU layer this wide onto the fused kernel up to 102 rows)
TG_WIDE_TBH = (6, 96, 1024)
TG_FEAT, TG_LAYERS = 40, 4       # fMLLR, cw_left = cw_right = 0
# init(1)'s head over the GRU's 550 outputs, U(+-sqrt(0.01/(550+1944))),
# barely moves the log-posteriors over time: x3000 makes the utterances
# decode to several phones (timit_gru_serve prints how many)
TIMIT_GRU_HEAD_GAIN = 3000.0
# The TIMIT RNN slice: cfg/TIMIT_baselines/TIMIT_RNN_fmllr.cfg (4x550 RNN,
# relu, BN on the projection, dropout 0.2 on the whole state, no HCGS, no
# quantizers, unidirectional: every layer on the dense fused RNN)
TIMIT_RNN_CFG = os.path.join(ROOT, "cfg", "TIMIT_baselines",
                             "TIMIT_RNN_fmllr.cfg")
TR_SERVE_TBH = (398, 8, 550)
TR_TRAIN_TBH = (300, 8, 550)     # the cfg's batch_size_train = 8
TR_WIDE_TBH = (6, 96, 1024)
TR_FEAT, TR_LAYERS = 40, 4       # fMLLR, cw_left = cw_right = 0
# init(1)'s head over the RNN's 550 outputs (small at random init: each
# layer's eval dropout scalar and BN's unit running variance shrink them
# to ~0.01) barely moves the log-posteriors: x5000 makes the utterances
# decode to 1-3 phones (timit_rnn_serve prints how many) and the
# frame-level argmax change every few frames
TIMIT_RNN_HEAD_GAIN = 5000.0
# The cfg's learning rates (RMSprop 0.0016 / 0.0008) diverge on one batch
# of random 1944-way labels: NaN by the third step, in the JAX package's
# step too (CPU, full width); at a sixteenth of them both packages' loss
# spikes past 1e6 at step 7. The relu recurrence has no gradient
# clipping. The loss-falls check runs at a thirty-second of them, where
# it falls step by step on the CPU in f32 and bf16; the cfg's rates are
# run for TR_CFG_LR_STEPS steps and printed.
TR_FALL_LR_SCALE = 1.0 / 32
TR_CFG_LR_STEPS = 4
# The cuDNN-class wrappers, at the widths their users run: nn.RNN-style
# 2x550 relu, nn.LSTM-style 2x512 and nn.GRU-style 2x550, all
# bidirectional, over the fMLLR features at the TIMIT RNN's training shape
CUDNN_CASES = (("RNN_cudnn", 550, {"nonlinearity": "relu"}),
               ("LSTM_cudnn", 512, {}), ("GRU_cudnn", 550, {}))

# The CGS-16x Li-GRU slice: the TIMIT Li-GRU cfg with the CGS-16x paper's
# HCGS setting (cfg/TIMIT_CGS/TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg:122-125)
# on x and h: both 2x1024 recurrences Kb=8, R=2 on the sparse liGRU
# kernels; the x-projections dense-masked (Kb < 16)
HCGS_16X = {"hcgsx_block": "128,8", "hcgsx_sparse": "75,75",
            "hcgsh_block": "128,8", "hcgsh_sparse": "75,75"}
CL_SMALL_TBH = (13, 5, 256)      # 128-blocks at 50%: Kb=2, R=1
CL_SERVE_TBH = (398, 8, 1024)
CL_TRAIN_TBH = (300, 8, 1024)    # the cfg's batch_size_train = 8
# the first layer at a batch where the JAX size rule says "" (from 163
# rows at this layout)
CL_LARGE_ROWS = 256
# init(1)'s head at the Li-GRU's x3000 decodes 7 of the 8 utterances to
# one phone: x10000 makes them decode to several (cgs_ligru_serve prints
# how many)
CGS_LIGRU_HEAD_GAIN = 10000.0
# GRU_cudnn at the TIMIT GRU's width and depth: 4 x 550, unidirectional
GT_TRAIN_TBH = (300, 8, 550)
GT_STEP_TBH = (20, 16, 550)     # the BPTT's blocks do not fit: step route
GT_SERVE_TBH = (398, 8, 550)
GT_LAYERS = 4

# The minimalGRU slice: the TIMIT Li-GRU cfg's [architecture1] as a
# minimalGRU (no shipped cfg names one; arch_class, arch_proto and every
# ligru_* field renamed): 2x1024, relu, BN, dropout 0.2, 8-bit weights,
# 16-bit input quantizers. At the cfg's own HCGS (128,4 at 25,62.5: Kb=8,
# R=6) both recurrences take the dense fused minimalGRU kernels; with the
# CGS-16x fields (HCGS_16X: Kb=8, R=2) the sparse ones.
MG_SMALL_TBH = (13, 5, 256)      # sparse at 128-blocks, 50%: Kb=2, R=1
MG_TRAIN_TBH = (300, 8, 1024)    # the cfg's batch_size_train = 8
MG_SERVE_TBH = (398, 8, 1024)
# the CGS-16x layer at a batch where the JAX size rule says "" (from 163
# rows at this layout, G=2)
MG_LARGE_ROWS = 256
# that layer without the quantizers, kernel vs twin (float32 sums in
# another order over 398 steps)
MG_LARGE_TOL = 1e-5
# the stash backward's gradients against the recompute one's on the card
# without the 16-bit quantizers, of each gradient's scale (the same
# forward; only the dU's recomputed z differs in rounding)
MG_STASH_TOL = 1e-5
# init(1)'s head: gains as the Li-GRU's (dense) and the CGS-16x Li-GRU's
MGRU_HEAD_GAIN = 3000.0
CGS_MGRU_HEAD_GAIN = 10000.0

# The CGS-16x RNN slice: no shipped cfg has a sparse RNN (every RNN cfg is
# 550 wide; a recurrent layout needs 128-multiple blocks), so the TIMIT
# RNN cfg's sections (relu, BN on the projection, dropout 0.2 on the
# whole state, unidirectional, 1944-way head) with rnn_lay = 4 x 1024,
# rnn_hcgs = True, the CGS-16x paper's HCGS fields (HCGS_16X) and that
# cfg's quantizer fields (QUANT_16X, TIMIT_LSTM_fmllr_cgs_hcgs_16x_a.cfg:
# 126-129, renamed rnn_*): every recurrence Kb=8, R=2 on the sparse RNN
# kernels; the x-projections dense-masked (Kb < 16)
QUANT_16X = {"rnn_quant": "True", "param_quant": "8", "rnn_quant_inp": "True",
             "inp_quant": "16"}
RS_SMALL_TBH = (13, 5, 256)      # 128-blocks at 50%: Kb=2, R=1
RS_SERVE_TBH = (398, 8, 1024)
RS_TRAIN_TBH = (300, 8, 1024)    # the cfg's batch_size_train = 8
RS_LAYERS = 4
# the layer at 256 rows, where the JAX size rule says "" (from 169 rows
# at this layout, G=1): kernel vs twin over 100 steps, f32 w3g
RS_LARGE_TBH = (100, 256, 1024)
# w3g in bf16 through rnn_scan_fused_sparse: at 16 rows a 2 MB budget
# makes the JAX size rule say "bf16" (12 to 17 rows; at 8 rows no whole
# number of MB does)
RS_BF16_TBH, RS_BF16_VMEM_MB = (300, 16, 1024), "2"
# init(1)'s head over the sparse RNN's 1024 outputs barely moves the
# log-posteriors (each x-projection keeps 1/16 of its weights; the eval
# dropout scalar and BN's unit running variance shrink every layer):
# x1e6 makes two of the 8 utterances decode to 4 and 2 phones, its
# log-posteriors 7.5e-3 apart card vs CPU as shipped. Tried on the card
# from x1e5 to x5e6: x2e6 decodes 5 of 8 to several phones but doubles
# the logits, and with them that difference, against TOL_POST_Q16's 1e-2
RNN_SPARSE_HEAD_GAIN = 1e6

# The large-batch check of the sparse recurrence: 80 utterances of the
# libri GRU (160 rows, both directions), 160 of the CGS-16x LSTM; the JAX
# size rule says "" there (from 158 and 152 rows)
LARGE_ROWS = 160


def flagship_options(to_do="forward", compute_dtype=""):
    """``__graft_entry__._flagship``: 2x512 LSTM, BN on the gate
    projections, HCGS 128/4 at 25/62.5% on x and h, 8-bit weights, tanh,
    drop 0, feeding the 1944-way log-softmax MLP head."""
    lstm = {
        "to_do": to_do, "compute_dtype": compute_dtype,
        "arch_name": "LSTM_layers",
        "lstm_lay": "512,512", "lstm_drop": "0.0,0.0",
        "lstm_use_batchnorm": "True,True", "lstm_use_laynorm": "False,False",
        "lstm_use_laynorm_inp": "False", "lstm_use_batchnorm_inp": "False",
        "lstm_act": "tanh,tanh", "lstm_orthinit": "True",
        "lstm_bidir": "False", "lstm_hcgs": "True",
        "hcgsx_block": "128,4", "hcgsx_sparse": "25,62.5",
        "hcgsh_block": "128,4", "hcgsh_sparse": "25,62.5",
        "lstm_quant": "True", "param_quant": "8,8",
        "lstm_quant_inp": "False", "inp_quant": "16",
        "lstm_prune": "False", "lstm_prune_perc": "50",
        "skip_regularization": "True"}
    mlp = {
        "to_do": to_do, "compute_dtype": compute_dtype,
        "arch_name": "MLP_out",
        "dnn_lay": str(PHONES * SPP), "dnn_drop": "0.0",
        "dnn_use_batchnorm": "False", "dnn_use_laynorm": "False",
        "dnn_use_laynorm_inp": "False", "dnn_use_batchnorm_inp": "False",
        "dnn_act": "softmax"}
    return lstm, mlp


class Stack(torch.nn.Module):
    """Recurrent net (LSTM or liGRU) -> MLP head over (T, B, F)
    sequences."""

    def __init__(self, rnn, mlp):
        super().__init__()
        self.rnn, self.mlp = rnn, mlp

    def forward(self, x):
        h = self.rnn(x)
        T, B, _ = h.shape
        return self.mlp(h.reshape(T * B, -1)).reshape(T, B, -1)

    def apply_streaming(self, x, carries=None):
        h, carries = self.rnn.apply_streaming(x, carries)
        T, B, _ = h.shape
        return self.mlp(h.reshape(T * B, -1)).reshape(T, B, -1), carries


def build_stack(dev, feat_dim=40):
    from pytorch_kaldi_cgs_tpu_torch.models import LSTM, MLP
    lo, mo = flagship_options()
    lstm = LSTM(lo, feat_dim, seed=0, device=dev)
    mlp = MLP(mo, lstm.out_dim, seed=1, device=dev)
    with torch.no_grad():
        mlp.params["w0"].mul_(HEAD_GAIN)
    return Stack(lstm, mlp).eval()


def build_recognizer(dev, stack_fn=build_stack):
    from pytorch_kaldi_cgs_tpu_torch.decode.viterbi import PhoneLoopHMM
    from pytorch_kaldi_cgs_tpu_torch.ops.frontend import Frontend
    from pytorch_kaldi_cgs_tpu_torch.runtime.serve import Recognizer
    p = np.random.RandomState(2).rand(PHONES * SPP) + 0.1
    log_priors = np.log(p / p.sum()).astype(np.float32)
    return Recognizer(stack_fn(dev), PhoneLoopHMM(PHONES, SPP),
                      frontend=Frontend(sample_rate=SR, num_mel_bins=40),
                      log_priors=log_priors, seq_model=True, device=dev)


def make_audio():
    """8 utterances of 4 s at 16 kHz, true lengths 64000 down to 36000
    samples, zero-padded: a tone sweep plus noise, from a seed."""
    n = int(SR * SECONDS)
    rng = np.random.RandomState(0)
    lens = np.linspace(n, 36000, N_UTT).astype(int)
    t = np.arange(n) / SR
    f0 = rng.uniform(150, 400, (N_UTT, 1))
    audio = (np.sin(2 * np.pi * f0 * t * (1 + t / 8)) * 0.3
             + rng.randn(N_UTT, n) * 0.05).astype(np.float32)
    for b, L in enumerate(lens):
        audio[b, L:] = 0.0
    return audio, lens


def lstm_inputs(T, B, H, seed, dev, drop_bh):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(a.astype(np.float32), device=dev)
    g = t(rng.randn(T, B, 4 * H) * 0.5)
    U = t(rng.randn(4 * H, H) / np.sqrt(H))
    drop = t((rng.rand(B, H) > 0.2) * 1.0) if drop_bh else t(np.full((1, 1), 0.8))
    return g, U, drop, t(rng.randn(B, H) * 0.3), t(rng.randn(B, H) * 0.3)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def smi_card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_build():
    from pytorch_kaldi_cgs_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(_build.SOURCES)
    for name, log in logs.items():
        print("[build] %s.cu (nvcc -Xptxas -v):\n%s" % (name, log.strip()))
    print("[build] %d kernel source(s) in %.1f s -> %s"
          % (len(_build.SOURCES), time.perf_counter() - t0,
             _build.BUILD_DIR))
    smi = smi_card()
    print("[build] card: %s" % smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_kernels(dev, shapes=(SMALL_TBH, SERVE_TBH)):
    """Kernel vs plain twin in every variant, on the route the plan names
    (lstm_fwd_launches: persistent at both shapes), the wrapper's launch
    counter moving by its launches, the device kernels of one call a
    shape held to the route's (lstm_fwd_design); at the serving shape
    the step route also runs forced (fused_lstm._fwd_kernel), against
    the twin and bit for bit the persistent route's. Returns the
    checks."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    checks = []
    for (T, B, H) in shapes:
        serve = (T, B, H) == SERVE_TBH
        cases = [(bf16, seeded, qbits, "tanh")
                 for bf16 in (False, True) for seeded in (False, True)
                 for qbits in (0, 16)]
        if not serve:
            cases += [(False, True, 16, a) for a in ("relu", "htanh", "linear")]
        for k, (bf16, seeded, qbits, act) in enumerate(cases):
            g, U, drop, h0, c0 = lstm_inputs(T, B, H, 10 + k, dev,
                                             drop_bh=not serve)
            carry = (h0, c0) if seeded else (None, None)
            route, n = lstm_fwd_launches(dev, T, B, H, bf16)
            w = F.fused_lstm_fwd
            with torch.no_grad():
                hs, cs = launched(w, n, lambda: w(g, U, drop, *carry, act=act,
                                                  qbits=qbits, bf16=bf16))
                hp, cp = F.fused_lstm_fwd_plain(g, U, drop, *carry, act,
                                                qbits, bf16)
                step = None
                if serve:          # the step route, forced
                    dk = torch.broadcast_to(drop, (B, H)).contiguous()
                    step = launched(w, T, lambda: F._fwd_kernel(
                        g, U, dk, *carry, act, qbits, bf16, False))
                if k + 1 == len(cases):     # the kernels of the route
                    bptt_kernels(lambda: w(g, U, drop, *carry, act=act,
                                           qbits=qbits, bf16=bf16),
                                 lstm_fwd_design(route, T, seeded, qbits))
            sync(dev)
            tol = TOL_BF16 if bf16 else (TOL_F32_SERVE if serve else TOL_F32_SMALL)
            base = {"kernel": "fused_lstm_fwd", "T": T, "B": B, "H": H,
                    "dtype": "bf16" if bf16 else "f32",
                    "carry": "seeded" if seeded else "zero", "qbits": qbits,
                    "act": act, "drop": "(1,1)" if serve else "(B,H)"}
            plan = lstm_plan_brief(dev, "fused_lstm_fwd", B, H, bf16)
            runs = [(route, (hs, cs))] + ([("step", step)] if step else [])
            for r, (h_, c_) in runs:
                err = max(float((h_ - hp).abs().max()),
                          float((c_ - cp).abs().max()))
                c = dict(base, route=r, plan=plan if r == route else None,
                         max_abs_err=err, tol=tol,
                         ok=bool(np.isfinite(err) and err <= tol))
                if r != route:      # both routes sum in one order
                    c["kernel"] = "fused_lstm_fwd/step_route"
                    c["bits_apart_from_%s" % route] = bits_apart(
                        (hs, cs), step)[0]
                    c["ok"] = c["ok"] and c["bits_apart_from_%s" % route] == 0
                checks.append(c)
                print("[kernels] fused_lstm_fwd %s" % json.dumps(c))
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("fused_lstm_fwd disagrees with its plain twin: %s"
                             % bad)
    check_fwd_routes(checks, "fused_lstm_fwd", {
        (SMALL_TBH, "persist"), (SERVE_TBH, "persist"), (SERVE_TBH, "step")})
    return checks


def phase_serve(dev, audio, lens, stack_fn=build_stack, tag="serve",
                kernel="fused_lstm_fwd", tol=TOL_POST, expect=None):
    """A serving path: Recognizer.recognize with every launch counter
    set to 0 just before and read just after (``kernel`` must run 2
    layers x T times, no other kernel; or the launches ``expect(T)``
    gives, which are then returned whole); then the same recognizer on
    the CPU (the plain twins): log-posteriors within ``tol`` (a number,
    or a function of the error and the CPU recognizer that returns the
    bar), equal phones."""
    rec = build_recognizer(dev, stack_fn)
    T_frames = rec.frontend.num_frames(audio.shape[1])
    phones, launches = counted(lambda: rec.recognize(audio, lens))
    want = (expect(T_frames) if expect
            else expected(**{kernel: 2 * T_frames}))
    print("[%s] recognize: launches %s (expected %s)"
          % (tag, {k: v for k, v in launches.items() if v},
             {k: v for k, v in want.items() if v}))
    if launches != want:
        raise AssertionError("the %s path did not run its kernels alone: "
                             "launches %s" % (tag, launches))
    launches = launches if expect else launches[kernel]
    logp = rec.posteriors(audio)
    if tuple(logp.shape) != (N_UTT, T_frames, PHONES * SPP) or \
            not bool(torch.isfinite(logp).all()):
        raise AssertionError("bad posteriors: %s" % (tuple(logp.shape),))
    from pytorch_kaldi_cgs_tpu_torch.decode.viterbi import \
        batched_viterbi_decode
    ref = build_recognizer("cpu", stack_fn)
    logp_ref = ref.posteriors(audio)
    err = float((logp.cpu() - logp_ref.cpu()).abs().max())
    phones_ref = batched_viterbi_decode(   # ref.recognize, posteriors reused
        logp_ref, ref.frame_lengths(N_UTT, audio.shape[1], lens), ref.hmm,
        acwt=ref.acwt)
    tol = tol(err, ref, audio) if callable(tol) else tol
    print("[%s] log-posteriors %s vs %s: max abs err %.3g (tol %g); "
          "phones equal: %s; phones per utt: %s"
          % (tag, dev, "cpu", err, tol, phones == phones_ref,
             [len(p) for p in phones]))
    if not err <= tol:
        raise AssertionError("recognizer posteriors disagree with the CPU")
    if phones != phones_ref:
        raise AssertionError("recognizer phones disagree with the CPU")
    return rec, phones, logp, launches, err


def stream_run(dev, rec, audio, lens, chunk):
    """StreamingRecognizer over the recognizer's features in chunks of
    ``chunk`` frames, launch counters read around the accepts. ->
    (log-posteriors (B, T, S) as numpy, finalized phones, launches)."""
    from pytorch_kaldi_cgs_tpu_torch.runtime.serve import StreamingRecognizer
    srec = StreamingRecognizer(rec.model, hmm=rec.hmm,
                               log_priors=rec.log_priors.cpu().numpy(),
                               device=dev)
    x = rec.features(audio).transpose(0, 1).contiguous()      # (T, B, F)
    sess = srec.start()

    def accept_all():
        for a in range(0, x.shape[0], chunk):
            srec.accept(sess, x[a:a + chunk])
    _, launches = counted(accept_all)
    streamed = np.concatenate(sess["chunks"]).transpose(1, 0, 2)
    final = srec.finalize(sess, rec.frame_lengths(N_UTT, audio.shape[1], lens))
    return streamed, final, launches


def phase_stream(dev, rec, audio, lens, phones, logp, chunk=100,
                 tag="stream", tol=TOL_STREAM, kernel="fused_lstm_fwd",
                 per_frame=2, count=None):
    """StreamingRecognizer over the recognizer's features in chunks: the
    dense seeded kernel (``kernel``, the cell's only streaming kernel,
    ``per_frame`` launches a frame over all layers, or ``count(T,
    chunk)`` launches a stream) against whole-utterance posteriors
    ``logp`` within ``tol``, and the phones."""
    T = rec.frontend.num_frames(audio.shape[1])
    streamed, final, launches = stream_run(dev, rec, audio, lens, chunk)
    want = count(T, chunk) if count else per_frame * T
    if launches != expected(**{kernel: want}):
        raise AssertionError("%s: launches %s, expected the dense seeded "
                             "kernel %d times" % (tag, launches, want))
    launches = launches[kernel]
    err = float(np.abs(streamed - logp.cpu().numpy()).max())
    print("[%s] %d chunks of <=%d frames: launches %d; streamed vs "
          "whole max abs err %.3g (tol %g); finalize == recognize: %s"
          % (tag, -(-T // chunk), chunk, launches, err, tol,
             final == phones))
    if not err <= tol or final != phones:
        raise AssertionError("%s disagrees with the whole utterance" % tag)
    return launches, err


def phase_chunked_stream(dev, rec, audio, lens, phones, logp,
                         tag="sparse_stream", kernel="fused_lstm_fwd",
                         per_frame=2, count=None):
    """A stream whose chunks of 100 frames cannot match the whole
    utterance to TOL_STREAM: one chunk of the whole utterance is held to
    the whole-utterance posteriors within TOL_STREAM, as slice 1's
    stream, and chunks of 100 frames within TOL_POST, with equal phones.

    The CGS-16x stack streams on the dense seeded kernel (the JAX
    package turns the sparse recurrence off under a stream), and its
    input quantizer scales by max|x| over each call, so a chunk's
    features quantize otherwise than the whole utterance's (in both
    packages). The TIMIT RNN's chunks run the x-projection GEMMs over
    fewer rows, where cuBLAS sums in another order: its relu recurrence
    and x5000 head carry that to ~6e-5 in the log-posteriors, the size
    of the card-vs-CPU difference. ``count``: as phase_stream's."""
    T = rec.frontend.num_frames(audio.shape[1])
    _, err_one = phase_stream(dev, rec, audio, lens, phones, logp, T,
                              tag + "_one_chunk", TOL_STREAM, kernel,
                              per_frame, count)
    launches, err = phase_stream(dev, rec, audio, lens, phones, logp, 100,
                                 tag, TOL_POST, kernel, per_frame, count)
    return launches, {"one_chunk_vs_whole": err_one,
                      "chunks_of_100_vs_whole": err}


@contextlib.contextmanager
def swapped(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block: routes a
    model's recurrence through a kernel's plain twin on the same tensors
    (the kernel's comparison, not a path of the port)."""
    kernel = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def plain_twin_on_card():
    """The dense LSTM forward routed through its plain twin."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F

    def plain(gates, U, drop, h0=None, c0=None, act="tanh", qbits=0,
              bf16=False):
        return F.fused_lstm_fwd_plain(gates, U, drop, h0, c0, act, qbits, bf16)
    return swapped(F, "fused_lstm_fwd", plain)


def phase_entry(dev, T=200, B=8, F_in=143):
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    stack = build_stack(dev, feat_dim=F_in)
    x = torch.tensor(np.random.RandomState(0).randn(T, B, F_in)
                     .astype(np.float32), device=dev)
    with torch.inference_mode():
        before = F.fused_lstm_fwd.launches
        y = stack(x)
        launched = F.fused_lstm_fwd.launches - before
        with plain_twin_on_card():
            y_plain = stack(x)
    sync(dev)
    err = float((y - y_plain).abs().max())
    print("[entry] T=%d B=%d F=%d -> %s: kernel launches %d, kernel vs plain "
          "max abs err %.3g (tol %g)" % (T, B, F_in, tuple(y.shape), launched,
                                         err, TOL_F32_SERVE))
    if torch.device(dev).type == "cuda" and launched != 2 * \
            lstm_fwd_launches(dev, T, B, SERVE_TBH[2])[1]:
        raise AssertionError("the entry-shape forward did not run the kernel")
    if tuple(y.shape) != (T, B, PHONES * SPP) or not bool(
            torch.isfinite(y).all()) or not err <= TOL_F32_SERVE:
        raise AssertionError("entry-shape forward failed")
    return err


def shifted(hs, cs, h0, c0):
    """The carries entering each step: (h_prev, c_prev)."""
    z = torch.zeros_like(hs[:1])
    return (torch.cat([z if h0 is None else h0[None], hs[:-1]]),
            torch.cat([z if c0 is None else c0[None], cs[:-1]]))


def rel_err(got, ref):
    """(max abs error, that error over the reference's largest |value|)
    over matching tuples of tensors."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    return err, err / max(scale, 1e-30)


def phase_train_kernels(dev, shapes=(SMALL_TBH, TRAIN_TBH)):
    """The stash forward and both BPTT kernels against their twins, on
    the same tensors, in every variant; the forward and the stash BPTT on
    the routes their plans name (persistent at both shapes: one launch a
    call, lstm_fwd_launches / lstm_bwd_stash_launches), the device
    kernels of one call a shape held to the route's; at the training
    shape the stash BPTT's step route also runs forced
    (fused_lstm._bwd_kernel), against the twin. Returns the checks."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    checks = []
    for (T, B, H) in shapes:
        small = (T, B, H) == SMALL_TBH
        cases = [(bf16, seeded, qbits, "tanh")
                 for bf16 in (False, True) for seeded in (False, True)
                 for qbits in (0, 16)]
        if small:
            cases += [(False, True, 16, a) for a in ("relu", "htanh", "linear")]
        for k, (bf16, seeded, qbits, act) in enumerate(cases):
            g, U, drop, h0, c0 = lstm_inputs(T, B, H, 40 + k, dev, drop_bh=True)
            rng = np.random.RandomState(60 + k)
            t = lambda a: torch.tensor(a.astype(np.float32), device=dev)
            dhs = t(rng.randn(T, B, H) * 0.1)
            carry = (h0, c0) if seeded else (None, None)
            seeds = ((t(rng.randn(B, H) * 0.1), t(rng.randn(B, H) * 0.1))
                     if seeded else (None, None))
            froute, nf = lstm_fwd_launches(dev, T, B, H, bf16)
            broute, nb = lstm_bwd_stash_launches(dev, T, B, H, seeded, bf16)
            routes = {"fused_lstm_fwd/stash": froute,
                      "fused_lstm_bwd_stash": broute,
                      "fused_lstm_bwd": "step"}
            plans = {"fused_lstm_fwd/stash": lstm_plan_brief(
                dev, "fused_lstm_fwd", B, H, bf16),
                "fused_lstm_bwd_stash": lstm_plan_brief(
                    dev, "fused_lstm_bwd_stash", B, H, bf16)}
            plans["fused_lstm_bwd_stash/determinism"] = \
                plans["fused_lstm_bwd_stash"]
            fw, bw = F.fused_lstm_fwd, F.fused_lstm_bwd_stash
            with torch.no_grad():
                hs, cs, acts = launched(fw, nf, lambda: fw(
                    g, U, drop, *carry, act=act, qbits=qbits, bf16=bf16,
                    stash=True))
                errs = {"fused_lstm_fwd/stash": rel_err(
                    (hs, cs, acts), F.fused_lstm_fwd_plain(
                        g, U, drop, *carry, act, qbits, bf16, True))}
                h_prev, c_prev = shifted(hs, cs, *carry)
                ref_b = F.fused_lstm_bwd_stash_plain(
                    acts, U, drop, cs, c_prev, dhs, *seeds, act=act,
                    bf16=bf16)
                errs["fused_lstm_bwd_stash"] = rel_err(launched(
                    bw, nb, lambda: bw(acts, U, drop, cs, c_prev, dhs, *seeds,
                                       act=act, bf16=bf16)), ref_b)
                if not small:       # the stash BPTT's step route, forced
                    routes["fused_lstm_bwd_stash/determinism"] = broute
                    errs["fused_lstm_bwd_stash/determinism"] = same_bits(
                        lambda: bw(acts, U, drop, cs, c_prev, dhs, *seeds,
                                   act=act, bf16=bf16))
                    routes["fused_lstm_bwd_stash/step_route"] = "step"
                    errs["fused_lstm_bwd_stash/step_route"] = rel_err(
                        launched(bw, T + int(seeded), lambda: F._bwd_kernel(
                            bw, acts, U, drop, None, cs, c_prev, dhs, *seeds,
                            act, 0, bf16, True)), ref_b)
                if k + 1 == len(cases):     # the kernels of the routes
                    bptt_kernels(lambda: fw(g, U, drop, *carry, act=act,
                                            qbits=qbits, bf16=bf16,
                                            stash=True),
                                 lstm_fwd_design(froute, T, seeded, qbits))
                    bptt_kernels(lambda: bw(acts, U, drop, cs, c_prev, dhs,
                                            *seeds, act=act, bf16=bf16),
                                 lstm_bwd_stash_design(broute, T, seeded))
                errs["fused_lstm_bwd"] = rel_err(
                    F.fused_lstm_bwd(g, U, drop, h_prev, c_prev, dhs, *seeds,
                                     act=act, qbits=qbits, bf16=bf16),
                    F.fused_lstm_bwd_plain(g, U, drop, h_prev, c_prev, dhs,
                                           *seeds, act=act, qbits=qbits,
                                           bf16=bf16))
            sync(dev)
            tol = TOL_BF16 if bf16 else (TOL_F32_SMALL if small
                                         else TOL_F32_SERVE)
            for name, (err, rel) in errs.items():
                # the forward's bar is absolute (as at the serving
                # shape), the backward's relative to the gradients' scale
                ok = (err if name.startswith("fused_lstm_fwd") else rel) <= (
                    0.0 if name.endswith("determinism") else tol)
                c = {"kernel": name, "T": T, "B": B, "H": H,
                     "dtype": "bf16" if bf16 else "f32",
                     "carry": "seeded" if seeded else "zero", "qbits": qbits,
                     "act": act, "route": routes[name],
                     "plan": plans.get(name), "max_abs_err": err,
                     "rel_err": rel, "tol": tol,
                     "ok": bool(np.isfinite(err) and ok)}
                checks.append(c)
                print("[kernels] %s" % json.dumps(c))
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a training kernel disagrees with its plain "
                             "twin: %s" % bad)
    check_fwd_routes(checks, "fused_lstm_bwd_stash", {
        (SMALL_TBH, "persist"), (TRAIN_TBH, "persist"), (TRAIN_TBH, "step")})
    return checks


CHUNK_CFG = """[exp]
to_do = train
seed = 0

[batches]
batch_size_train = {B}

[data_chunk]
fea = fea_name={fea}
\tfea_lst=none
\tfea_opts=none
\tcw_left=0
\tcw_right=0
lab = {labs}
"""


def chunk_setup(sections, T, B, fea, feat, labels):
    """A train step as a chunk config + in-memory chunk: ``sections``
    (the [architecture*] and [model] sections) over B sentences of T
    frames: x ~ N(0, 1) of width ``feat`` (feature stream ``fea``), then
    one label stream per ``labels`` entry (name, lab_opts, classes) in
    [0, classes), drawn in that order from RandomState(0) as bench.py
    draws them. -> (config, chunk, (inp, mask) of the one batch)."""
    import configparser
    from pytorch_kaldi_cgs_tpu_torch.data.dataset import (ChunkData,
                                                          FeaStream,
                                                          LabStream)
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import make_seq_batches
    labs = "\n\n\t".join("lab_name=%s\n\tlab_folder=none\n\tlab_opts=%s"
                         % (name, opts) for name, opts, _ in labels)
    config = configparser.ConfigParser()
    config.read_string(CHUNK_CFG.format(B=B, fea=fea, labs=labs))
    for name, sec in sections.items():
        config[name] = sec
    rng = np.random.RandomState(0)
    x = rng.randn(T, B, feat).astype(np.float32)
    ys = [rng.randint(0, n, (T, B)) for _, _, n in labels]
    data = np.concatenate([np.concatenate(
        [x[:, b]] + [y[:, b, None] for y in ys], 1)
        for b in range(B)]).astype(np.float32)
    chunk = ChunkData(["utt%02d" % b for b in range(B)], data,
                      np.cumsum([T] * B),
                      {fea: FeaStream(fea, "none", col_start=0, col_end=feat)},
                      {name: LabStream(name, "none", col=feat + k)
                       for k, (name, _, _) in enumerate(labels)})
    inp, mask, _, _ = next(make_seq_batches(chunk, B, True,
                                            np.random.RandomState(0),
                                            bucket=T))
    assert inp.shape == (T, B, feat + len(labels)) and mask.all()
    np.testing.assert_array_equal(inp[..., :feat], x)
    return config, chunk, (inp, mask)


CD_LABELS = [("lab_cd", "ali-to-pdf", PHONES * SPP)]


def train_setup(compute_dtype=""):
    """bench.py's flagship train step (chunk_setup): the flagship options
    with to_do=train, RMSprop lr 0.0016 alpha 0.95 eps 1e-8, x of width
    143 and cd labels, 16 sentences of 300 frames."""
    T, B, _ = TRAIN_TBH
    lo, mo = flagship_options("train", compute_dtype)
    opt = {"arch_lr": "0.0016", "arch_opt": "rmsprop", "opt_momentum": "0.0",
           "opt_alpha": "0.95", "opt_eps": "1e-8", "opt_centered": "False",
           "opt_weight_decay": "0.0", "arch_freeze": "False",
           "arch_library": "pytorch_kaldi_cgs_tpu_torch.models"}
    model = {"model_proto": "proto/model.proto",
             "model": "out_rnn=compute(LSTM_layers,fea)\n"
                      "out_dnn1=compute(MLP_out,out_rnn)\n"
                      "loss_final=cost_nll(out_dnn1,lab_cd)\n"
                      "err_final=cost_err(out_dnn1,lab_cd)"}
    return chunk_setup({
        "architecture1": dict(lo, arch_class="LSTM", arch_seq_model="True",
                              **opt),
        "architecture2": dict(mo, arch_class="MLP", arch_seq_model="False",
                              **opt),
        "model": model}, T, B, "fea", FEAT, CD_LABELS)


def train_runner(dev, compute_dtype=""):
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = train_setup(compute_dtype)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    return ChunkRunner(graph, config), batch


def wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    return {"fused_ligru_fwd": R.fused_ligru_fwd,
            "fused_ligru_bwd_stash": R.fused_ligru_bwd_stash,
            "fused_ligru_bwd": R.fused_ligru_bwd,
            "fused_gru_fwd_sparse": R.fused_gru_fwd_sparse,
            "fused_gru_bwd_sparse": R.fused_gru_bwd_sparse,
            "fused_gru_fwd": R.fused_gru_fwd,
            "fused_gru_bwd_stash": R.fused_gru_bwd_stash,
            "fused_gru_bwd": R.fused_gru_bwd,
            "fused_rnn_fwd": R.fused_rnn_fwd,
            "fused_rnn_bwd_stash": R.fused_rnn_bwd_stash,
            "fused_rnn_bwd": R.fused_rnn_bwd,
            "fused_ligru_fwd_sparse": R.fused_ligru_fwd_sparse,
            "fused_ligru_bwd_sparse": R.fused_ligru_bwd_sparse,
            "fused_gru_torch_fwd": R.fused_gru_torch_fwd,
            "fused_gru_torch_bwd": R.fused_gru_torch_bwd,
            "fused_mgru_fwd": R.fused_mgru_fwd,
            "fused_mgru_bwd_stash": R.fused_mgru_bwd_stash,
            "fused_mgru_bwd": R.fused_mgru_bwd,
            "fused_mgru_fwd_sparse": R.fused_mgru_fwd_sparse,
            "fused_mgru_bwd_sparse": R.fused_mgru_bwd_sparse,
            "fused_rnn_fwd_sparse": R.fused_rnn_fwd_sparse,
            "fused_rnn_bwd_sparse": R.fused_rnn_bwd_sparse,
            "block_sparse_v3_fwd": BS.block_sparse_v3_fwd,
            "block_sparse_v3_dx": BS.block_sparse_v3_dx,
            "fused_lstm_fwd": F.fused_lstm_fwd,
            "fused_lstm_bwd_stash": F.fused_lstm_bwd_stash,
            "fused_lstm_bwd": F.fused_lstm_bwd,
            "fused_lstm_fwd_sparse": F.fused_lstm_fwd_sparse,
            "fused_lstm_bwd_sparse_stash": F.fused_lstm_bwd_sparse_stash,
            "fused_lstm_bwd_sparse": F.fused_lstm_bwd_sparse,
            "block_sparse_dw": BS.block_sparse_dw,
            **{name: getattr(BS, name) for name in LB_WRAPPERS}}


def launched(w, n, fn):
    """fn(), checking that wrapper ``w``'s launch counter moved by n."""
    before = w.launches
    out = fn()
    if w.launches - before != n:
        raise AssertionError("%s: %d launches, expected %d"
                             % (w.__name__, w.launches - before, n))
    return out


def counted(fn):
    """Run fn with every kernel's launch counter set to 0 just before and
    read just after. -> (fn's result, {kernel: launches})."""
    wrappers_ = wrappers()
    for w in wrappers_.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: w.launches for n, w in wrappers_.items()}


@contextlib.contextmanager
def env(name, value):
    """The environment variable ``name`` set to ``value`` (None: unset)
    inside the block: the JAX package's knobs, PKC_LSTM_BWD_RECOMPUTE
    (the backward) and PKC_SPARSE_SCAN_VMEM_MB (the sparse recurrence's
    eligibility and weight-dtype rule)."""
    old = os.environ.get(name)

    def put(v):
        if v is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = v
    put(value)
    try:
        yield
    finally:
        put(old)


def grads_of(runner):
    return {"%s/%s" % (a, k): p.grad for a, net in runner.graph.nets.items()
            for k, p in net.params.items()}


def expected(**nonzero):
    """Launches per kernel: the ones named, 0 for every other kernel."""
    out = dict.fromkeys(wrappers(), 0)
    out.update(nonzero)
    return out


def lstm_modes(T, stash=None, recompute=None, dev="cuda", B=TRAIN_TBH[1],
               H=TRAIN_TBH[2]):
    """The LSTM train step's two backward modes: (name, knob, value,
    expected launches per step), the first the default. Defaults: a
    dense 2-layer LSTM's at (T, B, H) (the flagship's), each layer call on
    the route its plan names (lstm_fwd_launches, lstm_bwd_stash_launches:
    one launch a call on the persistent route), the recompute BPTT T
    times a call."""
    if stash is None or recompute is None:
        fwd = 2 * lstm_fwd_launches(dev, T, B, H)[1]
        stash = stash or expected(
            fused_lstm_fwd=fwd,
            fused_lstm_bwd_stash=2 * lstm_bwd_stash_launches(dev, T, B, H)[1])
        recompute = recompute or expected(fused_lstm_fwd=fwd,
                                          fused_lstm_bwd=2 * T)
    return (("stash", "PKC_LSTM_BWD_RECOMPUTE", "0", stash),
            ("recompute", "PKC_LSTM_BWD_RECOMPUTE", "1", recompute))


def dropout_gen():
    """A card-vs-CPU comparison's dropout masks come from one CPU
    generator on the card and on the CPU alike (drawn on its device,
    then moved), so the two runs drop the same units."""
    return torch.Generator().manual_seed(0)


def grad_rel_errs(runner, ref):
    """Each gradient's max abs difference over the reference's largest
    magnitude, by parameter."""
    g_dev, g_ref = grads_of(runner), grads_of(ref)
    return {k: float((g_dev[k].cpu() - g_ref[k].cpu()).abs().max())
            / max(float(g_ref[k].abs().max()), 1e-30) for k in g_ref}


def card_vs_cpu(runner, cpu, inp, mask, loss_err, knob, value, tag,
                grad_tol=TOL_GRAD_REL):
    """The CPU runner's step against the card's (``loss_err``, its
    gradients in ``runner``): loss within TOL_LOSS_REL, err within one
    frame, every gradient within ``grad_tol`` of its scale (a number, or
    a function of the worst gradient error that returns the bar)."""
    T, B = inp.shape[:2]
    loss, err = loss_err
    with env(knob, value):
        loss_c, err_c = cpu.train_step(inp, mask, dropout_gen())
    grad_errs = grad_rel_errs(runner, cpu)
    loss_rel = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    worst = max(grad_errs, key=grad_errs.get)
    if callable(grad_tol):          # a bar that depends on the error seen
        grad_tol = grad_tol(grad_errs[worst])
    out = dict(loss_card=float(loss), loss_cpu=float(loss_c),
               err_card=float(err), err_cpu=float(err_c),
               loss_rel_err=loss_rel, grads_compared=len(grad_errs),
               grad_rel_err_max=grad_errs[worst], grad_rel_err_worst=worst,
               grad_tol=grad_tol)
    print("[%s] card vs CPU: loss %.7f vs %.7f (rel %.3g, tol %g); %d "
          "gradients, worst rel err %.3g at %s (tol %g)"
          % (tag, float(loss), float(loss_c), loss_rel, TOL_LOSS_REL,
             len(grad_errs), grad_errs[worst], worst, grad_tol))
    if not (loss_rel <= TOL_LOSS_REL and grad_errs[worst] <= grad_tol
            and abs(float(err) - float(err_c)) <= 1.0 / (T * B) + 1e-7):
        raise AssertionError("%s step on the card disagrees with the CPU"
                             % tag)
    return out


def phase_train(dev, make_runner=train_runner, tag="train", modes=None,
                grad_tol=TOL_GRAD_REL, fall_runner=None):
    """A training path: ChunkRunner.train_step on the card. One step in
    the default backward mode against the CPU (card_vs_cpu), launches
    per step in each of ``modes`` (``lstm_modes`` by default), then
    TRAIN_STEPS steps on the one batch in f32 and bf16 (runners from
    ``fall_runner``, default ``make_runner``)."""
    out = {}
    runner, (inp, mask) = make_runner(dev)
    T, B = inp.shape[:2]
    modes = modes or lstm_modes(T, dev=dev, B=B)
    (name, knob, value, expect), *others = modes
    with env(knob, value):
        (loss, err), launches = counted(
            lambda: runner.train_step(inp, mask, dropout_gen()))
    out["launches_" + name] = launches
    print("[%s] step (%s backward): loss %.6f err %.4f, launches %s"
          % (tag, name, float(loss), float(err), launches))
    if launches != expect:
        raise AssertionError("%s step launches %s, expected %s"
                             % (tag, launches, expect))
    out.update(card_vs_cpu(runner, make_runner("cpu")[0], inp, mask,
                           (loss, err), knob, value, tag, grad_tol))
    for name, knob, value, expect in others:
        with env(knob, value):
            (loss_r, _), launches = counted(
                lambda: runner.train_step(inp, mask, dropout_gen()))
        out["launches_" + name] = launches
        print("[%s] step (%s backward): loss %.6f, launches %s"
              % (tag, name, float(loss_r), launches))
        if launches != expect:
            raise AssertionError("%s %s step launches %s, expected %s"
                                 % (tag, name, launches, expect))
    for cdt in ("", "bf16"):
        r, (inp, mask) = (fall_runner or make_runner)(dev, cdt)
        losses = [float(r.train_step(inp, mask)[0])
                  for _ in range(TRAIN_STEPS)]
        name = "bf16" if cdt else "f32"
        out["losses_" + name] = losses
        print("[%s] %s: %d steps on one batch, loss %s"
              % (tag, name, TRAIN_STEPS, ["%.4f" % v for v in losses]))
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError("%s training loss did not fall" % name)
    return out


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps=5):
    """Host wall times (ms) of ``reps`` synchronized calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def roofline_ms(nbytes, flops, dtype="f32"):
    """The least time (ms) for ``nbytes`` moved over the HBM rate and
    ``flops`` at the peak of their type: -> (ms, "bytes"|"operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lstm_bound_ms(T, B, H, dtype="f32", kind="fwd", kept=None):
    """Least time for one layer call: each input read once, each output
    written once, over the HBM rate; the FMAs over the peak of their
    type. kind: "fwd" (gates, drop, U in; hs, cs out), "fwd_stash" (and
    the (T, B, 4H) activations out), "bwd_stash" (activations, cs,
    c_prev, dhs, drop, U in; dg out; one (B, 4H) x (4H, H) product per
    step), "bwd" (gates, h_prev, c_prev, dhs, drop, U in; dg out; that
    product and the forward's). ``kept``: the block-sparse recurrence's
    R*bs kept columns per row of U (w3g is (4H, kept) in all), None for
    the dense U. -> (ms, "bytes"|"operations")."""
    u_bytes = 2 if dtype == "bf16" else 4
    kept = H if kept is None else kept
    gates, seq, bh = T * B * 4 * H * 4, T * B * H * 4, B * H * 4
    nbytes = {"fwd": gates + bh + 2 * seq,
              "fwd_stash": 2 * gates + bh + 2 * seq,
              "bwd_stash": 2 * gates + bh + 3 * seq,
              "bwd": 2 * gates + bh + 3 * seq}[kind] + 4 * H * kept * u_bytes
    flops = 2 * T * B * 4 * H * kept * (2 if kind == "bwd" else 1)
    return roofline_ms(nbytes, flops, dtype)


def phase_times(dev, rec, audio, lens):
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    T, B, H = SERVE_TBH
    g, U, drop, _, _ = lstm_inputs(T, B, H, 99, dev, drop_bh=False)
    times = {}
    with torch.no_grad():
        times["ms"] = cuda_ms(lambda: F.fused_lstm_fwd(g, U, drop), reps=20)
        times["plain_ms"] = cuda_ms(
            lambda: F.fused_lstm_fwd_plain(g, U, drop, None, None, "tanh", 0,
                                           False), reps=3, warmup=1)
        cudnn = torch.nn.LSTM(H, H).to(dev).eval()
        xin = torch.randn(T, B, H, device=dev)
        times["library_ms"] = cuda_ms(lambda: cudnn(xin), reps=20)
        times["ms_bf16"] = cuda_ms(
            lambda: F.fused_lstm_fwd(g, U, drop, bf16=True), reps=20)
    times["bound_ms"], times["bound_by"] = lstm_bound_ms(T, B, H)
    print("[times] fused_lstm_fwd at T=%d B=%d H=%d: kernel %.3f ms "
          "(bf16 dots %.3f ms), plain twin %.3f ms, cuDNN nn.LSTM %.3f ms, "
          "bound %.4f ms (%s)" % (T, B, H, times["ms"], times["ms_bf16"],
                                  times["plain_ms"], times["library_ms"],
                                  times["bound_ms"], times["bound_by"]))

    serve = serve_timings(rec, audio, lens)
    print("[times] recognizer (8 x 4 s batch): %s" % json.dumps(serve))
    return times, serve


def serve_timings(rec, audio, lens):
    """A recognizer's host wall times (median of 5 synchronized calls):
    recognize, and its features, posteriors and Viterbi parts; audio-s/s
    over the padded and the speech seconds; one profiled recognize."""
    from pytorch_kaldi_cgs_tpu_torch.decode.viterbi import \
        batched_viterbi_decode
    rec_ms = wall_ms(lambda: rec.recognize(audio, lens))
    logp = rec.posteriors(audio)
    frames = rec.frame_lengths(N_UTT, audio.shape[1], lens)
    med = float(np.median(rec_ms))
    serve = {"recognize_ms_runs": rec_ms, "recognize_ms_median": med,
             "features_ms_median": float(np.median(wall_ms(
                 lambda: rec.features(audio)))),
             "posteriors_ms_median": float(np.median(wall_ms(
                 lambda: rec.posteriors(audio)))),
             "decode_ms_median": float(np.median(wall_ms(
                 lambda: batched_viterbi_decode(logp, frames, rec.hmm,
                                                acwt=rec.acwt)))),
             "audio_s_per_s_padded": N_UTT * SECONDS / (med / 1e3),
             "audio_s_per_s_speech": float(np.sum(lens)) / SR / (med / 1e3)}
    serve.update(device_busy(lambda: rec.recognize(audio, lens)))
    serve["device_ms_by_class"] = kernel_classes(serve.pop("by_name"))
    return serve


def train_step_times(dev, make_runner, tag, reps, part_reps):
    """A train step as users run it, ``runner.train_step(inp, mask)``
    (dropout masks drawn on the card), in f32 and bf16: CUDA-event ms
    (mean of ``reps``) and frames/s, its parts (step_parts), one profiled
    step's device busy share and device ms by class of kernel."""
    step = {}
    for cdt in ("", "bf16"):
        name = "bf16" if cdt else "f32"
        runner, (inp, mask) = make_runner(dev, cdt)
        inp = torch.as_tensor(inp, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        T, B = inp.shape[:2]
        ms = cuda_ms(lambda: runner.train_step(inp, mask), reps=reps)
        step[name] = {"step_ms": ms, "frames_per_s": T * B / (ms / 1e3)}
        step[name].update(step_parts(runner, inp, mask, reps=part_reps))
        busy = device_busy(lambda: runner.train_step(inp, mask), top=10)
        busy["device_ms_by_class"] = kernel_classes(busy.pop("by_name"))
        step[name].update(busy)
        print("[%s] train step %s: %s" % (tag, name, json.dumps(step[name])))
    return step


def phase_train_times(dev):
    """CUDA-event times at the training shape: each kernel per layer call
    (f32 and bf16), its twin, its bound, cuDNN's nn.LSTM as a yardstick;
    the flagship train step in f32 and bf16 with its device busy share
    and where its time goes."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    T, B, H = TRAIN_TBH
    g, U, drop, _, _ = lstm_inputs(T, B, H, 98, dev, drop_bh=True)
    dhs = torch.randn(T, B, H, device=dev) * 0.01
    times = {}
    with torch.no_grad():
        for bf16 in (False, True):
            sfx = "_bf16" if bf16 else ""
            hs, cs, acts = F.fused_lstm_fwd(g, U, drop, bf16=bf16, stash=True)
            h_prev, c_prev = shifted(hs, cs, None, None)
            calls = {
                "fused_lstm_fwd": lambda: F.fused_lstm_fwd(
                    g, U, drop, bf16=bf16, stash=True),
                "fused_lstm_bwd_stash": lambda: F.fused_lstm_bwd_stash(
                    acts, U, drop, cs, c_prev, dhs, bf16=bf16),
                "fused_lstm_bwd": lambda: F.fused_lstm_bwd(
                    g, U, drop, h_prev, c_prev, dhs, bf16=bf16)}
            plain = {
                "fused_lstm_fwd": lambda: F.fused_lstm_fwd_plain(
                    g, U, drop, None, None, "tanh", 0, bf16, True),
                "fused_lstm_bwd_stash": lambda: F.fused_lstm_bwd_stash_plain(
                    acts, U, drop, cs, c_prev, dhs, bf16=bf16),
                "fused_lstm_bwd": lambda: F.fused_lstm_bwd_plain(
                    g, U, drop, h_prev, c_prev, dhs, bf16=bf16)}
            kinds = {"fused_lstm_fwd": "fwd_stash",
                     "fused_lstm_bwd_stash": "bwd_stash",
                     "fused_lstm_bwd": "bwd"}
            for name, fn in calls.items():
                times[name + "_ms" + sfx] = cuda_ms(fn, reps=10)
                times[name + "_plain_ms" + sfx] = cuda_ms(plain[name], reps=2,
                                                          warmup=1)
                bound, by = lstm_bound_ms(T, B, H, "bf16" if bf16 else "f32",
                                          kinds[name])
                times[name + "_bound_ms" + sfx] = bound
                times[name + "_bound_by" + sfx] = by
    cudnn = torch.nn.LSTM(H, H).to(dev)
    x = torch.randn(T, B, H, device=dev, requires_grad=True)
    dy = torch.randn(T, B, H, device=dev)
    fwd_ms = cuda_ms(lambda: cudnn(x)[0], reps=10)
    fb_ms = cuda_ms(lambda: cudnn(x)[0].backward(dy), reps=10)
    times.update(cudnn_fwd_ms=fwd_ms, cudnn_fwd_bwd_ms=fb_ms,
                 cudnn_bwd_ms=fb_ms - fwd_ms)
    # the dU product outside the BPTT kernel: (4H, T*B) @ (T*B, H)
    dg = torch.randn(T * B, 4 * H, device=dev)
    hq = torch.randn(T * B, H, device=dev)
    times["dU_matmul_ms"] = cuda_ms(lambda: dg.T @ hq, reps=20)
    print("[times] kernels at T=%d B=%d H=%d: %s" % (T, B, H,
                                                    json.dumps(times)))
    return times, train_step_times(dev, train_runner, "times", 10, 5)


def step_parts(runner, inp, mask, reps=5):
    """ChunkRunner.train_step's three parts timed apart with CUDA events
    (median ms of reps): graph forward, backward, optimizer steps."""
    parts = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for opt in runner.optimizers.values():
            opt.zero_grad(set_to_none=True)
        ev[0].record()
        outs = runner.graph.forward(inp, train=True, frame_mask=mask)
        ev[1].record()
        outs["loss_final"].backward()
        ev[2].record()
        for opt in runner.optimizers.values():
            opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, zip(ev, ev[1:])):
            parts[k].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in parts.items()}


def kernel_classes(by_name, launches=False):
    """Device ms per class of kernel, from the profile's kernel names (with
    ``launches``, the kernel records per class)."""
    # the first match names the class: the sparse RNN's and the sparse
    # liGRU's kernels before the sparse LSTM's ("sparse_bwd_step"), the
    # minimalGRU's (the GRU's step kernels at G=2) before the GRU's
    mg = ["gru_%s<%s2>" % (k, p) for k in ("zr_step", "h_step", "bwd_carry",
                                          "bwd_ds")
          for p in ("", "false, ", "true, ")]
    classes = {"rnn_sparse_fwd_kernel": ("rnn_sparse_step",
                                         "rnn_sparse_fwd_persist"),
               # the chain's step kernels or persistent kernel and the
               # persistent route's rebuild (the step route's is
               # rnn_sparse_step's, under rnn_sparse_fwd_kernel)
               "rnn_sparse_bptt_kernel": ("rnn_sparse_bwd",
                                          "rnn_sparse_rebuild"),
               # the step kernels at G=2 and the persistent forwards' G=2
               # instantiations, dense and sparse (their G=3 ones count
               # under gru_fwd_kernel)
               "mgru_fwd_kernel": tuple(mg[:6]) + (
                   "gru_dense_fwd_persist<2", "gru_fwd_persist<false, 2",
                   "gru_fwd_persist<true, 2"),
               # the step kernels, and the persistent chains (the dense one
               # with its rebuild's products and z pass; the sparse one's
               # rebuild is the step kernels')
               "mgru_bptt_kernel": tuple(mg[6:]) + (
                   "gru_dense_bwd_persist<2", "mgru_z_rebuild", "rows_dots",
                   "gru_bwd_persist<false, 2", "gru_bwd_persist<true, 2"),
               "ligru_sparse_fwd_kernel": ("ligru_sparse_step",),
               "ligru_sparse_bptt_kernel": ("ligru_sparse_bwd",),
               "gru_torch_fwd_kernel": ("gru_torch_step",),
               # the rebuild GEMM of the torch-semantics GRU's and the
               # liGRU's recompute BPTT (and an earlier tree's name of it)
               "rec_u_gemm_kernel": ("rec_u_gemm", "gru_torch_u_gemm"),
               # _step and _persist
               "gru_torch_bptt_kernel": ("gru_torch_bwd",),
               "lstm_fwd_kernel": ("lstm_step", "lstm_fwd_persist",
                                   "sparse_fwd_step",
                                   "lstm_sparse_fwd_persist"),
               # the step kernels, the dh0 dot and the persistent chains
               "lstm_bptt_kernel": ("lstm_bwd", "sparse_bwd_step",
                                    "lstm_sparse_bwd"),
               "ligru_fwd_kernel": ("ligru_step", "ligru_fwd_persist"),
               "ligru_bptt_kernel": ("ligru_bwd",),
               "gru_fwd_kernel": ("gru_zr_step", "gru_h_step",
                                  "gru_fwd_persist", "gru_dense_fwd_persist"),
               # the step route's and the persistent route's (its rebuild's
               # elementwise passes; its GEMMs count under v3_kernel), and
               # the dense stash chain's G=3 instantiation
               "gru_bptt_kernel": ("gru_bwd_carry", "gru_bwd_ds",
                                   "gru_bwd_persist", "gru_zr_rebuild",
                                   "gru_apre_rebuild", "quant_steps",
                                   "gru_dense_bwd_persist<3"),
               "rnn_fwd_kernel": ("rnn_step", "rnn_fwd_persist"),
               # the step kernels and the persistent chain (the recompute
               # backward's rebuild is rnn_step's, under rnn_fwd_kernel)
               "rnn_bptt_kernel": ("rnn_bwd_step", "rnn_bwd_persist"),
               # the forward's weight pass and GEMM, the dx's weight pass
               # and the legacy dx's float32 tile it runs on
               "v3_kernel": ("v3_fwd_gemm", "v3_weight_t", "v3_weight_packed",
                             "dx_gemm", "dx_reduce"),
               "block_sparse_dw_kernel": ("dw_gemm", "dw_reduce"),
               "matmul": ("gemm", "cutlass", "sm90_", "ampere_", "cublas"),
               }
    out = {k: 0.0 for k in classes}
    out["other"] = 0.0
    for name, (n, us) in by_name.items():
        low = name.lower()
        cls = next((k for k, subs in classes.items()
                    if any(sub in low for sub in subs)), "other")
        out[cls] += n if launches else us / 1e3
    return out


def device_busy(fn, top=6):
    """One call under torch.profiler: the share of its wall time the
    card spent in kernels (one stream, so kernels do not overlap) and
    the kernels that took most of it. None where the trace shows no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        # kernels and copies only: a user annotation (the optimizer's
        # record_function range) spans kernels already counted
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy_us = sum(t for _, t in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"profiled_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if by_name else None,
            "device_busy_share": busy_us / wall_us if by_name else None,
            "kernel_launches": sum(n for n, _ in by_name.values()),
            "top_kernels_ms": [[name[:60], n, t / 1e3]
                               for name, (n, t) in ranked[:top]],
            "by_name": by_name}


def kernel_short_name(name):
    """``void (anonymous namespace)::dw_gemm<true>(float const*, ...)`` ->
    ``dw_gemm``."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    m = re.match(r"[\w:]+", s)
    return m.group(0).split("::")[-1] if m else name[:40]


def trace_events(fn, reps=1, mark=False):
    """The events of torch.profiler's trace of ``reps`` calls of ``fn``
    (after one warm-up call), read from the trace file it writes; with
    ``mark``, call i inside a host range named ``call_<i>``, the device
    idle again before the next call."""
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("device_kernels"):
            for i in range(reps):
                if mark:
                    with record_function("call_%d" % i):
                        fn()
                    torch.cuda.synchronize()
                else:
                    fn()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", "device_kernels_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    return events


def kernel_ms(fn, reps=20):
    """Device time (ms) per call of the kernels one call of ``fn``
    launches, summed over the kernel records of ``reps`` profiled calls;
    None where the trace holds none."""
    durs = [float(e.get("dur", 0)) for e in trace_events(fn, reps)
            if e.get("cat") == "kernel"]
    return sum(durs) / reps / 1e3 if durs else None


def host_ms(fn, reps=100):
    """Host time (ms) per call of ``reps`` calls enqueued back to back,
    no synchronize inside the window: where it reaches the CUDA-event
    time of the same calls, the host path bounds them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def device_kernels(fn, tries=3):
    """The device kernels one call of ``fn`` launches, by short name, as
    torch.profiler's trace records them (read from the trace file it
    writes). A trace is whole when it holds a kernel record for each of
    the CUDA runtime's launch calls; one that holds fewer (late in the
    full run a short call's trace held none, or one of a call's two) is
    taken again, up to ``tries`` traces. Where none was whole it counts
    the launch calls instead, ``{"cuda_launch_calls": n}``; None where
    the traces held neither."""
    for _ in range(tries):
        events = trace_events(fn)
        out, calls = {}, 0
        for e in events:
            name = str(e.get("name", ""))
            if e.get("cat") == "kernel":
                k = kernel_short_name(name)
                out[k] = out.get(k, 0) + 1
            elif e.get("cat") == "cuda_runtime" and name.startswith(
                    ("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchCooperativeKernel")):
                calls += 1
        if out and sum(out.values()) >= calls:
            return out
        print("[device_kernels] %d kernel records %s for %d launch calls; "
              "trace categories: %s" % (
                  sum(out.values()), sorted(out), calls,
                  sorted({str(e.get("cat")) for e in events})))
    return {"cuda_launch_calls": calls} if calls else None


# ---------------------------------------------------------------------------
# the CGS-16x slice: the block-sparse HCGS recurrence
# ---------------------------------------------------------------------------

def cgs_sections(compute_dtype="", shipped=False):
    """The CGS-16x cfg's [architecture1..3] and [model], read from the
    file, with lstm_block_sparse=auto (the JAX package's default; the
    file says False, which ``shipped`` keeps: the dense kernels over the
    masked U), the port's arch_library, N_out_lab_cd = 1944 and
    N_out_lab_mono = 48."""
    import configparser
    src = configparser.ConfigParser()
    if not src.read(CGS_CFG):
        raise FileNotFoundError(CGS_CFG)
    secs = {k: dict(src[k]) for k in ("architecture1", "architecture2",
                                      "architecture3", "model")}
    if not shipped:
        secs["architecture1"]["lstm_block_sparse"] = "auto"
    for k in ("architecture1", "architecture2", "architecture3"):
        secs[k]["arch_library"] = "pytorch_kaldi_cgs_tpu_torch.models"
        secs[k]["compute_dtype"] = compute_dtype
    for k, n in (("architecture2", "N_out_lab_cd"),
                 ("architecture3", "N_out_lab_mono")):
        secs[k]["dnn_lay"] = secs[k]["dnn_lay"].replace(
            n, str(PHONES * SPP if n.endswith("cd") else N_MONO))
    return secs


def build_cgs_stack(dev, feat_dim=40):
    """The CGS-16x LSTM -> its 1944-way cd head (weights from init(0) /
    init(1)); both recurrences must take the block-sparse path."""
    from pytorch_kaldi_cgs_tpu_torch.models import LSTM, MLP
    secs = cgs_sections()
    lstm = LSTM(dict(secs["architecture1"], to_do="forward"), feat_dim,
                seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), lstm.out_dim,
              seed=1, device=dev)
    if sorted(lstm._rec_layouts) != [0, 1]:
        raise AssertionError("the CGS-16x recurrences have no sparse layout")
    with torch.no_grad():
        mlp.params["w0"].mul_(CGS_HEAD_GAIN)
    return Stack(lstm, mlp).eval()


def cgs_layout(H, seed):
    """A CGS-16x recurrent mask (HCGS 128,8 at 75,75) of width H, its
    layout, the level-2 submask in the w3g layout of the four gates."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask
    mask = hcgs_mask(H, H, [128, 8], [75, 75],
                     rng=np.random.RandomState(seed))
    layout = BS.pack_layout(mask, 128)
    sub3 = BS.stack_w3_gates([BS.pack_w3(mask, layout)] * 4)
    return mask, layout, sub3


def sparse_inputs(T, B, H, seed, dev):
    """Gates, the masked dense U (4H, H) and its w3g, a (B, H) dropout
    mask and upstream cotangents, on the CGS-16x recurrent layout."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    mask, layout, sub3 = cgs_layout(H, seed)
    rng = np.random.RandomState(seed + 1)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    U = rng.randn(4 * H, H) / np.sqrt(layout.R * layout.bs / 4.0)
    U = (U * np.tile(mask, (4, 1))).astype(np.float32)
    w3g = BS.stack_w3_gates([BS.pack_w3(U[g * H:(g + 1) * H], layout)
                             for g in range(4)])
    return {"g": t(rng.randn(T, B, 4 * H) * 0.5), "U": t(U), "w3g": t(w3g),
            "drop": t((rng.rand(B, H) > 0.2) * 1.0),
            "dhs": t(rng.randn(T, B, H) * 0.1), "layout": layout,
            "sub3": t(sub3)}


def dw_operands(dg, h_prev, layout):
    """A layer's dU operands over (T*B), as ``sparse_dU`` hands them to
    the dw kernel: dg in its (M, Nb*4*bs) order, and h_prev (M, H)."""
    T, B, H = h_prev.shape
    dg_flat = dg.reshape(T * B, 4, layout.Nb, layout.bs).transpose(1, 2) \
        .reshape(T * B, -1).contiguous()
    return dg_flat, h_prev.reshape(T * B, H).contiguous()


def same_bits(fn):
    """(max abs difference, the same) of two calls of ``fn`` (a tensor or
    a tuple of them): (0, 0) when they give equal bits (a check at tol
    0)."""
    return bits_apart(fn(), fn())


def bits_apart(a, b):
    """same_bits of two results in hand."""
    a, b = (v if isinstance(v, tuple) else (v,) for v in (a, b))
    err = max(0.0 if torch.equal(x, y) else float((x - y).abs().max())
              for x, y in zip(a, b))
    return err, err


def record_check(checks, tag, name, where, variant, err_rel, tol, by_rel):
    """Append and print one kernel-vs-twin check: ``where`` (shape keys)
    and ``variant`` describe it; ok when the max abs error (or, with
    ``by_rel``, that error over the twin's largest |value|) is finite and
    within ``tol``."""
    err, rel = err_rel
    c = {"kernel": name, **where, **variant, "max_abs_err": err,
         "rel_err": rel, "tol": tol,
         "ok": bool(np.isfinite(err) and (rel if by_rel else err) <= tol)}
    checks.append(c)
    print("[%s] %s" % (tag, json.dumps(c)))


def phase_sparse_kernels(dev):
    """The sparse forward (plain and stash), both sparse BPTT kernels
    and the block-sparse dw kernel against their twins on the same
    tensors: qbits 0/16 x tanh/relu x w3g f32/bf16; dw with and without
    the level-2 submask; at the small, serving and training shapes. Rows
    4 and 5 on the routes their plans name, each call's launches checked
    against its route's count (lstm_fwd_sparse_launches,
    lstm_bwd_sparse_stash_launches), two calls bit for bit, each step
    route forced (fused_lstm._fwd_sparse_step, _bwd_sparse_step) against
    the twin and bit for bit the wrapper's route (the forward's hs, cs
    and acts, the chain's dg); one tanh, qbits 16, f32 call of each a
    shape held to its route's device kernels by name
    (lstm_fwd_sparse_design, lstm_bwd_sparse_stash_design); both rows at
    every block shape of their tables (lstm_sparse_shapes)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    checks = []
    fwd, bwd = F.fused_lstm_fwd_sparse, F.fused_lstm_bwd_sparse_stash

    for shape in (SP_SMALL_TBH, SP_SERVE_TBH, SP_TRAIN_TBH):
        T, B, H = shape
        small, serve = shape == SP_SMALL_TBH, shape == SP_SERVE_TBH
        cases = [(wbf16, qbits, act) for wbf16 in (False, True)
                 for qbits in (0, 16) for act in ("tanh", "relu")]
        for k, (wbf16, qbits, act) in enumerate(cases):
            inp = sparse_inputs(T, B, H, 70 + k, dev)
            g, w3g, drop, dhs, layout = (inp[n] for n in (
                "g", "w3g", "drop", "dhs", "layout"))
            dbh = torch.broadcast_to(drop, (B, H)).contiguous()
            # the JAX package's rule reads w3g in bf16 when its budget is
            # small; a 256-wide layer always fits, so there the bf16
            # variant is asked for directly
            with env("PKC_SPARSE_SCAN_VMEM_MB",
                     SP_BF16_VMEM_MB if wbf16 else None):
                rule = F.sparse_scan_fits(B, H, layout)
            if not small and rule != ("bf16" if wbf16 else "f32"):
                raise AssertionError("sparse_scan_fits gave %r" % rule)
            bf16 = wbf16
            variant = {"w3g": "bf16" if bf16 else "f32", "qbits": qbits,
                       "act": act, "Kb": layout.Kb, "R": layout.R}
            tol = TOL_BF16 if bf16 else (TOL_F32_SMALL if small
                                         else TOL_F32_SERVE)
            kernels = (wbf16, qbits, act) == (False, 16, "tanh")

            def check(name, err_rel, tol_, by_rel, route=None):
                record_check(checks, "sparse_kernels", name,
                             dict(zip("TBH", shape)),
                             dict(variant, **({"route": route} if route
                                              else {})),
                             err_rel, tol_, by_rel)
            with torch.no_grad():
                fargs = (g, w3g, drop, layout, act, qbits, bf16)
                ref = F.fused_lstm_fwd_sparse_plain(*fargs, True)
                route, n = lstm_fwd_sparse_launches(dev, T, B, layout, bf16)
                hc = launched(fwd, n, lambda: fwd(*fargs))
                check("fused_lstm_fwd_sparse", rel_err(hc, ref[:2]), tol,
                      False, route)
                st = launched(fwd, T, lambda: F._fwd_sparse_step(
                    g, w3g, dbh, layout, act, qbits, bf16, not serve))
                check("fused_lstm_fwd_sparse/step_route",
                      rel_err(st, ref if not serve else ref[:2]), tol,
                      False, "step")
                if serve:
                    check("fused_lstm_fwd_sparse/persist_vs_step",
                          bits_apart(hc, st), 0.0, False, route)
                    if kernels:
                        bptt_kernels(lambda: fwd(*fargs),
                                     lstm_fwd_sparse_design(route, T))
                    continue
                hs, cs, acts = launched(fwd, n, lambda: fwd(*fargs,
                                                            stash=True))
                check("fused_lstm_fwd_sparse/stash", rel_err(
                    (hs, cs, acts), ref), tol, False, route)
                check("fused_lstm_fwd_sparse/determinism", same_bits(
                    lambda: fwd(*fargs, stash=True)), 0.0, False, route)
                check("fused_lstm_fwd_sparse/persist_vs_step",
                      bits_apart((hs, cs, acts), st), 0.0, False, route)
                if kernels:
                    bptt_kernels(lambda: fwd(*fargs, stash=True),
                                 lstm_fwd_sparse_design(route, T))
                h_prev, c_prev = shifted(hs, cs, None, None)
                bargs = (acts, w3g, drop, cs, c_prev, dhs, layout, act, bf16)
                route, n = lstm_bwd_sparse_stash_launches(dev, T, B, layout,
                                                          bf16)
                dg = launched(bwd, n, lambda: bwd(*bargs))
                ref = F.fused_lstm_bwd_sparse_stash_plain(*bargs)
                check("fused_lstm_bwd_sparse_stash", rel_err(dg, ref), tol,
                      True, route)
                check("fused_lstm_bwd_sparse_stash/determinism",
                      same_bits(lambda: bwd(*bargs)), 0.0, False, route)
                dg_st = launched(bwd, T, lambda: F._bwd_sparse_step(
                    bwd, acts, w3g, dbh, None, cs, c_prev, dhs, layout,
                    act, 0, bf16, True))
                check("fused_lstm_bwd_sparse_stash/step_route",
                      rel_err(dg_st, ref), tol, True, "step")
                check("fused_lstm_bwd_sparse_stash/persist_vs_step",
                      bits_apart(dg, dg_st), 0.0, False, route)
                if kernels:
                    bptt_kernels(lambda: bwd(*bargs),
                                 lstm_bwd_sparse_stash_design(route, T))
                check("fused_lstm_bwd_sparse", rel_err(
                    launched(F.fused_lstm_bwd_sparse, T,
                             lambda: F.fused_lstm_bwd_sparse(
                                 g, w3g, drop, h_prev, c_prev, dhs, layout,
                                 act, qbits, bf16)),
                    F.fused_lstm_bwd_sparse_plain(
                        g, w3g, drop, h_prev, c_prev, dhs, layout, act, qbits,
                        bf16)), tol, True, "step")
                if bf16 or qbits:
                    continue
                dg_flat, x = dw_operands(dg, h_prev, layout)
                for sub in (None, inp["sub3"]):
                    record_check(
                        checks, "sparse_kernels", "block_sparse_dw",
                        dict(zip("TBH", shape)),
                        {"fuse_sub": sub is not None, "act": act,
                         "M": T * B, "Kb": layout.Kb, "R": layout.R},
                        rel_err(BS.block_sparse_dw(dg_flat, x, layout, 4,
                                                   sub),
                                BS.block_sparse_dw_plain(dg_flat, x, layout,
                                                         4, sub)),
                        TOL_F32_SMALL, True)
                if shape == SP_TRAIN_TBH and act == "tanh":
                    record_check(
                        checks, "sparse_kernels", "block_sparse_dw/determinism",
                        dict(zip("TBH", shape)), {"M": T * B, "G": 4},
                        same_bits(lambda: BS.block_sparse_dw(dg_flat, x,
                                                             layout, 4)),
                        0.0, False)
    shapes = lstm_sparse_shapes(checks, F, dev)
    print("[sparse_kernels] rows 4 and 5 by block shape: %s"
          % json.dumps(shapes))
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a sparse kernel disagrees with its plain "
                             "twin: %s" % bad)
    return checks


#: the steps at which lstm_sparse_shapes forces each block shape of rows
#: 4 and 5 (at 8 bi - 3 rows: one ragged row group), over the layout of
#: seed 421, whose heaviest column holds 5 blocks
SP_SHAPES_T = 24
SP_SHAPES_SEED = 421


def lstm_sparse_shapes(checks, F, dev):
    """Rows 4 and 5's persistent routes forced to every block shape their
    plans can take (fused_lstm.LSTM_FWD_SPARSE_SHAPES,
    LSTM_BWD_SPARSE_SHAPES) at the CGS-16x layout of SP_SHAPES_SEED, 8 bi
    - 3 rows of 1024, tanh, qbits 16, f32 w3g: each against its twin at
    TOL_Q16, the forward's hs, cs and acts and the chain's dg bit for bit
    its step route's; the chain also forced to stage one entry a slab
    through two buffers (the plan's choice where whole rows do not fit);
    a shape whose grid is not co-resident is recorded as skipped."""
    out = {}
    for kind, shapes in (("fwd", F.LSTM_FWD_SPARSE_SHAPES),
                         ("bwd", F.LSTM_BWD_SPARSE_SHAPES)):
        for bi, un in shapes:
            T, B, H = SP_SHAPES_T, 8 * bi - 3, SP_TRAIN_TBH[2]
            inp = sparse_inputs(T, B, H, SP_SHAPES_SEED, dev)
            g, w3g, drop, dhs, lay = (inp[n] for n in (
                "g", "w3g", "drop", "dhs", "layout"))
            dbh = torch.broadcast_to(drop, (B, H)).contiguous()
            where = {"T": T, "B": B, "H": H}
            block = "%d units x %d rows" % (un, 8 * bi)
            kernel = ("fused_lstm_fwd_sparse" if kind == "fwd"
                      else "fused_lstm_bwd_sparse_stash")
            if kind == "fwd":
                plans = [F.lstm_fwd_sparse_plan(B, lay, (bi, un))]
            else:
                plan = F.lstm_bwd_sparse_stash_plan(B, H, lay.bs, lay.C,
                                                    (bi, un))
                plans = [plan] + ([F.lstm_bwd_sparse_stash_plan(
                    B, H, lay.bs, lay.C, (bi, un), entry_slabs=True)]
                    if plan.slabs == 1 else [])
            for plan in plans:
                tag = "%s %s, %d slab%s" % (kind, block, plan.slabs,
                                            "s" if plan.slabs > 1 else "")
                if not co_resident(kernel, plan):
                    out[tag] = "not co-resident"
                    continue
                variant = {"qbits": 16, "act": "tanh", "Kb": lay.Kb,
                           "R": lay.R, "C": lay.C, "w3g": "f32",
                           "route": "persist", "block": block,
                           "slabs": plan.slabs}

                def check(name, err_rel, tol, by_rel):
                    record_check(checks, "sparse_kernels", kernel + name,
                                 where, variant, err_rel, tol, by_rel)
                with torch.no_grad():
                    fargs = (g, w3g, dbh, lay, "tanh", 16, False, True)
                    st = F._fwd_sparse_step(*fargs)
                    if kind == "fwd":
                        got = F._fwd_sparse_persist(plan, *fargs)
                        check("/block", rel_err(
                            got, F.fused_lstm_fwd_sparse_plain(*fargs)),
                            TOL_Q16, False)
                        check("/block_vs_step", bits_apart(got, st), 0.0,
                              False)
                    else:
                        hs, cs, acts = st
                        c_prev = shifted(hs, cs, None, None)[1]
                        bargs = (acts, w3g, dbh, cs, c_prev, dhs, lay,
                                 "tanh", False)
                        dg = F._bwd_sparse_stash_persist(plan, *bargs)
                        check("/block", rel_err(
                            dg, F.fused_lstm_bwd_sparse_stash_plain(*bargs)),
                            TOL_Q16, True)
                        check("/block_vs_step", bits_apart(
                            dg, F._bwd_sparse_step(
                                F.fused_lstm_bwd_sparse_stash, acts, w3g,
                                dbh, None, cs, c_prev, dhs, lay, "tanh", 0,
                                False, True)), 0.0, False)
                out[tag] = "checked"
    return out


def cgs_train_setup(compute_dtype=""):
    """The CGS-16x train step (chunk_setup): the cfg's sections
    (cgs_sections), 16 sentences of 300 frames, fMLLR-shaped x of width
    143, cd labels then mono labels in [0, 48)."""
    T, B, _ = SP_TRAIN_TBH
    return chunk_setup(cgs_sections(compute_dtype), T, B, "fmllr", FEAT,
                       CD_LABELS + [("lab_mono", "ali-to-phones", N_MONO)])


def cgs_train_runner(dev, compute_dtype=""):
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = cgs_train_setup(compute_dtype)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    if sorted(graph.nets["LSTM_layers"]._rec_layouts) != [0, 1]:
        raise AssertionError("the CGS-16x recurrences have no sparse layout")
    return ChunkRunner(graph, config), batch


def phase_sparse_train(dev):
    """The CGS-16x train step (phase_train): launches a step in both
    backward modes, each sparse kernel's layer call on its route
    (lstm_sparse_layer_launches: one launch a call on the persistent
    routes), the recompute BPTT T a call, card vs CPU, loss falling."""
    T, B, _ = SP_TRAIN_TBH
    n = lstm_sparse_layer_launches(dev, T, B, True)
    fwd = 2 * n["fused_lstm_fwd_sparse"]
    return phase_train(dev, cgs_train_runner, "sparse_train", lstm_modes(
        T, expected(fused_lstm_fwd_sparse=fwd,
                    fused_lstm_bwd_sparse_stash=2 * n[
                        "fused_lstm_bwd_sparse_stash"],
                    block_sparse_dw=2),
        expected(fused_lstm_fwd_sparse=fwd, fused_lstm_bwd_sparse=2 * T,
                 block_sparse_dw=2)))


def cgs_expect_serve(T):
    """Launches per recognize of the CGS-16x stack: its 2 layers' sparse
    forward at 8 rows, each its route's (lstm_sparse_layer_launches), no
    other kernel."""
    return expected(fused_lstm_fwd_sparse=2 * lstm_sparse_layer_launches(
        "cuda", T, N_UTT, False)["fused_lstm_fwd_sparse"])


#: the CGS-16x cfg as shipped: lstm_block_sparse = False (:119) and its
#: batch_size_train = 8 (:93); its 2x1024 LSTM runs the dense kernels
CS_TRAIN_TBH = (300, 8, 1024)


def cgs_shipped_train_runner(dev, compute_dtype=""):
    """The CGS-16x train step as the cfg ships (cgs_sections(shipped)): 8
    sentences of 300 frames, both recurrences on the dense kernels."""
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    T, B, _ = CS_TRAIN_TBH
    config, chunk, batch = chunk_setup(
        cgs_sections(compute_dtype, shipped=True), T, B, "fmllr", FEAT,
        CD_LABELS + [("lab_mono", "ali-to-phones", N_MONO)])
    graph = NetGraph(config, chunk, seed=0, device=dev)
    if graph.nets["LSTM_layers"]._rec_layouts:
        raise AssertionError("the shipped CGS-16x cfg took a sparse layout")
    return ChunkRunner(graph, config), batch


def phase_cgs_shipped_train(dev):
    """The shipped CGS-16x train step (dense rows 1 and 3 at 2x1024, 8
    rows): launches a step on the routes the plans name, card vs CPU,
    loss falling over 10 steps in f32 and bf16."""
    T, B, H = CS_TRAIN_TBH
    return phase_train(dev, cgs_shipped_train_runner, "cgs_shipped_train",
                       lstm_modes(T, dev=dev, B=B, H=H))


def phase_cgs_shipped_times(dev):
    """Rows 1 (with the stash) and 3 at the shipped CGS-16x shape (2x1024,
    8 rows) per layer call in f32 and bf16, with bounds and cuDNN's
    nn.LSTM(1024) forward and backward beside them; the shipped train
    step (train_step_times: f32 and bf16, device ms by class of
    kernel)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    T, B, H = CS_TRAIN_TBH
    g, U, drop, _, _ = lstm_inputs(T, B, H, 95, dev, drop_bh=True)
    dhs = torch.randn(T, B, H, device=dev) * 0.01
    times = {"shape": {"T": T, "B": B, "H": H},
             "fwd_route": chain_route(dev, "fused_lstm_fwd", B, H),
             "bwd_route": chain_route(dev, "fused_lstm_bwd_stash", B, H)}
    with torch.no_grad():
        for bf16 in (False, True):
            sfx = "_bf16" if bf16 else ""
            hs, cs, acts = F.fused_lstm_fwd(g, U, drop, bf16=bf16, stash=True)
            c_prev = shifted(hs, cs, None, None)[1]
            times["fwd_ms" + sfx] = cuda_ms(lambda: F.fused_lstm_fwd(
                g, U, drop, bf16=bf16, stash=True), reps=10)
            times["bwd_stash_ms" + sfx] = cuda_ms(
                lambda: F.fused_lstm_bwd_stash(acts, U, drop, cs, c_prev, dhs,
                                               bf16=bf16), reps=10)
            for kind, key in (("fwd_stash", "fwd"), ("bwd_stash",
                                                     "bwd_stash")):
                bound = lstm_bound_ms(T, B, H, "bf16" if bf16 else "f32", kind)
                times[key + "_bound_ms" + sfx] = bound[0]
                times[key + "_bound_by" + sfx] = bound[1]
    times.update(cudnn_times(dev, T, B, H, T, B, torch.nn.LSTM(H, H),
                             "cudnn_lstm1024"))
    print("[cgs_shipped_times] %s" % json.dumps(times))
    step = train_step_times(dev, cgs_shipped_train_runner,
                            "cgs_shipped_times", 5, 3)
    return times, step


def phase_sparse_times(dev, rec, audio, lens):
    """CUDA-event times of the sparse kernels per layer call at the
    training shape (the forward also at the serving shape), in f32 and
    with w3g in bf16; their twins, bounds and yardsticks (cuDNN's dense
    nn.LSTM(1024, 1024); torch.bmm over the pre-gathered dw operands);
    rows 4 and 5's routes and plans (chain_route), us a step and each
    block shape of their tables (lstm_sparse_block_shapes); the dense
    fused kernels on the same layer (the masked U, H=1024); the CGS-16x
    train step and recognize."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    T, B, H = SP_TRAIN_TBH
    inp = sparse_inputs(T, B, H, 97, dev)
    g, U, w3g, drop, dhs, layout = (inp[n] for n in (
        "g", "U", "w3g", "drop", "dhs", "layout"))
    kept = layout.R * layout.bs
    times = {}
    with torch.no_grad():
        for bf16 in (False, True):
            sfx = "_bf16" if bf16 else ""
            dt = "bf16" if bf16 else "f32"
            hs, cs, acts = F.fused_lstm_fwd_sparse(g, w3g, drop, layout,
                                                   bf16=bf16, stash=True)
            h_prev, c_prev = shifted(hs, cs, None, None)
            calls = {
                "fused_lstm_fwd_sparse": (
                    lambda: F.fused_lstm_fwd_sparse(
                        g, w3g, drop, layout, bf16=bf16, stash=True),
                    lambda: F.fused_lstm_fwd_sparse_plain(
                        g, w3g, drop, layout, "tanh", 0, bf16, True),
                    "fwd_stash"),
                "fused_lstm_bwd_sparse_stash": (
                    lambda: F.fused_lstm_bwd_sparse_stash(
                        acts, w3g, drop, cs, c_prev, dhs, layout, bf16=bf16),
                    lambda: F.fused_lstm_bwd_sparse_stash_plain(
                        acts, w3g, drop, cs, c_prev, dhs, layout, "tanh",
                        bf16), "bwd_stash"),
                "fused_lstm_bwd_sparse": (
                    lambda: F.fused_lstm_bwd_sparse(
                        g, w3g, drop, h_prev, c_prev, dhs, layout, bf16=bf16),
                    lambda: F.fused_lstm_bwd_sparse_plain(
                        g, w3g, drop, h_prev, c_prev, dhs, layout, "tanh", 0,
                        bf16), "bwd")}
            for name, (fn, plain, kind) in calls.items():
                times[name + "_ms" + sfx] = cuda_ms(fn, reps=10)
                times[name + "_plain_ms" + sfx] = cuda_ms(plain, reps=2,
                                                          warmup=1)
                bound, by = lstm_bound_ms(T, B, H, dt, kind, kept)
                times[name + "_bound_ms" + sfx] = bound
                times[name + "_bound_by" + sfx] = by
            # the dense fused kernels on the same layer: the masked U
            dense = {
                "fused_lstm_fwd": lambda: F.fused_lstm_fwd(
                    g, U, drop, bf16=bf16, stash=True),
                "fused_lstm_bwd_stash": lambda: F.fused_lstm_bwd_stash(
                    acts, U, drop, cs, c_prev, dhs, bf16=bf16),
                "fused_lstm_bwd": lambda: F.fused_lstm_bwd(
                    g, U, drop, h_prev, c_prev, dhs, bf16=bf16)}
            for name, fn in dense.items():
                times["dense_" + name + "_ms" + sfx] = cuda_ms(fn, reps=10)
        # rows 4 and 5's routes, plans, us a step and block shapes
        for name in ("fused_lstm_fwd_sparse", "fused_lstm_bwd_sparse_stash"):
            times[name + "_kernel_route"] = chain_route(dev, name, B,
                                                        layout=layout)[1]
            times[name + "_us_per_step"] = 1e3 * times[name + "_ms"] / T
        times.update(lstm_sparse_block_shapes(g, w3g, drop, dhs, layout,
                                              "tanh", 0))
        # the serving forward (no stash) at the serving shape
        Ts, Bs, _ = SP_SERVE_TBH
        sv = sparse_inputs(Ts, Bs, H, 96, dev)
        times["serve_fwd_sparse_kernel_route"] = chain_route(
            dev, "fused_lstm_fwd_sparse", Bs, layout=sv["layout"])[1]
        for bf16 in (False, True):
            sfx = "_bf16" if bf16 else ""
            times["serve_fwd_sparse_ms" + sfx] = cuda_ms(
                lambda: F.fused_lstm_fwd_sparse(sv["g"], sv["w3g"], sv["drop"],
                                                sv["layout"], bf16=bf16),
                reps=10)
            times["serve_dense_fwd_ms" + sfx] = cuda_ms(
                lambda: F.fused_lstm_fwd(sv["g"], sv["U"], sv["drop"],
                                         bf16=bf16), reps=10)
        times["serve_fwd_sparse_us_per_step"] = \
            1e3 * times["serve_fwd_sparse_ms"] / Ts
        times["serve_fwd_sparse_plain_ms"] = cuda_ms(
            lambda: F.fused_lstm_fwd_sparse_plain(
                sv["g"], sv["w3g"], sv["drop"], sv["layout"], "tanh", 0,
                False), reps=2, warmup=1)
        times["serve_fwd_sparse_bound_ms"], times["serve_fwd_sparse_bound_by"] \
            = lstm_bound_ms(Ts, Bs, H, "f32", "fwd", kept)
        # the block-sparse dw over (T*B) at the training shape
        hs, cs, acts = F.fused_lstm_fwd_sparse(g, w3g, drop, layout,
                                               stash=True)
        h_prev, c_prev = shifted(hs, cs, None, None)
        dg_flat, x = dw_operands(F.fused_lstm_bwd_sparse_stash(
            acts, w3g, drop, cs, c_prev, dhs, layout), h_prev, layout)
        sub3 = inp["sub3"]
        times["block_sparse_dw_ms"] = cuda_ms(
            lambda: BS.block_sparse_dw(dg_flat, x, layout, 4), reps=20)
        times["block_sparse_dw_ms_fuse_sub"] = cuda_ms(
            lambda: BS.block_sparse_dw(dg_flat, x, layout, 4, sub3), reps=20)
        times["block_sparse_dw_plain_ms"] = cuda_ms(
            lambda: BS.block_sparse_dw_plain(dg_flat, x, layout, 4), reps=5)
        M = T * B
        dgb = dg_flat.reshape(M, layout.Nb, 4 * layout.bs).permute(1, 2, 0) \
            .contiguous()
        xg = BS.gather_cols(x, layout).contiguous()
        times["block_sparse_dw_library_ms"] = cuda_ms(
            lambda: torch.bmm(dgb, xg), reps=20)
        times["block_sparse_dw_bound_ms"], times["block_sparse_dw_bound_by"] \
            = roofline_ms((dg_flat.numel() + x.numel()
                           + layout.Nb * 4 * layout.bs * kept) * 4,
                          2 * M * 4 * layout.bs * kept * layout.Nb)
    # cuDNN's dense nn.LSTM at the same widths: a yardstick, not the
    # same function (dense, no quantizer, no dropout mask)
    cudnn = torch.nn.LSTM(H, H).to(dev)
    xin = torch.randn(T, B, H, device=dev, requires_grad=True)
    dy = torch.randn(T, B, H, device=dev)
    fwd_ms = cuda_ms(lambda: cudnn(xin)[0], reps=10)
    fb_ms = cuda_ms(lambda: cudnn(xin)[0].backward(dy), reps=10)
    with torch.no_grad():
        xs = torch.randn(Ts, Bs, H, device=dev)
        times["cudnn_serve_fwd_ms"] = cuda_ms(lambda: cudnn(xs), reps=10)
    times.update(cudnn_fwd_ms=fwd_ms, cudnn_fwd_bwd_ms=fb_ms,
                 cudnn_bwd_ms=fb_ms - fwd_ms)
    print("[sparse_times] kernels at T=%d B=%d H=%d (Kb=%d, R=%d): %s"
          % (T, B, H, layout.Kb, layout.R, json.dumps(times)))
    step = train_step_times(dev, cgs_train_runner, "sparse_times", 5, 3)
    serve = serve_timings(rec, audio, lens)
    print("[sparse_times] CGS-16x recognizer (8 x 4 s batch): %s"
          % json.dumps(serve))
    return times, step, serve


# ---------------------------------------------------------------------------
# the Li-GRU slice: the dense fused liGRU recurrence
# ---------------------------------------------------------------------------

def cfg_sections(path, compute_dtype="", lr_scale=1.0):
    """A shipped cfg's [architecture1..2] (a recurrent net and its cd
    head) and [model], read from the file, with the port's arch_library,
    N_out_lab_cd = 1944 (the PhoneLoopHMM(648, 3) decode of every stack)
    and both nets' learning rates times ``lr_scale``."""
    import configparser
    src = configparser.ConfigParser()
    if not src.read(path):
        raise FileNotFoundError(path)
    secs = {k: dict(src[k]) for k in ("architecture1", "architecture2",
                                      "model")}
    for k in ("architecture1", "architecture2"):
        secs[k]["arch_library"] = "pytorch_kaldi_cgs_tpu_torch.models"
        secs[k]["compute_dtype"] = compute_dtype
        if lr_scale != 1.0:
            secs[k]["arch_lr"] = repr(float(secs[k]["arch_lr"]) * lr_scale)
    secs["architecture2"]["dnn_lay"] = secs["architecture2"]["dnn_lay"] \
        .replace("N_out_lab_cd", str(PHONES * SPP))
    return secs


def ligru_sections(compute_dtype="", quant_inp=True, lr_scale=1.0):
    """The TIMIT Li-GRU cfg's sections (cfg_sections);
    ``quant_inp=False`` turns the liGRU's 16-bit input quantizers off,
    ``lr_scale`` scales both nets' learning rates."""
    secs = cfg_sections(LIGRU_CFG, compute_dtype, lr_scale)
    if not quant_inp:
        secs["architecture1"]["ligru_quant_inp"] = "False"
    return secs


def build_ligru_stack(dev, feat_dim=LG_FEAT, quant_inp=True):
    """The TIMIT Li-GRU -> its 1944-way cd head (weights from init(0) /
    init(1)); both recurrences must take the dense fused path.
    ``quant_inp=False`` turns the liGRU's 16-bit input quantizers off."""
    from pytorch_kaldi_cgs_tpu_torch.models import MLP, liGRU
    secs = ligru_sections(quant_inp=quant_inp)
    rnn = liGRU(dict(secs["architecture1"], to_do="forward"), feat_dim,
                seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
              seed=1, device=dev)
    if rnn._rec_layouts:
        raise AssertionError("the TIMIT Li-GRU recurrence has a sparse layout")
    with torch.no_grad():
        mlp.params["w0"].mul_(LIGRU_HEAD_GAIN)
    return Stack(rnn, mlp).eval()


def gated_inputs(T, B, H, seed, dev, act, gates=2):
    """Gates (T, B, gates*H), the candidate's first ([h | z] for the
    liGRU, [h | z | r] for the GRU), U (gates*H, H), a (B, H) dropout
    mask, h0 and upstream cotangents. For relu the candidate's gate
    inputs sit at +-(4 + |N(0, 0.5)|) and U at 0.2/sqrt(H), so the
    recurrent term (std ~0.5) never brings a pre-activation within reach
    of the ulp-level difference between the kernel's and the twin's sums,
    where relu's derivative would flip between 0 and 1 (both branches
    still run)."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    g = rng.randn(T, B, gates * H) * 0.5
    u_scale = 1.0
    if act == "relu":
        sign = np.where(rng.rand(1, B, H) > 0.5, 1.0, -1.0)
        g[..., :H] = sign * (4.0 + np.abs(g[..., :H]))
        u_scale = 0.2
    U = rng.randn(gates * H, H) * u_scale / np.sqrt(H)
    return {"g": t(g), "U": t(U), "drop": t((rng.rand(B, H) > 0.2) * 1.0),
            "h0": t(rng.randn(B, H) * 0.3), "dhs": t(rng.randn(T, B, H) * 0.1)}


def phase_ligru_kernels(dev):
    """The liGRU forward (plain, stash and seeded) and both BPTT kernels
    against their twins on the same tensors: qbits 0/16 x relu/tanh, at
    the small ragged shape, H=550, the serving shape (forward only) and
    the training shape; the recompute BPTT also at the libri Li-GRU's
    training shape (qbits 0) and on its step route (LG_STEP_TBH), each
    on its route with its launches, two calls bit for bit and its device
    kernels (ligru_bwd_check). The forward runs on the route its plan
    names (ligru_fwd_launches: persistent at all but LG_STEP_TBH, whose
    256 blocks are not co-resident), two calls bit for bit, its device
    kernels held to the route's (ligru_fwd_design) once a shape; at every
    shape but LG_STEP_TBH the step route also runs forced
    (fused_rnn._ligru_fwd_step), and both routes give equal bits."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    checks = []
    fwd = R.fused_ligru_fwd

    def check(name, shape, variant, err_rel, tol, by_rel):
        record_check(checks, "ligru_kernels", name, dict(zip("TBH", shape)), variant,
                     err_rel, tol, by_rel)

    def fwd_checks(shape, variant, g, U, drop, h0, act, qbits, tol_q, kernels,
                   forced):
        """The forward's checks at ``shape`` on its route: plain and
        seeded against the twin with their launches, two calls bit for
        bit; ``kernels``: its device kernels; ``forced``: the step route
        forced, against the twin and bit for bit the persistent one's.
        -> the stash forward's (hs, acts) and the twin's."""
        T, B, H = shape
        route, n = ligru_fwd_launches(dev, T, B, H)
        fvar = dict(variant, route=route)
        ref = R.fused_ligru_fwd_plain(g, U, drop, None, act, qbits, True)
        ref_seed = R.fused_ligru_fwd_plain(g, U, drop, h0, act, qbits)
        check("fused_ligru_fwd", shape, fvar, rel_err(launched(
            fwd, n, lambda: fwd(g, U, drop, act=act, qbits=qbits)), ref[0]),
            tol_q, False)
        check("fused_ligru_fwd/seeded", shape, fvar, rel_err(launched(
            fwd, n, lambda: fwd(g, U, drop, h0, act=act, qbits=qbits)),
            ref_seed), tol_q, False)
        check("fused_ligru_fwd/determinism", shape, fvar, same_bits(
            lambda: fwd(g, U, drop, h0, act=act, qbits=qbits, stash=True)),
            0.0, False)
        if kernels:
            bptt_kernels(lambda: fwd(g, U, drop, h0, act=act, qbits=qbits),
                         ligru_fwd_design(route, T, True, qbits))
        stash = launched(fwd, n, lambda: fwd(g, U, drop, act=act,
                                             qbits=qbits, stash=True))
        if forced:
            svar = dict(variant, route="step")
            st = launched(fwd, T, lambda: R._ligru_fwd_step(
                g, U, drop, None, act, qbits, True))
            check("fused_ligru_fwd/step_route/stash", shape, svar,
                  rel_err(st, ref), tol_q, False)
            # both routes sum in one order: the same bits
            check("fused_ligru_fwd/persist_vs_step", shape, fvar,
                  bits_apart(stash, st), 0.0, False)
            check("fused_ligru_fwd/step_route/seeded", shape, svar, rel_err(
                launched(fwd, T, lambda: R._ligru_fwd_step(
                    g, U, drop, h0, act, qbits, False)), ref_seed), tol_q,
                False)
        return stash, ref

    for shape in (SMALL_TBH, LG_MID_TBH, LG_SERVE_TBH, LG_TRAIN_TBH):
        T, B, H = shape
        small, serve = shape == SMALL_TBH, shape == LG_SERVE_TBH
        cases = [(q, a) for q in (0, 16) for a in ("relu", "tanh")]
        for k, (qbits, act) in enumerate(cases):
            inp = gated_inputs(T, B, H, 80 + k, dev, act)
            g, U, drop, h0, dhs = (inp[n] for n in ("g", "U", "drop", "h0",
                                                    "dhs"))
            variant = {"qbits": qbits, "act": act}
            tol = TOL_F32_SMALL if small else TOL_F32_SERVE
            tol_q = TOL_Q16 if qbits else tol
            with torch.no_grad():
                (hs, acts), ref = fwd_checks(
                    shape, variant, g, U, drop, h0, act, qbits, tol_q,
                    k + 1 == len(cases), True)
                if serve:
                    continue
                check("fused_ligru_fwd/stash", shape, dict(
                    variant, route=ligru_fwd_launches(dev, T, B, H)[0]),
                    rel_err((hs, acts), ref), tol_q, False)
                h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                check("fused_ligru_bwd_stash", shape, variant, rel_err(
                    R.fused_ligru_bwd_stash(acts, U, drop, h_prev, dhs, act),
                    R.fused_ligru_bwd_stash_plain(acts, U, drop, h_prev, dhs,
                                                  act)), tol, True)
                ligru_bwd_check(check, dev, shape, variant, g, U, drop,
                                h_prev, dhs, act, qbits, tol_q)
    # the libri Li-GRU's training shape (the forward's 8 x 32 blocks; the
    # recompute BPTT's chain stages in slabs) and a batch whose blocks are
    # not co-resident (both kernels' step routes)
    for shape, qbits, acts_ in ((LL_TRAIN_TBH, 0, ("relu", "tanh")),
                                (LG_STEP_TBH, 16, ("relu",))):
        T, B, H = shape
        for k, act in enumerate(acts_):
            inp = gated_inputs(T, B, H, 90 + k, dev, act)
            g, U, drop, h0, dhs = (inp[n] for n in ("g", "U", "drop", "h0",
                                                    "dhs"))
            variant = {"qbits": qbits, "act": act}
            tol_q = TOL_Q16 if qbits else TOL_F32_SERVE
            with torch.no_grad():
                hs = fwd_checks(shape, variant, g, U, drop, h0, act, qbits,
                                tol_q, k == 0, shape == LL_TRAIN_TBH)[0][0]
                h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                ligru_bwd_check(check, dev, shape, variant, g, U, drop,
                                h_prev, dhs, act, qbits, tol_q)
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a liGRU kernel disagrees with its plain twin: "
                             "%s" % bad)
    bwd = [c for c in checks if c["kernel"] == "fused_ligru_bwd"]
    if not any(c.get("route") == "step" for c in bwd) or not any(
            c.get("route") == "persist" and c["B"] == LL_TRAIN_TBH[1]
            for c in bwd):
        raise AssertionError("ligru_kernels: the recompute BPTT's routes "
                             "were not both checked")
    check_fwd_routes(checks, "fused_ligru_fwd", {
        (shape, route) for shape in (SMALL_TBH, LG_MID_TBH, LG_SERVE_TBH,
                                     LG_TRAIN_TBH, LL_TRAIN_TBH)
        for route in ("persist", "step")} | {(LG_STEP_TBH, "step")})
    return checks


def ligru_bwd_check(check, dev, shape, variant, g, U, drop, h_prev, dhs,
                    act, qbits, tol):
    """fused_ligru_bwd against its twin on the route its plan picks: the
    launches a call (the smoke's own table), two calls bit for bit, and
    one call's device kernels held to the route's design by name."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = shape
    route, n = ligru_bwd_launches(dev, T, B, H, qbits)
    variant = dict(variant, route=route)
    args = (g, U, drop, h_prev, dhs, act, qbits)
    got = launched(R.fused_ligru_bwd, n, lambda: R.fused_ligru_bwd(*args))
    check("fused_ligru_bwd", shape, variant,
          rel_err(got, R.fused_ligru_bwd_plain(*args)), tol, True)
    check("fused_ligru_bwd/determinism", shape, variant,
          same_bits(lambda: R.fused_ligru_bwd(*args)), 0.0, False)
    bptt_kernels(lambda: R.fused_ligru_bwd(*args),
                 ligru_bwd_design(route, T, qbits))


def phase_ligru_stream(dev, rec, audio, lens, phones, logp, chunk=100,
                       stack_fn=build_ligru_stack, tag="ligru_stream",
                       one_chunk_tol=TOL_STREAM, kernel="fused_ligru_fwd",
                       per_frame=2, count=None):
    """A Li-GRU (``stack_fn``'s; or a minimalGRU: ``kernel``, launched
    ``per_frame`` times a frame, or ``count(T, chunk)`` times a stream;
    the liGRU's by default its route's, ligru_stream_count) streams on
    the seeded forward. One chunk
    of the whole utterance is held to the whole-utterance posteriors
    within ``one_chunk_tol``. Chunks of 100 frames are held within
    TOL_POST_Q16 (as ligru_serve) to the same chunks streamed on the CPU
    (same phones), not to the whole utterance: the cfg's
    ligru_quant_inp=True scales each call's x (and layer 1's input) by
    its own max|x|, which at the head's x3000 logits moves the
    posteriors by ~1e-2 in both packages; that difference is printed."""
    T = rec.frontend.num_frames(audio.shape[1])
    if count is None and kernel == "fused_ligru_fwd":
        count = ligru_stream_count(dev)
    _, err_one = phase_stream(dev, rec, audio, lens, phones, logp, chunk=T,
                              tag=tag + "_one_chunk", tol=one_chunk_tol,
                              kernel=kernel, per_frame=per_frame,
                              count=count)
    streamed, final, launches = stream_run(dev, rec, audio, lens, chunk)
    want = count(T, chunk) if count else per_frame * T
    if launches != expected(**{kernel: want}):
        raise AssertionError("%s: launches %s, expected the seeded forward "
                             "%d times" % (tag, launches, want))
    ref, final_ref, _ = stream_run("cpu", build_recognizer(
        "cpu", stack_fn), audio, lens, chunk)
    err = float(np.abs(streamed - ref).max())
    vs_whole = float(np.abs(streamed - logp.cpu().numpy()).max())
    print("[%s] %d chunks of <=%d frames: launches %d; card vs CPU stream "
          "max abs err %.3g (tol %g), phones equal: %s; chunked vs whole "
          "utterance %.3g; finalize == recognize: %s"
          % (tag, -(-T // chunk), chunk, launches[kernel], err,
             TOL_POST_Q16, final == final_ref, vs_whole, final == phones))
    if not err <= TOL_POST_Q16 or final != final_ref:
        raise AssertionError("%s disagrees with the CPU stream" % tag)
    return launches[kernel], {
        "one_chunk_vs_whole": err_one, "chunked_card_vs_cpu": err,
        "chunked_vs_whole": vs_whole,
        "chunked_phones_equal_whole": final == phones}


def ligru_expect_serve(T):
    """Launches per recognize: 2 layers of the dense liGRU forward at 8
    rows, each its route's (ligru_fwd_launches: 1 a call on the
    persistent route, T on the step route), no other kernel."""
    return expected(fused_ligru_fwd=2 * ligru_fwd_launches(
        "cuda", T, N_UTT, LG_TRAIN_TBH[2])[1])


def ligru_stream_count(dev, layers=2, B=N_UTT, H=LG_TRAIN_TBH[2]):
    """``count(T, chunk)`` of a Li-GRU stream on the dense seeded forward:
    ligru_fwd_stream_launches over ``layers`` layers."""
    return lambda T, c: ligru_fwd_stream_launches(dev, T, c, B, H, layers)


def ligru_train_setup(compute_dtype="", quant_inp=True, lr_scale=1.0):
    """The TIMIT Li-GRU train step (chunk_setup): the cfg's sections
    (ligru_sections), 8 sentences of 300 frames, fMLLR x of width 40 and
    cd labels."""
    T, B, _ = LG_TRAIN_TBH
    return chunk_setup(ligru_sections(compute_dtype, quant_inp, lr_scale),
                       T, B, "fmllr", LG_FEAT, CD_LABELS)


def ligru_train_runner(dev, compute_dtype="", quant_inp=True, lr_scale=1.0):
    from pytorch_kaldi_cgs_tpu_torch.models import liGRU
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = ligru_train_setup(compute_dtype, quant_inp,
                                             lr_scale)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    rnn = graph.nets["RNN_layers"]
    if type(rnn) is not liGRU or rnn._rec_layouts:
        raise AssertionError("the Li-GRU cfg did not build a dense liGRU")
    return ChunkRunner(graph, config), batch


def ulp_sensitivity(make_runner, inp, mask, feat=LG_FEAT):
    """How far the CPU reference's own gradients move when x changes by
    one ulp (each of the ``feat`` features times 1 +- 2^-23, random
    signs): the worst gradient's max abs change over its scale, and
    where."""
    ref, _ = make_runner("cpu")
    ref.train_step(inp, mask, dropout_gen())
    moved, _ = make_runner("cpu")
    x = inp.copy()
    sign = np.random.RandomState(1).choice([-1.0, 1.0], x[..., :feat].shape)
    x[..., :feat] *= (1.0 + sign * 2.0 ** -23).astype(np.float32)
    moved.train_step(x, mask, dropout_gen())
    errs = grad_rel_errs(moved, ref)
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def phase_ligru_train(dev):
    """The default backward (recompute) is compared with the CPU, held to
    GRAD_FLIP_K times the CPU's own one-ulp sensitivity; the same step
    without the 16-bit quantizers to TOL_GRAD_REL; the stash backward
    runs under PKC_BWD_STASH_CELLS=ligru. The forward's and the recompute
    BPTT's launches a layer call are their routes' (ligru_fwd_launches,
    ligru_bwd_launches, the cfg's 16-bit quantizer)."""
    T = LG_TRAIN_TBH[0]
    knob = "PKC_BWD_STASH_CELLS"
    inp, mask = ligru_train_setup()[2]
    sens, where = ulp_sensitivity(ligru_train_runner, inp, mask)
    grad_tol = max(TOL_GRAD_REL, GRAD_FLIP_K * sens)
    print("[ligru_train] the CPU's own gradients under a one-ulp change of "
          "x: worst rel change %.3g at %s; card vs CPU bar %.3g"
          % (sens, where, grad_tol))
    route, n_bwd = ligru_bwd_launches(dev, T, LG_TRAIN_TBH[1],
                                      LG_TRAIN_TBH[2], 16)
    f_route, n_fwd = ligru_fwd_launches(dev, *LG_TRAIN_TBH)
    print("[ligru_train] forward: route %s, %d launches a layer call; "
          "recompute BPTT: route %s, %d launches a layer call"
          % (f_route, n_fwd, route, n_bwd))
    out = phase_train(dev, ligru_train_runner, "ligru_train", (
        ("recompute", knob, None,
         expected(fused_ligru_fwd=2 * n_fwd, fused_ligru_bwd=2 * n_bwd)),
        ("stash", knob, "ligru",
         expected(fused_ligru_fwd=2 * n_fwd, fused_ligru_bwd_stash=2 * T))),
        grad_tol=grad_tol, fall_runner=lambda d, cdt="":
        ligru_train_runner(d, cdt, lr_scale=LG_FALL_LR_SCALE))
    out.update(cpu_ulp_grad_rel_change=sens, cpu_ulp_worst=where)
    runner, (inp, mask) = ligru_train_runner(dev)
    cfg_lr = [float(runner.train_step(inp, mask)[0])
              for _ in range(LG_CFG_LR_STEPS)]
    out["losses_f32_cfg_lr"] = [v if np.isfinite(v) else str(v)
                                for v in cfg_lr]
    print("[ligru_train] f32 at the cfg's learning rates: loss %s"
          % ["%.4f" % v for v in cfg_lr])

    def no_quant(d, cdt=""):
        return ligru_train_runner(d, cdt, quant_inp=False)
    runner, (inp, mask) = no_quant(dev)
    with env(knob, None):
        loss_err = runner.train_step(inp, mask, dropout_gen())
    out["no_quant_inp"] = card_vs_cpu(
        runner, no_quant("cpu")[0], inp, mask, loss_err, knob, None,
        "ligru_train, ligru_quant_inp=False")
    return out


def ligru_bound_ms(T, B, H, kind, kept=None):
    """Least time for one liGRU layer call in float32: each input read
    once, each output written once, over the HBM rate; the FMAs over
    the float32 peak. kind: "fwd" (gates, U, drop in; hs out),
    "fwd_stash" (and the (T, B, 2H) stash out), "bwd_stash" (stash, U,
    drop, h_prev, dhs in; dg out; one (B, 2H) x (2H, H) product per
    step), "bwd" (gates instead of the stash; that product and the
    forward's), "bwd_s" (as "bwd", and s (T, B, H) out: the sparse
    minimalGRU's BPTT). ``kept``: the block-sparse recurrence's R*bs kept
    columns per row of U (w3g is (2H, kept) in all), None for the dense
    U. The minimalGRU has the liGRU's shapes and products. -> (ms,
    "bytes"|"operations")."""
    kept = H if kept is None else kept
    gates, seq, bh = T * B * 2 * H * 4, T * B * H * 4, B * H * 4
    nbytes = {"fwd": gates + bh + seq, "fwd_stash": 2 * gates + bh + seq,
              "bwd_stash": 2 * gates + bh + 2 * seq,
              "bwd": 2 * gates + bh + 2 * seq,
              "bwd_s": 2 * gates + bh + 3 * seq}[kind] + 2 * H * kept * 4
    recompute = kind in ("bwd", "bwd_s")
    return roofline_ms(nbytes,
                       2 * T * B * 2 * H * kept * (2 if recompute else 1))


def cudnn_times(dev, T, B, H, Ts, Bs, module=None, key="cudnn_gru"):
    """cuDNN's nn.GRU(H, H) (or ``module``, an (H, H) cuDNN recurrence),
    the yardstick: forward and forward + backward at (T, B), the backward
    as their difference, and the forward at the serving (Ts, Bs), under
    ``<key>_*`` keys."""
    gru = (module or torch.nn.GRU(H, H)).to(dev)
    xin = torch.randn(T, B, H, device=dev, requires_grad=True)
    dy = torch.randn(T, B, H, device=dev)
    fwd_ms = cuda_ms(lambda: gru(xin)[0], reps=10)
    fb_ms = cuda_ms(lambda: gru(xin)[0].backward(dy), reps=10)
    with torch.no_grad():
        xs = torch.randn(Ts, Bs, H, device=dev)
        serve_ms = cuda_ms(lambda: gru(xs), reps=10)
    return {key + "_fwd_ms": fwd_ms, key + "_fwd_bwd_ms": fb_ms,
            key + "_bwd_ms": fb_ms - fwd_ms,
            key + "_serve_fwd_ms": serve_ms}


def phase_ligru_times(dev, rec, audio, lens):
    """CUDA-event times of the liGRU kernels per layer call at the
    training shape (the forward also at the serving shape), as the
    cfg's main path runs them (relu, 16-bit recurrent quantizer); their
    twins and bounds; cuDNN's nn.GRU(1024, 1024) as a yardstick (three
    gates, no quantizer: not the same function); the dU matmul; the
    Li-GRU train step and recognize."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = LG_TRAIN_TBH
    qb, act = 16, "relu"
    inp = gated_inputs(T, B, H, 95, dev, act)
    g, U, drop, dhs = (inp[n] for n in ("g", "U", "drop", "dhs"))
    times = {}
    with torch.no_grad():
        hs, acts = R.fused_ligru_fwd(g, U, drop, act=act, qbits=qb,
                                     stash=True)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        calls = {
            "fused_ligru_fwd": (
                lambda: R.fused_ligru_fwd(g, U, drop, act=act, qbits=qb,
                                          stash=True),
                lambda: R.fused_ligru_fwd_plain(g, U, drop, None, act, qb,
                                                True), "fwd_stash"),
            "fused_ligru_bwd_stash": (
                lambda: R.fused_ligru_bwd_stash(acts, U, drop, h_prev, dhs,
                                                act),
                lambda: R.fused_ligru_bwd_stash_plain(acts, U, drop, h_prev,
                                                      dhs, act), "bwd_stash"),
            "fused_ligru_bwd": (
                lambda: R.fused_ligru_bwd(g, U, drop, h_prev, dhs, act, qb),
                lambda: R.fused_ligru_bwd_plain(g, U, drop, h_prev, dhs, act,
                                                qb), "bwd")}
        for name, (fn, plain, kind) in calls.items():
            times[name + "_ms"] = cuda_ms(fn, reps=10)
            times[name + "_plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                ligru_bound_ms(T, B, H, kind)
        times["fused_ligru_bwd_plan"] = chain_route(dev, "fused_ligru_bwd",
                                                    B, H)[1]
        times["fused_ligru_fwd_plan"] = chain_route(dev, "fused_ligru_fwd",
                                                    B, H)[1]
        times["fused_ligru_bwd_split"] = bptt_split(
            calls["fused_ligru_bwd"][0], 3)
        # the forward without the stash, and both without the quantizer
        # (no per-step absmax): interleaved with a repeat of the stash one
        for q in (qb, 0):
            sfx = "_q0" if q == 0 else ""
            times["fused_ligru_fwd_nostash_ms" + sfx] = cuda_ms(
                lambda: R.fused_ligru_fwd(g, U, drop, act=act, qbits=q),
                reps=10)
            times["fused_ligru_fwd_stash_ms" + sfx] = cuda_ms(
                lambda: R.fused_ligru_fwd(g, U, drop, act=act, qbits=q,
                                          stash=True), reps=10)
        Ts, Bs, _ = LG_SERVE_TBH
        sv = gated_inputs(Ts, Bs, H, 94, dev, act)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_ligru_fwd(sv["g"], sv["U"], sv["drop"], act=act,
                                      qbits=qb), reps=10)
        times["serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_ligru_fwd_plain(sv["g"], sv["U"], sv["drop"],
                                            None, act, qb), reps=2, warmup=1)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            ligru_bound_ms(Ts, Bs, H, "fwd")
        # the dU product outside the BPTT kernel: (2H, T*B) @ (T*B, H)
        dg = torch.randn(T * B, 2 * H, device=dev)
        hq = torch.randn(T * B, H, device=dev)
        times["dU_matmul_ms"] = cuda_ms(lambda: dg.T @ hq, reps=20)
    times.update(cudnn_times(dev, T, B, H, Ts, Bs))
    print("[ligru_times] kernels at T=%d B=%d H=%d (relu, qbits 16): %s"
          % (T, B, H, json.dumps(times)))
    step = train_step_times(dev, ligru_train_runner, "ligru_times", 5, 3)
    serve = serve_timings(rec, audio, lens)
    print("[ligru_times] Li-GRU recognizer (8 x 4 s batch): %s"
          % json.dumps(serve))
    return times, step, serve


def dense_rnn_rows(checks, times, launches, cell, replaces, train_tbh,
                   serve_tbh, act, qbits, library, fwd_extra,
                   lib="cudnn_gru", bwd_extra=None, stash_extra=None):
    """The kernels JSON rows of a dense fused cell's three kernels,
    ``fused_<cell>_fwd`` (the stash variant), ``_bwd_stash`` and ``_bwd``
    from ``csrc/fused_<cell>.cu``, replacing the JAX functions defined at
    lines ``replaces`` of ops/fused_rnn.py. ``ms`` etc. are per layer call
    at ``train_tbh`` (``act``, ``qbits`` as the cfg runs them; the
    forward also at ``serve_tbh``); ``launches`` counts one train step
    (the default backward; the other one for the kernel only it runs);
    ``max_abs_err`` is the check at ``train_tbh`` with qbits 0;
    ``library_ms`` is ``library`` (a cuDNN module), a yardstick, read
    from ``times`` under ``<lib>_fwd_ms``, ``<lib>_bwd_ms`` and
    ``<lib>_serve_fwd_ms``. ``fwd_extra`` and ``stash_extra`` map more
    keys of the forward's and the stash backward's rows to ``times``;
    ``bwd_extra`` holds more keys of the recompute backward's row."""
    T, B, H = train_tbh
    note = "%s %%s: a yardstick, not the same function" % library
    bwd_note = note % "backward (fwd+bwd minus fwd)"

    def err_at(kernel):
        return [c for c in checks if c["kernel"] == kernel
                and (c["T"], c["B"], c["H"]) == train_tbh
                and c["qbits"] == 0 and c["act"] == act][0]["max_abs_err"]

    def row(name, line, library_ms, library_note, err, **extra):
        mine = [c for c in checks if c["kernel"].split("/")[0] == name]
        r = {"name": name, "route": "cuda",
             "source": "pytorch_kaldi_cgs_tpu_torch/ops/csrc/fused_%s.cu"
             % cell,
             "replaces": "pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:%d" % line,
             "launches": launches[name]["main"],
             "launches_by_path": launches[name], "max_abs_err": err,
             "ms": times[name + "_ms"], "plain_ms": times[name + "_plain_ms"],
             "bound_ms": times[name + "_bound_ms"],
             "bound_by": times[name + "_bound_by"], "library_ms": library_ms,
             "library_note": library_note,
             "shape": {"T": T, "B": B, "H": H, "act": act, "qbits": qbits},
             "checks": len(mine), "checks_ok": all(c["ok"] for c in mine)}
        r.update(extra)
        return r

    fwd, bwd_stash, bwd = ("fused_%s_%s" % (cell, k)
                           for k in ("fwd", "bwd_stash", "bwd"))
    return [
        row(fwd, replaces[0], times[lib + "_fwd_ms"], note % "forward",
            err_at(fwd + "/stash"), variant="stash (training forward)",
            serve={"T": serve_tbh[0], "B": serve_tbh[1], "H": H,
                   "ms": times["serve_fwd_ms"],
                   "plain_ms": times["serve_fwd_plain_ms"],
                   "bound_ms": times["serve_fwd_bound_ms"],
                   "bound_by": times["serve_fwd_bound_by"],
                   "library_ms": times[lib + "_serve_fwd_ms"]},
            **{k: times[v] for k, v in fwd_extra.items()}),
        row(bwd_stash, replaces[1], times[lib + "_bwd_ms"], bwd_note,
            err_at(bwd_stash),
            **{k: times[v] for k, v in (stash_extra or {}).items()}),
        row(bwd, replaces[2], times[lib + "_bwd_ms"], bwd_note,
            err_at(bwd), **(bwd_extra or {}))]


# ---------------------------------------------------------------------------
# the LibriSpeech GRU slice: the sparse GRU recurrence and the v3
# block-sparse x-projections
# ---------------------------------------------------------------------------

def gru_sections(compute_dtype="", quant_inp=True):
    """The libri GRU cfg's sections (cfg_sections; the LibriSpeech
    alignments are not in the repo, so N_out_lab_cd = 1944 as for the
    TIMIT stacks); ``quant_inp=False`` turns the GRU's 16-bit input
    quantizers off."""
    secs = cfg_sections(GRU_CFG, compute_dtype)
    if not quant_inp:
        secs["architecture1"]["gru_quant_inp"] = "False"
    return secs


def check_gru_layouts(rnn):
    """The libri GRU as the JAX package's rules place it: every
    recurrence sparse, layers 1-4's x-projections on v3."""
    if sorted(rnn._rec_layouts) != list(range(GR_LAYERS)) or \
            sorted(rnn._bs_layouts) != list(range(1, GR_LAYERS)):
        raise AssertionError("the libri GRU's layouts: recurrences %s, v3 %s"
                             % (sorted(rnn._rec_layouts),
                                sorted(rnn._bs_layouts)))


def build_gru_stack(dev, feat_dim=GR_FEAT, quant_inp=True):
    """The libri GRU -> its 1944-way cd head (weights from init(0) /
    init(1), the head times GRU_HEAD_GAIN)."""
    from pytorch_kaldi_cgs_tpu_torch.models import GRU, MLP
    secs = gru_sections(quant_inp=quant_inp)
    rnn = GRU(dict(secs["architecture1"], to_do="forward"), feat_dim,
              seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
              seed=1, device=dev)
    check_gru_layouts(rnn)
    with torch.no_grad():
        mlp.params["w0"].mul_(GRU_HEAD_GAIN)
    return Stack(rnn, mlp).eval()


def gru_layout(N, K, seed, pad_k=False):
    """An HCGS mask of the libri cfg (128,4 at 75,50), its layout."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask
    mask = hcgs_mask(N, K, [128, 4], [75, 50],
                     rng=np.random.RandomState(seed))
    return mask, BS.pack_layout(mask, 128, pad_k=pad_k)


def gru_inputs(T, B, H, seed, dev):
    """Gates (T, B, 3H) [h | z | r], w3g (Nb, 3bs, R*bs) on the libri
    recurrent layout, a (B, H) dropout mask, upstream cotangents."""
    _, layout = gru_layout(H, H, seed)
    rng = np.random.RandomState(seed + 1)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    w3g = rng.randn(layout.Nb, 3 * 128, layout.R * 128) \
        / np.sqrt(layout.R * 128)
    return {"g": t(rng.randn(T, B, 3 * H) * 0.5), "w3g": t(w3g),
            "drop": t((rng.rand(B, H) > 0.2) * 1.0),
            "dhs": t(rng.randn(T, B, H) * 0.1), "layout": layout}


def v3_inputs(M, G, seed, dev, K=2048, N=1024):
    """x (M, K_true), w3 (Nb, G*bs, R*bs) at 8-bit-scale weights, the
    level-2 submask sub3 and a flat cotangent, on a libri x-projection
    layout (K-padded when K is not a multiple of 128)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    mask, layout = gru_layout(N, K, seed, pad_k=True)
    rng = np.random.RandomState(seed + 1)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return {"x": t(rng.randn(M, K)), "layout": layout,
            "w3": t(rng.randn(layout.Nb, G * 128, layout.R * 128) * 0.05),
            "sub3": t(BS.stack_w3_gates([BS.pack_w3(mask, layout)] * G)),
            "gy": t(rng.randn(M, layout.Nb * G * 128))}


def v3_dx_variant_checks(check, v, layout, G, qbits, sub3, M, K, variant,
                         ref):
    """Row 14 beyond the plan's own call at M: the serving M (398 x 16, a
    ragged last tile of M), gy 4 bytes off a float4 (dx_gemm's 4-byte
    loads) and the finest split of dx_splits forced (every column with
    more than one entry cut into single entries, dx_reduce summing the
    parts), each against the twin within TOL_F32_SMALL."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    gy, w3 = v["gy"], v["w3"]
    Ms = GR_SERVE_TBH[0] * GR_SERVE_TBH[1]
    gs = gy[:Ms].contiguous()
    check("block_sparse_v3_dx", (Ms, K, layout.N), dict(variant, M=Ms),
          rel_err(BS.block_sparse_v3_dx(gs, w3, layout, G, qbits, sub3),
                  BS.block_sparse_v3_dx_plain(gs, w3, layout, G, qbits,
                                              sub3)), TOL_F32_SMALL, True)
    buf = torch.empty(gy.numel() + 1, device=gy.device)
    gyo = buf[1:].view(gy.shape).copy_(gy)
    if BS.gemm_vec(layout.bs, gyo):
        raise AssertionError("gy 4 bytes off a float4 took the 16-byte loads")
    check("block_sparse_v3_dx", (M, K, layout.N),
          dict(variant, loads="scalar"), rel_err(BS.block_sparse_v3_dx(
              gyo, w3, layout, G, qbits, sub3), ref), TOL_F32_SMALL, True)
    finest = BS.dx_splits(BS.column_counts(layout))[-1]
    plan_fn = BS.dx_plan
    BS.dx_plan = lambda *a: plan_fn(*a[:6], split=finest)
    try:
        got = BS.block_sparse_v3_dx(gy, w3, layout, G, qbits, sub3)
        parts = dx_plan_of(layout, M, G, "gemm", gy.device).parts
    finally:
        BS.dx_plan = plan_fn
    check("block_sparse_v3_dx", (M, K, layout.N),
          dict(variant, split=list(finest), parts=parts), rel_err(got, ref),
          TOL_F32_SMALL, True)


def phase_gru_kernels(dev):
    """The sparse GRU forward and BPTT kernels (qbits 0/16, w3g f32 and
    bf16, tanh as the cfg and relu at the small shape) at the small,
    serving and training shapes (the BPTT at the small and training
    ones; the forward also at GR_STEP_TBH, its step route, qbits 16 f32;
    each call on its route with its launches, two calls bit for bit and
    its device kernels), the v3 forward and dx kernels (G=3 with the 8-bit quantizer
    and the submask; G=1; a K-padded layout; the plain variant; the dx
    two calls bit for bit, and at G=3 also at the serving M, on dx_gemm's
    4-byte loads and at the finest split: v3_dx_variant_checks) and the
    dw kernel at the path's G=1, 2, 3, against their twins; the forward
    and the dw at G=3 also on their scalar-load instantiation."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    checks = []

    def check(name, shape, variant, err_rel, tol, by_rel):
        record_check(checks, "gru_kernels", name, {"shape": list(shape)},
                     variant, err_rel, tol, by_rel)

    for shape in (GR_SMALL_TBH, GR_SERVE_TBH, GR_TRAIN_TBH, GR_STEP_TBH):
        T, B, H = shape
        small, serve = shape == GR_SMALL_TBH, shape == GR_SERVE_TBH
        step = shape == GR_STEP_TBH
        cases = [(q, wb, "tanh") for q in (0, 16) for wb in (False, True)
                 if not (step and (wb or not q))]
        if small:
            cases += [(16, False, "relu")]
        for k, (qbits, wbf16, act) in enumerate(cases):
            inp = gru_inputs(T, B, H, 110 + k, dev)
            g, w3g, drop, dhs, layout = (inp[n] for n in (
                "g", "w3g", "drop", "dhs", "layout"))
            variant = {"qbits": qbits, "w3g": "bf16" if wbf16 else "f32",
                       "act": act, "Kb": layout.Kb, "R": layout.R}
            tol = TOL_BF16 if wbf16 else (
                TOL_Q16 if qbits else (TOL_F32_SMALL if small
                                       else TOL_F32_SERVE))
            with torch.no_grad():
                # the forward on its route: launches, bits, device kernels
                fargs = (g, w3g, drop, layout, act, qbits, wbf16)
                route, n = gru_fwd_sparse_launches(dev, T, B, layout, wbf16)
                fvar = dict(variant, route=route)
                hs = launched(R.fused_gru_fwd_sparse, n,
                              lambda: R.fused_gru_fwd_sparse(*fargs))
                check("fused_gru_fwd_sparse", shape, fvar, rel_err(
                    hs, R.fused_gru_fwd_sparse_plain(*fargs)), tol, False)
                check("fused_gru_fwd_sparse/determinism", shape, fvar,
                      same_bits(lambda: R.fused_gru_fwd_sparse(*fargs)),
                      0.0, False)
                bptt_kernels(lambda: R.fused_gru_fwd_sparse(*fargs),
                             gru_fwd_sparse_design(route, T))
                if serve or step:
                    continue
                h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                args = (g, w3g, drop, h_prev, dhs, layout, act, qbits, wbf16)
                # the route picked before the launch, its launches (and the
                # v3 forward calls of its rebuild), two calls bit for bit
                route, n, n_v3 = gru_bwd_sparse_launches(dev, T, B, layout,
                                                         qbits, wbf16)
                bvar = dict(variant, route=route)
                v3_before = BS.block_sparse_v3_fwd.launches
                got = launched(R.fused_gru_bwd_sparse, n,
                               lambda: R.fused_gru_bwd_sparse(*args))
                if BS.block_sparse_v3_fwd.launches - v3_before != n_v3:
                    raise AssertionError("the %s BPTT made %d v3 calls"
                                         % (route, BS.block_sparse_v3_fwd
                                            .launches - v3_before))
                check("fused_gru_bwd_sparse", shape, bvar, rel_err(
                    got, R.fused_gru_bwd_sparse_plain(*args)), tol, True)
                check("fused_gru_bwd_sparse/determinism", shape, bvar,
                      same_bits(lambda: R.fused_gru_bwd_sparse(*args)), 0.0,
                      False)
                # the kernels that ran are the route's
                bptt_kernels(lambda: R.fused_gru_bwd_sparse(*args),
                             bptt_design(route, T, qbits, wbf16))
    # the v3 pair at the training M = T*B (and G=1, K-padded, plain)
    M = GR_TRAIN_TBH[0] * GR_TRAIN_TBH[1]
    for k, (G, K, qbits, sub) in enumerate(((3, 2048, 8, True),
                                            (1, 2048, 8, True),
                                            (3, 2000, 8, True),
                                            (3, 2048, 0, False))):
        v = v3_inputs(M, G, 130 + k, dev, K=K)
        layout, sub3 = v["layout"], (v["sub3"] if sub else None)
        xp = BS.pad_cols(v["x"], layout.K).contiguous()
        variant = {"G": G, "K": K, "K_padded": layout.K, "qbits": qbits,
                   "fuse_sub": sub, "M": M, "Kb": layout.Kb, "R": layout.R}
        with torch.no_grad():
            check("block_sparse_v3_fwd", (M, K, layout.N), variant, rel_err(
                BS.block_sparse_v3_fwd(xp, v["w3"], layout, G, qbits, sub3),
                BS.block_sparse_v3_fwd_plain(xp, v["w3"], layout, G, qbits,
                                             sub3)), TOL_F32_SMALL, True)
            # row 14: the weight pass and dx_gemm over dx_plan's items
            dcall = lambda: BS.block_sparse_v3_dx(v["gy"], v["w3"], layout,
                                                  G, qbits, sub3)
            dx_ref = BS.block_sparse_v3_dx_plain(v["gy"], v["w3"], layout, G,
                                                 qbits, sub3)
            check("block_sparse_v3_dx", (M, K, layout.N), variant,
                  rel_err(dcall(), dx_ref), TOL_F32_SMALL, True)
            check("block_sparse_v3_dx/determinism", (M, K, layout.N),
                  variant, same_bits(dcall), 0.0, False)
            if k == 0:
                v3_dx_variant_checks(check, v, layout, G, qbits, sub3, M, K,
                                     variant, dx_ref)
                check("block_sparse_dw", (M, K, layout.N),
                      dict(variant, path="v3 dw, G=3"), rel_err(
                          BS.block_sparse_dw(v["gy"], xp, layout, G, sub3),
                          BS.block_sparse_dw_plain(v["gy"], xp, layout, G,
                                                   sub3)),
                      TOL_F32_SMALL, True)
                check("block_sparse_dw/determinism", (M, K, layout.N),
                      dict(variant, path="v3 dw, G=3"), same_bits(
                          lambda: BS.block_sparse_dw(v["gy"], xp, layout, G,
                                                     sub3)), 0.0, False)
                # the serving M (398 x 16): its last tile of M is ragged
                Ms = GR_SERVE_TBH[0] * GR_SERVE_TBH[1]
                check("block_sparse_v3_fwd", (Ms, K, layout.N),
                      dict(variant, M=Ms), rel_err(
                          BS.block_sparse_v3_fwd(xp[:Ms], v["w3"], layout, G,
                                                 qbits, sub3),
                          BS.block_sparse_v3_fwd_plain(xp[:Ms], v["w3"],
                                                       layout, G, qbits,
                                                       sub3)),
                      TOL_F32_SMALL, True)
                # the scalar-load instantiation of both GEMMs: x copied 4
                # bytes off a float4 (no model path gives them one)
                buf = torch.empty(xp.numel() + 1, device=dev)
                xo = buf[1:].view(xp.shape).copy_(xp)
                if BS.gemm_vec(layout.bs, xo):
                    raise AssertionError("x 4 bytes off a float4 took the "
                                         "16-byte loads")
                scalar = dict(variant, loads="scalar")
                check("block_sparse_v3_fwd", (M, K, layout.N), scalar,
                      rel_err(BS.block_sparse_v3_fwd(xo, v["w3"], layout, G,
                                                     qbits, sub3),
                              BS.block_sparse_v3_fwd_plain(
                                  xp, v["w3"], layout, G, qbits, sub3)),
                      TOL_F32_SMALL, True)
                check("block_sparse_dw", (M, K, layout.N),
                      dict(scalar, path="v3 dw, G=3"), rel_err(
                          BS.block_sparse_dw(v["gy"], xo, layout, G, sub3),
                          BS.block_sparse_dw_plain(v["gy"], xp, layout, G,
                                                   sub3)),
                      TOL_F32_SMALL, True)
                del buf, xo
    # the GRU's dU: G=1 over q(s), G=2 over q(h_prev), K = H; the CGS-16x
    # Li-GRU's (G=2) and minimalGRU's / RNN's (G=1) at T=300, B=8
    T, B, H = GR_TRAIN_TBH
    _, layout = gru_layout(H, H, 140)
    cgs = cgs_layout(H, 142)[1]
    rng = np.random.RandomState(141)
    for lay, M, G, path in ((layout, T * B, 1, "GRU dU"),
                            (layout, T * B, 2, "GRU dU"),
                            (cgs, 2400, 2, "CGS-16x liGRU dU"),
                            (cgs, 2400, 1, "CGS-16x minimalGRU/RNN dU")):
        dg = torch.tensor(rng.randn(M, lay.Nb * G * 128)
                          .astype(np.float32), device=dev)
        x = torch.tensor(rng.randn(M, H).astype(np.float32), device=dev)
        variant = {"G": G, "path": path, "M": M, "Kb": lay.Kb, "R": lay.R,
                   "splits": BS.dw_plan(M, lay.Nb, G, lay.R, 128,
                                        BS.gemm_grid(dev))[1]}
        with torch.no_grad():
            check("block_sparse_dw", (M, H, H), variant, rel_err(
                BS.block_sparse_dw(dg, x, lay, G),
                BS.block_sparse_dw_plain(dg, x, lay, G)), TOL_F32_SMALL, True)
            check("block_sparse_dw/determinism", (M, H, H), variant,
                  same_bits(lambda: BS.block_sparse_dw(dg, x, lay, G)), 0.0,
                  False)
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a GRU-slice kernel disagrees with its plain "
                             "twin: %s" % bad)
    routes = {(tuple(c["shape"]), c["route"]) for c in checks
              if c["kernel"] == "fused_gru_fwd_sparse"}
    if not {(GR_TRAIN_TBH, "persist"), (GR_SERVE_TBH, "persist"),
            (GR_STEP_TBH, "step")} <= routes:
        raise AssertionError("gru_kernels: the forward's routes were %s"
                             % sorted(routes))
    return checks


#: each wrapper with a persistent route: its route function in fused_rnn,
#: and its library, occupancy entry and that entry's ints before the
#: dynamic shared memory (from the plan and bf16)
PERSIST_ROUTES = {
    "fused_gru_torch_bwd": ("gru_torch_bwd_route", "fused_gru_torch",
                            "fused_gru_torch_bwd_occupancy",
                            lambda plan, bf16: (plan.bi,)),
    "fused_gru_bwd_sparse": ("gru_bwd_sparse_route", "fused_gru_sparse",
                             "gru_bwd_sparse_occupancy",
                             lambda plan, bf16: (int(bf16), plan.bi)),
    "fused_ligru_bwd": ("ligru_bwd_route", "fused_ligru",
                        "fused_ligru_bwd_occupancy",
                        lambda plan, bf16: (plan.bi, plan.units)),
    "fused_gru_fwd_sparse": ("gru_fwd_sparse_route", "fused_gru_sparse",
                             "gru_fwd_sparse_occupancy",
                             lambda plan, bf16: (int(bf16), plan.bi,
                                                 plan.units)),
    "fused_gru_fwd": ("gru_fwd_route", "fused_gru", "gru_fwd_dense_occupancy",
                      lambda plan, bf16: (3, plan.bi, plan.units)),
    "fused_mgru_fwd": ("gru_fwd_route", "fused_gru",
                       "gru_fwd_dense_occupancy",
                       lambda plan, bf16: (2, plan.bi, plan.units)),
    "fused_ligru_fwd": ("ligru_fwd_route", "fused_ligru",
                        "fused_ligru_fwd_occupancy",
                        lambda plan, bf16: (plan.bi, plan.units)),
    "fused_mgru_bwd": ("mgru_bwd_route", "fused_gru",
                       "gru_bwd_dense_occupancy",
                       lambda plan, bf16: (2, plan.bi, plan.units)),
    "fused_lstm_fwd": ("lstm_fwd_route", "fused_lstm_fwd",
                       "lstm_fwd_occupancy",
                       lambda plan, bf16: (int(bf16), plan.bi, plan.units)),
    "fused_lstm_bwd_stash": ("lstm_bwd_stash_route", "fused_lstm_bwd",
                             "lstm_bwd_stash_occupancy",
                             lambda plan, bf16: (int(bf16), plan.bi,
                                                 plan.units)),
    "fused_gru_bwd_stash": ("gru_bwd_stash_route", "fused_gru",
                            "gru_bwd_dense_occupancy",
                            lambda plan, bf16: (3, plan.bi, plan.units)),
    "fused_rnn_fwd": ("rnn_fwd_route", "fused_rnn", "fused_rnn_fwd_occupancy",
                      lambda plan, bf16: (plan.bi, plan.units)),
    "fused_rnn_bwd": ("rnn_bwd_route", "fused_rnn", "fused_rnn_bwd_occupancy",
                      lambda plan, bf16: (plan.bi, plan.units)),
    "fused_mgru_fwd_sparse": ("gru_fwd_sparse_route", "fused_gru_sparse",
                              "mgru_fwd_sparse_occupancy",
                              lambda plan, bf16: (int(bf16), plan.bi,
                                                  plan.units)),
    "fused_mgru_bwd_sparse": ("mgru_bwd_sparse_route", "fused_gru_sparse",
                              "mgru_bwd_sparse_occupancy",
                              lambda plan, bf16: (int(bf16), plan.bi)),
    "fused_rnn_fwd_sparse": ("rnn_fwd_sparse_route", "fused_rnn_sparse",
                             "rnn_fwd_sparse_occupancy",
                             lambda plan, bf16: (int(bf16), plan.bi,
                                                 plan.units)),
    "fused_rnn_bwd_sparse": ("rnn_bwd_sparse_route", "fused_rnn_sparse",
                             "rnn_bwd_sparse_occupancy",
                             lambda plan, bf16: (int(bf16), plan.bi,
                                                 plan.units)),
    "fused_lstm_fwd_sparse": ("lstm_fwd_sparse_route", "fused_lstm_sparse",
                              "lstm_fwd_sparse_occupancy",
                              lambda plan, bf16: (int(bf16), plan.bi,
                                                  plan.units)),
    "fused_lstm_bwd_sparse_stash": ("lstm_bwd_sparse_stash_route",
                                    "fused_lstm_sparse",
                                    "lstm_bwd_sparse_stash_occupancy",
                                    lambda plan, bf16: (int(bf16), plan.bi,
                                                        plan.units))}
#: the dense forwards' gate counts (their route functions take G)
DENSE_FWD_G = {"fused_gru_fwd": 3, "fused_mgru_fwd": 2}
#: the sparse minimalGRU's wrappers: their routes are in a package that
#: has mgru_bwd_sparse_route (an earlier tree's runs both on "step"); the
#: forward's route function is the GRU's, at G=2
MGRU_SPARSE = ("fused_mgru_fwd_sparse", "fused_mgru_bwd_sparse")
#: the dense LSTM's wrappers with a persistent route: their route
#: functions are fused_lstm's and take (B, H, bf16, dev)
LSTM_PERSIST = ("fused_lstm_fwd", "fused_lstm_bwd_stash")
#: the sparse LSTM's wrappers with a persistent route: their route
#: functions are fused_lstm's and take (B, layout, bf16, dev)
LSTM_SPARSE = ("fused_lstm_fwd_sparse", "fused_lstm_bwd_sparse_stash")


def chain_route(dev, kernel, B, H=None, layout=None, bf16=False):
    """The route the wrapper ``kernel`` (a key of PERSIST_ROUTES) takes at
    batch B (width H for the dense ones, over ``layout`` for the sparse
    ones) and its plan as a dict: the grid, the blocks an SM it needs and
    the most that fit, the shared memory, resident and staged bytes of a
    block, the slabs a staged row is cut into. A package without that
    wrapper's persistent route (an earlier tree's) runs "step". The dense
    GRU forwards (DENSE_FWD_G) take their gate count, the dense LSTM's
    wrappers (LSTM_PERSIST) bf16, the sparse LSTM's (LSTM_SPARSE) a
    layout and bf16, the sparse minimalGRU's forward the GRU's route at
    G=2."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    fn, lib, entry, ints = PERSIST_ROUTES[kernel]
    in_f = kernel in LSTM_PERSIST + LSTM_SPARSE
    if not hasattr(F if in_f else R, fn) or (
            kernel in MGRU_SPARSE and not hasattr(R, "mgru_bwd_sparse_route")):
        return "step", {}
    if kernel in DENSE_FWD_G:
        route, plan = getattr(R, fn)(B, H, DENSE_FWD_G[kernel], dev)
    elif kernel == "fused_mgru_fwd_sparse":
        route, plan = R.gru_fwd_sparse_route(B, layout, bf16, dev, 2)
    elif kernel in LSTM_PERSIST:
        route, plan = getattr(F, fn)(B, H, bf16, dev)
    elif kernel in LSTM_SPARSE:
        route, plan = getattr(F, fn)(B, layout, bf16, dev)
    else:
        route, plan = (getattr(R, fn)(B, H, dev) if layout is None
                       else getattr(R, fn)(B, layout, bf16, dev))
    info = {"route": route, "grid": plan.grid,
            "batch_rows_per_block": 8 * plan.bi,
            "units_per_block": plan.units,
            "smem_per_block": plan.smem + plan.static,
            "resident_bytes_per_block": plan.resident,
            "staged_bytes_per_block_per_step": plan.staged}
    if getattr(plan, "slab", 0):
        info.update(slab=plan.slab, slabs=plan.slabs)
    if plan.smem + plan.static <= R._SMEM_MAX:
        fit, sms, _ = R._persist_occupancy(lib, entry, ints(plan, bf16)
                                           + (plan.smem,),
                                           torch.device(dev).index or 0)
        info.update(blocks_per_sm=-(-plan.grid // sms),
                    blocks_per_sm_max=fit, sms=sms)
    return route, info


def bptt_route(dev, B, H=None, layout=None, bf16=False):
    """chain_route of a GRU BPTT: the torch-semantics GRU's at width H,
    the sparse GRU's over ``layout``."""
    if layout is None:
        return chain_route(dev, "fused_gru_torch_bwd", B, H)
    return chain_route(dev, "fused_gru_bwd_sparse", B, layout=layout,
                       bf16=bf16)


def gru_torch_bwd_launches(dev, T, B, H):
    """fused_gru_torch_bwd's launches a call: the rebuild and the chain
    (2), or the rebuild and T step kernels."""
    return 2 if bptt_route(dev, B, H)[0] == "persist" else T + 1


#: fused_gru_bwd_sparse's launches a call on the persistent route by
#: (qbits > 0, wbf16), written from the design: the z/r pass, a_pre and
#: the chain, the per-step scales with the quantizer, q(h) and q(s) where
#: the quantizer or bf16 rounding changes them
GRU_BWD_SPARSE_PERSIST_LAUNCHES = {(False, False): 3, (True, False): 6,
                                   (False, True): 5, (True, True): 6}


def gru_bwd_sparse_launches(dev, T, B, layout, qbits, bf16):
    """fused_gru_bwd_sparse's launches a call on its route, and the v3
    forward calls its rebuild makes: -> (route, launches, v3 calls)."""
    route = bptt_route(dev, B, layout=layout, bf16=bf16)[0]
    if route == "step":
        return route, 2 * T + 2, 0
    return route, GRU_BWD_SPARSE_PERSIST_LAUNCHES[qbits > 0, bool(bf16)], 2


#: fused_ligru_bwd's launches a call on the persistent route by qbits >
#: 0, written from the design: the rebuild's GEMM and the chain, and the
#: per-step scales and q(h_prev) with the quantizer ("step": T)
LIGRU_BWD_PERSIST_LAUNCHES = {False: 2, True: 4}
#: fused_gru_fwd_sparse's launches a call on the persistent route: the
#: one cooperative launch ("step": two a step)
GRU_FWD_SPARSE_PERSIST_LAUNCHES = 1


#: fused_gru_fwd's and fused_mgru_fwd's launches a call on the persistent
#: route, written from the design: the one cooperative launch, a seed's
#: scale taken inside it ("step": two a step, and the reduction of max|h0|
#: before them with a seed and the quantizer)
GRU_FWD_PERSIST_LAUNCHES = 1


def gru_fwd_launches(dev, kernel, T, B, H, seeded=False, qbits=0):
    """The dense forward ``kernel``'s (fused_gru_fwd or fused_mgru_fwd)
    route at (B, H) and its launches a call of T steps."""
    route = chain_route(dev, kernel, B, H)[0]
    return route, (GRU_FWD_PERSIST_LAUNCHES if route == "persist"
                   else 2 * T + int(seeded and qbits > 0))


def gru_fwd_design(route, T, seeded=False, qbits=0):
    """fused_gru_fwd's and fused_mgru_fwd's device kernels a call by
    name."""
    if route == "persist":
        return {"gru_dense_fwd_persist": 1}
    want = {"gru_zr_step": T, "gru_h_step": T}
    if seeded and qbits > 0:
        want["absmax_bits"] = 1
    return want


def dense_fwd_stream_launches(dev, kernel, T, chunk, B, H, layers, qbits):
    """A stream's launches of the dense forward ``kernel`` over ``layers``
    layers: each layer's seeded call a chunk of ``chunk`` of the T frames,
    on its route (gru_fwd_launches)."""
    return layers * sum(gru_fwd_launches(dev, kernel, min(chunk, T - a), B,
                                         H, True, qbits)[1]
                        for a in range(0, T, chunk))


def ligru_bwd_launches(dev, T, B, H, qbits):
    """fused_ligru_bwd's route at (B, H) and its launches a call."""
    route = chain_route(dev, "fused_ligru_bwd", B, H)[0]
    return route, (LIGRU_BWD_PERSIST_LAUNCHES[qbits > 0]
                   if route == "persist" else T)


#: fused_ligru_fwd's launches a call on the persistent route, written from
#: the design: the one cooperative launch, a seed's scale taken inside it
#: ("step": one a step, as its counter counts them)
LIGRU_FWD_PERSIST_LAUNCHES = 1


def ligru_fwd_launches(dev, T, B, H):
    """fused_ligru_fwd's route at (B, H) and its launches a call of T
    steps."""
    route = chain_route(dev, "fused_ligru_fwd", B, H)[0]
    return route, LIGRU_FWD_PERSIST_LAUNCHES if route == "persist" else T


def ligru_fwd_design(route, T, seeded=False, qbits=0):
    """fused_ligru_fwd's device kernels a call by name: the one
    cooperative launch, or a step kernel a step (after the reduction of
    max|h0| with a seed and the quantizer)."""
    if route == "persist":
        return {"ligru_fwd_persist": 1}
    return dict({"absmax_bits": 1} if seeded and qbits > 0 else {},
                ligru_step=T)


def ligru_fwd_stream_launches(dev, T, chunk, B, H, layers):
    """A stream's launches of fused_ligru_fwd over ``layers`` layers: each
    layer's seeded call a chunk of ``chunk`` of the T frames, on its
    route."""
    return layers * sum(ligru_fwd_launches(dev, min(chunk, T - a), B, H)[1]
                        for a in range(0, T, chunk))


#: fused_mgru_bwd's launches a call on the persistent route by qbits > 0,
#: written from the design: the two rebuild products around the z pass
#: and the chain, and with the quantizer the per-step scales, q(h_prev) and
#: q(s) ("step": the two rebuild kernels and two a reverse step)
MGRU_BWD_PERSIST_LAUNCHES = {False: 4, True: 7}


def mgru_bwd_launches(dev, T, B, H, qbits):
    """fused_mgru_bwd's route at (B, H) and its launches a call."""
    route = chain_route(dev, "fused_mgru_bwd", B, H)[0]
    return route, (MGRU_BWD_PERSIST_LAUNCHES[qbits > 0]
                   if route == "persist" else 2 * T + 2)


def mgru_bwd_design(route, T, qbits):
    """fused_mgru_bwd's device kernels a call by name: with the quantizer
    the per-step scales (and on the persistent route q(h_prev) and q(s));
    then the two rebuild products around the z pass and the chain, or the
    two rebuild step kernels and two a reverse step."""
    want = {"absmax_steps": 1} if qbits > 0 else {}
    if route == "step":
        return dict(want, gru_zr_step=1, gru_h_step=1, gru_bwd_carry=T,
                    gru_bwd_ds=T)
    if qbits > 0:
        want["quant_steps"] = 2
    return dict(want, rows_dots=2, mgru_z_rebuild=1,
                gru_dense_bwd_persist=1)


def gru_bwd_stash_launches(dev, T, B, H):
    """fused_gru_bwd_stash's route at (B, H) and its launches a call: the
    one cooperative launch, or two a reverse step."""
    route = chain_route(dev, "fused_gru_bwd_stash", B, H)[0]
    return route, 1 if route == "persist" else 2 * T


def gru_bwd_stash_design(route, T):
    """fused_gru_bwd_stash's device kernels a call by name: the chain
    (gru_dense_bwd_persist<3, ., ., false>), or two a reverse step."""
    if route == "persist":
        return {"gru_dense_bwd_persist": 1}
    return {"gru_bwd_carry": T, "gru_bwd_ds": T}


#: fused_rnn_fwd's launches a call on the persistent route, written from
#: the design: the one cooperative launch, a seed's scale taken inside it
#: ("step": one a step, as its counter counts them)
RNN_FWD_PERSIST_LAUNCHES = 1


def rnn_fwd_launches(dev, T, B, H):
    """fused_rnn_fwd's route at (B, H) and its launches a call of T
    steps."""
    route = chain_route(dev, "fused_rnn_fwd", B, H)[0]
    return route, RNN_FWD_PERSIST_LAUNCHES if route == "persist" else T


def rnn_fwd_design(route, T, seeded=False, qbits=0):
    """fused_rnn_fwd's device kernels a call by name: the one cooperative
    launch, or a step kernel a step (after the reduction of max|h0| with
    a seed and the quantizer)."""
    if route == "persist":
        return {"rnn_fwd_persist": 1}
    return dict({"absmax_bits": 1} if seeded and qbits > 0 else {},
                rnn_step=T)


#: fused_rnn_bwd's launches a call on the persistent route by qbits > 0,
#: written from the design: the rebuild and the chain, and the per-step
#: scales of q(h_prev) with the quantizer ("step": the rebuild and one a
#: reverse step, T + 1, as its counter counts them)
RNN_BWD_PERSIST_LAUNCHES = {False: 2, True: 3}


def rnn_bwd_launches(dev, T, B, H, qbits=0):
    """fused_rnn_bwd's route at (B, H) and its launches a call of T
    steps."""
    route = chain_route(dev, "fused_rnn_bwd", B, H)[0]
    return route, (RNN_BWD_PERSIST_LAUNCHES[qbits > 0] if route == "persist"
                   else T + 1)


def rnn_bwd_design(route, T, qbits):
    """fused_rnn_bwd's device kernels a call by name: with the quantizer
    the per-step scales, the rebuild (rnn_step over all T), then the
    chain or T step kernels."""
    want = {"absmax_steps": 1} if qbits > 0 else {}
    want["rnn_step"] = 1
    if route == "persist":
        return dict(want, rnn_bwd_persist=1)
    return dict(want, rnn_bwd_step=T)


def rnn_stream_count(dev, layers, B, H):
    """``count(T, chunk)`` of an RNN stream on the dense seeded forward:
    each of ``layers`` layers' seeded call a chunk, on its route."""
    return lambda T, c: layers * sum(
        rnn_fwd_launches(dev, min(c, T - a), B, H)[1]
        for a in range(0, T, c))


def gru_fwd_sparse_launches(dev, T, B, layout, bf16=False,
                            kernel="fused_gru_fwd_sparse"):
    """fused_gru_fwd_sparse's (or ``kernel``'s, fused_mgru_fwd_sparse's)
    route at B over ``layout`` and its launches a call."""
    route = chain_route(dev, kernel, B, layout=layout, bf16=bf16)[0]
    return route, (GRU_FWD_SPARSE_PERSIST_LAUNCHES if route == "persist"
                   else 2 * T)


def mgru_fwd_sparse_launches(dev, T, B, layout, bf16=False):
    """fused_mgru_fwd_sparse's route at B over ``layout`` and its
    launches a call: the GRU's counts (gru_fwd_sparse_launches)."""
    return gru_fwd_sparse_launches(dev, T, B, layout, bf16,
                                   "fused_mgru_fwd_sparse")


#: fused_mgru_bwd_sparse's launches a call on the persistent route by
#: qbits > 0, written from the design: the rebuild's two step kernels over
#: all T and the chain, and the per-step scales with the quantizer
#: ("step": the two rebuild kernels and two a reverse step, 2T + 2, as its
#: counter counts them)
MGRU_BWD_SPARSE_PERSIST_LAUNCHES = {False: 3, True: 4}


def mgru_bwd_sparse_launches(dev, T, B, layout, qbits, bf16=False):
    """fused_mgru_bwd_sparse's route at B over ``layout`` and its
    launches a call."""
    route = chain_route(dev, "fused_mgru_bwd_sparse", B, layout=layout,
                        bf16=bf16)[0]
    return route, (MGRU_BWD_SPARSE_PERSIST_LAUNCHES[qbits > 0]
                   if route == "persist" else 2 * T + 2)


def mgru_bwd_sparse_design(route, T, qbits):
    """fused_mgru_bwd_sparse's device kernels a call by name: with the
    quantizer the per-step scales, the rebuild's two step kernels over all
    T, then the chain or two a reverse step."""
    want = dict({"absmax_steps": 1} if qbits > 0 else {}, gru_zr_step=1,
                gru_h_step=1)
    if route == "persist":
        return dict(want, gru_bwd_persist=1)
    return dict(want, gru_bwd_carry=T, gru_bwd_ds=T)


def rnn_fwd_sparse_launches(dev, T, B, layout, bf16=False):
    """fused_rnn_fwd_sparse's route at B over ``layout`` and its launches
    a call: one on the persistent route, T on the step route (an earlier
    tree's package runs "step")."""
    route = chain_route(dev, "fused_rnn_fwd_sparse", B, layout=layout,
                        bf16=bf16)[0]
    return route, 1 if route == "persist" else T


#: fused_rnn_bwd_sparse's launches a call on the persistent route by
#: qbits > 0, written from the design: the rebuild and the chain, and with
#: the quantizer the per-step scales and q(h_prev) ("step": the rebuild
#: and one a reverse step, T + 1, as its counter counts them)
RNN_BWD_SPARSE_PERSIST_LAUNCHES = {False: 2, True: 4}


def rnn_bwd_sparse_launches(dev, T, B, layout, qbits, bf16=False):
    """fused_rnn_bwd_sparse's route at B over ``layout`` and its launches
    a call."""
    route = chain_route(dev, "fused_rnn_bwd_sparse", B, layout=layout,
                        bf16=bf16)[0]
    return route, (RNN_BWD_SPARSE_PERSIST_LAUNCHES[qbits > 0]
                   if route == "persist" else T + 1)


def rnn_fwd_sparse_design(route, T):
    """fused_rnn_fwd_sparse's device kernels a call by name."""
    return ({"rnn_sparse_fwd_persist": 1} if route == "persist"
            else {"rnn_sparse_step": T})


def rnn_bwd_sparse_design(route, T, qbits):
    """fused_rnn_bwd_sparse's device kernels a call by name: with the
    quantizer the per-step scales (and on the persistent route
    q(h_prev)); then the rebuild and the chain, or the step kernel over
    all T and one a reverse step."""
    want = {"absmax_steps": 1} if qbits > 0 else {}
    if route == "step":
        return dict(want, rnn_sparse_step=1, rnn_sparse_bwd_step=T)
    if qbits > 0:
        want["quant_steps"] = 1
    return dict(want, rnn_sparse_rebuild=1, rnn_sparse_bwd_persist=1)


def lstm_fwd_sparse_launches(dev, T, B, layout, bf16=False):
    """fused_lstm_fwd_sparse's route at B over ``layout`` and its launches
    a call: one on the persistent route, T on the step route (an earlier
    tree's package runs "step")."""
    route = chain_route(dev, "fused_lstm_fwd_sparse", B, layout=layout,
                        bf16=bf16)[0]
    return route, 1 if route == "persist" else T


def lstm_bwd_sparse_stash_launches(dev, T, B, layout, bf16=False):
    """fused_lstm_bwd_sparse_stash's route at B over ``layout`` and its
    launches a call: one on the persistent route, T on the step route."""
    route = chain_route(dev, "fused_lstm_bwd_sparse_stash", B, layout=layout,
                        bf16=bf16)[0]
    return route, 1 if route == "persist" else T


def lstm_fwd_sparse_design(route, T):
    """fused_lstm_fwd_sparse's device kernels a call by name."""
    return ({"lstm_sparse_fwd_persist": 1} if route == "persist"
            else {"sparse_fwd_step": T})


def lstm_bwd_sparse_stash_design(route, T):
    """fused_lstm_bwd_sparse_stash's device kernels a call by name (the
    step route's transposed copy of w3g is PyTorch's)."""
    return ({"lstm_sparse_bwd_stash_persist": 1} if route == "persist"
            else {"sparse_bwd_step": T})


def lstm_sparse_layer_launches(dev, T, B, train):
    """One CGS-16x LSTM layer call's launches at (T, B) on each sparse
    kernel's route over the cfg's layout at a seed whose heaviest column
    holds 5 blocks (every layer's layout has Kb=8, R=2 and width 1024,
    and both blocks fit at every column count up to 8 at 8 and 16 rows,
    so they alone pick the route): {wrapper: launches}, the stash BPTT's
    with ``train``."""
    lay = cgs_layout(SP_TRAIN_TBH[2], 421)[1]
    out = {"fused_lstm_fwd_sparse": lstm_fwd_sparse_launches(dev, T, B,
                                                            lay)[1]}
    if train:
        out["fused_lstm_bwd_sparse_stash"] = lstm_bwd_sparse_stash_launches(
            dev, T, B, lay)[1]
    return out


def rnn_sparse_layer_launches(dev, T, B, qbits, train):
    """One CGS-16x RNN layer call's launches at (T, B) on each sparse
    kernel's route over the cfg's layout at the timed seed (every layer's
    layout has Kb=8, R=2 and width 1024, and the chain's block fits at
    every column count up to 8 at 8 rows, so they alone pick the route):
    {wrapper: launches}, the BPTT's with ``train``."""
    lay = cgs_layout(RS_TRAIN_TBH[2], 421)[1]
    out = {"fused_rnn_fwd_sparse": rnn_fwd_sparse_launches(dev, T, B,
                                                          lay)[1]}
    if train:
        out["fused_rnn_bwd_sparse"] = rnn_bwd_sparse_launches(
            dev, T, B, lay, qbits)[1]
    return out


def cgs_mgru_layer_launches(dev, T, B, qbits, train):
    """One CGS-16x minimalGRU layer call's launches at (T, B) on each
    sparse kernel's route over the cfg's layout at the timed seed (every
    layer's layout has Kb=8, R=2 and width 1024, and the chain's block
    fits at every column count up to 8 at 8 rows, so they alone pick the
    route): {wrapper: launches}, the BPTT's with ``train``."""
    lay = cgs_layout(MG_TRAIN_TBH[2], 421)[1]
    out = {"fused_mgru_fwd_sparse": mgru_fwd_sparse_launches(dev, T, B,
                                                            lay)[1]}
    if train:
        out["fused_mgru_bwd_sparse"] = mgru_bwd_sparse_launches(
            dev, T, B, lay, qbits)[1]
    return out


#: fused_lstm_fwd's and fused_lstm_bwd_stash's launches a call on the
#: persistent route, written from the design: the one cooperative launch
#: (a seed's quantizer scale and the seeded BPTT's dh0 inside it)
#: ("step": one a step, and the seeded BPTT's dh0 dot)
LSTM_PERSIST_LAUNCHES = 1


def lstm_fwd_launches(dev, T, B, H, bf16=False):
    """fused_lstm_fwd's route at (B, H) and its launches a call of T
    steps."""
    route = chain_route(dev, "fused_lstm_fwd", B, H, bf16=bf16)[0]
    return route, LSTM_PERSIST_LAUNCHES if route == "persist" else T


def lstm_bwd_stash_launches(dev, T, B, H, seeded=False, bf16=False):
    """fused_lstm_bwd_stash's route at (B, H) and its launches a call."""
    route = chain_route(dev, "fused_lstm_bwd_stash", B, H, bf16=bf16)[0]
    return route, (LSTM_PERSIST_LAUNCHES if route == "persist"
                   else T + int(seeded))


def lstm_plan_brief(dev, kernel, B, H, bf16=False):
    """The plan of ``kernel``'s persistent route at (B, H) in brief
    ("units x rows, grid blocks"; chain_route), None on the step
    route."""
    route, info = chain_route(dev, kernel, B, H, bf16=bf16)
    if route != "persist":
        return None
    return "%d units x %d rows, %d blocks" % (
        info["units_per_block"], info["batch_rows_per_block"], info["grid"])


def lstm_fwd_design(route, T, seeded=False, qbits=0):
    """fused_lstm_fwd's device kernels a call by name: the one
    cooperative launch, or a step kernel a step (after the reduction of
    max|h0| with a seed and the quantizer)."""
    if route == "persist":
        return {"lstm_fwd_persist": 1}
    return dict({"absmax_bits": 1} if seeded and qbits > 0 else {},
                lstm_step=T)


def lstm_bwd_stash_design(route, T, seeded=False):
    """fused_lstm_bwd_stash's device kernels a call by name: the one
    cooperative launch, or a kernel a reverse step and the dh0 dot when
    seeded."""
    if route == "persist":
        return {"lstm_bwd_stash_persist": 1}
    return dict({"lstm_bwd_dh0": 1} if seeded else {}, lstm_bwd_step=T)


def lstm_stream_launches(dev, T, chunk, B, H, layers):
    """A stream's launches of fused_lstm_fwd over ``layers`` layers: each
    layer's seeded call a chunk of ``chunk`` of the T frames, on its
    route."""
    return layers * sum(lstm_fwd_launches(dev, min(chunk, T - a), B, H)[1]
                        for a in range(0, T, chunk))


def flagship_expect_serve(T):
    """Launches per recognize of the flagship: its 2 layers' dense
    forward at 8 rows of H=512, each its route's, no other kernel."""
    return expected(fused_lstm_fwd=2 * lstm_fwd_launches(
        "cuda", T, N_UTT, SERVE_TBH[2])[1])


#: the port's own kernels a call on a persistent or a step route may
#: launch; bptt_kernels holds a call's trace to them (PyTorch's own
#: copies are not held)
ROUTE_KERNELS = (
    "absmax_steps", "quant_steps", "gru_zr_rebuild", "gru_apre_rebuild",
    "gru_bwd_persist", "v3_weight_t", "v3_fwd_gemm", "gru_zr_step",
    "gru_h_step", "gru_bwd_carry", "gru_bwd_ds", "rec_u_gemm",
    "gru_torch_bwd_persist", "gru_torch_bwd_step", "gru_torch_step",
    "ligru_bwd_persist", "ligru_bwd_step", "gru_fwd_persist",
    "gru_dense_fwd_persist", "absmax_bits", "ligru_fwd_persist",
    "ligru_step", "gru_dense_bwd_persist", "mgru_z_rebuild", "rows_dots",
    "lstm_fwd_persist", "lstm_step", "lstm_bwd_stash_persist",
    "lstm_bwd_step", "lstm_bwd_dh0", "rnn_fwd_persist", "rnn_step",
    "rnn_bwd_persist", "rnn_bwd_step", "rnn_sparse_fwd_persist",
    "rnn_sparse_step", "rnn_sparse_rebuild", "rnn_sparse_bwd_step",
    "rnn_sparse_bwd_persist", "sparse_fwd_step", "lstm_sparse_fwd_persist",
    "sparse_bwd_step", "lstm_sparse_bwd_stash_persist")


def bptt_design(route, T, qbits=None, bf16=False):
    """The device kernels of one GRU BPTT call by name, from the design:
    qbits None for fused_gru_torch_bwd (the rebuild's GEMM, then the chain
    or T step kernels); else fused_gru_bwd_sparse's (persistent: the
    rebuild's passes, two v3 forward calls of v3_weight_t + v3_fwd_gemm,
    the chain; step: the two rebuild kernels, two a reverse step)."""
    if qbits is None:
        return {"rec_u_gemm": 1,
                **({"gru_torch_bwd_persist": 1} if route == "persist"
                   else {"gru_torch_bwd_step": T})}
    want = {"absmax_steps": 1} if qbits > 0 else {}
    if route == "step":
        return dict(want, gru_zr_step=1, gru_h_step=1, gru_bwd_carry=T,
                    gru_bwd_ds=T)
    if qbits > 0 or bf16:
        want["quant_steps"] = 2
    return dict(want, gru_zr_rebuild=1, gru_apre_rebuild=1,
                gru_bwd_persist=1, v3_weight_t=2, v3_fwd_gemm=2)


def ligru_bwd_design(route, T, qbits):
    """fused_ligru_bwd's device kernels a call by name: with the quantizer
    the per-step scales (and on the persistent route q(h_prev)); then the
    rebuild's GEMM and the chain, or T step kernels."""
    want = {"absmax_steps": 1} if qbits > 0 else {}
    if route == "step":
        return dict(want, ligru_bwd_step=T)
    if qbits > 0:
        want["quant_steps"] = 1
    return dict(want, rec_u_gemm=1, ligru_bwd_persist=1)


def gru_fwd_sparse_design(route, T):
    """fused_gru_fwd_sparse's device kernels a call by name."""
    return ({"gru_fwd_persist": 1} if route == "persist"
            else {"gru_zr_step": T, "gru_h_step": T})


def last_call_kernels(fn, reps=3):
    """The device kernels of the last of ``reps`` profiled calls of
    ``fn`` by short name, its launch calls and, of those, its cooperative
    ones: the kernel records whose correlation id is one of the launch
    calls made inside that call's host range. The earlier calls take the
    records the profiler may drop at the start of its window (late in the
    full run a trace lacked a call's first three kernels, every time; a
    3 ms minimalGRU BPTT's second call lacked its first three too). ->
    (kernels, launch calls, cooperative launch calls), or None where the
    trace holds no such range."""
    events = trace_events(fn, reps=reps, mark=True)
    marks = [e for e in events if e.get("name") == "call_%d" % (reps - 1)
             and e.get("cat") == "user_annotation" and "dur" in e]
    if not marks:
        return None
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    launches, coop = set(), 0
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") == "cuda_runtime" and name.startswith(
                ("cudaLaunchKernel", "cuLaunchKernel",
                 "cudaLaunchCooperativeKernel")) \
                and t0 <= float(e.get("ts", -1)) <= t1:
            launches.add(e.get("args", {}).get("correlation", id(e)))
            coop += name.startswith("cudaLaunchCooperativeKernel")
    got = {}
    for e in events:
        if e.get("cat") == "kernel" and \
                e.get("args", {}).get("correlation") in launches:
            k = kernel_short_name(str(e.get("name", "")))
            got[k] = got.get(k, 0) + 1
    return got, len(launches), coop


def bptt_kernels(fn, want, tries=3):
    """Hold one call of the BPTT (or routed forward) ``fn`` to ``want``
    (bptt_design, ligru_bwd_design, gru_fwd_sparse_design,
    gru_fwd_design, ligru_fwd_design, mgru_bwd_design,
    gru_bwd_stash_design, rnn_fwd_design, rnn_bwd_design,
    rnn_fwd_sparse_design, rnn_bwd_sparse_design): the kernel records of
    the call (last_call_kernels) among ROUTE_KERNELS must be
    exactly those, so the route that ran is
    the one named. A trace that differs is taken again, up to ``tries``
    traces (the profiler can drop a record, device_kernels). The profiler
    drops records often: a short call's trace can hold no kernel record,
    or only a PyTorch copy's (a full run saw row 32's cooperative kernel
    dropped beside a kept ``vectorized_elementwise_kernel``), and a full
    run's three traces of row 29 each lacked the call's first kernel
    (``absmax_steps``) beside its two others. So where no trace equals
    the design, a trace whose records of the port's kernels are only
    part of it (none outside it, none more often) stands for it when its
    launch calls number at least the kernels ``want`` names (PyTorch's
    own copies launch too) and its cooperative ones exactly its chains
    (the ``*_persist`` kernels: one on a persistent route, none on a step
    route). It raises where any trace held a port kernel outside the
    design, or more often, or no trace stood for it. -> the port's
    kernels of the trace that agreed (or, for a partial trace, what it
    held with {"cuda_launch_calls": n, "cooperative": c})."""
    seen, partial, outside = [], None, False
    chains = sum(v for k, v in want.items() if k.endswith("_persist"))
    for _ in range(tries):
        got, calls, coop = last_call_kernels(fn) or ({}, 0, 0)
        port = {k: v for k, v in got.items() if k in ROUTE_KERNELS}
        if port == want:
            print("[bptt_kernels] %s" % json.dumps(port))
            return port
        if port:
            seen.append(got)
        if any(v > want.get(k, 0) for k, v in port.items()):
            outside = True
        elif calls >= sum(want.values()) and coop == chains:
            partial = dict(port, cuda_launch_calls=calls, cooperative=coop)
    if partial is not None and not outside:
        print("[bptt_kernels] %d traces held part of the design's records "
              "or none: %s (the design %s)" % (tries, json.dumps(partial),
                                               json.dumps(want)))
        return partial
    raise AssertionError("a routed call launched %s (%d launch calls, %d "
                         "cooperative); the design is %s"
                         % (seen, calls, coop, want))


def libri_gru_fwd_launches(dev, T, B, layouts=None):
    """fused_gru_fwd_sparse's launches over the libri GRU's 5 layer calls
    at batch B (gru_fwd_sparse_launches: 1 a call on the persistent
    route, 2T on the step route), over ``layouts`` (the model's
    recurrent ones) or, where they are not at hand, over the cfg's
    layout at the timed seed (every layer's layout has the same R, bs and
    width, which alone pick the route). -> [(route, launches)] a layer."""
    layouts = layouts or [gru_layout(1024, 1024, 150)[1]] * GR_LAYERS
    return [gru_fwd_sparse_launches(dev, T, B, lay) for lay in layouts]


def gru_expect_serve(T):
    """Launches per recognize: 5 layers of the sparse GRU forward at 16
    rows (each its route's, libri_gru_fwd_launches), one v3 forward for
    each of layers 1-4."""
    fwd = libri_gru_fwd_launches("cuda", T, GR_SERVE_TBH[1])
    return expected(fused_gru_fwd_sparse=sum(n for _, n in fwd),
                    block_sparse_v3_fwd=GR_LAYERS - 1)


def gru_expect_train(T, bwd=None, fwd=None):
    """Launches per train step: the forward (``fwd``: one (route,
    launches) a layer, libri_gru_fwd_launches), the layers' v3 forward,
    the BPTT (``bwd``: one (route, launches, v3 calls) a layer,
    gru_bwd_sparse_launches; the persistent route's rebuild makes two v3
    forward calls), layers 1-4's dx, and the dw kernel for layers 1-4's
    v3 dw (G=3) and two dU products per layer (G=1 and G=2)."""
    bwd = bwd or [("step", 2 * T + 2, 0)] * GR_LAYERS
    fwd = fwd or [("step", 2 * T)] * GR_LAYERS
    return expected(fused_gru_fwd_sparse=sum(n for _, n in fwd),
                    fused_gru_bwd_sparse=sum(n for _, n, _ in bwd),
                    block_sparse_v3_fwd=GR_LAYERS - 1 + sum(
                        v for _, _, v in bwd),
                    block_sparse_v3_dx=GR_LAYERS - 1,
                    block_sparse_dw=GR_LAYERS - 1 + 2 * GR_LAYERS)


def gru_serve_bar(err, ref, audio):
    """The recognizer's card-vs-CPU bar: TOL_POST, or where the 16-bit
    ceil input quantizers put more than that between the card's and the
    CPU's sums, GRAD_FLIP_K times the CPU recognizer's own change of its
    log-posteriors under a one-ulp change of its features (measured)."""
    if err <= TOL_POST:
        return TOL_POST
    x = ref.features(audio).transpose(0, 1).contiguous()
    sign = torch.as_tensor(np.random.RandomState(1).choice(
        [-1.0, 1.0], tuple(x.shape)).astype(np.float32))
    with torch.inference_mode():
        sens = float((ref.model(x * (1.0 + sign * 2.0 ** -23))
                      - ref.model(x)).abs().max())
    print("[gru_serve] the CPU's own log-posteriors under a one-ulp change "
          "of the features: %.3g" % sens)
    return max(TOL_POST, GRAD_FLIP_K * sens)


def gru_train_setup(compute_dtype="", quant_inp=True):
    """The libri GRU train step (chunk_setup): the cfg's sections
    (gru_sections), 16 sentences of 200 frames (start_seq_len_train),
    fMLLR x of width 40 and cd labels."""
    T, B, _ = GR_TRAIN_TBH
    return chunk_setup(gru_sections(compute_dtype, quant_inp), T, B // 2,
                       "fmllr", GR_FEAT, CD_LABELS)


def gru_train_runner(dev, compute_dtype="", quant_inp=True):
    """A ChunkRunner over the libri GRU's sections and its one batch;
    ``runner.train_step(inp, mask, chip_smoke.dropout_gen())`` for masks
    that match the CPU's (the cfg has dropout 0.2)."""
    from pytorch_kaldi_cgs_tpu_torch.models import GRU
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = gru_train_setup(compute_dtype, quant_inp)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    rnn = graph.nets["GRU_layers"]
    if type(rnn) is not GRU:
        raise AssertionError("the libri cfg did not build a GRU")
    check_gru_layouts(rnn)
    return ChunkRunner(graph, config), batch


@contextlib.contextmanager
def dw_groups():
    """Count the block-sparse dw kernel's launches by G (the v3 dw at
    G=3, the GRU's dU at G=1 and G=2) while the block runs; a launch that
    takes the scalar-load instantiation (a misaligned operand) raises."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    real, by_g = BS._dw_kernel, {}

    def spy(dg_flat, x, layout, G, sub3):
        if not BS.gemm_vec(layout.bs, dg_flat, x, sub3):
            raise AssertionError("the dw kernel took its scalar loads at G=%d"
                                 % G)
        by_g[G] = by_g.get(G, 0) + 1
        return real(dg_flat, x, layout, G, sub3)
    BS._dw_kernel = spy
    try:
        yield by_g
    finally:
        BS._dw_kernel = real


def phase_gru_train(dev):
    """One train step on the card against the CPU (loss, err, every
    gradient, the packed x-weights' included): as shipped at TOL_GRAD_REL,
    or, where the 16-bit ceil input quantizers put more than that between
    the card's and the CPU's sums, GRAD_FLIP_K times the CPU's own
    one-ulp sensitivity and then the same cfg without the quantizers at
    TOL_GRAD_REL. Launches per step (the dw kernel's by G), 10 steps at
    the cfg's learning rates in f32 and bf16."""
    T = GR_TRAIN_TBH[0]
    knob = "PKC_BWD_STASH_CELLS"    # the sparse GRU has one backward

    def bar(worst):
        if worst <= TOL_GRAD_REL:
            return TOL_GRAD_REL
        inp, mask = gru_train_setup()[2]
        sens, where = ulp_sensitivity(gru_train_runner, inp, mask, GR_FEAT)
        print("[gru_train] the CPU's own gradients under a one-ulp change "
              "of x: worst rel change %.3g at %s" % (sens, where))
        return max(TOL_GRAD_REL, GRAD_FLIP_K * sens)
    fwd, bwd = libri_gru_routes(dev)
    with dw_groups() as by_g:
        out = phase_train(dev, gru_train_runner, "gru_train", (
            ("recompute", knob, None, gru_expect_train(T, bwd, fwd)),),
            grad_tol=bar)
        out["block_sparse_dw_by_G"] = dict(by_g)
    out["forward_routes"] = [r for r, _ in fwd]
    out["bptt_routes"] = [r for r, _, _ in bwd]
    print("[gru_train] dw kernel launches by G over the checked steps: %s"
          % out["block_sparse_dw_by_G"])
    if sorted(by_g) != [1, 2, 3]:
        raise AssertionError("the dw kernel did not run at G=1, 2 and 3")
    if out["grad_rel_err_max"] <= TOL_GRAD_REL:
        return out                  # the shipped cfg met the tight bar

    def no_quant(d, cdt=""):
        return gru_train_runner(d, cdt, quant_inp=False)
    runner, (inp, mask) = no_quant(dev)
    loss_err = runner.train_step(inp, mask, dropout_gen())
    out["no_quant_inp"] = card_vs_cpu(
        runner, no_quant("cpu")[0], inp, mask, loss_err, knob, None,
        "gru_train, gru_quant_inp=False")
    return out


def libri_gru_routes(dev):
    """Each libri GRU layer's forward and BPTT at the train step (32
    rows, the 16-bit quantizer, float32 w3g) over the runner's recurrent
    layouts: libri_gru_fwd_launches and gru_bwd_sparse_launches, the
    routes printed with the plans of layer 0. -> (forward, BPTT) lists."""
    T, B, _ = GR_TRAIN_TBH
    runner, _ = gru_train_runner(dev)
    layouts = [runner.graph.nets["GRU_layers"]._rec_layouts[i]
               for i in range(GR_LAYERS)]
    fwd = libri_gru_fwd_launches(dev, T, B, layouts)
    bwd = [gru_bwd_sparse_launches(dev, T, B, lay, 16, False)
           for lay in layouts]
    print("[gru_train] forward per layer (route, launches): %s; plan of "
          "layer 0: %s" % (fwd, json.dumps(chain_route(
              dev, "fused_gru_fwd_sparse", B, layout=layouts[0])[1])))
    print("[gru_train] BPTT per layer (route, launches, v3 calls): %s; plan "
          "of layer 0: %s" % (bwd, json.dumps(bptt_route(
              dev, B, layout=layouts[0])[1])))
    return fwd, bwd


def gru_bound_ms(T, B, H, kept, kind):
    """Least time for one GRU layer call in float32: each input read
    once, each output written once, over the HBM rate; the FMAs of its
    products (three gates over the ``kept`` columns of each row: R*bs
    sparse, H dense) over the float32 peak. kind: "fwd" (gates, U or w3g,
    drop in; hs out), "fwd_stash" (and the (T, B, 3H) stash out), "bwd"
    (the sparse BPTT: gates, w3g, drop, h_prev, dhs in; dg and s out; the
    forward's products and their transposes), "bwd_dense" (the dense
    recompute BPTT: the same without s out), "bwd_stash" (the stash, U,
    drop, h_prev, dhs in; dg out; the two transposed products). The
    torch-semantics GRU reads b_hh (3H) where these read drop (B*H; 11 KB
    more at the TIMIT width, and operations bound both) and its BPTT
    writes dm where the sparse one writes s: "fwd" and "bwd" count it
    with kept = H."""
    gates, seq = T * B * 3 * H * 4, T * B * H * 4
    nbytes = {"fwd": gates + seq, "fwd_stash": 2 * gates + seq,
              "bwd": 2 * gates + 3 * seq, "bwd_dense": 2 * gates + 2 * seq,
              "bwd_stash": 2 * gates + 2 * seq}[kind]
    recompute = kind in ("bwd", "bwd_dense")
    return roofline_ms(nbytes + 3 * H * kept * 4 + B * H * 4,
                       2 * T * B * 3 * H * kept * (2 if recompute else 1))


def v3_bound_ms(M, layout, G):
    """Least time for one v3 forward or dx call in float32: x (M, K),
    w3 and sub3 in, (G, M, N) out (or the reverse), and 2*M*nnz*bs^2*G
    FMAs over the float32 peak."""
    bs = layout.bs
    return roofline_ms((M * layout.K + 2 * layout.nnz * G * bs * bs
                        + G * M * layout.N) * 4,
                       2 * M * layout.nnz * bs * bs * G)


def phase_gru_times(dev, rec, audio, lens):
    """CUDA-event times per layer call at the training shape (T=200, 32
    rows, H=1024; tanh, qbits 16 as the cfg runs them; the GRU forward
    also at the serving shape, T=398, 16 rows) of the sparse GRU kernels,
    their twins, bounds and yardstick (cuDNN's nn.GRU(1024, 1024) at 32
    rows); the libri GRU train step and recognize. The v3 pair's are
    bs_gemm_times'."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = GR_TRAIN_TBH
    qb, act = 16, "tanh"
    inp = gru_inputs(T, B, H, 150, dev)
    g, w3g, drop, dhs, layout = (inp[n] for n in ("g", "w3g", "drop", "dhs",
                                                  "layout"))
    kept = layout.R * layout.bs
    times = {}
    with torch.no_grad():
        hs = R.fused_gru_fwd_sparse(g, w3g, drop, layout, act, qb)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        calls = {
            "fused_gru_fwd_sparse": (
                lambda: R.fused_gru_fwd_sparse(g, w3g, drop, layout, act, qb),
                lambda: R.fused_gru_fwd_sparse_plain(g, w3g, drop, layout,
                                                     act, qb), "fwd"),
            "fused_gru_bwd_sparse": (
                lambda: R.fused_gru_bwd_sparse(g, w3g, drop, h_prev, dhs,
                                               layout, act, qb),
                lambda: R.fused_gru_bwd_sparse_plain(
                    g, w3g, drop, h_prev, dhs, layout, act, qb), "bwd")}
        for name, (fn, plain, kind) in calls.items():
            times[name + "_ms"] = cuda_ms(fn, reps=10)
            times[name + "_plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                gru_bound_ms(T, B, H, kept, kind)
        times["fused_gru_fwd_sparse_ms_q0"] = cuda_ms(
            lambda: R.fused_gru_fwd_sparse(g, w3g, drop, layout, act, 0),
            reps=10)
        times["fused_gru_bwd_sparse_plan"] = bptt_route(dev, B,
                                                        layout=layout)[1]
        times["fused_gru_fwd_sparse_plan"] = chain_route(
            dev, "fused_gru_fwd_sparse", B, layout=layout)[1]
        times["fused_gru_bwd_sparse_split"] = bptt_split(
            calls["fused_gru_bwd_sparse"][0], 3)
        Ts, Bs, _ = GR_SERVE_TBH
        sv = gru_inputs(Ts, Bs, H, 151, dev)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_gru_fwd_sparse(sv["g"], sv["w3g"], sv["drop"],
                                           sv["layout"], act, qb), reps=10)
        times["serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_gru_fwd_sparse_plain(
                sv["g"], sv["w3g"], sv["drop"], sv["layout"], act, qb),
            reps=2, warmup=1)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            gru_bound_ms(Ts, Bs, H, kept, "fwd")
        times["serve_fwd_plan"] = chain_route(
            dev, "fused_gru_fwd_sparse", Bs, layout=sv["layout"])[1]
    times.update(cudnn_times(dev, T, B, H, Ts, Bs))
    print("[gru_times] kernels at T=%d B=%d H=%d (Kb=%d, R=%d; tanh, qbits "
          "16): %s" % (T, B, H, layout.Kb, layout.R, json.dumps(times)))
    step = train_step_times(dev, gru_train_runner, "gru_times", 5, 3)
    serve = serve_timings(rec, audio, lens)
    print("[gru_times] libri GRU recognizer (8 x 4 s batch): %s"
          % json.dumps(serve))
    return times, step, serve


def gru_rows(checks, times, launches):
    """The kernels JSON rows of the LibriSpeech GRU slice. ``ms`` etc. are
    per layer call at the training shape (the GRU: T=200, 32 rows,
    H=1024, tanh, qbits 16; v3: M=6400, K=2048, N=1024, G=3, qbits 8 with
    the submask); ``launches`` counts one libri GRU train step;
    ``library_ms`` is cuDNN's nn.GRU(1024, 1024) for the recurrence (a
    yardstick: dense, no quantizer) and the dense-masked torch.matmul for
    the v3 pair (the JAX package's path at Kb < 16)."""
    T, B, H = GR_TRAIN_TBH
    fr = "pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:%d"
    bsp = "pytorch_kaldi_cgs_tpu/ops/block_sparse.py:%d"
    src = "pytorch_kaldi_cgs_tpu_torch/ops/csrc/%s.cu"

    def err_at(kernel, **want):
        hits = [c for c in checks if c["kernel"] == kernel
                and all(c.get(k) == v for k, v in want.items())]
        return hits[0]["max_abs_err"]

    def row(name, source, replaces, library_ms, library_note, err, shape,
            **extra):
        mine = [c for c in checks if c["kernel"] == name]
        r = {"name": name, "route": "cuda", "source": src % source,
             "replaces": replaces, "launches": launches[name]["main"],
             "launches_by_path": launches[name], "max_abs_err": err,
             "ms": times[name + "_ms"], "plain_ms": times[name + "_plain_ms"],
             "bound_ms": times[name + "_bound_ms"],
             "bound_by": times[name + "_bound_by"], "library_ms": library_ms,
             "library_note": library_note, "shape": shape,
             "checks": len(mine), "checks_ok": all(c["ok"] for c in mine)}
        r.update(extra)
        return r

    rec = {"T": T, "B": B, "H": H, "Kb": 8, "R": 2, "act": "tanh",
           "qbits": 16}
    train = list(GR_TRAIN_TBH)
    v3 = {"M": T * B, "K": 2048, "N": 1024, "G": 3, "Kb": 16, "R": 4,
          "qbits": 8, "fuse_sub": True}
    dense = "dense-masked torch.matmul %s, the JAX package's path at Kb < 16"
    return [
        row("fused_gru_fwd_sparse", "fused_gru_sparse", fr % 1443,
            times["cudnn_gru_fwd_ms"],
            "cuDNN nn.GRU(1024, 1024) forward at 32 rows: a yardstick "
            "(dense, no quantizer)",
            err_at("fused_gru_fwd_sparse", shape=train, qbits=16, w3g="f32"),
            rec, ms_q0=times["fused_gru_fwd_sparse_ms_q0"],
            plan=times["fused_gru_fwd_sparse_plan"],
            serve={"T": GR_SERVE_TBH[0], "B": GR_SERVE_TBH[1], "H": H,
                   "ms": times["serve_fwd_ms"],
                   "plain_ms": times["serve_fwd_plain_ms"],
                   "bound_ms": times["serve_fwd_bound_ms"],
                   "bound_by": times["serve_fwd_bound_by"],
                   "library_ms": times["cudnn_gru_serve_fwd_ms"],
                   "plan": times["serve_fwd_plan"]}),
        row("fused_gru_bwd_sparse", "fused_gru_sparse", fr % 1495,
            times["cudnn_gru_bwd_ms"],
            "cuDNN nn.GRU(1024, 1024) backward (fwd+bwd minus fwd)",
            err_at("fused_gru_bwd_sparse", shape=train, qbits=16, w3g="f32"),
            rec, plan=times["fused_gru_bwd_sparse_plan"],
            split=times["fused_gru_bwd_sparse_split"]),
        row("block_sparse_v3_fwd", "block_sparse_v3", bsp % 656,
            times["dense_masked_fwd_ms"],
            dense % "(6400, 2048) x (2048, 3072)",
            err_at("block_sparse_v3_fwd", G=3, K=2048, qbits=8), v3,
            serve={"M": GR_SERVE_TBH[0] * GR_SERVE_TBH[1],
                   "ms": times["serve_v3_fwd_ms"],
                   "bound_ms": times["serve_v3_fwd_bound_ms"],
                   "bound_by": times["serve_v3_fwd_bound_by"],
                   "library_ms": times["serve_dense_masked_fwd_ms"],
                   "ms_q0": times["serve_v3_fwd_ms_q0"],
                   "device_launches": times["serve_v3_fwd_device_launches"],
                   "max_abs_err": err_at("block_sparse_v3_fwd", G=3,
                                         K=2048, qbits=8,
                                         M=GR_SERVE_TBH[0] * GR_SERVE_TBH[1])},
            ms_q0=times["block_sparse_v3_fwd_ms_q0"],
            device_launches=times["block_sparse_v3_fwd_device_launches"]),
        row("block_sparse_v3_dx", "block_sparse_dx", bsp % 744,
            times["dense_masked_dx_ms"],
            dense % "(6400, 3072) x (3072, 2048)",
            err_at("block_sparse_v3_dx", G=3, K=2048, qbits=8), v3,
            v3_dw_ms=times["dw_libri_v3_G3_ms"],
            device_launches=times["block_sparse_v3_dx_device_launches"],
            kernels_ms=times["block_sparse_v3_dx_kernels_ms"],
            plan=times["block_sparse_v3_dx_plan"])]


# ---------------------------------------------------------------------------
# the TIMIT GRU slice: the dense fused GRU (serve, stream, train), and the
# sparse recurrences at a batch the JAX size rule keeps off them
# ---------------------------------------------------------------------------

def check_timit_gru(rnn):
    """The TIMIT GRU as the cfg ships it: 4x550, no sparse layout, every
    layer on the dense fused GRU."""
    if (list(rnn.lay) != [TG_TRAIN_TBH[2]] * TG_LAYERS or rnn._rec_layouts
            or rnn._bs_layouts
            or not all(rnn._fused_ok(i) for i in range(rnn.N))):
        raise AssertionError("the TIMIT GRU cfg did not build a 4x550 GRU "
                             "on the dense fused kernels")


def build_timit_gru_stack(dev, feat_dim=TG_FEAT):
    """The TIMIT GRU -> its 1944-way cd head (weights from init(0) /
    init(1), the head times TIMIT_GRU_HEAD_GAIN)."""
    from pytorch_kaldi_cgs_tpu_torch.models import GRU, MLP
    secs = cfg_sections(TIMIT_GRU_CFG)
    rnn = GRU(dict(secs["architecture1"], to_do="forward"), feat_dim,
              seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
              seed=1, device=dev)
    check_timit_gru(rnn)
    with torch.no_grad():
        mlp.params["w0"].mul_(TIMIT_GRU_HEAD_GAIN)
    return Stack(rnn, mlp).eval()


def phase_timit_gru_kernels(dev):
    """The dense GRU forward (plain, stash and seeded) and both BPTT
    kernels against their twins on the same tensors: qbits 0/16 x
    tanh/relu at the small ragged shape, the training shape, the serving
    shape (forward only) and H=1024 (T=6, 96 rows); each wrapper's
    launch counter must move by its launches. The forward runs on the
    route its plan names (gru_fwd_launches: persistent at the first three
    shapes, the step route at 96 rows), two calls bit for bit, its device
    kernels held to the route's (gru_fwd_design) once a shape; at the
    training shape the step route also runs forced
    (fused_rnn._gru_fwd_step). The stash BPTT (row 20) the same way
    (gru_bwd_stash_launches, gru_bwd_stash_design: persistent but at 96
    rows of 1024), two calls bit for bit; at the training shape also on
    the step route forced and at every other co-resident block shape of
    GRU_BWD_SHAPES, forced."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    checks = []

    def check(name, shape, variant, err_rel, tol, by_rel):
        record_check(checks, "timit_gru_kernels", name,
                     dict(zip("TBH", shape)), variant, err_rel, tol, by_rel)

    for shape in (SMALL_TBH, TG_TRAIN_TBH, TG_SERVE_TBH, TG_WIDE_TBH):
        T, B, H = shape
        small, serve = shape == SMALL_TBH, shape == TG_SERVE_TBH
        cases = [(q, a) for q in (0, 16) for a in ("tanh", "relu")]
        for k, (qbits, act) in enumerate(cases):
            inp = gated_inputs(T, B, H, 160 + k, dev, act, 3)
            g, U, drop, h0, dhs = (inp[n] for n in ("g", "U", "drop", "h0",
                                                    "dhs"))
            variant = {"qbits": qbits, "act": act}
            tol = TOL_F32_SMALL if small else TOL_F32_SERVE
            tol_q = TOL_Q16 if qbits else tol
            fwd = R.fused_gru_fwd
            route, n = gru_fwd_launches(dev, "fused_gru_fwd", T, B, H)
            n_seed = gru_fwd_launches(dev, "fused_gru_fwd", T, B, H, True,
                                      qbits)[1]
            fvar = dict(variant, route=route)
            with torch.no_grad():
                ref = R.fused_gru_fwd_plain(g, U, drop, None, act, qbits, True)
                ref_seed = R.fused_gru_fwd_plain(g, U, drop, h0, act, qbits)
                check("fused_gru_fwd", shape, fvar, rel_err(launched(
                    fwd, n, lambda: fwd(g, U, drop, act=act, qbits=qbits)),
                    ref[0]), tol_q, False)
                check("fused_gru_fwd/seeded", shape, fvar, rel_err(
                    launched(fwd, n_seed, lambda: fwd(g, U, drop, h0, act=act,
                                                      qbits=qbits)),
                    ref_seed), tol_q, False)
                check("fused_gru_fwd/determinism", shape, fvar, same_bits(
                    lambda: fwd(g, U, drop, h0, act=act, qbits=qbits,
                                stash=True)), 0.0, False)
                if k + 1 == len(cases):     # the kernels of the route
                    bptt_kernels(lambda: fwd(g, U, drop, h0, act=act,
                                             qbits=qbits),
                                 gru_fwd_design(route, T, True, qbits))
                if shape == TG_TRAIN_TBH:   # the step route, forced
                    svar = dict(variant, route="step")
                    st = launched(fwd, 2 * T, lambda: R._gru_fwd_step(
                        fwd, g, U, drop, None, act, qbits, True))
                    check("fused_gru_fwd/step_route/stash", shape, svar,
                          rel_err(st, ref), tol_q, False)
                    # both routes sum in one order: the same bits
                    check("fused_gru_fwd/persist_vs_step", shape, fvar,
                          bits_apart(fwd(g, U, drop, act=act, qbits=qbits,
                                         stash=True), st), 0.0, False)
                    check("fused_gru_fwd/step_route/seeded", shape, svar,
                          rel_err(launched(
                              fwd, 2 * T + int(qbits > 0),
                              lambda: R._gru_fwd_step(fwd, g, U, drop, h0,
                                                      act, qbits, False)),
                              ref_seed), tol_q, False)
                if serve:
                    continue
                hs, acts = launched(fwd, n, lambda: fwd(
                    g, U, drop, act=act, qbits=qbits, stash=True))
                check("fused_gru_fwd/stash", shape, fvar,
                      rel_err((hs, acts), ref), tol_q, False)
                h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                bw = R.fused_gru_bwd_stash
                b_route, n_bs = gru_bwd_stash_launches(dev, T, B, H)
                bvar = dict(variant, route=b_route)
                bcall = lambda: bw(acts, U, drop, h_prev, dhs, act)
                ref_bs = R.fused_gru_bwd_stash_plain(acts, U, drop, h_prev,
                                                     dhs, act)
                check("fused_gru_bwd_stash", shape, bvar, rel_err(
                    launched(bw, n_bs, bcall), ref_bs), tol, True)
                check("fused_gru_bwd_stash/determinism", shape, bvar,
                      same_bits(bcall), 0.0, False)
                if k + 1 == len(cases):     # the kernels of the route
                    bptt_kernels(bcall, gru_bwd_stash_design(b_route, T))
                if shape == TG_TRAIN_TBH:   # the step route and each shape
                    check("fused_gru_bwd_stash/step_route", shape,
                          dict(variant, route="step"), rel_err(launched(
                              bw, 2 * T, lambda: R._gru_bwd_step(
                                  bw, "fused_gru_bwd", 3, acts, U, drop,
                                  h_prev, dhs, act, 0, True)), ref_bs),
                          tol, True)
                    plan = R.gru_bwd_stash_plan(B, H)
                    for shape_ in R.GRU_BWD_SHAPES:
                        fp = R.gru_bwd_stash_plan(B, H, shape_)
                        if shape_ == (plan.bi, plan.units) or \
                                fp.smem > R._SMEM_MAX or not co_resident(
                                    "fused_gru_bwd_stash", fp):
                            continue
                        check("fused_gru_bwd_stash/forced", shape,
                              dict(variant, route="persist",
                                   plan="%d units x %d rows" % (
                                       fp.units, 8 * fp.bi)),
                              rel_err(launched(
                                  bw, 1, lambda: R._gru_bwd_stash_persist(
                                      fp, acts, U, drop, h_prev, dhs, act)),
                                  ref_bs), tol, True)
                check("fused_gru_bwd", shape, variant, rel_err(
                    launched(R.fused_gru_bwd, 2 * T + 2,
                             lambda: R.fused_gru_bwd(g, U, drop, h_prev, dhs,
                                                     act, qbits)),
                    R.fused_gru_bwd_plain(g, U, drop, h_prev, dhs, act,
                                          qbits)), tol_q, True)
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a dense GRU kernel disagrees with its plain "
                             "twin: %s" % bad)
    check_fwd_routes(checks, "fused_gru_fwd", {
        (SMALL_TBH, "persist"), (TG_TRAIN_TBH, "persist"),
        (TG_SERVE_TBH, "persist"), (TG_TRAIN_TBH, "step"),
        (TG_WIDE_TBH, "step")})
    check_fwd_routes(checks, "fused_gru_bwd_stash", {
        (SMALL_TBH, "persist"), (TG_TRAIN_TBH, "persist"),
        (TG_TRAIN_TBH, "step"), (TG_WIDE_TBH, "step")})
    return checks


def check_fwd_routes(checks, kernel, want):
    """Every (shape, route) of ``want`` among the checks of the routed
    ``kernel`` (a dense forward, or row 20's BPTT): both routes ran."""
    routes = {(tuple(c[k] for k in "TBH"), c["route"]) for c in checks
              if c["kernel"].split("/")[0] == kernel and "route" in c}
    if not want <= routes:
        raise AssertionError("%s ran on %s, not on %s" % (
            kernel, sorted(routes), sorted(want - routes)))


def timit_gru_expect_serve(T):
    """Launches per recognize: 4 layers of the dense GRU forward at 8
    rows, each its route's (gru_fwd_launches: 1 a call on the persistent
    route, 2T on the step route)."""
    return expected(fused_gru_fwd=TG_LAYERS * gru_fwd_launches(
        "cuda", "fused_gru_fwd", T, N_UTT, TG_TRAIN_TBH[2])[1])


def timit_gru_train_setup(compute_dtype=""):
    """The TIMIT GRU train step (chunk_setup): the cfg's sections, 8
    sentences of 300 frames, fMLLR x of width 40 and cd labels."""
    T, B, _ = TG_TRAIN_TBH
    return chunk_setup(cfg_sections(TIMIT_GRU_CFG, compute_dtype), T, B,
                       "fmllr", TG_FEAT, CD_LABELS)


def timit_gru_train_runner(dev, compute_dtype=""):
    """A ChunkRunner over the TIMIT GRU's sections and its one batch;
    ``runner.train_step(inp, mask, chip_smoke.dropout_gen())`` for masks
    that match the CPU's (the cfg has dropout 0.2)."""
    from pytorch_kaldi_cgs_tpu_torch.models import GRU
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = timit_gru_train_setup(compute_dtype)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    rnn = graph.nets["RNN_layers"]
    if type(rnn) is not GRU:
        raise AssertionError("the TIMIT GRU cfg did not build a GRU")
    check_timit_gru(rnn)
    return ChunkRunner(graph, config), batch


def phase_timit_gru_train(dev):
    """One train step on the card against the CPU with the stash backward
    (the default) and, from fresh runners, with the recompute one
    (PKC_LSTM_BWD_RECOMPUTE=1); launches per step in both, each routed
    kernel its route's; 10 steps at the cfg's learning rates in f32 and
    bf16."""
    T, B, H = TG_TRAIN_TBH
    n = TG_LAYERS * gru_fwd_launches(dev, "fused_gru_fwd", T, B, H)[1]
    out = phase_train(dev, timit_gru_train_runner, "timit_gru_train",
                      lstm_modes(T, expected(fused_gru_fwd=n,
                                             fused_gru_bwd_stash=(
                                                 TG_LAYERS *
                                                 gru_bwd_stash_launches(
                                                     dev, T, B, H)[1])),
                                 expected(fused_gru_fwd=n, fused_gru_bwd=(
                                     TG_LAYERS * (2 * T + 2)))))
    knob = "PKC_LSTM_BWD_RECOMPUTE"
    runner, (inp, mask) = timit_gru_train_runner(dev)
    with env(knob, "1"):
        loss_err = runner.train_step(inp, mask, dropout_gen())
    out["recompute_vs_cpu"] = card_vs_cpu(
        runner, timit_gru_train_runner("cpu")[0], inp, mask, loss_err, knob,
        "1", "timit_gru_train, recompute backward")
    return out


def first_layer(sec, prefix):
    """An architecture section cut to its first layer (the per-layer
    lists: widths, dropout, norms, activation, weight bits)."""
    keys = ["%s_%s" % (prefix, k) for k in ("lay", "drop", "use_laynorm",
                                            "use_batchnorm", "act")]
    return dict(sec, **{k: sec[k].split(",")[0]
                        for k in keys + ["param_quant"] if k in sec})


def phase_gru_large_batch(dev):
    """The sparse recurrences at a batch the JAX size rule keeps off its
    sparse kernels (it says "" from 158 rows for the libri GRU, 152 for
    the CGS-16x LSTM, 163 for the CGS-16x Li-GRU): the libri GRU's first
    layer over 80 utterances of T=398 (160 rows, both directions), the
    CGS-16x LSTM's over 160 and the CGS-16x Li-GRU's over CL_LARGE_ROWS.
    Each runs its sparse forward kernel alone, with float32 w3g (the
    scans read it in bf16 only where the rule says "bf16"), matching the
    model run on the sparse twin (the GRU's and the LSTM's on their routes
    there, gru_fwd_sparse_launches, lstm_fwd_sparse_launches); the sparse
    BPTT kernels take those batches too (T=16, against their twins)."""
    from pytorch_kaldi_cgs_tpu_torch.models import GRU, LSTM, liGRU
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T = SP_SERVE_TBH[0]
    x = torch.tensor(np.random.RandomState(170).randn(
        T, max(LARGE_ROWS, CL_LARGE_ROWS), TG_FEAT).astype(np.float32),
        device=dev)
    out, checks = {}, []
    for tag, cls, sections, prefix, G, mod, kernel, n, rows in (
            ("gru", GRU, gru_sections, "gru", 3, R, "fused_gru_fwd_sparse",
             2 * T, LARGE_ROWS),
            ("lstm", LSTM, cgs_sections, "lstm", 4, F,
             "fused_lstm_fwd_sparse", T, LARGE_ROWS),
            ("ligru", liGRU, cgs_ligru_sections, "ligru", 2, R,
             "fused_ligru_fwd_sparse", T, CL_LARGE_ROWS)):
        sec = first_layer(sections()["architecture1"], prefix)
        net = cls(dict(sec, to_do="forward"), TG_FEAT, seed=0,
                  device=dev).eval()
        layout = net._rec_layouts.get(0)
        B = rows // 2 if net.bidir else rows
        if layout is None or F.sparse_scan_fits(rows, layout.N, layout,
                                                G) != "":
            raise AssertionError("%s: no sparse layout, or one the JAX size "
                                 "rule keeps at %d rows" % (tag, rows))
        with torch.inference_mode():
            y, launches = counted(lambda: net(x[:, :B]))
            with swapped(mod, kernel, getattr(mod, kernel + "_plain")):
                y_plain = net(x[:, :B])
        if tag == "gru":            # the forward's route at that batch
            route, n = gru_fwd_sparse_launches(dev, T, B, layout)
            out["gru_forward_route"] = route
        if tag == "lstm":
            route, n = lstm_fwd_sparse_launches(dev, T, B, layout)
            out["lstm_forward_route"] = route
        if launches != expected(**{kernel: n}):
            raise AssertionError("gru_large_batch %s: launches %s" % (tag,
                                                                    launches))
        record_check(checks, "gru_large_batch", kernel + "/model",
                     {"T": T, "rows": rows}, {"Kb": layout.Kb, "R": layout.R},
                     rel_err(y, y_plain), TOL_Q16, False)
        out[tag] = {"rows": rows, "launches": launches[kernel]}
    # the sparse BPTT kernels at those batches
    gi = gru_inputs(16, LARGE_ROWS, 1024, 171, dev)
    si = sparse_inputs(16, LARGE_ROWS, 1024, 172, dev)
    li = cgs_ligru_inputs(16, CL_LARGE_ROWS, 1024, 173, dev, "relu")
    with torch.no_grad():
        hs = R.fused_gru_fwd_sparse(gi["g"], gi["w3g"], gi["drop"],
                                    gi["layout"], "tanh", 16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        args = (gi["g"], gi["w3g"], gi["drop"], h_prev, gi["dhs"],
                gi["layout"], "tanh", 16)
        record_check(checks, "gru_large_batch", "fused_gru_bwd_sparse",
                     {"T": 16, "rows": LARGE_ROWS}, {
                         "qbits": 16, "route": bptt_route(
                             dev, LARGE_ROWS, layout=gi["layout"])[0]},
                     rel_err(
                         R.fused_gru_bwd_sparse(*args),
                         R.fused_gru_bwd_sparse_plain(*args)), TOL_Q16, True)
        lay = si["layout"]
        hs, cs, acts = F.fused_lstm_fwd_sparse(si["g"], si["w3g"], si["drop"],
                                               lay, stash=True)
        h_prev, c_prev = shifted(hs, cs, None, None)
        a_st = (acts, si["w3g"], si["drop"], cs, c_prev, si["dhs"], lay)
        a_rc = (si["g"], si["w3g"], si["drop"], h_prev, c_prev, si["dhs"],
                lay)
        record_check(checks, "gru_large_batch", "fused_lstm_bwd_sparse_stash",
                     {"T": 16, "rows": LARGE_ROWS}, {
                         "qbits": 0, "route": chain_route(
                             dev, "fused_lstm_bwd_sparse_stash", LARGE_ROWS,
                             layout=lay)[0]}, rel_err(
                         F.fused_lstm_bwd_sparse_stash(*a_st),
                         F.fused_lstm_bwd_sparse_stash_plain(*a_st)),
                     TOL_F32_SERVE, True)
        record_check(checks, "gru_large_batch", "fused_lstm_bwd_sparse",
                     {"T": 16, "rows": LARGE_ROWS}, {"qbits": 0}, rel_err(
                         F.fused_lstm_bwd_sparse(*a_rc),
                         F.fused_lstm_bwd_sparse_plain(*a_rc)),
                     TOL_F32_SERVE, True)
        hs = R.fused_ligru_fwd_sparse(li["g"], li["w3g"], li["drop"],
                                      li["layout"], "relu", 16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        args = (li["g"], li["w3g"], li["drop"], h_prev, li["dhs"],
                li["layout"], "relu", 16)
        record_check(checks, "gru_large_batch", "fused_ligru_bwd_sparse",
                     {"T": 16, "rows": CL_LARGE_ROWS}, {"qbits": 16},
                     rel_err(R.fused_ligru_bwd_sparse(*args),
                             R.fused_ligru_bwd_sparse_plain(*args)),
                     TOL_Q16, True)
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("gru_large_batch: %s" % bad)
    out["checks"] = checks
    return out


def phase_timit_gru_times(dev, rec, audio, lens):
    """CUDA-event times of the dense GRU kernels per layer call at the
    training shape (the forward also at the serving shape), as the cfg
    runs them (tanh, no quantizer); their twins and bounds; row 20's route
    and plan and its other co-resident block shapes, forced; cuDNN's
    nn.GRU(550, 550) as a yardstick; the dU matmuls; the TIMIT GRU train
    step and recognize."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = TG_TRAIN_TBH
    act = "tanh"
    inp = gated_inputs(T, B, H, 175, dev, act, 3)
    g, U, drop, dhs = (inp[n] for n in ("g", "U", "drop", "dhs"))
    times = {}
    with torch.no_grad():
        hs, acts = R.fused_gru_fwd(g, U, drop, act=act, stash=True)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        calls = {
            "fused_gru_fwd": (
                lambda: R.fused_gru_fwd(g, U, drop, act=act, stash=True),
                lambda: R.fused_gru_fwd_plain(g, U, drop, None, act, 0, True),
                "fwd_stash"),
            "fused_gru_bwd_stash": (
                lambda: R.fused_gru_bwd_stash(acts, U, drop, h_prev, dhs,
                                              act),
                lambda: R.fused_gru_bwd_stash_plain(acts, U, drop, h_prev,
                                                    dhs, act), "bwd_stash"),
            "fused_gru_bwd": (
                lambda: R.fused_gru_bwd(g, U, drop, h_prev, dhs, act),
                lambda: R.fused_gru_bwd_plain(g, U, drop, h_prev, dhs, act),
                "bwd_dense")}
        for name, (fn, plain, kind) in calls.items():
            times[name + "_ms"] = cuda_ms(fn, reps=10)
            times[name + "_plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                gru_bound_ms(T, B, H, H, kind)
        times["fused_gru_fwd_nostash_ms"] = cuda_ms(
            lambda: R.fused_gru_fwd(g, U, drop, act=act), reps=10)
        times["fused_gru_fwd_plan"] = chain_route(dev, "fused_gru_fwd", B,
                                                  H)[1]
        times["fused_gru_fwd_ms_q16"] = cuda_ms(
            lambda: R.fused_gru_fwd(g, U, drop, act=act, qbits=16,
                                    stash=True), reps=10)
        # row 20: its route and plan, each other block shape forced
        route, plan = chain_route(dev, "fused_gru_bwd_stash", B, H)
        times["fused_gru_bwd_stash_kernel_route"] = {
            "train": {"route": route, "plan": plan}}
        times["fused_gru_bwd_stash_by_block_shape"] = forced_plan_ms(
            "fused_gru_bwd_stash", lambda shape_, run=False: (
                R._gru_bwd_stash_persist(R.gru_bwd_stash_plan(B, H, shape_),
                                         acts, U, drop, h_prev, dhs, act)
                if run else R.gru_bwd_stash_plan(B, H, shape_)), 10,
            [s_ for s_ in getattr(R, "GRU_BWD_SHAPES", ())
             if s_ != (plan.get("batch_rows_per_block", 0) // 8,
                       plan.get("units_per_block"))])
        Ts, Bs, _ = TG_SERVE_TBH
        sv = gated_inputs(Ts, Bs, H, 176, dev, act, 3)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_gru_fwd(sv["g"], sv["U"], sv["drop"], act=act),
            reps=10)
        times["serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_gru_fwd_plain(sv["g"], sv["U"], sv["drop"], None,
                                          act, 0), reps=2, warmup=1)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            gru_bound_ms(Ts, Bs, H, H, "fwd")
        # the dU products outside the BPTT kernel: (H, T*B) @ (T*B, H) for
        # Uh over q(s), (2H, T*B) @ (T*B, H) for [Uz; Ur] over q(h_prev)
        dg = torch.randn(T * B, 3 * H, device=dev)
        sq, hq = (torch.randn(T * B, H, device=dev) for _ in range(2))
        times["dU_matmul_ms"] = cuda_ms(
            lambda: torch.cat([dg[:, :H].T @ sq, dg[:, H:].T @ hq]), reps=20)
    times.update(cudnn_times(dev, T, B, H, Ts, Bs))
    print("[timit_gru_times] kernels at T=%d B=%d H=%d (tanh, no quantizer): "
          "%s" % (T, B, H, json.dumps(times)))
    step = train_step_times(dev, timit_gru_train_runner, "timit_gru_times", 5,
                            3)
    serve = serve_timings(rec, audio, lens)
    print("[timit_gru_times] TIMIT GRU recognizer (8 x 4 s batch): %s"
          % json.dumps(serve))
    return times, step, serve


# ---------------------------------------------------------------------------
# the TIMIT RNN slice: the dense fused RNN (serve, stream, train), and the
# cuDNN-class wrappers on the ported kernels
# ---------------------------------------------------------------------------

def check_timit_rnn(rnn, act="relu"):
    """The TIMIT RNN as the cfg ships it: 4x550 relu (or ``act``), no
    sparse layout, every layer on the dense fused RNN."""
    if (list(rnn.lay) != [TR_TRAIN_TBH[2]] * TR_LAYERS or rnn._rec_layouts
            or rnn._bs_layouts or set(rnn.act_names) != {act}
            or not all(rnn._fused_ok(i) for i in range(rnn.N))):
        raise AssertionError("the TIMIT RNN cfg did not build a 4x550 %s "
                             "RNN on the dense fused kernels" % act)


def build_timit_rnn_stack(dev, feat_dim=TR_FEAT):
    """The TIMIT RNN -> its 1944-way cd head (weights from init(0) /
    init(1), the head times TIMIT_RNN_HEAD_GAIN)."""
    from pytorch_kaldi_cgs_tpu_torch.models import MLP, RNN
    secs = cfg_sections(TIMIT_RNN_CFG)
    rnn = RNN(dict(secs["architecture1"], to_do="forward"), feat_dim,
              seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
              seed=1, device=dev)
    check_timit_rnn(rnn)
    with torch.no_grad():
        mlp.params["w0"].mul_(TIMIT_RNN_HEAD_GAIN)
    return Stack(rnn, mlp).eval()


def phase_timit_rnn_kernels(dev):
    """The dense RNN forward (plain, stash and seeded) and both BPTT
    kernels against their twins on the same tensors: qbits 0/16 x
    tanh/relu at the small ragged shape (a (B, H) mask and the eval
    scalar), the training shape (mask), the serving shape (the eval
    scalar; forward only) and H=1024 (T=6, 96 rows; the scalar); the
    seeded forward from h_{k-1} against the zero-state forward's steps
    k..T-1; each wrapper's launch counter must move by its launches. The
    forward runs on the route its plan names (rnn_fwd_launches:
    persistent but at 96 rows of 1024), two calls bit for bit, its device
    kernels held to the route's (rnn_fwd_design) once a shape; at the
    training shape also on the step route forced, whose bits the
    persistent route must give in every variant (zero and seeded, stash
    and not, qbits 0 and 16, tanh and relu), also forced to every other
    co-resident block shape of RNN_FWD_SHAPES; and at the CGS-16x RNN's
    dense stream shape (a seeded chunk of 100 frames at 8 rows of 1024,
    relu, qbits 16) both routes, bit for bit, against the twin."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    checks = []

    def check(name, shape, variant, err_rel, tol, by_rel):
        record_check(checks, "timit_rnn_kernels", name,
                     dict(zip("TBH", shape)), variant, err_rel, tol, by_rel)

    drops = {SMALL_TBH: ("(B,H)", "(1,1)"), TR_TRAIN_TBH: ("(B,H)",),
             TR_SERVE_TBH: ("(1,1)",), TR_WIDE_TBH: ("(1,1)",)}
    k = 0
    for shape, shape_drops in drops.items():
        T, B, H = shape
        small, serve = shape == SMALL_TBH, shape == TR_SERVE_TBH
        cases = [(q, a, d) for q in (0, 16) for a in ("tanh", "relu")
                 for d in shape_drops]
        for qbits, act, dname in cases:
            k += 1
            inp = gated_inputs(T, B, H, 180 + k, dev, act, 1)
            g, U, h0, dhs = (inp[n] for n in ("g", "U", "h0", "dhs"))
            drop = (inp["drop"] if dname == "(B,H)"
                    else torch.full((1, 1), 0.8, device=dev))
            variant = {"qbits": qbits, "act": act, "drop": dname}
            tol = TOL_F32_SMALL if small else TOL_F32_SERVE
            tol_q = TOL_Q16 if qbits else tol
            fwd = R.fused_rnn_fwd
            route, n = rnn_fwd_launches(dev, T, B, H)
            fvar = dict(variant, route=route)
            with torch.no_grad():
                ref = R.fused_rnn_fwd_plain(g, U, drop, None, act, qbits, True)
                hs = launched(fwd, n, lambda: fwd(g, U, drop, act=act,
                                                  qbits=qbits))
                check("fused_rnn_fwd", shape, fvar, rel_err(hs, ref[0]),
                      tol_q, False)
                check("fused_rnn_fwd/seeded", shape, fvar, rel_err(
                    launched(fwd, n, lambda: fwd(g, U, drop, h0, act=act,
                                                 qbits=qbits)),
                    R.fused_rnn_fwd_plain(g, U, drop, h0, act, qbits)),
                    tol_q, False)
                s = T // 2          # seeded from h_{s-1}: steps s..T-1
                check("fused_rnn_fwd/seeded_vs_shifted", shape, fvar,
                      rel_err(launched(
                          fwd, rnn_fwd_launches(dev, T - s, B, H)[1],
                          lambda: fwd(g[s:].contiguous(), U, drop,
                                      hs[s - 1].contiguous(), act=act,
                                      qbits=qbits)), hs[s:]), tol_q, False)
                check("fused_rnn_fwd/determinism", shape, fvar, same_bits(
                    lambda: fwd(g, U, drop, h0, act=act, qbits=qbits,
                                stash=True)), 0.0, False)
                if (qbits, act) == (16, "relu"):    # the route's kernels
                    bptt_kernels(lambda: fwd(g, U, drop, h0, act=act,
                                             qbits=qbits),
                                 rnn_fwd_design(route, T, True, qbits))
                if shape == TR_TRAIN_TBH:
                    rnn_fwd_step_checks(check, shape, variant, g, U, drop,
                                        h0, act, qbits, tol_q)
                if serve:
                    continue
                hs_s, acts = launched(fwd, n, lambda: fwd(
                    g, U, drop, act=act, qbits=qbits, stash=True))
                check("fused_rnn_fwd/stash", shape, fvar,
                      rel_err((hs_s, acts), ref), tol_q, False)
                h_prev = torch.cat([torch.zeros_like(hs_s[:1]), hs_s[:-1]])
                check("fused_rnn_bwd_stash", shape, variant, rel_err(
                    launched(R.fused_rnn_bwd_stash, T,
                             lambda: R.fused_rnn_bwd_stash(
                                 acts, U, drop, dhs, act)),
                    R.fused_rnn_bwd_stash_plain(acts, U, drop, dhs, act)),
                    tol, True)
                # row 29 on the route its plan names, its launches, two
                # calls bit for bit, its device kernels once a shape
                b_route, n_b = rnn_bwd_launches(dev, T, B, H, qbits)
                bvar = dict(variant, route=b_route)
                bcall = lambda: R.fused_rnn_bwd(g, U, drop, h_prev, dhs, act,
                                                qbits)
                ref_b = R.fused_rnn_bwd_plain(g, U, drop, h_prev, dhs, act,
                                              qbits)
                check("fused_rnn_bwd", shape, bvar, rel_err(
                    launched(R.fused_rnn_bwd, n_b, bcall), ref_b), tol_q,
                    True)
                check("fused_rnn_bwd/determinism", shape, bvar,
                      same_bits(bcall), 0.0, False)
                if (qbits, act) == (16, "relu"):
                    bptt_kernels(bcall, rnn_bwd_design(b_route, T, qbits))
                if shape == TR_TRAIN_TBH:
                    rnn_bwd_step_checks(check, shape, variant, g, U, drop,
                                        h_prev, dhs, act, qbits, ref_b,
                                        tol_q)
    # the CGS-16x RNN's dense stream: a seeded chunk of 100 at 8 rows of
    # 1024, relu behind the 16-bit quantizer, on both routes
    T, B, H = 100, RS_TRAIN_TBH[1], RS_TRAIN_TBH[2]
    inp = gated_inputs(T, B, H, 199, dev, "relu", 1)
    g, U, drop, h0 = (inp[n] for n in ("g", "U", "drop", "h0"))
    variant = {"qbits": 16, "act": "relu", "drop": "(B,H)"}
    with torch.no_grad():
        route, n = rnn_fwd_launches(dev, T, B, H)
        check("fused_rnn_fwd/seeded", (T, B, H), dict(variant, route=route),
              rel_err(launched(R.fused_rnn_fwd, n, lambda: R.fused_rnn_fwd(
                  g, U, drop, h0, act="relu", qbits=16)),
                  R.fused_rnn_fwd_plain(g, U, drop, h0, "relu", 16)),
              TOL_Q16, False)
        rnn_fwd_step_checks(check, (T, B, H), variant, g, U, drop, h0,
                            "relu", 16, TOL_Q16, shapes=False)
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a dense RNN kernel disagrees with its plain "
                             "twin: %s" % bad)
    check_fwd_routes(checks, "fused_rnn_fwd", {
        (SMALL_TBH, "persist"), (TR_TRAIN_TBH, "persist"),
        (TR_SERVE_TBH, "persist"), (TR_TRAIN_TBH, "step"),
        (TR_WIDE_TBH, "step"), ((T, B, H), "persist"), ((T, B, H), "step")})
    check_fwd_routes(checks, "fused_rnn_bwd", {
        (SMALL_TBH, "persist"), (TR_TRAIN_TBH, "persist"),
        (TR_TRAIN_TBH, "step"), (TR_WIDE_TBH, "step")})
    return checks


def rnn_bwd_step_checks(check, shape, variant, g, U, drop, h_prev, dhs, act,
                        qbits, ref, tol):
    """Row 29's step route forced (fused_rnn._rnn_bwd_step) against the
    twin, the route the wrapper takes bit for bit equal to it (the chain's
    dots are rnn_bwd_step's sums), and each co-resident block shape of
    RNN_BWD_SHAPES forced onto the persistent route, bit for bit."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = shape
    w = R.fused_rnn_bwd
    route = rnn_bwd_launches("cuda", T, B, H, qbits)[0]
    st = launched(w, T + 1, lambda: R._rnn_bwd_step(
        w, g, U, drop, h_prev, dhs, act, qbits, False))
    check("fused_rnn_bwd/step_route", shape, dict(variant, route="step"),
          rel_err(st, ref), tol, True)
    check("fused_rnn_bwd/%s_vs_step" % route, shape,
          dict(variant, route=route), bits_apart(
              w(g, U, drop, h_prev, dhs, act, qbits), st), 0.0, False)
    for shape_ in R.RNN_BWD_SHAPES:
        fp = R.rnn_bwd_plan(B, H, shape_)
        if fp.smem > R._SMEM_MAX or not co_resident("fused_rnn_bwd", fp):
            continue
        check("fused_rnn_bwd/forced_vs_step", shape, dict(
            variant, route="persist", plan="%d units x %d rows" % (
                fp.units, 8 * fp.bi)), bits_apart(launched(
                    w, RNN_BWD_PERSIST_LAUNCHES[qbits > 0],
                    lambda: R._rnn_bwd_persist(fp, g, U, drop, h_prev, dhs,
                                               act, qbits)), st), 0.0, False)


def rnn_fwd_step_checks(check, shape, variant, g, U, drop, h0, act, qbits,
                        tol, shapes=True):
    """Row 27's step route forced (fused_rnn._rnn_fwd_step) against the
    twin, and the route the wrapper takes bit for bit equal to it, zero
    and seeded, stash and not (the persistent route gives the step
    route's bits); with ``shapes`` also each other co-resident block shape
    of RNN_FWD_SHAPES forced, bit for bit, with the stash."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = shape
    fwd = R.fused_rnn_fwd
    svar = dict(variant, route="step")
    route = rnn_fwd_launches("cuda", T, B, H)[0]
    for seed in (None, h0):
        carry = "seeded" if seed is not None else "zero"
        for stash in (False, True):
            st = launched(fwd, T, lambda: R._rnn_fwd_step(
                g, U, drop, seed, act, qbits, stash))
            check("fused_rnn_fwd/step_route/%s%s" % (
                carry, "/stash" if stash else ""), shape, svar, rel_err(
                    st, R.fused_rnn_fwd_plain(g, U, drop, seed, act, qbits,
                                              stash)), tol, False)
            check("fused_rnn_fwd/%s_vs_step/%s%s" % (
                route, carry, "/stash" if stash else ""), shape,
                dict(variant, route=route), bits_apart(fwd(
                    g, U, drop, seed, act=act, qbits=qbits, stash=stash),
                    st), 0.0, False)
            if not (shapes and stash):
                continue
            plan = R.rnn_fwd_plan(B, H)
            for shape_ in R.RNN_FWD_SHAPES:
                fp = R.rnn_fwd_plan(B, H, shape_)
                if shape_ == (plan.bi, plan.units) or \
                        fp.smem > R._SMEM_MAX or not co_resident(
                            "fused_rnn_fwd", fp):
                    continue
                check("fused_rnn_fwd/forced_vs_step/%s/stash" % carry, shape,
                      dict(variant, route="persist", plan="%d units x %d rows"
                           % (fp.units, 8 * fp.bi)), bits_apart(launched(
                               fwd, 1, lambda: R._rnn_fwd_persist(
                                   fp, g, U, drop, seed, act, qbits, True)),
                               st), 0.0, False)


def timit_rnn_expect_serve(T):
    """Launches per recognize: 4 layers of the dense RNN forward at 8
    rows, each its route's (rnn_fwd_launches: 1 a call on the persistent
    route, T on the step route), no other kernel."""
    return expected(fused_rnn_fwd=TR_LAYERS * rnn_fwd_launches(
        "cuda", T, N_UTT, TR_TRAIN_TBH[2])[1])


def timit_rnn_train_setup(compute_dtype="", lr_scale=1.0, act="relu"):
    """The TIMIT RNN train step (chunk_setup): the cfg's sections (its
    relu, or ``act`` on every layer), 8 sentences of 300 frames, fMLLR x
    of width 40 and cd labels."""
    T, B, _ = TR_TRAIN_TBH
    secs = cfg_sections(TIMIT_RNN_CFG, compute_dtype, lr_scale)
    if act != "relu":
        secs["architecture1"]["rnn_act"] = ",".join([act] * TR_LAYERS)
    return chunk_setup(secs, T, B, "fmllr", TR_FEAT, CD_LABELS)


def timit_rnn_train_runner(dev, compute_dtype="", lr_scale=1.0,
                           act="relu"):
    """A ChunkRunner over the TIMIT RNN's sections and its one batch;
    ``runner.train_step(inp, mask, chip_smoke.dropout_gen())`` for masks
    that match the CPU's (the cfg has dropout 0.2)."""
    from pytorch_kaldi_cgs_tpu_torch.models import RNN
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = timit_rnn_train_setup(compute_dtype, lr_scale, act)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    rnn = graph.nets["RNN_layers"]
    if type(rnn) is not RNN:
        raise AssertionError("the TIMIT RNN cfg did not build an RNN")
    check_timit_rnn(rnn, act)
    return ChunkRunner(graph, config), batch


def phase_timit_rnn_train(dev):
    """One train step on the card against the CPU with the recompute
    backward (the default) and, from fresh runners, with the stash one
    (PKC_BWD_STASH_CELLS=rnn); launches per step in both; 10 steps at
    TR_FALL_LR_SCALE times the cfg's learning rates in f32 and bf16, and
    TR_CFG_LR_STEPS at the cfg's own (printed, not checked).

    The relu recurrence has ~5M pre-activations a step, some within an
    ulp of 0, where relu's derivative flips between the card's sums and
    the CPU's: the shipped cfg's gradients are held to GRAD_FLIP_K times
    the CPU's own worst change under a one-ulp change of x (measured in
    the run, at least TOL_GRAD_REL), as the Li-GRU's; the same step with
    rnn_act=tanh (no flips) to TOL_GRAD_REL, with both backwards."""
    T, B, H = TR_TRAIN_TBH
    n = TR_LAYERS * rnn_fwd_launches(dev, T, B, H)[1]
    knob = "PKC_BWD_STASH_CELLS"
    inp, mask = timit_rnn_train_setup()[2]
    sens, where = ulp_sensitivity(timit_rnn_train_runner, inp, mask,
                                  TR_FEAT)
    grad_tol = max(TOL_GRAD_REL, GRAD_FLIP_K * sens)
    print("[timit_rnn_train] the CPU's own gradients under a one-ulp change "
          "of x: worst rel change %.3g at %s; card vs CPU bar %.3g"
          % (sens, where, grad_tol))
    out = phase_train(dev, timit_rnn_train_runner, "timit_rnn_train", (
        ("recompute", knob, None,
         expected(fused_rnn_fwd=n, fused_rnn_bwd=TR_LAYERS * rnn_bwd_launches(
             dev, T, B, H)[1])),
        ("stash", knob, "rnn",
         expected(fused_rnn_fwd=n, fused_rnn_bwd_stash=TR_LAYERS * T))),
        grad_tol=grad_tol, fall_runner=lambda d, cdt="":
        timit_rnn_train_runner(d, cdt, TR_FALL_LR_SCALE))
    out.update(cpu_ulp_grad_rel_change=sens, cpu_ulp_worst=where)
    runner, (inp, mask) = timit_rnn_train_runner(dev)
    cfg_lr = [float(runner.train_step(inp, mask)[0])
              for _ in range(TR_CFG_LR_STEPS)]
    out["losses_f32_cfg_lr"] = [v if np.isfinite(v) else str(v)
                                for v in cfg_lr]
    print("[timit_rnn_train] f32 at the cfg's learning rates: loss %s"
          % ["%.4f" % v for v in cfg_lr])
    runner, (inp, mask) = timit_rnn_train_runner(dev)
    with env(knob, "rnn"):
        loss_err = runner.train_step(inp, mask, dropout_gen())
    out["stash_vs_cpu"] = card_vs_cpu(
        runner, timit_rnn_train_runner("cpu")[0], inp, mask, loss_err, knob,
        "rnn", "timit_rnn_train, stash backward", grad_tol)

    def tanh(d, cdt=""):
        return timit_rnn_train_runner(d, cdt, act="tanh")
    for name, value in (("recompute", None), ("stash", "rnn")):
        runner, (inp, mask) = tanh(dev)
        with env(knob, value):
            loss_err = runner.train_step(inp, mask, dropout_gen())
        out["tanh_%s_vs_cpu" % name] = card_vs_cpu(
            runner, tanh("cpu")[0], inp, mask, loss_err, knob, value,
            "timit_rnn_train, rnn_act=tanh, %s backward" % name)
    return out


def cudnn_wrapper(dev, name, H, extra, layers=2, bidir=True):
    """A cuDNN-class wrapper as a user builds it: ``layers`` of H, both
    directions (or one), inter-layer dropout 0.2, over the fMLLR
    width."""
    from pytorch_kaldi_cgs_tpu_torch import models
    opts = dict({"hidden_size": str(H), "num_layers": str(layers),
                 "bidirectional": str(bidir), "dropout": "0.2",
                 "bias": "True", "arch_name": name}, **extra)
    return getattr(models, name)(opts, TR_FEAT, seed=0, device=dev)


def phase_cudnn_wrappers(dev):
    """RNN_cudnn (2x550 relu), LSTM_cudnn (2x512) and GRU_cudnn (2x550),
    bidirectional, at T=300 over 8 sentences: eval and a train-mode
    forward + backward on the card, launch counters set to 0 just before and read just after
    each (only the ported kernels: 4 layer calls a direction pair, the
    default backward), against the same model on the CPU: outputs within
    TOL_F32_SERVE, every gradient within TOL_GRAD_REL of its scale."""
    T, B, _ = TR_TRAIN_TBH
    x = torch.tensor(np.random.RandomState(7).randn(T, B, TR_FEAT)
                     .astype(np.float32))
    dy = torch.tensor(np.random.RandomState(8).randn(T, B, 1100)
                      .astype(np.float32) * 0.01)
    out = {}
    for name, H, extra in CUDNN_CASES:
        cell = {"RNN_cudnn": "rnn", "LSTM_cudnn": "lstm",
                "GRU_cudnn": "gru_torch"}[name]
        # the LSTM's and the RNN's layer calls on their routes (one
        # launch a call on the persistent route), the GRU's a launch a step
        fwd = 4 * {"lstm": lambda: lstm_fwd_launches(dev, T, B, H)[1],
                   "rnn": lambda: rnn_fwd_launches(dev, T, B, H)[1],
                   "gru_torch": lambda: T}[cell]()
        want_eval = expected(**{"fused_%s_fwd" % cell: fwd})
        want_train = expected(**{
            "rnn": {"fused_rnn_fwd": fwd, "fused_rnn_bwd":
                    4 * rnn_bwd_launches(dev, T, B, H)[1]},
            "lstm": {"fused_lstm_fwd": fwd, "fused_lstm_bwd_stash":
                     4 * lstm_bwd_stash_launches(dev, T, B, H)[1]},
            "gru_torch": {"fused_gru_torch_fwd": 4 * T,
                          "fused_gru_torch_bwd": 4 * gru_torch_bwd_launches(
                              dev, T, B, H)}}[cell])

        def run(d):
            """-> (eval y, train y, grads, eval and train launches)."""
            model = cudnn_wrapper(d, name, H, extra)
            xd, dyd = x.to(d), dy[..., :2 * H].to(d)
            count = counted if d == dev else (lambda fn: (fn(), None))

            def train():
                y = model.run(xd, train=True, generator=dropout_gen())
                y.backward(dyd)
                return y.detach()
            with torch.no_grad():
                y_eval, l_eval = count(lambda: model.run(xd, train=False))
            y_train, l_train = count(train)
            return (y_eval.cpu(), y_train.cpu(),
                    {k: p.grad.cpu() for k, p in model.params.items()},
                    l_eval, l_train)
        ye, yt, gd, l_eval, l_train = run(dev)
        ye_c, yt_c, gc, _, _ = run("cpu")
        if l_eval != want_eval or l_train != want_train:
            raise AssertionError("%s launched %s (eval), %s (train); "
                                 "expected %s, %s" % (
                                     name, l_eval, l_train, want_eval,
                                     want_train))
        grad_errs = {k: float((gd[k] - gc[k]).abs().max())
                     / max(float(gc[k].abs().max()), 1e-30) for k in gc}
        worst = max(grad_errs, key=grad_errs.get)
        r = {"H": H, "eval_max_abs_err": float((ye - ye_c).abs().max()),
             "train_max_abs_err": float((yt - yt_c).abs().max()),
             "grads_compared": len(grad_errs),
             "grad_rel_err_max": grad_errs[worst], "grad_rel_err_worst": worst,
             "launches_eval": {k: v for k, v in l_eval.items() if v},
             "launches_train": {k: v for k, v in l_train.items() if v}}
        print("[cudnn_wrappers] %s: %s" % (name, json.dumps(r)))
        if not (r["eval_max_abs_err"] <= TOL_F32_SERVE
                and r["train_max_abs_err"] <= TOL_F32_SERVE
                and r["grad_rel_err_max"] <= TOL_GRAD_REL):
            raise AssertionError("%s on the card disagrees with the CPU"
                                 % name)
        out[name] = r
    return out


def rnn_bound_ms(T, B, H, kind, kept=None):
    """Least time for one RNN layer call in float32: each input read
    once, each output written once, over the HBM rate; the FMAs of its
    (B, H) x (H, kept) products over the float32 peak. kind: "fwd"
    (gates, U, drop in; hs out), "fwd_stash" (and the (T, B, H) stash
    out), "bwd_stash" (stash, U, drop, dhs in; dg out; one product per
    step), "bwd" (gates, U, drop, h_prev, dhs in; dg out; that product
    and the forward's). ``kept``: the block-sparse recurrence's R*bs
    kept columns per row of U (w3g is (H, kept) in all), None for the
    dense U."""
    kept = H if kept is None else kept
    seq = T * B * H * 4
    nbytes = {"fwd": 2 * seq, "fwd_stash": 3 * seq, "bwd_stash": 3 * seq,
              "bwd": 4 * seq}[kind]
    return roofline_ms(nbytes + H * kept * 4 + B * H * 4,
                       2 * T * B * H * kept * (2 if kind == "bwd" else 1))


def phase_timit_rnn_times(dev, rec, audio, lens):
    """CUDA-event times of the dense RNN kernels per layer call at the
    training shape (the forward also at the serving shape, with the eval
    scalar), as the cfg runs them (relu, no quantizer); their twins and
    bounds; row 27's routes and plans (train, serve, the CGS-16x RNN's
    dense stream, a seeded chunk of which is timed) and its other
    co-resident block shapes at the train shape, forced; row 29's route
    and plan at the train shape and RNN_cudnn's, its rebuild / chain
    split and its other co-resident block shapes, forced; cuDNN's
    nn.RNN(550, 550, nonlinearity="relu") as a yardstick; the dU matmul;
    the TIMIT RNN train step and recognize."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = TR_TRAIN_TBH
    act = "relu"
    inp = gated_inputs(T, B, H, 195, dev, act, 1)
    g, U, drop, dhs = (inp[n] for n in ("g", "U", "drop", "dhs"))
    times = {}
    with torch.no_grad():
        hs, acts = R.fused_rnn_fwd(g, U, drop, act=act, stash=True)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        calls = {
            "fused_rnn_fwd": (
                lambda: R.fused_rnn_fwd(g, U, drop, act=act, stash=True),
                lambda: R.fused_rnn_fwd_plain(g, U, drop, None, act, 0, True),
                "fwd_stash"),
            "fused_rnn_bwd_stash": (
                lambda: R.fused_rnn_bwd_stash(acts, U, drop, dhs, act),
                lambda: R.fused_rnn_bwd_stash_plain(acts, U, drop, dhs, act),
                "bwd_stash"),
            "fused_rnn_bwd": (
                lambda: R.fused_rnn_bwd(g, U, drop, h_prev, dhs, act),
                lambda: R.fused_rnn_bwd_plain(g, U, drop, h_prev, dhs, act),
                "bwd")}
        for name, (fn, plain, kind) in calls.items():
            times[name + "_ms"] = cuda_ms(fn, reps=10)
            times[name + "_plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                rnn_bound_ms(T, B, H, kind)
        times["fused_rnn_fwd_nostash_ms"] = cuda_ms(
            lambda: R.fused_rnn_fwd(g, U, drop, act=act), reps=10)
        times["fused_rnn_fwd_ms_q16"] = cuda_ms(
            lambda: R.fused_rnn_fwd(g, U, drop, act=act, qbits=16,
                                    stash=True), reps=10)
        Ts, Bs, _ = TR_SERVE_TBH
        sv = gated_inputs(Ts, Bs, H, 196, dev, act, 1)
        d11 = torch.full((1, 1), 0.8, device=dev)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_rnn_fwd(sv["g"], sv["U"], d11, act=act), reps=10)
        times["serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_rnn_fwd_plain(sv["g"], sv["U"], d11, None, act,
                                          0), reps=2, warmup=1)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            rnn_bound_ms(Ts, Bs, H, "fwd")
        # row 27's routes and plans: train, serve and the CGS-16x RNN's
        # dense stream (a seeded chunk of 100 at 8 rows of 1024, qbits 16,
        # timed too); at the train shape each other block shape, forced
        Hc = RS_TRAIN_TBH[2]
        times["fused_rnn_fwd_kernel_route"] = {
            tag: dict(zip(("route", "plan"), chain_route(
                dev, "fused_rnn_fwd", B_, H_)))
            for tag, B_, H_ in (("train", B, H), ("serve", Bs, H),
                                ("cgs16x_stream", B, Hc))}
        plan = times["fused_rnn_fwd_kernel_route"]["train"]["plan"]
        times["fused_rnn_fwd_by_block_shape"] = forced_plan_ms(
            "fused_rnn_fwd", lambda shape_, run=False: (
                R._rnn_fwd_persist(R.rnn_fwd_plan(B, H, shape_), g, U, drop,
                                   None, act, 0, True)
                if run else R.rnn_fwd_plan(B, H, shape_)), 10,
            [s_ for s_ in getattr(R, "RNN_FWD_SHAPES", ())
             if s_ != (plan.get("batch_rows_per_block", 0) // 8,
                       plan.get("units_per_block"))])
        ck = gated_inputs(100, B, Hc, 197, dev, act, 1)
        times["cgs16x_stream_chunk100_ms"] = cuda_ms(
            lambda: R.fused_rnn_fwd(ck["g"], ck["U"], ck["drop"], ck["h0"],
                                    act=act, qbits=16), reps=10)
        times["cgs16x_stream_chunk100_bound_ms"] = rnn_bound_ms(
            100, B, Hc, "fwd")[0]
        del ck
        # row 29's route and plan at the TIMIT RNN's train shape and at
        # RNN_cudnn's (each direction's layer call at 8 rows), its
        # rebuild / chain split and its other block shapes, forced
        Hr = dict((n, h) for n, h, _ in CUDNN_CASES)["RNN_cudnn"]
        times["fused_rnn_bwd_kernel_route"] = {
            tag: dict(zip(("route", "plan"), chain_route(
                dev, "fused_rnn_bwd", B, H_)))
            for tag, H_ in (("train", H), ("rnn_cudnn", Hr))}
        bcall = calls["fused_rnn_bwd"][0]
        times["fused_rnn_bwd_split"] = bptt_split(bcall, 3)
        plan = times["fused_rnn_bwd_kernel_route"]["train"]["plan"]
        times["fused_rnn_bwd_by_block_shape"] = forced_plan_ms(
            "fused_rnn_bwd", lambda shape_, run=False: (
                R._rnn_bwd_persist(R.rnn_bwd_plan(B, H, shape_), g, U, drop,
                                   h_prev, dhs, act, 0)
                if run else R.rnn_bwd_plan(B, H, shape_)), 10,
            [s_ for s_ in getattr(R, "RNN_BWD_SHAPES", ())
             if s_ != (plan.get("batch_rows_per_block", 0) // 8,
                       plan.get("units_per_block"))])
        # the dU product outside the BPTT kernel: (H, T*B) @ (T*B, H)
        dg = torch.randn(T * B, H, device=dev)
        hq = torch.randn(T * B, H, device=dev)
        times["dU_matmul_ms"] = cuda_ms(lambda: dg.T @ hq, reps=20)
    times.update(cudnn_times(
        dev, T, B, H, Ts, Bs, torch.nn.RNN(H, H, nonlinearity="relu"),
        "cudnn_rnn"))
    print("[timit_rnn_times] kernels at T=%d B=%d H=%d (relu, no quantizer): "
          "%s" % (T, B, H, json.dumps(times)))
    step = train_step_times(dev, timit_rnn_train_runner, "timit_rnn_times",
                            5, 3)
    serve = serve_timings(rec, audio, lens)
    print("[timit_rnn_times] TIMIT RNN recognizer (8 x 4 s batch): %s"
          % json.dumps(serve))
    return times, step, serve


# ---------------------------------------------------------------------------
# the CGS-16x Li-GRU slice: the sparse liGRU recurrence (serve, stream,
# train); GRU_cudnn on the torch-semantics GRU kernels
# ---------------------------------------------------------------------------

def cgs_ligru_sections(compute_dtype="", quant_inp=True, lr_scale=1.0):
    """The TIMIT Li-GRU cfg's sections (ligru_sections) with the CGS-16x
    paper's HCGS fields on the liGRU (HCGS_16X)."""
    secs = ligru_sections(compute_dtype, quant_inp, lr_scale)
    secs["architecture1"].update(HCGS_16X)
    return secs


def check_cgs_ligru(rnn):
    """Both 1024-wide recurrences on a Kb=8, R=2 sparse layout; the
    x-projections dense-masked (no v3 layout at this setting)."""
    lays = [(l.Kb, l.R) for _, l in sorted(rnn._rec_layouts.items())]
    if list(rnn.lay) != [1024, 1024] or lays != [(8, 2)] * 2 \
            or rnn._bs_layouts:
        raise AssertionError("the CGS-16x Li-GRU did not build two Kb=8, "
                             "R=2 sparse recurrences: %s, %s"
                             % (lays, sorted(rnn._bs_layouts)))


def build_cgs_ligru_stack(dev, feat_dim=LG_FEAT, quant_inp=True):
    """The CGS-16x Li-GRU -> its 1944-way cd head (weights from init(0) /
    init(1), the head times CGS_LIGRU_HEAD_GAIN)."""
    from pytorch_kaldi_cgs_tpu_torch.models import MLP, liGRU
    secs = cgs_ligru_sections(quant_inp=quant_inp)
    rnn = liGRU(dict(secs["architecture1"], to_do="forward"), feat_dim,
                seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
              seed=1, device=dev)
    check_cgs_ligru(rnn)
    with torch.no_grad():
        mlp.params["w0"].mul_(CGS_LIGRU_HEAD_GAIN)
    return Stack(rnn, mlp).eval()


def cgs_ligru_inputs(T, B, H, seed, dev, act, gates=2):
    """gated_inputs' gates, drop and cotangents, and a 128-block HCGS
    recurrent mask of width H (128,8 at 75,75 from H=1024: Kb=8, R=2; 128
    at 50 below: Kb=2, R=1), its layout and the masked U's kept blocks as
    w3g (Nb, gates*bs, R*bs): the sparse liGRU's and minimalGRU's
    operands (both cells have gates [h | z]), and at ``gates=1`` the
    sparse RNN's."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask
    inp = gated_inputs(T, B, H, seed, dev, act, gates)
    blocks, sparse = ([128, 8], [75, 75]) if H >= 1024 else ([128], [50])
    mask = hcgs_mask(H, H, blocks, sparse, rng=np.random.RandomState(seed))
    layout = BS.pack_layout(mask, 128)
    # U's scale over the kept columns, as gated_inputs' over all of them
    U = inp["U"].cpu().numpy() * np.sqrt(H / (layout.R * layout.bs))
    w3g = BS.stack_w3_gates([BS.pack_w3(U[g * H:(g + 1) * H] * mask, layout)
                             for g in range(gates)])
    inp.update(layout=layout,
               w3g=torch.tensor(np.asarray(w3g, np.float32), device=dev))
    return inp


def phase_cgs_ligru_kernels(dev):
    """The sparse liGRU forward and BPTT kernels against their twins on
    the same tensors, each launch counter checked (T and T + 1): qbits
    0/16 x relu/tanh at the small shape (Kb=2, R=1), the serving shape
    (forward only) and the training shape (Kb=8, R=2); w3g in bf16 at the
    training shape (the JAX size rule's bf16 case). At the training shape
    the dense liGRU forward over the masked U, seeded (the stream's
    kernel), on both its routes (masked_u_checks)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    checks = []
    k = 0
    for shape in (CL_SMALL_TBH, CL_SERVE_TBH, CL_TRAIN_TBH):
        T, B, H = shape
        small, serve = shape == CL_SMALL_TBH, shape == CL_SERVE_TBH
        cases = [(q, a, False) for q in (0, 16) for a in ("relu", "tanh")]
        if shape == CL_TRAIN_TBH:
            cases += [(16, "relu", True), (0, "tanh", True)]
        for qbits, act, bf16 in cases:
            k += 1
            inp = cgs_ligru_inputs(T, B, H, 300 + k, dev, act)
            g, w3g, drop, dhs, lay = (inp[n] for n in ("g", "w3g", "drop",
                                                       "dhs", "layout"))
            variant = {"qbits": qbits, "act": act, "Kb": lay.Kb, "R": lay.R,
                       "w3g": "bf16" if bf16 else "f32"}
            tol = TOL_BF16 if bf16 else (
                TOL_Q16 if qbits else (TOL_F32_SMALL if small
                                       else TOL_F32_SERVE))
            where = dict(zip("TBH", shape))
            fwd, bwd = R.fused_ligru_fwd_sparse, R.fused_ligru_bwd_sparse
            with torch.no_grad():
                hs = launched(fwd, T, lambda: fwd(g, w3g, drop, lay, act,
                                                  qbits, bf16))
                record_check(checks, "cgs_ligru_kernels",
                             "fused_ligru_fwd_sparse", where, variant,
                             rel_err(hs, R.fused_ligru_fwd_sparse_plain(
                                 g, w3g, drop, lay, act, qbits, bf16)),
                             tol, False)
                if shape == CL_TRAIN_TBH and not bf16:
                    masked_u_checks(checks, dev, shape, variant, inp, act,
                                    qbits, tol)
                if serve:
                    continue
                h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                args = (g, w3g, drop, h_prev, dhs, lay, act, qbits, bf16)
                record_check(checks, "cgs_ligru_kernels",
                             "fused_ligru_bwd_sparse", where, variant,
                             rel_err(launched(bwd, T + 1, lambda: bwd(*args)),
                                     R.fused_ligru_bwd_sparse_plain(*args)),
                             tol, True)
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a sparse liGRU kernel disagrees with its plain "
                             "twin: %s" % bad)
    check_fwd_routes(checks, "fused_ligru_fwd", {(CL_TRAIN_TBH, "persist"),
                                                 (CL_TRAIN_TBH, "step")})
    return checks


def masked_u_checks(checks, dev, shape, variant, inp, act, qbits, tol):
    """The dense liGRU forward over the masked U (what a CGS-16x Li-GRU
    stream runs, seeded): on its route (ligru_fwd_launches) against its
    twin, and bit for bit the step route's, seeded from h0."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = shape
    g, w3g, drop, h0, lay = (inp[n] for n in ("g", "w3g", "drop", "h0",
                                              "layout"))
    U = np.concatenate([BS.unpack_w3(w.cpu().numpy(), lay) for w in
                        (w3g[:, :lay.bs], w3g[:, lay.bs:])])
    U = torch.as_tensor(np.ascontiguousarray(U, np.float32), device=dev)
    route, n = ligru_fwd_launches(dev, T, B, H)
    fwd, where = R.fused_ligru_fwd, dict(zip("TBH", shape))
    hs = launched(fwd, n, lambda: fwd(g, U, drop, h0, act=act, qbits=qbits))
    record_check(checks, "cgs_ligru_kernels", "fused_ligru_fwd/masked_u",
                 where, dict(variant, route=route), rel_err(
                     hs, R.fused_ligru_fwd_plain(g, U, drop, h0, act, qbits)),
                 tol, False)
    st = launched(fwd, T, lambda: R._ligru_fwd_step(g, U, drop, h0, act,
                                                    qbits, False))
    record_check(checks, "cgs_ligru_kernels",
                 "fused_ligru_fwd/masked_u_persist_vs_step", where,
                 dict(variant, route="step"), bits_apart(hs, st), 0.0, False)


def cgs_ligru_expect_serve(T):
    """Launches per recognize: 2 layers x 1 sparse step per frame; the
    dense liGRU none."""
    return expected(fused_ligru_fwd_sparse=2 * T)


def phase_cgs_ligru_stream(dev, rec, audio, lens, phones, logp, noq,
                           chunk=100):
    """A stream drops the sparse layout (as the JAX package's does) and
    runs the dense seeded liGRU forward over the masked U, a call a chunk
    and layer on its route (ligru_stream_count). As shipped: one chunk of
    the whole utterance against the sparse whole-utterance posteriors
    within TOL_Q16 (the recurrent quantizer's ceil steps: the dense and the
    sparse product sum in another order); chunks of 100 frames against the
    CPU's stream of the same chunks within TOL_POST_Q16 with equal phones
    (the input quantizer scales each chunk by its own max|x|:
    phase_ligru_stream). Without the 16-bit quantizers: chunks of 100
    against the whole utterance within TOL_POST. ``noq``: phase_serve's
    (rec, phones, logp, ...) of the stack without them."""
    launches, out = phase_ligru_stream(
        dev, rec, audio, lens, phones, logp, chunk, build_cgs_ligru_stack,
        "cgs_ligru_stream", TOL_Q16)
    rec_noq, phones_noq, logp_noq = noq[:3]
    _, out["chunks_vs_whole_no_quant_inp"] = phase_stream(
        dev, rec_noq, audio, lens, phones_noq, logp_noq, chunk,
        "cgs_ligru_stream, ligru_quant_inp=False", TOL_POST,
        "fused_ligru_fwd", count=ligru_stream_count(dev))
    return launches, out


def cgs_ligru_train_setup(compute_dtype="", quant_inp=True, lr_scale=1.0):
    """The CGS-16x Li-GRU train step (chunk_setup): its sections, 8
    sentences of 300 frames, fMLLR x of width 40 and cd labels."""
    T, B, _ = CL_TRAIN_TBH
    return chunk_setup(cgs_ligru_sections(compute_dtype, quant_inp,
                                          lr_scale),
                       T, B, "fmllr", LG_FEAT, CD_LABELS)


def cgs_ligru_train_runner(dev, compute_dtype="", quant_inp=True,
                           lr_scale=1.0):
    """A ChunkRunner over the CGS-16x Li-GRU's sections and its one
    batch."""
    from pytorch_kaldi_cgs_tpu_torch.models import liGRU
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = cgs_ligru_train_setup(compute_dtype, quant_inp,
                                                 lr_scale)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    rnn = graph.nets["RNN_layers"]
    if type(rnn) is not liGRU:
        raise AssertionError("the CGS-16x Li-GRU cfg did not build a liGRU")
    check_cgs_ligru(rnn)
    return ChunkRunner(graph, config), batch


def phase_cgs_ligru_train(dev):
    """One train step on the card against the CPU, held to GRAD_FLIP_K
    times the CPU's own one-ulp sensitivity (relu behind the 16-bit ceil
    quantizers, as the Li-GRU's), launches per step (the sparse kernels
    alone: T per layer forward, T + 1 per layer backward, one dw launch
    per layer; no dense liGRU kernel), 10 steps in f32 and bf16 at
    LG_FALL_LR_SCALE times the cfg's rates; the same step without the
    16-bit quantizers at TOL_GRAD_REL."""
    T = CL_TRAIN_TBH[0]
    knob = "PKC_BWD_STASH_CELLS"     # no stash variant: both read the same
    inp, mask = cgs_ligru_train_setup()[2]
    sens, where = ulp_sensitivity(cgs_ligru_train_runner, inp, mask)
    grad_tol = max(TOL_GRAD_REL, GRAD_FLIP_K * sens)
    print("[cgs_ligru_train] the CPU's own gradients under a one-ulp change "
          "of x: worst rel change %.3g at %s; card vs CPU bar %.3g"
          % (sens, where, grad_tol))
    want = expected(fused_ligru_fwd_sparse=2 * T,
                    fused_ligru_bwd_sparse=2 * (T + 1), block_sparse_dw=2)
    out = phase_train(dev, cgs_ligru_train_runner, "cgs_ligru_train", (
        ("recompute", knob, None, want), ("stash_knob", knob, "ligru", want)),
        grad_tol=grad_tol, fall_runner=lambda d, cdt="":
        cgs_ligru_train_runner(d, cdt, lr_scale=LG_FALL_LR_SCALE))
    out.update(cpu_ulp_grad_rel_change=sens, cpu_ulp_worst=where)

    def no_quant(d, cdt=""):
        return cgs_ligru_train_runner(d, cdt, quant_inp=False)
    runner, (inp, mask) = no_quant(dev)
    loss_err = runner.train_step(inp, mask, dropout_gen())
    out["no_quant_inp"] = card_vs_cpu(
        runner, no_quant("cpu")[0], inp, mask, loss_err, knob, None,
        "cgs_ligru_train, ligru_quant_inp=False")
    return out


def phase_cgs_ligru_times(dev, rec, audio, lens):
    """CUDA-event times of the sparse liGRU kernels per layer call at the
    training shape (the forward also at the serving shape), as the cfg
    runs them (relu, 16-bit recurrent quantizer, Kb=8, R=2); their twins
    and bounds; the dense liGRU forward on the same layer (the masked U);
    cuDNN's nn.GRU(1024, 1024) at B=8 as a yardstick (three gates, dense,
    no quantizer: not the same function); the CGS-16x Li-GRU train step
    and recognize."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = CL_TRAIN_TBH
    qb, act = 16, "relu"
    inp = cgs_ligru_inputs(T, B, H, 320, dev, act)
    g, w3g, drop, dhs, lay = (inp[n] for n in ("g", "w3g", "drop", "dhs",
                                               "layout"))
    kept = lay.R * lay.bs
    times = {}
    with torch.no_grad():
        hs = R.fused_ligru_fwd_sparse(g, w3g, drop, lay, act, qb)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        bargs = (g, w3g, drop, h_prev, dhs, lay, act, qb)
        calls = {
            "fused_ligru_fwd_sparse": (
                lambda: R.fused_ligru_fwd_sparse(g, w3g, drop, lay, act, qb),
                lambda: R.fused_ligru_fwd_sparse_plain(g, w3g, drop, lay, act,
                                                       qb), "fwd"),
            "fused_ligru_bwd_sparse": (
                lambda: R.fused_ligru_bwd_sparse(*bargs),
                lambda: R.fused_ligru_bwd_sparse_plain(*bargs), "bwd")}
        for name, (fn, plain, kind) in calls.items():
            times[name + "_ms"] = cuda_ms(fn, reps=10)
            times[name + "_plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                ligru_bound_ms(T, B, H, kind, kept)
        times["fused_ligru_fwd_sparse_ms_q0"] = cuda_ms(
            lambda: R.fused_ligru_fwd_sparse(g, w3g, drop, lay, act, 0),
            reps=10)
        # the dense liGRU kernels on the same layer: the masked U
        U = np.concatenate([BS.unpack_w3(w.cpu().numpy(), lay) for w in
                            (w3g[:, :lay.bs], w3g[:, lay.bs:])])
        U = torch.as_tensor(np.ascontiguousarray(U, np.float32), device=dev)
        times["dense_fused_ligru_fwd_ms"] = cuda_ms(
            lambda: R.fused_ligru_fwd(g, U, drop, act=act, qbits=qb),
            reps=10)
        times["dense_fused_ligru_bwd_ms"] = cuda_ms(
            lambda: R.fused_ligru_bwd(g, U, drop, h_prev, dhs, act, qb),
            reps=10)
        Ts, Bs, _ = CL_SERVE_TBH
        sv = cgs_ligru_inputs(Ts, Bs, H, 321, dev, act)
        sargs = (sv["g"], sv["w3g"], sv["drop"], sv["layout"], act, qb)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_ligru_fwd_sparse(*sargs), reps=10)
        times["serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_ligru_fwd_sparse_plain(*sargs), reps=2, warmup=1)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            ligru_bound_ms(Ts, Bs, H, "fwd", kept)
        # the dU product on the dw kernel: G=2 over (T*B, H)
        dg = torch.randn(T * B, 2 * H, device=dev)
        hq = torch.randn(T * B, H, device=dev)
        times["dU_dw_ms"] = cuda_ms(lambda: R.sparse_dU(dg, hq, lay, 2),
                                    reps=20)
    times.update(cudnn_times(dev, T, B, H, Ts, Bs))
    print("[cgs_ligru_times] kernels at T=%d B=%d H=%d (relu, qbits 16, "
          "Kb=%d, R=%d): %s" % (T, B, H, lay.Kb, lay.R, json.dumps(times)))
    step = train_step_times(dev, cgs_ligru_train_runner, "cgs_ligru_times",
                            5, 3)
    serve = serve_timings(rec, audio, lens)
    print("[cgs_ligru_times] CGS-16x Li-GRU recognizer (8 x 4 s batch): %s"
          % json.dumps(serve))
    return times, step, serve


def gru_torch_inputs(T, B, H, seed, dev):
    """Gates (T, B, 3H) [r | z | n], W_hh (3H, H) and b_hh (3H,) drawn as
    torch draws them (U(+-1/sqrt(H))), h0 and upstream cotangents."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    k = 1.0 / np.sqrt(H)
    return {"g": t(rng.randn(T, B, 3 * H) * 0.5),
            "W": t(rng.uniform(-k, k, (3 * H, H))),
            "b": t(rng.uniform(-k, k, (3 * H,))),
            "h0": t(rng.randn(B, H) * 0.3),
            "dhs": t(rng.randn(T, B, H) * 0.1)}


def phase_gru_torch_kernels(dev):
    """The torch-semantics GRU forward (zero state, seeded, and seeded
    from h_{k-1} against the zero-state run's steps k..T-1) and BPTT
    kernel against their twins, each launch counter checked (T, and for
    the BPTT 2 on the persistent route, T + 1 on the step one: the route
    named, and one call's device kernels held to the route's), the BPTT
    twice bit for bit, at the small ragged shape and the TIMIT width's
    training shape (both on the persistent route) and at 16 rows of the
    TIMIT width (GT_STEP_TBH: its blocks do not fit, so the step route)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    checks = []
    fwd, bwd = R.fused_gru_torch_fwd, R.fused_gru_torch_bwd
    for k, shape in enumerate((SMALL_TBH, GT_TRAIN_TBH, GT_STEP_TBH)):
        T, B, H = shape
        inp = gru_torch_inputs(T, B, H, 330 + k, dev)
        g, W, b, h0, dhs = (inp[n] for n in ("g", "W", "b", "h0", "dhs"))
        tol = TOL_F32_SMALL if shape == SMALL_TBH else TOL_F32_SERVE
        where = dict(zip("TBH", shape))

        def check(name, got, ref, by_rel):
            record_check(checks, "gru_torch_kernels", name, where, {},
                         rel_err(got, ref), tol, by_rel)
        with torch.no_grad():
            hs = launched(fwd, T, lambda: fwd(g, W, b))
            check("fused_gru_torch_fwd", hs,
                  R.fused_gru_torch_fwd_plain(g, W, b), False)
            check("fused_gru_torch_fwd/seeded",
                  launched(fwd, T, lambda: fwd(g, W, b, h0)),
                  R.fused_gru_torch_fwd_plain(g, W, b, h0), False)
            s = T // 2
            check("fused_gru_torch_fwd/seeded_vs_shifted",
                  launched(fwd, T - s, lambda: fwd(
                      g[s:].contiguous(), W, b, hs[s - 1].contiguous())),
                  hs[s:], False)
            h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
            route = bptt_route(dev, B, H)[0]
            if route != ("step" if shape == GT_STEP_TBH else "persist"):
                raise AssertionError("fused_gru_torch_bwd at %s takes the %s "
                                     "route" % (shape, route))
            where["route"] = route
            check("fused_gru_torch_bwd",
                  launched(bwd, 2 if route == "persist" else T + 1,
                           lambda: bwd(g, W, b, h_prev, dhs)),
                  R.fused_gru_torch_bwd_plain(g, W, b, h_prev, dhs), True)
            record_check(checks, "gru_torch_kernels",
                         "fused_gru_torch_bwd/determinism", where, {},
                         same_bits(lambda: bwd(g, W, b, h_prev, dhs)), 0.0,
                         False)
            bptt_kernels(lambda: bwd(g, W, b, h_prev, dhs),
                         bptt_design(route, T))
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a torch-semantics GRU kernel disagrees with its "
                             "plain twin: %s" % bad)
    return checks


def nn_gru_of(model):
    """torch.nn.GRU with a GRU_cudnn wrapper's weights (cuDNN's own
    implementation: a check of the wrapper's semantics)."""
    H, L = model.hidden_size, model.num_layers
    ref = torch.nn.GRU(model.input_dim, H, L,
                       bidirectional=model.bidirectional)
    ref = ref.to(next(iter(model.params.values())).device)
    with torch.no_grad():
        for name, p in model.params.items():
            kind, _, sfx = name.split("_")[:3]
            torch_name = "%s_%s_%s" % ({"w": "weight", "b": "bias"}[kind[0]],
                                       name.split("_")[1], sfx)
            if name.endswith("_r"):
                torch_name += "_reverse"
            getattr(ref, torch_name).copy_(p)
    return ref.eval()


def phase_gru_cudnn(dev):
    """GRU_cudnn as its users run it at the TIMIT width: 4 layers of 550,
    unidirectional, dropout 0.2, over the fMLLR features (T=300, B=8).
    Eval and a train-mode forward + backward on the card with the launch
    counters set to 0 just before and read just after (the
    torch-semantics GRU kernels alone: 4 x T forward, 4 x 2 backward on
    the persistent route, 4 x (T + 1) on the step one), against the same model on the CPU (outputs within
    TOL_POST, every gradient, b_hh included, within TOL_GRAD_REL of its
    scale); the eval output against torch.nn.GRU with the same weights
    within TOL_STREAM (cudnn.allow_tf32 off); the stream in chunks of 100
    frames (the seeded forward, 4 x T launches) against the whole
    utterance within TOL_STREAM."""
    T, B, H = GT_TRAIN_TBH
    x = torch.tensor(np.random.RandomState(340).randn(T, B, TR_FEAT)
                     .astype(np.float32))
    dy = torch.tensor(np.random.RandomState(341).randn(T, B, H)
                      .astype(np.float32) * 0.01)
    L = GT_LAYERS

    def run(d):
        model = cudnn_wrapper(d, "GRU_cudnn", H, {}, layers=L, bidir=False)
        xd = x.to(d)
        count = counted if d == dev else (lambda fn: (fn(), None))

        def train():
            y = model.run(xd, train=True, generator=dropout_gen())
            y.backward(dy.to(d))
            return y.detach()
        with torch.no_grad():
            y_eval, l_eval = count(lambda: model.run(xd, train=False))
        y_train, l_train = count(train)
        return (model, y_eval, y_train.cpu(),
                {k: p.grad.cpu() for k, p in model.params.items()},
                l_eval, l_train)
    model, ye, yt, gd, l_eval, l_train = run(dev)
    _, ye_c, yt_c, gc, _, _ = run("cpu")
    want_eval = expected(fused_gru_torch_fwd=L * T)
    want_train = expected(
        fused_gru_torch_fwd=L * T,
        fused_gru_torch_bwd=L * gru_torch_bwd_launches(dev, T, B, H))
    if l_eval != want_eval or l_train != want_train:
        raise AssertionError("GRU_cudnn launched %s (eval), %s (train)"
                             % (l_eval, l_train))
    with torch.no_grad():
        y_nn = nn_gru_of(model)(x.to(dev))[0]
        (streamed, carries), l_stream = counted(lambda: _stream_chunks(
            model, x.to(dev), 100))
    if l_stream != want_eval:
        raise AssertionError("GRU_cudnn stream launched %s" % l_stream)
    grad_errs = {k: float((gd[k] - gc[k]).abs().max())
                 / max(float(gc[k].abs().max()), 1e-30) for k in gc}
    worst = max(grad_errs, key=grad_errs.get)
    r = {"T": T, "B": B, "H": H, "layers": L,
         "eval_vs_cpu": float((ye.cpu() - ye_c).abs().max()),
         "train_vs_cpu": float((yt - yt_c).abs().max()),
         "grads_compared": len(grad_errs), "grad_rel_err_max": grad_errs[worst],
         "grad_rel_err_worst": worst,
         "b_hh_grad_rel_err_max": max(v for k, v in grad_errs.items()
                                      if k.startswith("b_hh")),
         "eval_vs_nn_gru": float((ye - y_nn).abs().max()),
         "stream_vs_whole": float((streamed - ye).abs().max()),
         "launches_eval": l_eval["fused_gru_torch_fwd"],
         "launches_train": {k: v for k, v in l_train.items() if v},
         "launches_stream": l_stream["fused_gru_torch_fwd"]}
    print("[gru_cudnn] %s" % json.dumps(r))
    if not (r["eval_vs_cpu"] <= TOL_POST and r["train_vs_cpu"] <= TOL_POST
            and r["grad_rel_err_max"] <= TOL_GRAD_REL
            and r["eval_vs_nn_gru"] <= TOL_STREAM
            and r["stream_vs_whole"] <= TOL_STREAM):
        raise AssertionError("GRU_cudnn on the card disagrees: %s" % r)
    return r


def _stream_chunks(model, x, chunk):
    """A unidirectional wrapper's stream over x in chunks of ``chunk``
    frames: -> (the concatenated outputs, the final carries)."""
    carries, outs = None, []
    for a in range(0, x.shape[0], chunk):
        y, carries = model.apply_streaming(x[a:a + chunk], carries)
        outs.append(y)
    return torch.cat(outs), carries


def phase_gru_torch_times(dev):
    """CUDA-event times of the torch-semantics GRU kernels per layer call
    at the TIMIT width's training shape (the forward also at the serving
    shape), their twins and bounds, the BPTT's route, plan and split into
    rebuild and chain, and cuDNN's nn.GRU(550, 550): the same function
    (torch's GRU), the library's time for it, beside the port's whole
    GRU_cudnn layer timed the same way (port_gru_layer_times)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = GT_TRAIN_TBH
    inp = gru_torch_inputs(T, B, H, 350, dev)
    g, W, b, dhs = (inp[n] for n in ("g", "W", "b", "dhs"))
    times = {}
    with torch.no_grad():
        hs = R.fused_gru_torch_fwd(g, W, b)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        calls = {
            "fused_gru_torch_fwd": (
                lambda: R.fused_gru_torch_fwd(g, W, b),
                lambda: R.fused_gru_torch_fwd_plain(g, W, b), "fwd"),
            "fused_gru_torch_bwd": (
                lambda: R.fused_gru_torch_bwd(g, W, b, h_prev, dhs),
                lambda: R.fused_gru_torch_bwd_plain(g, W, b, h_prev, dhs),
                "bwd")}
        for name, (fn, plain, kind) in calls.items():
            times[name + "_ms"] = cuda_ms(fn, reps=10)
            times[name + "_plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                gru_bound_ms(T, B, H, H, kind)
        times["fused_gru_torch_bwd_plan"] = bptt_route(dev, B, H)[1]
        times["fused_gru_torch_bwd_split"] = bptt_split(
            calls["fused_gru_torch_bwd"][0])
        Ts, Bs, _ = GT_SERVE_TBH
        sv = gru_torch_inputs(Ts, Bs, H, 351, dev)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_gru_torch_fwd(sv["g"], sv["W"], sv["b"]),
            reps=10)
        times["serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_gru_torch_fwd_plain(sv["g"], sv["W"], sv["b"]),
            reps=2, warmup=1)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            gru_bound_ms(Ts, Bs, H, H, "fwd")
    times.update(cudnn_times(dev, T, B, H, Ts, Bs, torch.nn.GRU(H, H),
                             "cudnn_gru550"))
    times.update(port_gru_layer_times(dev, T, B, H))
    print("[gru_torch_times] kernels at T=%d B=%d H=%d: %s"
          % (T, B, H, json.dumps(times)))
    return times


# ---------------------------------------------------------------------------
# the minimalGRU slice: the TIMIT Li-GRU cfg as a minimalGRU, dense (the
# cfg's own HCGS) and at CGS-16x (the sparse kernels)
# ---------------------------------------------------------------------------

def mgru_sections(compute_dtype="", quant_inp=True, lr_scale=1.0,
                  hcgs=None, act=None):
    """The TIMIT Li-GRU cfg's sections (ligru_sections) with its
    [architecture1] as a minimalGRU: arch_class, arch_proto and every
    ligru_* field renamed (no shipped cfg names minimalGRU). ``hcgs``:
    HCGS fields to set (HCGS_16X for the CGS-16x model); ``act``: both
    layers' activation in place of the cfg's relu."""
    secs = ligru_sections(compute_dtype, quant_inp, lr_scale)
    arch = {k.replace("ligru_", "minimalgru_"): v
            for k, v in secs["architecture1"].items()}
    arch.update(arch_class="minimalGRU", arch_proto="proto/minimalGRU.proto",
                **(hcgs or {}))
    if act:
        arch["minimalgru_act"] = "%s,%s" % (act, act)
    secs["architecture1"] = arch
    return secs


def check_mgru(rnn, sparse):
    """2x1024, every recurrence on the dense fused minimalGRU kernels, or
    (``sparse``) on a Kb=8, R=2 sparse layout; the x-projections
    dense-masked (no v3 layout at either setting)."""
    lays = [(l.Kb, l.R) for _, l in sorted(rnn._rec_layouts.items())]
    if list(rnn.lay) != [1024, 1024] or rnn._bs_layouts \
            or lays != ([(8, 2)] * 2 if sparse else []) \
            or not all(rnn._fused_ok(i) for i in range(rnn.N)):
        raise AssertionError("the minimalGRU (sparse=%s) did not build as "
                             "expected: %s, %s"
                             % (sparse, lays, sorted(rnn._bs_layouts)))


def build_mgru_stack(dev, feat_dim=LG_FEAT, quant_inp=True, sparse=False):
    """The cfg's minimalGRU -> its 1944-way cd head (weights from init(0)
    / init(1), the head times MGRU_HEAD_GAIN, or CGS_MGRU_HEAD_GAIN for
    the ``sparse`` CGS-16x model)."""
    from pytorch_kaldi_cgs_tpu_torch.models import MLP, minimalGRU
    secs = mgru_sections(quant_inp=quant_inp,
                         hcgs=HCGS_16X if sparse else None)
    rnn = minimalGRU(dict(secs["architecture1"], to_do="forward"), feat_dim,
                     seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
              seed=1, device=dev)
    check_mgru(rnn, sparse)
    with torch.no_grad():
        mlp.params["w0"].mul_(CGS_MGRU_HEAD_GAIN if sparse
                              else MGRU_HEAD_GAIN)
    return Stack(rnn, mlp).eval()


def build_cgs_mgru_stack(dev, quant_inp=True):
    return build_mgru_stack(dev, quant_inp=quant_inp, sparse=True)


def mgru_expect_serve(T):
    """Launches per recognize: 2 layers of the dense minimalGRU forward
    at 8 rows, each its route's (gru_fwd_launches), no other kernel."""
    return expected(fused_mgru_fwd=2 * gru_fwd_launches(
        "cuda", "fused_mgru_fwd", T, N_UTT, MG_TRAIN_TBH[2])[1])


def cgs_mgru_expect_serve(T):
    """Launches per recognize: 2 layers of the sparse minimalGRU forward
    at 8 rows, each its route's (cgs_mgru_layer_launches: one launch a
    layer on the persistent route), no other kernel."""
    return expected(fused_mgru_fwd_sparse=2 * cgs_mgru_layer_launches(
        "cuda", T, N_UTT, 16, False)["fused_mgru_fwd_sparse"])


def phase_mgru_kernels(dev):
    """The dense minimalGRU forward (plain, stash, seeded, and seeded from
    h_{k-1} against the zero-state run's steps k..T-1) and both BPTT
    kernels, and the sparse forward and BPTT (hs, dg and the emitted s;
    w3g in f32, and in bf16 at the training and serving shapes), against
    their twins on the same tensors, each launch counter checked (the
    dense forward and recompute BPTT their routes' launches,
    gru_fwd_launches and mgru_bwd_check; 2T for the stash BPTT; the sparse
    kernels their routes', _mgru_sparse_check): qbits 0/16 x relu/tanh at
    MG_SMALL_TBH (sparse: Kb=2, R=1), the training shape and the serving
    shape (forward only; sparse Kb=8, R=2); the sparse kernels also at
    MG_LARGE_ROWS rows (T=16, their step routes). The sparse kernels' step
    routes forced at the training and serving shapes (the forward bit for
    bit its persistent route), their device kernels held to each route's
    once, rows 34 and 35 at every block shape (mgru_sparse_shapes). The
    dense forward runs on the route its
    plan names (persistent at all three shapes), two calls bit for bit,
    its device kernels held to the route's once a shape, and at the
    training shape on the step route too, forced; the recompute BPTT
    (mgru_bwd_check) on its persistent route and on the step route,
    forced, at the small and the training shape."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    checks = []
    k = 0
    for shape in (MG_SMALL_TBH, MG_TRAIN_TBH, MG_SERVE_TBH):
        T, B, H = shape
        small, serve = shape == MG_SMALL_TBH, shape == MG_SERVE_TBH
        where = dict(zip("TBH", shape))
        for qbits in (0, 16):
            for act in ("relu", "tanh"):
                k += 1
                inp = gated_inputs(T, B, H, 400 + k, dev, act)
                g, U, drop, h0, dhs = (inp[n] for n in ("g", "U", "drop",
                                                        "h0", "dhs"))
                variant = {"qbits": qbits, "act": act}
                tol = TOL_F32_SMALL if small else TOL_F32_SERVE
                tol_q = TOL_Q16 if qbits else tol
                fwd = R.fused_mgru_fwd
                route, n = gru_fwd_launches(dev, "fused_mgru_fwd", T, B, H)

                def n_seed(steps):
                    return gru_fwd_launches(dev, "fused_mgru_fwd", steps, B,
                                            H, True, qbits)[1]

                def check(name, err_rel, tol_, by_rel, route_=None):
                    record_check(checks, "mgru_kernels", name, where,
                                 dict(variant, route=route_) if route_
                                 else variant, err_rel, tol_, by_rel)
                with torch.no_grad():
                    ref = R.fused_mgru_fwd_plain(g, U, drop, None, act,
                                                 qbits, True)
                    ref_seed = R.fused_mgru_fwd_plain(g, U, drop, h0, act,
                                                      qbits)
                    hs = launched(fwd, n, lambda: fwd(
                        g, U, drop, act=act, qbits=qbits))
                    check("fused_mgru_fwd", rel_err(hs, ref[0]), tol_q,
                          False, route)
                    check("fused_mgru_fwd/seeded", rel_err(
                        launched(fwd, n_seed(T), lambda: fwd(
                            g, U, drop, h0, act=act, qbits=qbits)),
                        ref_seed), tol_q, False, route)
                    s = T // 2      # seeded from h_{s-1}: steps s..T-1
                    check("fused_mgru_fwd/seeded_vs_shifted", rel_err(
                        launched(fwd, n_seed(T - s), lambda: fwd(
                            g[s:].contiguous(), U, drop,
                            hs[s - 1].contiguous(), act=act, qbits=qbits)),
                        hs[s:]), tol_q, False, route)
                    check("fused_mgru_fwd/determinism", same_bits(
                        lambda: fwd(g, U, drop, h0, act=act, qbits=qbits,
                                    stash=True)), 0.0, False, route)
                    if qbits and act == "tanh":   # the route's kernels
                        bptt_kernels(lambda: fwd(g, U, drop, h0, act=act,
                                                 qbits=qbits),
                                     gru_fwd_design(route, T, True, qbits))
                    if shape == MG_TRAIN_TBH:     # the step route, forced
                        st = launched(fwd, 2 * T, lambda: R._gru_fwd_step(
                            fwd, g, U, drop, None, act, qbits, True))
                        check("fused_mgru_fwd/step_route/stash",
                              rel_err(st, ref), tol_q, False, "step")
                        # both routes sum in one order: the same bits
                        check("fused_mgru_fwd/persist_vs_step", bits_apart(
                            fwd(g, U, drop, act=act, qbits=qbits,
                                stash=True), st), 0.0, False, route)
                        check("fused_mgru_fwd/step_route/seeded", rel_err(
                            launched(fwd, 2 * T + int(qbits > 0),
                                     lambda: R._gru_fwd_step(
                                         fwd, g, U, drop, h0, act, qbits,
                                         False)), ref_seed), tol_q, False,
                              "step")
                    if not serve:
                        hs_s, acts = launched(fwd, n, lambda: fwd(
                            g, U, drop, act=act, qbits=qbits, stash=True))
                        check("fused_mgru_fwd/stash", rel_err(
                            (hs_s, acts), ref), tol_q, False, route)
                        h_prev = torch.cat([torch.zeros_like(hs_s[:1]),
                                            hs_s[:-1]])
                        check("fused_mgru_bwd_stash", rel_err(
                            launched(R.fused_mgru_bwd_stash, 2 * T,
                                     lambda: R.fused_mgru_bwd_stash(
                                         acts, U, drop, h_prev, dhs, act)),
                            R.fused_mgru_bwd_stash_plain(acts, U, drop,
                                                         h_prev, dhs, act)),
                            tol, True)
                        mgru_bwd_check(check, dev, shape, g, U, drop,
                                       h_prev, dhs, act, qbits, tol_q,
                                       qbits and act == "tanh", True)
                for bf16 in (False, True) if not small else (False,):
                    k += 1
                    _mgru_sparse_check(
                        checks, R, shape, qbits, act, bf16, not serve,
                        400 + k, dev, forced=not small,
                        kernels=(not small and not bf16 and qbits
                                 and act == "relu"))
    for qbits, act in ((16, "relu"), (0, "tanh")):
        k += 1
        _mgru_sparse_check(checks, R, (16, MG_LARGE_ROWS, 1024), qbits, act,
                           False, True, 400 + k, dev, kernels=qbits > 0)
    shapes = mgru_sparse_shapes(checks, R, dev)
    print("[mgru_kernels] rows 34 and 35 by block shape: %s"
          % json.dumps(shapes))
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a minimalGRU kernel disagrees with its plain "
                             "twin: %s" % bad)
    check_fwd_routes(checks, "fused_mgru_fwd", {
        (MG_SMALL_TBH, "persist"), (MG_TRAIN_TBH, "persist"),
        (MG_SERVE_TBH, "persist"), (MG_TRAIN_TBH, "step")})
    check_fwd_routes(checks, "fused_mgru_bwd", {
        (MG_SMALL_TBH, "persist"), (MG_TRAIN_TBH, "persist"),
        (MG_SMALL_TBH, "step"), (MG_TRAIN_TBH, "step")})
    large = (16, MG_LARGE_ROWS, 1024)
    check_fwd_routes(checks, "fused_mgru_fwd_sparse", {
        (MG_SMALL_TBH, "persist"), (MG_TRAIN_TBH, "persist"),
        (MG_SERVE_TBH, "persist"), (large, "step")})
    check_fwd_routes(checks, "fused_mgru_bwd_sparse", {
        (MG_SMALL_TBH, "persist"), (MG_TRAIN_TBH, "persist"),
        (MG_TRAIN_TBH, "step"), (large, "step")})
    return checks


def mgru_bwd_check(check, dev, shape, g, U, drop, h_prev, dhs, act, qbits,
                   tol, kernels, forced):
    """fused_mgru_bwd against its twin on the route its plan picks
    (mgru_bwd_launches), two calls bit for bit; ``kernels``: one call's
    device kernels held to the route's design (mgru_bwd_design);
    ``forced``: the step route forced (fused_rnn._gru_bwd_step) against
    the twin, and the two routes within the same bar of each other (their
    rebuilds give the forward's bits, but the chain's dots sum in another
    order than the step kernels': its warps split the contraction)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = shape
    route, n = mgru_bwd_launches(dev, T, B, H, qbits)
    args = (g, U, drop, h_prev, dhs, act, qbits)
    got = launched(R.fused_mgru_bwd, n, lambda: R.fused_mgru_bwd(*args))
    ref = R.fused_mgru_bwd_plain(*args)
    check("fused_mgru_bwd", rel_err(got, ref), tol, True, route)
    check("fused_mgru_bwd/determinism",
          same_bits(lambda: R.fused_mgru_bwd(*args)), 0.0, False, route)
    if kernels:
        bptt_kernels(lambda: R.fused_mgru_bwd(*args),
                     mgru_bwd_design(route, T, qbits))
    if forced:
        st = launched(R.fused_mgru_bwd, 2 * T + 2, lambda: R._gru_bwd_step(
            R.fused_mgru_bwd, "fused_mgru_bwd", 2, g, U, drop, h_prev, dhs,
            act, qbits, False))
        check("fused_mgru_bwd/step_route", rel_err(st, ref), tol, True,
              "step")
        check("fused_mgru_bwd/persist_vs_step", rel_err(got, st), tol, True,
              route)


def _mgru_sparse_check(checks, R, shape, qbits, act, bf16, bwd, seed, dev,
                       forced=False, kernels=False):
    """The sparse minimalGRU forward (and, with ``bwd``, its BPTT: dg and
    s) against the twins at ``shape`` on the routes their plans name
    (mgru_fwd_sparse_launches, mgru_bwd_sparse_launches), two calls bit
    for bit; ``kernels``: one call of each held to its route's device
    kernels (gru_fwd_sparse_design, mgru_bwd_sparse_design); ``forced``:
    each step route forced (fused_rnn._gru_fwd_sparse_step,
    _gru_bwd_sparse_step) against the twin, the forward's bits those of
    its persistent route (both sum in row_dots' order), the BPTT's dg
    within the same bar of the persistent route's (its chain sums in
    another order) and its rebuilt s bit for bit (both routes rebuild on
    the forward's step kernels: the forward's sums)."""
    T, B, H = shape
    inp = cgs_ligru_inputs(T, B, H, seed, dev, act)
    gm, w3g, drop, dhs, lay = (inp[n] for n in ("g", "w3g", "drop", "dhs",
                                                "layout"))
    variant = {"qbits": qbits, "act": act, "Kb": lay.Kb, "R": lay.R,
               "w3g": "bf16" if bf16 else "f32"}
    tol = TOL_BF16 if bf16 else (
        TOL_Q16 if qbits else (TOL_F32_SMALL if shape == MG_SMALL_TBH
                               else TOL_F32_SERVE))
    where = dict(zip("TBH", shape))
    fwd, bwdk = R.fused_mgru_fwd_sparse, R.fused_mgru_bwd_sparse
    dbh = torch.broadcast_to(drop, (B, H)).contiguous()

    def check(name, err_rel, tol_, by_rel, route):
        record_check(checks, "mgru_kernels", name, where,
                     dict(variant, route=route), err_rel, tol_, by_rel)
    with torch.no_grad():
        fargs = (gm, w3g, drop, lay, act, qbits, bf16)
        route, n = mgru_fwd_sparse_launches(dev, T, B, lay, bf16)
        hs = launched(fwd, n, lambda: fwd(*fargs))
        check("fused_mgru_fwd_sparse", rel_err(
            hs, R.fused_mgru_fwd_sparse_plain(*fargs)), tol, False, route)
        check("fused_mgru_fwd_sparse/determinism",
              same_bits(lambda: fwd(*fargs)), 0.0, False, route)
        if kernels:
            bptt_kernels(lambda: fwd(*fargs), gru_fwd_sparse_design(route, T))
        if forced:
            st = launched(fwd, 2 * T, lambda: R._gru_fwd_sparse_step(
                fwd, gm, w3g, dbh, lay, act, qbits, bf16))
            check("fused_mgru_fwd_sparse/persist_vs_step", bits_apart(hs, st),
                  0.0, False, route)
        if not bwd:
            return
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        args = (gm, w3g, drop, h_prev, dhs, lay, act, qbits, bf16)
        route, n = mgru_bwd_sparse_launches(dev, T, B, lay, qbits, bf16)
        got = launched(bwdk, n, lambda: bwdk(*args))
        ref = R.fused_mgru_bwd_sparse_plain(*args)
        check("fused_mgru_bwd_sparse", rel_err(got, ref), tol, True, route)
        check("fused_mgru_bwd_sparse/determinism",
              same_bits(lambda: bwdk(*args)), 0.0, False, route)
        if kernels:
            bptt_kernels(lambda: bwdk(*args),
                         mgru_bwd_sparse_design(route, T, qbits))
        if forced:
            st = launched(bwdk, 2 * T + 2, lambda: R._gru_bwd_sparse_step(
                bwdk, gm, w3g, dbh, h_prev, dhs, lay, act, qbits, bf16))
            check("fused_mgru_bwd_sparse/step_route", rel_err(st, ref), tol,
                  True, "step")
            check("fused_mgru_bwd_sparse/persist_vs_step",
                  rel_err(got[0], st[0]), tol, True, route)
            check("fused_mgru_bwd_sparse/rebuild_s_vs_step",
                  bits_apart(got[1], st[1]), 0.0, False, route)


#: the steps at which mgru_sparse_shapes forces each block shape of rows
#: 34 and 35 (at 8 bi - 3 rows: one ragged row group, so that every grid
#: of 1024 units is co-resident; 8 bi + 3 rows at 8 and 16 rows, two row
#: groups, left the forward's grid of 256 blocks at one block an SM)
MG_SHAPES_T = 24


def mgru_sparse_shapes(checks, R, dev):
    """Rows 34 and 35's persistent routes forced to every block shape
    their plans can take (fused_rnn.GRU_FWD_SPARSE_SHAPES,
    GRU_BWD_SPARSE_SHAPES) at the CGS-16x layout, 8 bi - 3 rows of 1024,
    relu, qbits 16, f32 w3g: each against its twin at TOL_Q16, the
    forward bit for bit its step route; a shape whose grid is not
    co-resident is recorded as skipped."""
    out = {}
    for kind, shapes in (("fwd", R.GRU_FWD_SPARSE_SHAPES),
                         ("bwd", R.GRU_BWD_SPARSE_SHAPES)):
        for bi, un in shapes:
            T, B, H = MG_SHAPES_T, 8 * bi - 3, MG_TRAIN_TBH[2]
            inp = cgs_ligru_inputs(T, B, H, 430 + bi + un, dev, "relu")
            gm, w3g, drop, dhs, lay = (inp[n] for n in (
                "g", "w3g", "drop", "dhs", "layout"))
            dbh = torch.broadcast_to(drop, (B, H)).contiguous()
            where = {"T": T, "B": B, "H": H}
            variant = {"qbits": 16, "act": "relu", "Kb": lay.Kb, "R": lay.R,
                       "w3g": "f32", "route": "persist",
                       "block": "%d units x %d rows" % (un, 8 * bi)}
            kernel = "fused_mgru_%s_sparse" % kind
            plan = (R.gru_fwd_sparse_plan(B, lay, (bi, un), G=2)
                    if kind == "fwd" else
                    R.mgru_bwd_sparse_plan(B, H, lay.bs, lay.C, (bi, un)))
            if not co_resident(kernel, plan):
                out["%s %s" % (kind, variant["block"])] = "not co-resident"
                continue
            with torch.no_grad():
                fargs = (gm, w3g, dbh, lay, "relu", 16, False)
                if kind == "fwd":
                    hs = R._gru_fwd_sparse_persist(plan, *fargs)
                    record_check(checks, "mgru_kernels", kernel + "/block",
                                 where, variant, rel_err(
                                     hs, R.fused_mgru_fwd_sparse_plain(
                                         *fargs)), TOL_Q16, False)
                    record_check(checks, "mgru_kernels",
                                 kernel + "/block_vs_step", where, variant,
                                 bits_apart(hs, R._gru_fwd_sparse_step(
                                     R.fused_mgru_fwd_sparse, gm, w3g, dbh,
                                     lay, "relu", 16, False)), 0.0, False)
                else:
                    hs = R.fused_mgru_fwd_sparse(*fargs)
                    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                    args = (gm, w3g, dbh, h_prev, dhs, lay, "relu", 16, False)
                    record_check(checks, "mgru_kernels", kernel + "/block",
                                 where, variant, rel_err(
                                     R._mgru_bwd_sparse_persist(plan, *args),
                                     R.fused_mgru_bwd_sparse_plain(*args)),
                                 TOL_Q16, True)
            out["%s %s" % (kind, variant["block"])] = "checked"
    return out


def phase_mgru_train(dev, sparse=False):
    """One train step of the cfg's minimalGRU on the card against the
    CPU, held to GRAD_FLIP_K times the CPU's own one-ulp sensitivity
    (relu behind two 16-bit ceil quantizers in series), with the
    recompute backward (the default); the stash one
    (PKC_BWD_STASH_CELLS=mgru) from a fresh runner, its gradients held to
    the default's on the card (as shipped at the one-ulp bar, without
    the quantizers within MG_STASH_TOL of scale); launches per
    step in each (the minimalGRU kernels alone; ``sparse``: the sparse
    kernels in both modes and the dw kernel, two launches a layer, for
    dU); 10 steps in f32 and bf16 at LG_FALL_LR_SCALE times the cfg's
    rates; the same step without the 16-bit quantizers and with tanh in
    place of relu against the CPU at TOL_GRAD_REL. (Without the
    quantizers relu still flips: this step has pre-activations within
    1e-7 of 0 in both layers, where the card's and the CPU's sums, an
    ulp apart, take relu' to 0 and to 1; one flip moves wh1's gradient
    by 5.6e-2 of its scale. The TIMIT RNN's check is held the same way.)"""
    T = MG_TRAIN_TBH[0]
    tag = "cgs_mgru_train" if sparse else "mgru_train"
    knob = "PKC_BWD_STASH_CELLS"

    def make(d, cdt="", quant_inp=True, lr_scale=1.0, act=None):
        return mgru_train_runner(d, cdt, quant_inp, lr_scale, sparse, act)
    inp, mask = mgru_train_setup(sparse=sparse)[2]
    sens, where = ulp_sensitivity(make, inp, mask)
    grad_tol = max(TOL_GRAD_REL, GRAD_FLIP_K * sens)
    print("[%s] the CPU's own gradients under a one-ulp change of x: "
          "worst rel change %.3g at %s; card vs CPU bar %.3g"
          % (tag, sens, where, grad_tol))
    if sparse:
        n = cgs_mgru_layer_launches(dev, *MG_TRAIN_TBH[:2], 16, True)
        want = expected(block_sparse_dw=2 * 2,
                        **{k: 2 * v for k, v in n.items()})
        modes = (("recompute", knob, None, want),
                 ("stash_knob", knob, "mgru", want))
    else:
        n = 2 * gru_fwd_launches(dev, "fused_mgru_fwd", *MG_TRAIN_TBH)[1]
        n_bwd = mgru_bwd_launches(dev, *MG_TRAIN_TBH, 16)[1]
        modes = (("recompute", knob, None,
                  expected(fused_mgru_fwd=n, fused_mgru_bwd=2 * n_bwd)),
                 ("stash", knob, "mgru",
                  expected(fused_mgru_fwd=n,
                           fused_mgru_bwd_stash=2 * 2 * T)))
    out = phase_train(dev, make, tag, modes, grad_tol=grad_tol,
                      fall_runner=lambda d, cdt="": make(
                          d, cdt, lr_scale=LG_FALL_LR_SCALE))
    out.update(cpu_ulp_grad_rel_change=sens, cpu_ulp_worst=where)
    # the two backwards from the same parameters, on the card: as shipped
    # at the one-ulp bar (dU's s comes from the stashed z or from z
    # recomputed by cuBLAS, an ulp apart, which the 16-bit ceil quantizer
    # can move a whole step), without the quantizers at MG_STASH_TOL
    for quant_inp, tol in ((True, grad_tol), (False, MG_STASH_TOL)):
        grads = {}
        for value in (None, "mgru"):
            runner, (inp, mask) = make(dev, quant_inp=quant_inp)
            with env(knob, value):
                runner.train_step(inp, mask, dropout_gen())
            grads[value] = runner
        errs = grad_rel_errs(grads["mgru"], grads[None])
        worst = max(errs, key=errs.get)
        key = "stash_vs_recompute_grad_rel_err_max" + (
            "" if quant_inp else "_no_quant_inp")
        out[key] = errs[worst]
        print("[%s] PKC_BWD_STASH_CELLS=mgru vs the default (quant_inp=%s): "
              "worst gradient rel err %.3g at %s (tol %g)"
              % (tag, quant_inp, errs[worst], worst, tol))
        if not errs[worst] <= tol:
            raise AssertionError("%s: the stash backward's gradients "
                                 "disagree with the recompute one's" % tag)
    runner, (inp, mask) = make(dev, quant_inp=False, act="tanh")
    loss_err = runner.train_step(inp, mask, dropout_gen())
    out["no_quant_inp_tanh"] = card_vs_cpu(
        runner, make("cpu", quant_inp=False, act="tanh")[0], inp, mask,
        loss_err, knob, None,
        tag + ", minimalgru_quant_inp=False, minimalgru_act=tanh")
    return out


def mgru_train_setup(compute_dtype="", quant_inp=True, lr_scale=1.0,
                     sparse=False, act=None):
    """The minimalGRU train step (chunk_setup): its sections
    (mgru_sections), 8 sentences of 300 frames, fMLLR x of width 40 and
    cd labels."""
    T, B, _ = MG_TRAIN_TBH
    return chunk_setup(mgru_sections(compute_dtype, quant_inp, lr_scale,
                                     HCGS_16X if sparse else None, act),
                       T, B, "fmllr", LG_FEAT, CD_LABELS)


def mgru_train_runner(dev, compute_dtype="", quant_inp=True, lr_scale=1.0,
                      sparse=False, act=None):
    """A ChunkRunner over the cfg's minimalGRU (``sparse``: at the
    CGS-16x HCGS fields) and its one batch; pass
    ``chip_smoke.dropout_gen()`` to ``train_step`` for masks that match
    the CPU's."""
    from pytorch_kaldi_cgs_tpu_torch.models import minimalGRU
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = mgru_train_setup(compute_dtype, quant_inp,
                                            lr_scale, sparse, act)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    rnn = graph.nets["RNN_layers"]
    if type(rnn) is not minimalGRU:
        raise AssertionError("the cfg did not build a minimalGRU")
    check_mgru(rnn, sparse)
    return ChunkRunner(graph, config), batch


def cgs_mgru_train_runner(dev, compute_dtype="", quant_inp=True,
                          lr_scale=1.0):
    return mgru_train_runner(dev, compute_dtype, quant_inp, lr_scale, True)


def phase_mgru_stream(dev, rec, audio, lens, phones, logp, noq, sparse):
    """The minimalGRU streams on the dense seeded forward (a sparse layer
    drops its layout under a stream, as in the JAX package), 2 layers,
    each a seeded call a chunk on its route (dense_fwd_stream_launches):
    phase_ligru_stream's checks (one chunk against
    the whole utterance, within TOL_STREAM dense, TOL_Q16 sparse: the
    dense and the sparse product sum in another order; chunks of 100
    against the CPU's stream at TOL_POST_Q16) and, without the 16-bit
    quantizers, chunks of 100 against the whole utterance at TOL_POST."""
    tag = "cgs_mgru_stream" if sparse else "mgru_stream"
    stack = build_cgs_mgru_stack if sparse else build_mgru_stack

    def count(qbits):
        return lambda T, c: dense_fwd_stream_launches(
            dev, "fused_mgru_fwd", T, c, N_UTT, MG_TRAIN_TBH[2], 2, qbits)
    launches, out = phase_ligru_stream(
        dev, rec, audio, lens, phones, logp, 100, stack, tag,
        TOL_Q16 if sparse else TOL_STREAM, "fused_mgru_fwd", count=count(16))
    rec_noq, phones_noq, logp_noq = noq[:3]
    _, out["chunks_vs_whole_no_quant_inp"] = phase_stream(
        dev, rec_noq, audio, lens, phones_noq, logp_noq, 100,
        tag + ", minimalgru_quant_inp=False", TOL_POST, "fused_mgru_fwd",
        count=count(0))
    return launches, out


def phase_mgru_large_batch(dev):
    """The CGS-16x minimalGRU's first layer over MG_LARGE_ROWS utterances
    of T=398, where the JAX size rule says "" (it would run its float32
    lax.scan over the masked U): the sparse forward alone, on its step
    route (1,024 blocks are not co-resident: 2 x 398 launches), with
    float32 w3g (the scan reads it in bf16 only where the rule says
    "bf16"), against the model on the sparse twin;
    as shipped at TOL_Q16 and without the 16-bit quantizers at
    MG_LARGE_TOL."""
    from pytorch_kaldi_cgs_tpu_torch.models import minimalGRU
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, rows = MG_SERVE_TBH[0], MG_LARGE_ROWS
    x = torch.tensor(np.random.RandomState(410).randn(T, rows, LG_FEAT)
                     .astype(np.float32), device=dev)
    out, checks = {}, []
    for quant_inp, tol in ((True, TOL_Q16), (False, MG_LARGE_TOL)):
        sec = first_layer(mgru_sections(quant_inp=quant_inp, hcgs=HCGS_16X)
                          ["architecture1"], "minimalgru")
        net = minimalGRU(dict(sec, to_do="forward"), LG_FEAT, seed=0,
                         device=dev).eval()
        layout = net._rec_layouts.get(0)
        if layout is None or F.sparse_scan_fits(rows, layout.N, layout,
                                                2) != "":
            raise AssertionError("mgru_large_batch: no sparse layout, or one "
                                 "the JAX size rule keeps at %d rows" % rows)
        with torch.inference_mode():
            y, launches = counted(lambda: net(x))
            with swapped(R, "fused_mgru_fwd_sparse",
                         R.fused_mgru_fwd_sparse_plain):
                y_plain = net(x)
        route, n = mgru_fwd_sparse_launches(dev, T, rows, layout)
        if route != "step" or launches != expected(
                fused_mgru_fwd_sparse=n):
            raise AssertionError("mgru_large_batch: launches %s on route %s"
                                 % (launches, route))
        record_check(checks, "mgru_large_batch",
                     "fused_mgru_fwd_sparse/model",
                     {"T": T, "rows": rows},
                     {"Kb": layout.Kb, "R": layout.R, "w3g": "f32",
                      "quant_inp": quant_inp}, rel_err(y, y_plain), tol,
                     False)
        out["launches" if quant_inp else "launches_noq"] = \
            launches["fused_mgru_fwd_sparse"]
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("mgru_large_batch: %s" % bad)
    out.update(rows=rows, checks=checks)
    return out


def phase_mgru_times(dev, rec, cgs_rec, audio, lens):
    """CUDA-event times of the five minimalGRU kernels per layer call at
    the training shape (the forwards also at the serving shape), as the
    cfg runs them (relu, 16-bit recurrent quantizers; the sparse ones at
    Kb=8, R=2 with f32 w3g); their twins and bounds; cuDNN's
    nn.GRU(1024, 1024) at B=8 as a yardstick (three gates, dense, no
    quantizer: not the same function); the dU products; the train step
    and recognize of both models."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = MG_TRAIN_TBH
    Ts, Bs, _ = MG_SERVE_TBH
    qb, act = 16, "relu"
    inp = gated_inputs(T, B, H, 420, dev, act)
    g, U, drop, dhs = (inp[n] for n in ("g", "U", "drop", "dhs"))
    sp = cgs_ligru_inputs(T, B, H, 421, dev, act)
    sg, w3g, sdrop, sdhs, lay = (sp[n] for n in ("g", "w3g", "drop", "dhs",
                                                  "layout"))
    kept = lay.R * lay.bs
    times = {}
    with torch.no_grad():
        hs, acts = R.fused_mgru_fwd(g, U, drop, act=act, qbits=qb,
                                    stash=True)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        shs = R.fused_mgru_fwd_sparse(sg, w3g, sdrop, lay, act, qb)
        sh_prev = torch.cat([torch.zeros_like(shs[:1]), shs[:-1]])
        bargs = (sg, w3g, sdrop, sh_prev, sdhs, lay, act, qb)
        calls = {
            "fused_mgru_fwd": (
                lambda: R.fused_mgru_fwd(g, U, drop, act=act, qbits=qb,
                                         stash=True),
                lambda: R.fused_mgru_fwd_plain(g, U, drop, None, act, qb,
                                               True), "fwd_stash", None),
            "fused_mgru_bwd_stash": (
                lambda: R.fused_mgru_bwd_stash(acts, U, drop, h_prev, dhs,
                                               act),
                lambda: R.fused_mgru_bwd_stash_plain(acts, U, drop, h_prev,
                                                     dhs, act),
                "bwd_stash", None),
            "fused_mgru_bwd": (
                lambda: R.fused_mgru_bwd(g, U, drop, h_prev, dhs, act, qb),
                lambda: R.fused_mgru_bwd_plain(g, U, drop, h_prev, dhs, act,
                                               qb), "bwd", None),
            "fused_mgru_fwd_sparse": (
                lambda: R.fused_mgru_fwd_sparse(sg, w3g, sdrop, lay, act, qb),
                lambda: R.fused_mgru_fwd_sparse_plain(sg, w3g, sdrop, lay,
                                                      act, qb), "fwd", kept),
            "fused_mgru_bwd_sparse": (
                lambda: R.fused_mgru_bwd_sparse(*bargs),
                lambda: R.fused_mgru_bwd_sparse_plain(*bargs), "bwd_s",
                kept)}
        for name, (fn, plain, kind, k) in calls.items():
            times[name + "_ms"] = cuda_ms(fn, reps=5)
            times[name + "_plain_ms"] = cuda_ms(plain, reps=1, warmup=1)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                ligru_bound_ms(T, B, H, kind, k)
        times["fused_mgru_fwd_nostash_ms"] = cuda_ms(
            lambda: R.fused_mgru_fwd(g, U, drop, act=act, qbits=qb), reps=5)
        times["fused_mgru_fwd_plan"] = chain_route(dev, "fused_mgru_fwd", B,
                                                   H)[1]
        times["fused_mgru_bwd_plan"] = chain_route(dev, "fused_mgru_bwd", B,
                                                   H)[1]
        times["fused_mgru_bwd_split"] = bptt_split(calls["fused_mgru_bwd"][0],
                                                   3)
        for k in ("fused_mgru_fwd_sparse", "fused_mgru_bwd_sparse"):
            times[k + "_plan"] = chain_route(dev, k, B, layout=lay)[1]
        times["fused_mgru_bwd_sparse_split"] = bptt_split(
            calls["fused_mgru_bwd_sparse"][0], 3)
        times["fused_mgru_fwd_ms_q0"] = cuda_ms(
            lambda: R.fused_mgru_fwd(g, U, drop, act=act, qbits=0,
                                     stash=True), reps=5)
        sv = gated_inputs(Ts, Bs, H, 422, dev, act)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_mgru_fwd(sv["g"], sv["U"], sv["drop"], act=act,
                                     qbits=qb), reps=5)
        times["serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_mgru_fwd_plain(sv["g"], sv["U"], sv["drop"],
                                           None, act, qb), reps=1, warmup=1)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            ligru_bound_ms(Ts, Bs, H, "fwd")
        ssv = cgs_ligru_inputs(Ts, Bs, H, 423, dev, act)
        sargs = (ssv["g"], ssv["w3g"], ssv["drop"], ssv["layout"], act, qb)
        times["sparse_serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_mgru_fwd_sparse(*sargs), reps=5)
        times["sparse_serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_mgru_fwd_sparse_plain(*sargs), reps=1, warmup=1)
        times["sparse_serve_fwd_bound_ms"], \
            times["sparse_serve_fwd_bound_by"] = \
            ligru_bound_ms(Ts, Bs, H, "fwd", kept)
        # dU outside the BPTT kernels: two (H, T*B) @ (T*B, H) matmuls
        # (dense), two dw launches at G=1 (sparse)
        dg = torch.randn(T * B, 2 * H, device=dev)
        hq = torch.randn(T * B, H, device=dev)
        times["dU_matmul_ms"] = cuda_ms(
            lambda: (dg[:, :H].T @ hq, dg[:, H:].T @ hq), reps=10)
        dgc = (dg[:, :H].contiguous(), dg[:, H:].contiguous())
        times["dU_dw_ms"] = cuda_ms(
            lambda: [R.sparse_dU(d, hq, lay, 1) for d in dgc], reps=10)
    times.update(cudnn_times(dev, T, B, H, Ts, Bs))
    print("[mgru_times] kernels at T=%d B=%d H=%d (relu, qbits 16; sparse "
          "Kb=%d, R=%d): %s" % (T, B, H, lay.Kb, lay.R, json.dumps(times)))
    steps, serves = {}, {}
    for tag, runner_fn, r in (("mgru", mgru_train_runner, rec),
                              ("cgs_mgru", cgs_mgru_train_runner, cgs_rec)):
        steps[tag] = train_step_times(dev, runner_fn, tag + "_times", 3, 2)
        serves[tag] = serve_timings(r, audio, lens)
        print("[mgru_times] %s recognizer (8 x 4 s batch): %s"
              % (tag, json.dumps(serves[tag])))
    return times, steps, serves


# ---------------------------------------------------------------------------
# the CGS-16x RNN slice: the block-sparse RNN recurrence (serve, stream,
# train); the dense kernels' width limits; the minimalGRU stream with tanh
# ---------------------------------------------------------------------------

def rnn_sparse_sections(compute_dtype="", quant_inp=True, lr_scale=1.0,
                        act=None):
    """The TIMIT RNN cfg's sections (cfg_sections) with rnn_lay = 4 x
    1024, rnn_hcgs = True, the CGS-16x HCGS and quantizer fields
    (HCGS_16X, QUANT_16X; ``quant_inp=False`` turns the 16-bit input
    quantizers off); ``act``: every layer's activation in place of the
    cfg's relu."""
    secs = cfg_sections(TIMIT_RNN_CFG, compute_dtype, lr_scale)
    arch = secs["architecture1"]
    arch.update(HCGS_16X, **QUANT_16X)
    arch.update(rnn_lay=",".join([str(RS_TRAIN_TBH[2])] * RS_LAYERS),
                rnn_hcgs="True", rnn_quant_inp=str(quant_inp))
    if act:
        arch["rnn_act"] = ",".join([act] * RS_LAYERS)
    return secs


def check_rnn_sparse(rnn):
    """Four 1024-wide recurrences on a Kb=8, R=2 sparse layout; the
    x-projections dense-masked (no v3 layout at this setting)."""
    lays = [(l.Kb, l.R) for _, l in sorted(rnn._rec_layouts.items())]
    if list(rnn.lay) != [RS_TRAIN_TBH[2]] * RS_LAYERS or rnn._bs_layouts \
            or lays != [(8, 2)] * RS_LAYERS:
        raise AssertionError("the CGS-16x RNN did not build four Kb=8, R=2 "
                             "sparse recurrences: %s, %s"
                             % (lays, sorted(rnn._bs_layouts)))


def build_rnn_sparse_stack(dev, feat_dim=TR_FEAT, quant_inp=True):
    """The CGS-16x RNN -> its 1944-way cd head (weights from init(0) /
    init(1), the head times RNN_SPARSE_HEAD_GAIN)."""
    from pytorch_kaldi_cgs_tpu_torch.models import MLP, RNN
    secs = rnn_sparse_sections(quant_inp=quant_inp)
    rnn = RNN(dict(secs["architecture1"], to_do="forward"), feat_dim,
              seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
              seed=1, device=dev)
    check_rnn_sparse(rnn)
    with torch.no_grad():
        mlp.params["w0"].mul_(RNN_SPARSE_HEAD_GAIN)
    return Stack(rnn, mlp).eval()


def rnn_sparse_expect_serve(T):
    """Launches per recognize: 4 layers of the sparse RNN forward at 8
    rows, each its route's (rnn_sparse_layer_launches: one launch a layer
    on the persistent route); no dense RNN kernel."""
    return expected(fused_rnn_fwd_sparse=RS_LAYERS * rnn_sparse_layer_launches(
        "cuda", T, N_UTT, 16, False)["fused_rnn_fwd_sparse"])


def phase_rnn_sparse_kernels(dev):
    """The sparse RNN forward and BPTT kernels against their twins on the
    same tensors, each on the route its plan names and its launch counter
    checked against that route's count (rnn_fwd_sparse_launches,
    rnn_bwd_sparse_launches), two calls bit for bit: qbits 0/16 x
    tanh/relu at the small shape (Kb=2, R=1), the serving shape (forward
    only) and the training shape (Kb=8, R=2; and w3g in bf16); the layer
    at RS_LARGE_TBH's 256 rows (the step routes: 1,024 blocks are not
    co-resident), where the JAX size rule says "", on f32 w3g;
    rnn_scan_fused_sparse reading w3g in bf16 where a small
    PKC_SPARSE_SCAN_VMEM_MB makes the rule say "bf16". Below 256 rows
    each step route forced (fused_rnn._rnn_fwd_sparse_step,
    _rnn_bwd_sparse_step) against the twin, the forward's hs and the
    BPTT's dg bit for bit the persistent route's (both sum in the step
    kernels' order), the BPTT's rebuilt a_pre bit for bit the step
    route's; one relu, qbits 16, f32 call of each a shape held to its
    route's device kernels by name (rnn_fwd_sparse_design,
    rnn_bwd_sparse_design); rows 36 and 37 at every block shape of their
    tables (rnn_sparse_shapes)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    checks = []
    k = 0
    fwd, bwd = R.fused_rnn_fwd_sparse, R.fused_rnn_bwd_sparse
    for shape in (RS_SMALL_TBH, RS_SERVE_TBH, RS_TRAIN_TBH, RS_LARGE_TBH):
        T, B, H = shape
        small, serve = shape == RS_SMALL_TBH, shape == RS_SERVE_TBH
        large = shape == RS_LARGE_TBH
        cases = [(q, a, False) for q in (0, 16) for a in ("tanh", "relu")]
        if shape == RS_TRAIN_TBH:
            cases += [(16, "relu", True), (0, "tanh", True)]
        if large:
            cases = [(16, "relu", False), (0, "tanh", False)]
        for qbits, act, bf16 in cases:
            k += 1
            inp = cgs_ligru_inputs(T, B, H, 500 + k, dev, act, 1)
            g, w3g, drop, dhs, lay = (inp[n] for n in ("g", "w3g", "drop",
                                                       "dhs", "layout"))
            if large and F.sparse_scan_fits(B, H, lay, 1):
                raise AssertionError("rnn_sparse_kernels: the JAX size rule "
                                     "keeps %d rows" % B)
            dbh = torch.broadcast_to(drop, (B, H)).contiguous()
            variant = {"qbits": qbits, "act": act, "Kb": lay.Kb, "R": lay.R,
                       "w3g": "bf16" if bf16 else "f32"}
            tol = TOL_BF16 if bf16 else (
                TOL_Q16 if qbits else (TOL_F32_SMALL if small
                                       else TOL_F32_SERVE))
            where = dict(zip("TBH", shape))
            kernels = (qbits, act, bf16) == (16, "relu", False)

            def check(name, err_rel, tol_, by_rel, route):
                record_check(checks, "rnn_sparse_kernels", name, where,
                             dict(variant, route=route), err_rel, tol_,
                             by_rel)
            with torch.no_grad():
                fargs = (g, w3g, drop, lay, act, qbits, bf16)
                route, n = rnn_fwd_sparse_launches(dev, T, B, lay, bf16)
                hs = launched(fwd, n, lambda: fwd(*fargs))
                ref = R.fused_rnn_fwd_sparse_plain(*fargs)
                check("fused_rnn_fwd_sparse", rel_err(hs, ref), tol, False,
                      route)
                check("fused_rnn_fwd_sparse/determinism",
                      same_bits(lambda: fwd(*fargs)), 0.0, False, route)
                if kernels:
                    bptt_kernels(lambda: fwd(*fargs),
                                 rnn_fwd_sparse_design(route, T))
                if not large:
                    st = launched(fwd, T, lambda: R._rnn_fwd_sparse_step(
                        g, w3g, dbh, lay, act, qbits, bf16))
                    check("fused_rnn_fwd_sparse/step_route",
                          rel_err(st, ref), tol, False, "step")
                    check("fused_rnn_fwd_sparse/persist_vs_step",
                          bits_apart(hs, st), 0.0, False, route)
                if serve:
                    continue
                h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                args = (g, w3g, drop, h_prev, dhs, lay, act, qbits, bf16)
                route, n = rnn_bwd_sparse_launches(dev, T, B, lay, qbits,
                                                   bf16)
                got = launched(bwd, n, lambda: bwd(*args))
                ref = R.fused_rnn_bwd_sparse_plain(*args)
                check("fused_rnn_bwd_sparse", rel_err(got, ref), tol, True,
                      route)
                check("fused_rnn_bwd_sparse/determinism",
                      same_bits(lambda: bwd(*args)), 0.0, False, route)
                if kernels:
                    bptt_kernels(lambda: bwd(*args),
                                 rnn_bwd_sparse_design(route, T, qbits))
                if large:
                    continue
                dargs = (g, w3g, dbh, h_prev, dhs, lay, act, qbits, bf16)
                dg_st, pre_st = launched(bwd, T + 1,
                                         lambda: R._rnn_bwd_sparse_step(
                                             *dargs, with_pre=True))
                check("fused_rnn_bwd_sparse/step_route", rel_err(dg_st, ref),
                      tol, True, "step")
                check("fused_rnn_bwd_sparse/persist_vs_step",
                      bits_apart(got, dg_st), 0.0, False, route)
                if route == "persist":
                    plan = R.rnn_bwd_sparse_route(B, lay, bf16, dev)[1]
                    pre = launched(bwd, n, lambda: R._rnn_bwd_sparse_persist(
                        plan, *dargs, with_pre=True))[1]
                    check("fused_rnn_bwd_sparse/rebuild_pre_vs_step",
                          bits_apart(pre, pre_st), 0.0, False, route)
    T, B, H = RS_BF16_TBH
    inp = cgs_ligru_inputs(T, B, H, 520, dev, "relu", 1)
    g, w3g, drop, lay = (inp[n] for n in ("g", "w3g", "drop", "layout"))
    with env("PKC_SPARSE_SCAN_VMEM_MB", RS_BF16_VMEM_MB), torch.no_grad():
        if F.sparse_scan_fits(B, H, lay, 1) != "bf16":
            raise AssertionError("rnn_sparse_kernels: no bf16 case")
        route, n = rnn_fwd_sparse_launches(dev, T, B, lay, True)
        hs = launched(fwd, n, lambda: R.rnn_scan_fused_sparse(
            g, w3g, lay, drop, "relu", 16))
    record_check(checks, "rnn_sparse_kernels",
                 "fused_rnn_fwd_sparse/scan", dict(zip("TBH", RS_BF16_TBH)),
                 {"qbits": 16, "act": "relu", "Kb": lay.Kb, "R": lay.R,
                  "w3g": "bf16 (PKC_SPARSE_SCAN_VMEM_MB=%s)"
                         % RS_BF16_VMEM_MB, "route": route},
                 rel_err(hs, R.fused_rnn_fwd_sparse_plain(
                     g, w3g, drop, lay, "relu", 16, True)), TOL_BF16, False)
    shapes = rnn_sparse_shapes(checks, R, dev)
    print("[rnn_sparse_kernels] rows 36 and 37 by block shape: %s"
          % json.dumps(shapes))
    sync(dev)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError("a sparse RNN kernel disagrees with its plain "
                             "twin: %s" % bad)
    return checks


#: the steps at which rnn_sparse_shapes forces each block shape of rows
#: 36 and 37 (at 8 bi - 3 rows, as mgru_sparse_shapes': one ragged row
#: group)
RS_SHAPES_T = 24


def rnn_sparse_shapes(checks, R, dev):
    """Rows 36 and 37's persistent routes forced to every block shape
    their plans can take (fused_rnn.RNN_FWD_SPARSE_SHAPES,
    RNN_BWD_SPARSE_SHAPES) at the CGS-16x layout, 8 bi - 3 rows of 1024,
    relu, qbits 16, f32 w3g: each against its twin at TOL_Q16, the
    forward's hs and the BPTT's dg and rebuilt a_pre bit for bit its step
    route's; a shape whose grid is not co-resident is recorded as
    skipped."""
    out = {}
    for kind, shapes in (("fwd", R.RNN_FWD_SPARSE_SHAPES),
                         ("bwd", R.RNN_BWD_SPARSE_SHAPES)):
        for bi, un in shapes:
            T, B, H = RS_SHAPES_T, 8 * bi - 3, RS_TRAIN_TBH[2]
            inp = cgs_ligru_inputs(T, B, H, 540 + bi + un, dev, "relu", 1)
            g, w3g, drop, dhs, lay = (inp[n] for n in (
                "g", "w3g", "drop", "dhs", "layout"))
            dbh = torch.broadcast_to(drop, (B, H)).contiguous()
            where = {"T": T, "B": B, "H": H}
            variant = {"qbits": 16, "act": "relu", "Kb": lay.Kb, "R": lay.R,
                       "w3g": "f32", "route": "persist",
                       "block": "%d units x %d rows" % (un, 8 * bi)}
            kernel = "fused_rnn_%s_sparse" % kind
            plan = (R.rnn_fwd_sparse_plan(B, lay, (bi, un)) if kind == "fwd"
                    else R.rnn_bwd_sparse_plan(B, H, lay.bs, lay.C,
                                               (bi, un)))
            if not co_resident(kernel, plan):
                out["%s %s" % (kind, variant["block"])] = "not co-resident"
                continue

            def check(name, err_rel, tol, by_rel):
                record_check(checks, "rnn_sparse_kernels", kernel + name,
                             where, variant, err_rel, tol, by_rel)
            with torch.no_grad():
                fargs = (g, w3g, dbh, lay, "relu", 16, False)
                if kind == "fwd":
                    hs = R._rnn_fwd_sparse_persist(plan, *fargs)
                    check("/block", rel_err(
                        hs, R.fused_rnn_fwd_sparse_plain(*fargs)), TOL_Q16,
                        False)
                    check("/block_vs_step", bits_apart(
                        hs, R._rnn_fwd_sparse_step(*fargs)), 0.0, False)
                else:
                    hs = R.fused_rnn_fwd_sparse(*fargs)
                    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                    args = (g, w3g, dbh, h_prev, dhs, lay, "relu", 16, False)
                    dg, pre = R._rnn_bwd_sparse_persist(plan, *args,
                                                        with_pre=True)
                    dg_st, pre_st = R._rnn_bwd_sparse_step(*args,
                                                           with_pre=True)
                    check("/block", rel_err(
                        dg, R.fused_rnn_bwd_sparse_plain(*args)), TOL_Q16,
                        True)
                    check("/block_vs_step", bits_apart(dg, dg_st), 0.0,
                          False)
                    check("/block_rebuild_pre_vs_step",
                          bits_apart(pre, pre_st), 0.0, False)
            out["%s %s" % (kind, variant["block"])] = "checked"
    return out


def phase_rnn_sparse_stream(dev, rec, audio, lens, phones, logp, noq,
                            chunk=100):
    """A stream drops the sparse layout (as the JAX package's does) and
    runs the dense seeded RNN forward over the masked U, each layer's
    call a chunk on its route (rnn_stream_count: one launch a call on the
    persistent route): one chunk of the whole utterance against the sparse
    whole-utterance posteriors within TOL_Q16, chunks of 100 against the
    CPU's stream of the same chunks within TOL_POST_Q16 with equal phones
    (phase_ligru_stream); without the 16-bit quantizers, chunks of 100
    against the whole utterance within TOL_POST. ``noq``: phase_serve's
    (rec, phones, logp, ...) of the stack without them."""
    count = rnn_stream_count(dev, RS_LAYERS, N_UTT, RS_TRAIN_TBH[2])
    launches, out = phase_ligru_stream(
        dev, rec, audio, lens, phones, logp, chunk, build_rnn_sparse_stack,
        "rnn_sparse_stream", TOL_Q16, "fused_rnn_fwd", RS_LAYERS, count)
    rec_noq, phones_noq, logp_noq = noq[:3]
    _, out["chunks_vs_whole_no_quant_inp"] = phase_stream(
        dev, rec_noq, audio, lens, phones_noq, logp_noq, chunk,
        "rnn_sparse_stream, rnn_quant_inp=False", TOL_POST, "fused_rnn_fwd",
        RS_LAYERS, count)
    return launches, out


def rnn_sparse_train_setup(compute_dtype="", quant_inp=True, lr_scale=1.0,
                           act=None):
    """The CGS-16x RNN train step (chunk_setup): its sections, 8
    sentences of 300 frames, fMLLR x of width 40 and cd labels."""
    T, B, _ = RS_TRAIN_TBH
    return chunk_setup(rnn_sparse_sections(compute_dtype, quant_inp,
                                           lr_scale, act),
                       T, B, "fmllr", TR_FEAT, CD_LABELS)


def rnn_sparse_train_runner(dev, compute_dtype="", quant_inp=True,
                            lr_scale=1.0, act=None):
    """A ChunkRunner over the CGS-16x RNN's sections and its one batch;
    ``runner.train_step(inp, mask, chip_smoke.dropout_gen())`` for masks
    that match the CPU's."""
    from pytorch_kaldi_cgs_tpu_torch.models import RNN
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    config, chunk, batch = rnn_sparse_train_setup(compute_dtype, quant_inp,
                                                  lr_scale, act)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    rnn = graph.nets["RNN_layers"]
    if type(rnn) is not RNN:
        raise AssertionError("the CGS-16x RNN cfg did not build an RNN")
    check_rnn_sparse(rnn)
    return ChunkRunner(graph, config), batch


def phase_rnn_sparse_train(dev):
    """One train step on the card against the CPU, held to GRAD_FLIP_K
    times the CPU's own one-ulp sensitivity (relu behind the 16-bit ceil
    quantizers, as the TIMIT RNN's and the Li-GRU's), launches per step
    (the sparse kernels alone, each layer call its route's,
    rnn_sparse_layer_launches: 1 forward and 4 backward a layer on the
    persistent routes; one dw launch per layer; no dense RNN kernel; the
    same under PKC_BWD_STASH_CELLS=rnn, as the sparse RNN has no stash
    variant), 10 steps in f32 and bf16 at TR_FALL_LR_SCALE times the
    cfg's rates (the cfg's own diverge on random labels, in both
    packages); the same step with rnn_act=tanh and no 16-bit quantizers
    (no relu' flips at 0, no ceil steps) at TOL_GRAD_REL."""
    T = RS_TRAIN_TBH[0]
    knob = "PKC_BWD_STASH_CELLS"
    inp, mask = rnn_sparse_train_setup()[2]
    sens, where = ulp_sensitivity(rnn_sparse_train_runner, inp, mask,
                                  TR_FEAT)
    grad_tol = max(TOL_GRAD_REL, GRAD_FLIP_K * sens)
    print("[rnn_sparse_train] the CPU's own gradients under a one-ulp change "
          "of x: worst rel change %.3g at %s; card vs CPU bar %.3g"
          % (sens, where, grad_tol))
    n = rnn_sparse_layer_launches(dev, T, RS_TRAIN_TBH[1], 16, True)
    want = expected(block_sparse_dw=RS_LAYERS,
                    **{k: RS_LAYERS * v for k, v in n.items()})
    out = phase_train(dev, rnn_sparse_train_runner, "rnn_sparse_train", (
        ("recompute", knob, None, want), ("stash_knob", knob, "rnn", want)),
        grad_tol=grad_tol, fall_runner=lambda d, cdt="":
        rnn_sparse_train_runner(d, cdt, lr_scale=TR_FALL_LR_SCALE))
    out.update(cpu_ulp_grad_rel_change=sens, cpu_ulp_worst=where)

    def strict(d, cdt=""):
        return rnn_sparse_train_runner(d, cdt, quant_inp=False, act="tanh")
    runner, (inp, mask) = strict(dev)
    loss_err = runner.train_step(inp, mask, dropout_gen())
    out["tanh_no_quant_inp"] = card_vs_cpu(
        runner, strict("cpu")[0], inp, mask, loss_err, knob, None,
        "rnn_sparse_train, rnn_act=tanh, rnn_quant_inp=False")
    return out


def phase_rnn_sparse_times(dev, rec, audio, lens):
    """CUDA-event times of the sparse RNN kernels per layer call at the
    training shape (the forward also at the serving shape), as the model
    runs them (relu, 16-bit recurrent quantizer, Kb=8, R=2, f32 w3g);
    their twins and bounds; each one's route and plan, us a step, the
    BPTT's rebuild / chain split, each block shape of their tables
    (forced, co-resident ones); the dense fused RNN kernels on the same
    layer (the masked U); cuDNN's nn.RNN(1024, 1024, relu) at B=8 as a
    yardstick (dense, no quantizer: not the same function); the dU dw
    product; the CGS-16x RNN train step and recognize."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = RS_TRAIN_TBH
    Ts, Bs, _ = RS_SERVE_TBH
    qb, act = 16, "relu"
    inp = cgs_ligru_inputs(T, B, H, 530, dev, act, 1)
    g, w3g, drop, dhs, lay = (inp[n] for n in ("g", "w3g", "drop", "dhs",
                                               "layout"))
    kept = lay.R * lay.bs
    times = {}
    with torch.no_grad():
        hs = R.fused_rnn_fwd_sparse(g, w3g, drop, lay, act, qb)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        bargs = (g, w3g, drop, h_prev, dhs, lay, act, qb)
        calls = {
            "fused_rnn_fwd_sparse": (
                lambda: R.fused_rnn_fwd_sparse(g, w3g, drop, lay, act, qb),
                lambda: R.fused_rnn_fwd_sparse_plain(g, w3g, drop, lay, act,
                                                     qb), "fwd"),
            "fused_rnn_bwd_sparse": (
                lambda: R.fused_rnn_bwd_sparse(*bargs),
                lambda: R.fused_rnn_bwd_sparse_plain(*bargs), "bwd")}
        for name, (fn, plain, kind) in calls.items():
            times[name + "_ms"] = cuda_ms(fn, reps=10)
            times[name + "_plain_ms"] = cuda_ms(plain, reps=2, warmup=1)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                rnn_bound_ms(T, B, H, kind, kept)
        times["fused_rnn_fwd_sparse_ms_q0"] = cuda_ms(
            lambda: R.fused_rnn_fwd_sparse(g, w3g, drop, lay, act, 0),
            reps=10)
        for k in ("fused_rnn_fwd_sparse", "fused_rnn_bwd_sparse"):
            times[k + "_plan"] = chain_route(dev, k, B, layout=lay)[1]
            times[k + "_us_per_step"] = 1e3 * times[k + "_ms"] / T
        times["fused_rnn_bwd_sparse_split"] = bptt_split(
            calls["fused_rnn_bwd_sparse"][0], 3)
        times.update(rnn_sparse_block_shapes(g, w3g, drop, h_prev, dhs, lay,
                                             act, qb))
        # the dense RNN kernels on the same layer: the masked U
        U = torch.as_tensor(np.ascontiguousarray(
            BS.unpack_w3(w3g.cpu().numpy(), lay), np.float32), device=dev)
        times["dense_fused_rnn_fwd_ms"] = cuda_ms(
            lambda: R.fused_rnn_fwd(g, U, drop, act=act, qbits=qb), reps=10)
        times["dense_fused_rnn_bwd_ms"] = cuda_ms(
            lambda: R.fused_rnn_bwd(g, U, drop, h_prev, dhs, act, qb),
            reps=10)
        sv = cgs_ligru_inputs(Ts, Bs, H, 531, dev, act, 1)
        sargs = (sv["g"], sv["w3g"], sv["drop"], sv["layout"], act, qb)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_rnn_fwd_sparse(*sargs), reps=10)
        times["serve_fwd_plain_ms"] = cuda_ms(
            lambda: R.fused_rnn_fwd_sparse_plain(*sargs), reps=2, warmup=1)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            rnn_bound_ms(Ts, Bs, H, "fwd", kept)
        # the dU product on the dw kernel: G=1 over (T*B, H)
        dg = torch.randn(T * B, H, device=dev)
        hq = torch.randn(T * B, H, device=dev)
        times["dU_dw_ms"] = cuda_ms(lambda: R.sparse_dU(dg, hq, lay, 1),
                                    reps=20)
    times.update(cudnn_times(dev, T, B, H, Ts, Bs,
                             torch.nn.RNN(H, H, nonlinearity="relu"),
                             "cudnn_rnn1024"))
    times["serve_fwd_plan"] = chain_route(dev, "fused_rnn_fwd_sparse", Bs,
                                          layout=lay)[1]
    print("[rnn_sparse_times] kernels at T=%d B=%d H=%d (relu, qbits 16, "
          "Kb=%d, R=%d): %s" % (T, B, H, lay.Kb, lay.R, json.dumps(times)))
    step = train_step_times(dev, rnn_sparse_train_runner, "rnn_sparse_times",
                            5, 3)
    serve = serve_timings(rec, audio, lens)
    print("[rnn_sparse_times] CGS-16x RNN recognizer (8 x 4 s batch): %s"
          % json.dumps(serve))
    return times, step, serve


#: Each dense wrapper and the backward kind its width limit counts
DENSE_WIDTH_CASES = (
    ("lstm", "fwd", "fused_lstm_fwd"),
    ("lstm", "stash", "fused_lstm_bwd_stash"),
    ("lstm", "recompute", "fused_lstm_bwd"),
    ("ligru", "fwd", "fused_ligru_fwd"),
    ("ligru", "stash", "fused_ligru_bwd_stash"),
    ("ligru", "recompute", "fused_ligru_bwd"),
    ("gru", "fwd", "fused_gru_fwd"), ("gru", "stash", "fused_gru_bwd_stash"),
    ("gru", "recompute", "fused_gru_bwd"), ("mgru", "fwd", "fused_mgru_fwd"),
    ("mgru", "stash", "fused_mgru_bwd_stash"),
    ("mgru", "recompute", "fused_mgru_bwd"), ("rnn", "fwd", "fused_rnn_fwd"),
    ("rnn", "stash", "fused_rnn_bwd_stash"),
    ("rnn", "recompute", "fused_rnn_bwd"),
    ("gru_torch", "fwd", "fused_gru_torch_fwd"),
    ("gru_torch", "recompute", "fused_gru_torch_bwd"))
GATES = {"lstm": 4, "ligru": 2, "gru": 3, "mgru": 2, "rnn": 1,
         "gru_torch": 3}
# the width check: a 2048-wide LSTM layer (beyond both LSTM backwards,
# within the forward) trains on the plain step loop
WIDE_LSTM_TBH = (50, 8, 2048)


def dense_width_call(cell, kind, name, H, dev, T=2, B=1):
    """One call of the dense wrapper ``name`` at width H on zeros."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    z = lambda *s: torch.zeros(s, device=dev)
    G = GATES[cell]
    lead, U, seq, drop = z(T, B, G * H), z(G * H, H), z(T, B, H), z(B, H)
    fn = getattr(F if cell == "lstm" else R, name)
    if cell == "gru_torch":
        args = (lead, U, z(G * H)) + ((seq, seq) if kind != "fwd" else ())
    elif cell == "lstm" and kind != "fwd":
        args = (lead, U, drop, seq, seq, seq)
    elif cell == "rnn" and kind == "stash":
        args = (lead, U, drop, seq)
    else:
        args = (lead, U, drop) + ((seq, seq) if kind != "fwd" else ())
    with torch.no_grad():
        return fn(*args)


def wide_lstm_runner(dev, compute_dtype=""):
    """A 1 x 2048 LSTM (the flagship's options, one layer, no HCGS) ->
    the 1944-way head train step at WIDE_LSTM_TBH."""
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    T, B, H = WIDE_LSTM_TBH
    config, _, _ = train_setup(compute_dtype)
    secs = {k: dict(config[k]) for k in ("architecture1", "architecture2",
                                         "model")}
    secs["architecture1"] = dict(first_layer(secs["architecture1"], "lstm"),
                                 lstm_lay=str(H), lstm_hcgs="False")
    config, chunk, batch = chunk_setup(secs, T, B, "fea", FEAT, CD_LABELS)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    return ChunkRunner(graph, config), batch


def phase_dense_width(dev):
    """The dense kernels' width limits (fused_lstm.dense_max_width, from
    the shared memory their blocks stage): each dense wrapper runs at its
    limit (zeros, T=2, B=1) and raises a ValueError naming it one unit
    wider; a 2048-wide LSTM layer (past both LSTM backwards' limits)
    serves on the forward kernel and trains on the plain step loop with
    no LSTM kernel launched, its train step against the CPU's."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    out = {"limits": {}}
    for cell, kind, name in DENSE_WIDTH_CASES:
        limit = F.dense_max_width(cell, None if kind == "fwd" else kind)
        w = wrappers()[name]
        before = w.launches
        dense_width_call(cell, kind, name, limit, dev)
        sync(dev)
        n = w.launches - before
        if not n:
            raise AssertionError("%s launched nothing at H=%d" % (name, limit))
        try:
            dense_width_call(cell, kind, name, limit + 1, dev)
        except ValueError as e:
            if "H <= %d" % limit not in str(e):
                raise
        else:
            raise AssertionError("%s took H=%d past its limit" % (name,
                                                                  limit + 1))
        out["limits"][name] = {"H": limit, "launches": n}
        print("[dense_width] %s runs at H=%d (%d launches), refuses H=%d"
              % (name, limit, n, limit + 1))
        torch.cuda.empty_cache()
    T, B, H = WIDE_LSTM_TBH
    runner, (inp, mask) = wide_lstm_runner(dev)
    rnn = runner.graph.nets["LSTM_layers"]
    if list(rnn.lay) != [H] or rnn._fused_ok(0, True) \
            or not rnn._fused_ok(0):
        raise AssertionError("dense_width: the wide LSTM is not routed as "
                             "expected")
    x = torch.as_tensor(inp[..., :FEAT], device=dev)
    with torch.no_grad():
        _, l_eval = counted(lambda: rnn.run(x, train=False))
    (loss, err), l_train = counted(
        lambda: runner.train_step(inp, mask, dropout_gen()))
    if l_eval != expected(fused_lstm_fwd=T) or l_train != expected():
        raise AssertionError("dense_width: launches %s (eval), %s (train)"
                             % (l_eval, l_train))
    out["wide_lstm"] = card_vs_cpu(
        runner, wide_lstm_runner("cpu")[0], inp, mask, (loss, err),
        "PKC_LSTM_BWD_RECOMPUTE", None,
        "dense_width, 1 x %d LSTM on the plain loop" % H)
    out["wide_lstm"]["eval_launches"] = l_eval["fused_lstm_fwd"]
    return out


def phase_mgru_stream_tanh(dev, audio, lens, relu):
    """The dense minimalGRU as shipped but with minimalgru_act = tanh
    (the 16-bit quantizers on): chunks of 100 frames on the card against
    the CPU's stream of the same chunks, within TOL_POST_Q16 with equal
    phones. Beside the relu stream's difference (``relu``, mgru_stream's
    result) it says which of relu or the quantizer moves the chunked
    stream past 1e-3: the quantizer if the tanh stream is past it too."""
    def stack(d):
        from pytorch_kaldi_cgs_tpu_torch.models import MLP, minimalGRU
        secs = mgru_sections(act="tanh")
        rnn = minimalGRU(dict(secs["architecture1"], to_do="forward"),
                         LG_FEAT, seed=0, device=d)
        mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
                  seed=1, device=d)
        check_mgru(rnn, False)
        with torch.no_grad():
            mlp.params["w0"].mul_(MGRU_HEAD_GAIN)
        return Stack(rnn, mlp).eval()
    T = build_recognizer("cpu", stack).frontend.num_frames(audio.shape[1])
    streamed, final, launches = stream_run(
        dev, build_recognizer(dev, stack), audio, lens, 100)
    if launches != expected(fused_mgru_fwd=dense_fwd_stream_launches(
            dev, "fused_mgru_fwd", T, 100, N_UTT, MG_TRAIN_TBH[2], 2, 16)):
        raise AssertionError("mgru_stream_tanh: launches %s" % launches)
    ref, final_ref, _ = stream_run("cpu", build_recognizer("cpu", stack),
                                   audio, lens, 100)
    err = float(np.abs(streamed - ref).max())
    cause = "the 16-bit quantizer" if err > 1e-3 else "relu"
    out = {"chunked_card_vs_cpu_tanh": err,
           "chunked_card_vs_cpu_relu": relu["chunked_card_vs_cpu"],
           "phones_equal": final == final_ref,
           "past_1e-3_by": cause}
    print("[mgru_stream_tanh] chunks of 100, card vs CPU: tanh %.3g, relu "
          "%.3g (tol %g); phones equal: %s; the gap past 1e-3 comes with %s"
          % (err, relu["chunked_card_vs_cpu"], TOL_POST_Q16,
             final == final_ref, cause))
    if not err <= TOL_POST_Q16 or final != final_ref:
        raise AssertionError("mgru_stream_tanh disagrees with the CPU stream")
    return out


def slice10_rows(checks, times, launches):
    """The kernels JSON rows of the sparse RNN: ``ms`` etc. per layer
    call at RS_TRAIN_TBH (relu, qbits 16, Kb=8, R=2, f32 w3g; the
    forward also at RS_SERVE_TBH); ``launches`` counts one CGS-16x RNN
    train step; ``max_abs_err`` is the check at RS_TRAIN_TBH, relu,
    qbits 0, f32 w3g; ``library_ms`` is cuDNN's nn.RNN(1024, 1024,
    relu) at B=8, a yardstick (dense, no quantizer)."""
    T, B, H = RS_TRAIN_TBH
    shape = {"T": T, "B": B, "H": H, "Kb": 8, "R": 2, "bs": 128,
             "act": "relu", "qbits": 16, "w3g": "f32"}
    yard = "cuDNN nn.RNN(1024, 1024, relu) %s at B=8: a yardstick (dense, " \
           "no quantizer)"

    def row(name, line, library_ms, note, **extra):
        mine = [c for c in checks if c["kernel"].split("/")[0] == name]
        err = [c for c in mine if c["kernel"] == name
               and (c["T"], c["B"], c["H"]) == RS_TRAIN_TBH
               and c["qbits"] == 0 and c["act"] == "relu"
               and c["w3g"] == "f32"][0]["max_abs_err"]
        r = {"name": name, "route": "cuda",
             "source": "pytorch_kaldi_cgs_tpu_torch/ops/csrc/"
                       "fused_rnn_sparse.cu",
             "replaces": "pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:%d" % line,
             "launches": launches[name]["main"],
             "launches_by_path": launches[name], "max_abs_err": err,
             "ms": times[name + "_ms"], "plain_ms": times[name + "_plain_ms"],
             "bound_ms": times[name + "_bound_ms"],
             "bound_by": times[name + "_bound_by"], "library_ms": library_ms,
             "library_note": note, "shape": shape, "checks": len(mine),
             "checks_ok": all(c["ok"] for c in mine)}
        r.update(extra)
        return r
    return [
        row("fused_rnn_fwd_sparse", 1779, times["cudnn_rnn1024_fwd_ms"],
            yard % "forward", ms_q0=times["fused_rnn_fwd_sparse_ms_q0"],
            plan=times["fused_rnn_fwd_sparse_plan"],
            us_per_step=times["fused_rnn_fwd_sparse_us_per_step"],
            by_block_shape=times["fused_rnn_fwd_sparse_by_block_shape"],
            dense_fused_rnn_fwd_ms=times["dense_fused_rnn_fwd_ms"],
            serve={"T": RS_SERVE_TBH[0], "B": RS_SERVE_TBH[1], "H": H,
                   "ms": times["serve_fwd_ms"],
                   "plain_ms": times["serve_fwd_plain_ms"],
                   "bound_ms": times["serve_fwd_bound_ms"],
                   "bound_by": times["serve_fwd_bound_by"],
                   "library_ms": times["cudnn_rnn1024_serve_fwd_ms"],
                   "plan": times["serve_fwd_plan"]}),
        row("fused_rnn_bwd_sparse", 1818, times["cudnn_rnn1024_bwd_ms"],
            yard % "backward (fwd+bwd minus fwd)",
            plan=times["fused_rnn_bwd_sparse_plan"],
            split=times["fused_rnn_bwd_sparse_split"],
            us_per_step=times["fused_rnn_bwd_sparse_us_per_step"],
            by_block_shape=times["fused_rnn_bwd_sparse_by_block_shape"],
            dense_fused_rnn_bwd_ms=times["dense_fused_rnn_bwd_ms"],
            dU_dw_ms=times["dU_dw_ms"])]


def slice9_rows(checks, times, launches):
    """The kernels JSON rows of the five minimalGRU kernels: ``ms`` etc.
    per layer call at MG_TRAIN_TBH (relu, qbits 16; the sparse ones at
    Kb=8, R=2, f32 w3g; the forwards also at MG_SERVE_TBH); ``launches``
    counts one train step (the default backward; the other one for the
    kernel only it runs); ``max_abs_err`` is the check at MG_TRAIN_TBH,
    relu, qbits 0; ``library_ms`` is cuDNN's nn.GRU(1024, 1024) at B=8,
    a yardstick (no PyTorch call computes this function)."""
    T, B, H = MG_TRAIN_TBH
    fr = "pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:%d"
    src = "pytorch_kaldi_cgs_tpu_torch/ops/csrc/%s.cu"
    yard = "cuDNN nn.GRU(1024, 1024) %s at B=8: a yardstick (three gates, " \
           "dense, no quantizer)"
    bwd_note = yard % "backward (fwd+bwd minus fwd)"

    def err_at(kernel):
        return [c for c in checks if c["kernel"] == kernel
                and (c["T"], c["B"], c["H"]) == MG_TRAIN_TBH
                and c["qbits"] == 0 and c["act"] == "relu"
                and c.get("w3g", "f32") == "f32"][0]["max_abs_err"]

    def row(name, source, line, err, library_ms, note, **extra):
        mine = [c for c in checks if c["kernel"].split("/")[0] == name]
        r = {"name": name, "route": "cuda", "source": src % source,
             "replaces": fr % line, "launches": launches[name]["main"],
             "launches_by_path": launches[name], "max_abs_err": err,
             "ms": times[name + "_ms"], "plain_ms": times[name + "_plain_ms"],
             "bound_ms": times[name + "_bound_ms"],
             "bound_by": times[name + "_bound_by"], "library_ms": library_ms,
             "library_note": note,
             "shape": {"T": T, "B": B, "H": H, "act": "relu", "qbits": 16},
             "checks": len(mine), "checks_ok": all(c["ok"] for c in mine)}
        r.update(extra)
        return r

    def serve(prefix):
        return {"T": MG_SERVE_TBH[0], "B": MG_SERVE_TBH[1], "H": H,
                "ms": times[prefix + "serve_fwd_ms"],
                "plain_ms": times[prefix + "serve_fwd_plain_ms"],
                "bound_ms": times[prefix + "serve_fwd_bound_ms"],
                "bound_by": times[prefix + "serve_fwd_bound_by"],
                "library_ms": times["cudnn_gru_serve_fwd_ms"]}
    return [
        row("fused_mgru_fwd", "fused_gru", 771, err_at("fused_mgru_fwd/stash"),
            times["cudnn_gru_fwd_ms"], yard % "forward",
            variant="stash (the forward of a step under "
                    "PKC_BWD_STASH_CELLS=mgru); ms_nostash is the default "
                    "training and serving forward",
            ms_nostash=times["fused_mgru_fwd_nostash_ms"],
            ms_q0=times["fused_mgru_fwd_ms_q0"], serve=serve(""),
            plan=times["fused_mgru_fwd_plan"]),
        row("fused_mgru_bwd_stash", "fused_gru", 848,
            err_at("fused_mgru_bwd_stash"), times["cudnn_gru_bwd_ms"],
            bwd_note),
        row("fused_mgru_bwd", "fused_gru", 906, err_at("fused_mgru_bwd"),
            times["cudnn_gru_bwd_ms"], bwd_note,
            dU_matmul_ms=times["dU_matmul_ms"],
            plan=times["fused_mgru_bwd_plan"],
            split=times["fused_mgru_bwd_split"]),
        row("fused_mgru_fwd_sparse", "fused_gru_sparse", 1617,
            err_at("fused_mgru_fwd_sparse"), times["cudnn_gru_fwd_ms"],
            yard % "forward", serve=serve("sparse_"),
            sparse={"Kb": 8, "R": 2, "bs": 128, "w3g": "f32"},
            plan=times["fused_mgru_fwd_sparse_plan"]),
        row("fused_mgru_bwd_sparse", "fused_gru_sparse", 1663,
            err_at("fused_mgru_bwd_sparse"), times["cudnn_gru_bwd_ms"],
            bwd_note, sparse={"Kb": 8, "R": 2, "bs": 128, "w3g": "f32"},
            dU_dw_ms=times["dU_dw_ms"],
            plan=times["fused_mgru_bwd_sparse_plan"],
            split=times["fused_mgru_bwd_sparse_split"])]


def slice8_rows(cl_checks, cl_times, cl_launches, gt_checks, gt_times,
                gt_launches):
    """The kernels JSON rows of the CGS-16x Li-GRU slice and GRU_cudnn.
    The sparse liGRU's ``ms`` etc. are per layer call at CL_TRAIN_TBH
    (relu, qbits 16, Kb=8, R=2; the forward also at CL_SERVE_TBH);
    ``launches`` counts one CGS-16x Li-GRU train step; ``library_ms`` is
    cuDNN's nn.GRU(1024, 1024) at B=8, a yardstick. The torch GRU's are
    per layer call at GT_TRAIN_TBH; ``launches`` counts GRU_cudnn's
    4-layer train-mode forward + backward; ``library_ms`` is
    nn.GRU(550, 550), which computes the same function."""
    fr = "pytorch_kaldi_cgs_tpu/ops/fused_rnn.py:%d"
    src = "pytorch_kaldi_cgs_tpu_torch/ops/csrc/%s.cu"

    def err_at(checks, kernel, shape, **want):
        return [c for c in checks if c["kernel"] == kernel
                and (c["T"], c["B"], c["H"]) == shape
                and all(c.get(k) == v for k, v in want.items())][0][
                    "max_abs_err"]

    def row(name, source, line, times, launches, checks, err, library_ms,
            note, shape, **extra):
        mine = [c for c in checks if c["kernel"].split("/")[0] == name]
        r = {"name": name, "route": "cuda", "source": src % source,
             "replaces": fr % line, "launches": launches[name]["main"],
             "launches_by_path": launches[name], "max_abs_err": err,
             "ms": times[name + "_ms"], "plain_ms": times[name + "_plain_ms"],
             "bound_ms": times[name + "_bound_ms"],
             "bound_by": times[name + "_bound_by"], "library_ms": library_ms,
             "library_note": note, "shape": shape, "checks": len(mine),
             "checks_ok": all(c["ok"] for c in mine)}
        r.update(extra)
        return r

    T, B, H = CL_TRAIN_TBH
    sp = {"T": T, "B": B, "H": H, "Kb": 8, "R": 2, "bs": 128, "act": "relu",
          "qbits": 16}
    tt_ = {"T": GT_TRAIN_TBH[0], "B": GT_TRAIN_TBH[1], "H": GT_TRAIN_TBH[2]}
    yard = "cuDNN nn.GRU(1024, 1024) %s at B=8: a yardstick (three gates, " \
           "dense, no quantizer)"
    lib = "cuDNN nn.GRU(550, 550) %s: the same function"
    f32 = dict(qbits=0, act="relu", w3g="f32")
    return [
        row("fused_ligru_fwd_sparse", "fused_ligru_sparse", 1291, cl_times,
            cl_launches, cl_checks,
            err_at(cl_checks, "fused_ligru_fwd_sparse", CL_TRAIN_TBH, **f32),
            cl_times["cudnn_gru_fwd_ms"], yard % "forward", sp,
            ms_q0=cl_times["fused_ligru_fwd_sparse_ms_q0"],
            dense_fused_ligru_fwd_ms=cl_times["dense_fused_ligru_fwd_ms"],
            serve={"T": CL_SERVE_TBH[0], "B": CL_SERVE_TBH[1], "H": H,
                   "ms": cl_times["serve_fwd_ms"],
                   "plain_ms": cl_times["serve_fwd_plain_ms"],
                   "bound_ms": cl_times["serve_fwd_bound_ms"],
                   "bound_by": cl_times["serve_fwd_bound_by"],
                   "library_ms": cl_times["cudnn_gru_serve_fwd_ms"]}),
        row("fused_ligru_bwd_sparse", "fused_ligru_sparse", 1339, cl_times,
            cl_launches, cl_checks,
            err_at(cl_checks, "fused_ligru_bwd_sparse", CL_TRAIN_TBH, **f32),
            cl_times["cudnn_gru_bwd_ms"],
            yard % "backward (fwd+bwd minus fwd)", sp,
            dense_fused_ligru_bwd_ms=cl_times["dense_fused_ligru_bwd_ms"],
            dU_dw_ms=cl_times["dU_dw_ms"]),
        row("fused_gru_torch_fwd", "fused_gru_torch", 603, gt_times,
            gt_launches, gt_checks,
            err_at(gt_checks, "fused_gru_torch_fwd", GT_TRAIN_TBH),
            gt_times["cudnn_gru550_fwd_ms"], lib % "forward", tt_,
            serve={"T": GT_SERVE_TBH[0], "B": GT_SERVE_TBH[1],
                   "H": GT_SERVE_TBH[2], "ms": gt_times["serve_fwd_ms"],
                   "plain_ms": gt_times["serve_fwd_plain_ms"],
                   "bound_ms": gt_times["serve_fwd_bound_ms"],
                   "bound_by": gt_times["serve_fwd_bound_by"],
                   "library_ms": gt_times["cudnn_gru550_serve_fwd_ms"]}),
        row("fused_gru_torch_bwd", "fused_gru_torch", 651, gt_times,
            gt_launches, gt_checks,
            err_at(gt_checks, "fused_gru_torch_bwd", GT_TRAIN_TBH),
            gt_times["cudnn_gru550_bwd_ms"],
            lib % "backward (fwd+bwd minus fwd, so with its input "
            "projection's and dW's backward: port_layer_bwd_ms is the "
            "port's layer timed the same way)", tt_,
            plan=gt_times["fused_gru_torch_bwd_plan"],
            split=gt_times["fused_gru_torch_bwd_split"],
            port_layer_bwd_ms=gt_times["port_layer_bwd_ms"])]


# ---------------------------------------------------------------------------
# the legacy v1/v2 block-sparse matmul (rows 7-12): the ops-level API at the
# shapes of real layers; no model path runs it
# ---------------------------------------------------------------------------

# The libri GRU's layers 1-4 x-projection (gru_layout 1024 x 2048: Kb=16,
# R=4) at M = T * rows of its train step; the CGS-16x LSTM's 1024 x 1024
# recurrent layout (Kb=8, R=2) with its four gates at M = T*B of its step;
# the flagship's 143-wide input (HCGS 128,4 at 25,62.5, K-padded to 256)
# with the LSTM's four gates.
LB_M = GR_TRAIN_TBH[0] * GR_TRAIN_TBH[1]
LB_CGS_M = SP_TRAIN_TBH[0] * SP_TRAIN_TBH[1]
# kernel vs twin: float32 1e-5 of the twin's largest |value| (the same
# float32 sums in another order); a bf16 output one bf16 ulp of that
# value, bf16_ulp (both round one float32 sum, which can land on either
# side of a rounding boundary)
TOL_LB_F32 = 1e-5
LB_DTYPES = (("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"))
LB_WRAPPERS = ("bsl_fwd", "bsl_dx", "bsl_dw", "bsl_fwd_multi",
               "bsl_dx_multi", "bsl_dw_multi")


def bf16_ulp(scale):
    """One bf16 ulp at ``scale``: 2^(floor(log2 scale) - 7), between 2^-8
    and 2^-7 of it."""
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def api_tile(M):
    """The JAX API's row tile for M: its default 256 where that divides
    M, else the largest multiple of 8 below it that does (M=4800: 240)."""
    return max(t for t in range(8, 257, 8) if M % t == 0)


def uneven_layout():
    """tests/test_torch_block_sparse.py's uneven layout at bs=8: Nb=4,
    Kb=6, R=2, column 1 kept by every row (C=4), column 5 by none."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    occ = np.zeros((4, 6), np.float32)
    for j, cs in enumerate(((0, 1), (1, 2), (1, 3), (1, 4))):
        occ[j, list(cs)] = 1
    return BS.pack_layout(np.kron(occ, np.ones((8, 8), np.float32)), 8)


def legacy_layouts():
    """(name, layout, M, Gs, dtype rows) of the legacy kernels' checks."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.sparsity.hcgs import hcgs_mask
    small = BS.pack_layout(hcgs_mask(32, 48, [8], [50],
                                     rng=np.random.RandomState(0)), 8)
    flag = BS.pack_layout(hcgs_mask(TRAIN_TBH[2], FEAT, [128, 4],
                                    [25, 62.5], rng=np.random.RandomState(3)),
                          128, pad_k=True)
    small_dt = LB_DTYPES + (("f32", "bf16"),)
    return (("small_hcgs", small, 16, (1, 4), small_dt),
            ("small_uneven", uneven_layout(), 16, (1, 3), small_dt),
            ("libri_x", gru_layout(1024, 2048, 170)[1], LB_M, (1, 3),
             LB_DTYPES),
            ("cgs16x", cgs_layout(1024, 171)[1], LB_CGS_M, (4,), LB_DTYPES),
            ("k_padded_143", flag, LB_CGS_M, (4,), LB_DTYPES))


def legacy_operands(layout, G, M, seed, dev, xdt="f32", wdt="f32"):
    """x (M, K; a K-padded layout's pad columns zero), stacked w (nnz,
    G*bs, bs) and a flat cotangent (M, Nb*G*bs) in x's dtype."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    bs = layout.bs
    x = torch.randn(M, layout.K, device=dev, generator=gen)
    x[:, layout.k_true:] = 0
    w = torch.randn(layout.nnz, G * bs, bs, device=dev, generator=gen) \
        / np.sqrt(layout.R * bs)
    gy = torch.randn(M, layout.Nb * G * bs, device=dev, generator=gen)
    return x.to(dt[xdt]), w.to(dt[wdt]), gy.to(dt[xdt])


def legacy_calls(layout, G, x, w, gy):
    """(wrapper name, kernel call, twin call) of the three kernels at G:
    the v1 wrappers at G=1 (w as (nnz, bs, bs), the forward as (1, M, N)),
    the v2 ones above."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    if G == 1:
        return (("bsl_fwd", lambda: BS.bsl_fwd(x, w, layout)[None],
                 lambda: BS.bsl_fwd_plain(x, w, layout, 1)),
                ("bsl_dx", lambda: BS.bsl_dx(gy, w, layout),
                 lambda: BS.bsl_dx_plain(gy, w, layout, 1)),
                ("bsl_dw", lambda: BS.bsl_dw(gy, x, layout),
                 lambda: BS.bsl_dw_plain(gy, x, layout, 1)))
    return (("bsl_fwd_multi", lambda: BS.bsl_fwd_multi(x, w, layout, G),
             lambda: BS.bsl_fwd_plain(x, w, layout, G)),
            ("bsl_dx_multi", lambda: BS.bsl_dx_multi(gy, w, layout, G),
             lambda: BS.bsl_dx_plain(gy, w, layout, G)),
            ("bsl_dw_multi", lambda: BS.bsl_dw_multi(gy, x, layout, G),
             lambda: BS.bsl_dw_plain(gy, x, layout, G)))


def dense_of(w, layout, G):
    """Stacked blocks (nnz, G*bs, bs) -> the G dense (N, K) weights (G, N,
    K) with the dropped blocks zero, on w's device, float32."""
    bs = layout.bs
    rows = torch.as_tensor(layout.rows, dtype=torch.long, device=w.device)
    cols = torch.as_tensor(layout.cols, dtype=torch.long, device=w.device)
    dense = torch.zeros(G, layout.Nb, layout.Kb, bs, bs, device=w.device)
    dense[:, rows, cols] = w.float().reshape(layout.nnz, G, bs, bs) \
        .transpose(0, 1)
    return dense.permute(0, 1, 3, 2, 4).reshape(G, layout.N, layout.K)


def legacy_api_check(checks, name, layout, G, M, seed, dev):
    """block_sparse_matmul (G=1) or block_sparse_matmul_multi forward and
    backward on the card against the dense masked product (float32,
    TF32 off), with the launch counters set to 0 just before and read
    just after: one forward, one dx and one dw launch. -> launches."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    x, w, _ = legacy_operands(layout, G, M, seed, dev)
    if G == 1:
        w = w.reshape(layout.nnz, layout.bs, layout.bs)
    cot = torch.randn(G, M, layout.N, device=dev)
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()

    def run():
        if G == 1:
            y = BS.block_sparse_matmul(xt, wt, layout, api_tile(M))[None]
        else:
            y = BS.block_sparse_matmul_multi(xt, wt, layout, G, api_tile(M))
        y.backward(cot)
        return y.detach()
    y, launches = counted(run)
    v = "" if G == 1 else "_multi"
    want = expected(**{"bsl_fwd" + v: 1, "bsl_dx" + v: 1, "bsl_dw" + v: 1})
    if launches != want:
        raise AssertionError("legacy %s G=%d: launches %s" % (
            name, G, {k: n for k, n in launches.items() if n}))
    W = dense_of(w, layout, G)
    bs = layout.bs
    y_ref = torch.einsum("mk,gnk->gmn", x, W)
    dx_ref = torch.einsum("gmn,gnk->mk", cot, W)
    dW = torch.einsum("gmn,mk->gnk", cot, x).reshape(
        G, layout.Nb, bs, layout.Kb, bs).permute(1, 3, 0, 2, 4)
    rows = torch.as_tensor(layout.rows, dtype=torch.long, device=dev)
    cols = torch.as_tensor(layout.cols, dtype=torch.long, device=dev)
    dw_ref = dW[rows, cols].reshape(layout.nnz, G * bs, bs)
    sync(dev)
    for what, got, ref in (("y", y, y_ref), ("dx", xt.grad, dx_ref),
                           ("dw", wt.grad.reshape(dw_ref.shape), dw_ref)):
        record_check(checks, "legacy_bs_kernels",
                     "block_sparse_matmul" + v + "/" + what,
                     {"layout": name, "M": M, "G": G},
                     {"vs": "dense masked float32"}, rel_err(got, ref),
                     TOL_LB_F32, True)
    return launches


def phase_legacy_bs_kernels(dev):
    """The three legacy kernels through their six wrappers (v1 at G=1,
    v2 at G>1) against their twins on the card, one launch each, at the
    JAX tests' small shapes (bs=8: an HCGS and an uneven layout), the
    libri GRU's x-projection layout (M=6400, G=1 and 3), the CGS-16x
    LSTM's 1024 x 1024 (M=4800, G=4) and the flagship's K-padded 143-wide
    input (M=4800, G=4), in f32, bf16 and bf16 x with f32 w (and f32 x
    with bf16 w at the small shapes): float32 outputs within TOL_LB_F32
    of the twin's scale, bf16 ones within one bf16 ulp of it (bf16_ulp);
    both autograd Functions (the JAX row tile, api_tile) against the
    dense masked product with exact launch counts, once more with the
    six twins swapped for functions that raise (the card's path never
    reaches them). The dw also with the mixed pairs (float32 gy with bf16
    x and the reverse: its bsl_dw_tile route); each check names the route
    it took (BS.legacy_fwd_route, BS.legacy_dx_route, BS.legacy_dw_route).
    -> (checks, API-path launches by wrapper)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    checks = []
    cases = legacy_layouts()

    def check(wname, kernel, plain, where, variant):
        with torch.no_grad():
            got = launched(getattr(BS, wname), 1, kernel)
            sync(dev)
            ref = plain()
        if got.dtype != ref.dtype:
            raise AssertionError("%s: dtype %s, twin %s" % (
                wname, got.dtype, ref.dtype))
        bf16 = got.dtype == torch.bfloat16
        record_check(checks, "legacy_bs_kernels", wname, where,
                     dict(variant, out=str(got.dtype).split(".")[-1]),
                     rel_err(got.float(), ref.float()),
                     bf16_ulp(float(ref.float().abs().max()))
                     if bf16 else TOL_LB_F32, not bf16)

    for name, layout, M, Gs, dts in cases:
        where = {"layout": name, "M": M, "K": layout.K, "N": layout.N,
                 "Kb": layout.Kb, "R": layout.R, "C": layout.C,
                 "bs": layout.bs}
        for G in Gs:
            for k, (xdt, wdt) in enumerate(dts):
                x, w, gy = legacy_operands(layout, G, M, 200 + k, dev, xdt,
                                           wdt)
                if G == 1:
                    w = w.reshape(layout.nnz, layout.bs, layout.bs)
                for wname, kernel, plain in legacy_calls(layout, G, x, w, gy):
                    variant = {"G": G, "x": xdt, "w": wdt}
                    op = wname.split("_")[1]
                    if op == "dw":
                        variant["route"] = BS.legacy_dw_route(gy, x,
                                                              layout.bs)
                    elif op == "fwd":
                        variant["route"] = BS.legacy_fwd_route(x, w,
                                                               layout.bs)
                    else:
                        variant["route"] = BS.legacy_dx_route(gy, w,
                                                              layout.bs)
                    check(wname, kernel, plain, where, variant)
                if k == 0:      # f32: the dw's mixed pairs
                    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
                    for gdt, xdt_ in (("f32", "bf16"), ("bf16", "f32")):
                        gm, xm = gy.to(dt[gdt]), x.to(dt[xdt_])
                        wname, kernel, plain = legacy_calls(
                            layout, G, xm, w, gm)[2]
                        check(wname, kernel, plain, where, {
                            "G": G, "gy": gdt, "x": xdt_, "w": "-",
                            "route": BS.legacy_dw_route(gm, xm, layout.bs)})
                del x, w, gy
        torch.cuda.empty_cache()
    api = dict.fromkeys(LB_WRAPPERS, 0)
    for name, layout, M, Gs, _ in cases[2:]:
        for G in Gs:
            for k, n in legacy_api_check(checks, name, layout, G, M, 210,
                                         dev).items():
                if k in api:
                    api[k] += n

    def boom(*a, **k):
        raise AssertionError("a legacy twin ran on the card's path")
    twins = ("bsl_fwd_plain", "bsl_dx_plain", "bsl_dw_plain")
    with contextlib.ExitStack() as stack:
        for t in twins:
            stack.enter_context(swapped(BS, t, boom))
        for k, n in legacy_api_check(checks, "libri_x, twins swapped out",
                                     cases[2][1], 3, LB_M, 211,
                                     dev).items():
            if k in api:
                api[k] += n
    bad = [c for c in checks if not c["ok"]]
    print("[legacy_bs_kernels] %d checks, %d failed; API-path launches %s"
          % (len(checks), len(bad), api))
    if bad:
        raise AssertionError("legacy block-sparse kernels disagree: %s" % bad)
    return checks, api


def legacy_bound_ms(M, layout, G, op, dtype="f32"):
    """Least time for one legacy kernel call: each input read once, each
    output written once, over the HBM rate; 2*M*nnz*bs^2*G FMAs over the
    peak of the operands' type (the bf16 rows: bf16 operands; mixed ones
    count as f32). op: "fwd" (x, w in; (G, M, N) out), "dx" (gy, w in;
    (M, K) out), "dw" (gy, x in; w's shape out)."""
    bs, es = layout.bs, 2 if dtype == "bf16" else 4
    x, w, y = M * layout.K, layout.nnz * G * bs * bs, G * M * layout.N
    n = {"fwd": x + w + y, "dx": y + w + x, "dw": y + x + w}[op]
    return roofline_ms(n * es, 2 * M * layout.nnz * bs * bs * G, dtype)


def phase_legacy_bs_times(dev):
    """CUDA-event ms per call of each legacy kernel at the libri GRU's
    x-projection layout (M=6400; G=1 through the v1 wrappers, G=3 through
    the v2 ones; f32, and bf16 x and w), its twin, its bound and the
    library yardstick computing the same function: the dense-masked
    torch.matmul (fwd: x @ W.T, dx: gy @ W, W the (G*N, K) scattered
    weight) and, for dw, torch.bmm over the pre-gathered operands;
    the v3 kernels at the same G=3 shape (no quantizer or submask, the
    same function; and as the libri GRU runs them, qbits 8 with the
    submask); the three at the CGS-16x LSTM's G=4, M=4800 (f32, bf16);
    the device kernels of one call of each at each shape and dtype
    (``device_kernels``)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    times = {}
    (_, libri, _, _, _), (_, cgs, _, _, _) = legacy_layouts()[2:4]
    for layout, M, G, dts in ((libri, LB_M, 1, ("f32", "bf16")),
                              (libri, LB_M, 3, ("f32", "bf16")),
                              (cgs, LB_CGS_M, 4, ("f32", "bf16"))):
        tag = "libri_G%d" % G if layout is libri else "cgs16x_G4"
        bs = layout.bs
        rows = torch.as_tensor(layout.rows, dtype=torch.long, device=dev)
        cols = torch.as_tensor(layout.cols, dtype=torch.long, device=dev)
        for dt in dts:
            x, w, gy = legacy_operands(layout, G, M, 220, dev, dt, dt)
            if G == 1:
                w = w.reshape(layout.nnz, bs, bs)
            W = dense_of(w, layout, G).reshape(G * layout.N, layout.K) \
                .to(x.dtype)
            gyd = gy.reshape(M, layout.Nb, G, bs).permute(0, 2, 1, 3) \
                .reshape(M, G * layout.N).contiguous()
            gb = gy.reshape(M, layout.Nb, G * bs).transpose(0, 1)[rows] \
                .transpose(1, 2).contiguous()             # (nnz, G*bs, M)
            xb = x.reshape(M, layout.Kb, bs).transpose(0, 1)[cols] \
                .contiguous()                              # (nnz, M, bs)
            library = {"fwd": lambda: x @ W.T, "dx": lambda: gyd @ W,
                       "dw": lambda: torch.bmm(gb, xb)}
            with torch.no_grad():
                for wname, kernel, plain in legacy_calls(layout, G, x, w,
                                                         gy):
                    op = wname.split("_")[1]
                    key = "%s_%s_%s" % (tag, op, dt)
                    # 50 calls: the bf16 dw takes 0.03-0.1 ms a call
                    times[key + "_ms"] = cuda_ms(kernel, reps=50)
                    times[key + "_plain_ms"] = cuda_ms(plain, reps=3,
                                                       warmup=1)
                    times[key + "_library_ms"] = cuda_ms(library[op],
                                                         reps=20)
                    times[key + "_bound_ms"], times[key + "_bound_by"] = \
                        legacy_bound_ms(M, layout, G, op, dt)
                    times[key + "_device_kernels"] = device_kernels(kernel)
            del x, w, gy, W, gyd, gb, xb
            torch.cuda.empty_cache()
    # the v3 kernels at the libri G=3 shape
    v = v3_inputs(LB_M, 3, 152, dev)
    vl, x, w3, gy, sub3 = v["layout"], v["x"], v["w3"], v["gy"], v["sub3"]
    with torch.no_grad():
        for q, sub, sfx in ((0, None, ""), (8, sub3, "_q8_sub")):
            times["v3_fwd_ms" + sfx] = cuda_ms(
                lambda: BS.block_sparse_v3_fwd(x, w3, vl, 3, q, sub), reps=10)
            times["v3_dx_ms" + sfx] = cuda_ms(
                lambda: BS.block_sparse_v3_dx(gy, w3, vl, 3, q, sub), reps=10)
            times["v3_dw_ms" + sfx] = cuda_ms(
                lambda: BS.block_sparse_dw(gy, x, vl, 3, sub), reps=10)
            # the timed calls against their twins, and the split-M dw's
            # two calls bit for bit
            for op, got, ref in (
                    ("fwd", BS.block_sparse_v3_fwd(x, w3, vl, 3, q, sub),
                     BS.block_sparse_v3_fwd_plain(x, w3, vl, 3, q, sub)),
                    ("dx", BS.block_sparse_v3_dx(gy, w3, vl, 3, q, sub),
                     BS.block_sparse_v3_dx_plain(gy, w3, vl, 3, q, sub)),
                    ("dw", BS.block_sparse_dw(gy, x, vl, 3, sub),
                     BS.block_sparse_dw_plain(gy, x, vl, 3, sub))):
                rel = rel_err(got, ref)[1]
                times["v3_%s_rel_err%s" % (op, sfx)] = rel
                if not rel <= TOL_F32_SMALL:
                    raise AssertionError("v3 %s%s disagrees with its twin: "
                                         "%.3g" % (op, sfx, rel))
            err = same_bits(lambda: BS.block_sparse_dw(gy, x, vl, 3, sub))[0]
            if err:
                raise AssertionError("two split-M dw calls differ by %g"
                                     % err)
    print("[legacy_bs_times] libri x-projection (M=%d, K=%d, N=%d, Kb=%d, "
          "R=%d), CGS-16x (M=%d, Kb=%d, R=%d): %s"
          % (LB_M, libri.K, libri.N, libri.Kb, libri.R, LB_CGS_M, cgs.Kb,
             cgs.R, json.dumps(times)))
    return times


def slice11_rows(checks, times, api_launches):
    """The kernels JSON rows of the legacy API (rows 7-12): ``ms`` etc.
    per call at the libri x-projection layout, f32 (the v1 rows at G=1,
    the v2 rows at G=3), bf16 and the CGS-16x G=4 numbers beside them;
    ``launches`` counts the API path's calls in legacy_bs_kernels (the
    autograd Functions: one launch of each a call); no model path runs
    these kernels (0 launches in every other phase, by ``expected``);
    ``library_ms`` computes the same function (the dense-masked
    torch.matmul, or torch.bmm over the gathered operands for dw). All six
    rows, redesigned, name their routes and the device kernels of one
    call."""
    bsp = "pytorch_kaldi_cgs_tpu/ops/block_sparse.py:%d"
    csrc = "pytorch_kaldi_cgs_tpu_torch/ops/csrc/%s.cu"
    stats = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    lib = {"fwd": "dense-masked torch.matmul x @ W.T, W (G*N, K)",
           "dx": "dense-masked torch.matmul gy @ W",
           "dw": "torch.bmm over the pre-gathered (nnz, G*bs, M) and "
                 "(nnz, M, bs) operands"}
    rows = []
    for name, replaces in zip(LB_WRAPPERS, (198, 248, 294, 380, 439, 487)):
        op = name.split("_")[1]
        G = 3 if name.endswith("multi") else 1
        key = "libri_G%d_%s_" % (G, op)
        mine = [c for c in checks if c["kernel"] == name]
        err = [c for c in mine if c["layout"] == "libri_x"
               and c["x"] == c["w"] == "f32"][0]["max_abs_err"]
        dw = op == "dw"
        r = {"name": name, "route": "cuda",
             "source": csrc % {"dw": "block_sparse_dw",
                               "fwd": "block_sparse_v3",
                               "dx": "block_sparse_dx"}[op],
             "replaces": bsp % replaces, "launches": api_launches[name],
             "launches_by_path": {"api": api_launches[name],
                                  "model_paths": 0},
             "max_abs_err": err, "ms": times[key + "f32_ms"],
             "plain_ms": times[key + "f32_plain_ms"],
             "bound_ms": times[key + "f32_bound_ms"],
             "bound_by": times[key + "f32_bound_by"],
             "library_ms": times[key + "f32_library_ms"],
             "library_note": lib[op],
             "shape": {"M": LB_M, "K": 2048, "N": 1024, "G": G, "bs": 128,
                       "Kb": 16, "R": 4},
             "bf16": {k: times[key + "bf16_" + k] for k in stats},
             "checks": len(mine), "checks_ok": all(c["ok"] for c in mine)}
        if dw:
            r["status"] = "redesigned"
            r["routes"] = {
                "f32": "dw_gemm (bs_gemm.cuh) + dw_reduce where M is split",
                "bf16": "dw_mma (bs_mma.cuh, wgmma m64n128k16 bf16, "
                        "float32 sums) + dw_reduce where M is split",
                "mixed": "bsl_dw_tile (block_sparse_legacy.cu)"}
        elif op == "fwd":
            r["status"] = "redesigned"
            r["routes"] = {
                "f32 x (w f32 or bf16)": "packed_weight_t + v3_fwd_gemm "
                                         "(block_sparse_v3.cu, bs_gemm.cuh)",
                "bf16": "fwd_mma (block_sparse_v3.cu, bs_mma.cuh K-major, "
                        "wgmma m64n128k16 bf16, float32 sums)",
                "bf16 x, f32 w": "bsl_fwd_tile (block_sparse_legacy.cu)"}
        else:
            r["status"] = "redesigned"
            r["routes"] = {
                "f32": "dx_gemm (block_sparse_dx.cu, bs_gemm.cuh) + "
                       "dx_reduce where dx_plan splits a column",
                "bf16": "dx_mma (block_sparse_dx.cu, bs_mma.cuh: gy "
                        "K-major, w MN-major, wgmma m64n128k16 bf16, "
                        "float32 sums) + dx_reduce where dx_plan splits",
                "mixed": "bsl_dx_tile (block_sparse_legacy.cu)"}
        r["device_kernels_per_call"] = {
            dt: times[key + dt + "_device_kernels"] for dt in ("f32", "bf16")}
        if G == 3:
            r["cgs16x_G4"] = {k: times["cgs16x_G4_%s_f32_" % op + k]
                              for k in stats}
            r["cgs16x_G4_bf16"] = {k: times["cgs16x_G4_%s_bf16_" % op + k]
                                   for k in stats}
            r["v3_same_shape_ms"] = times["v3_%s_ms" % op]
        rows.append(r)
    return rows


# ---------------------------------------------------------------------------
# rows 13 and 15 on the register-blocked GEMM tile: every shape a model
# path launches them at
# ---------------------------------------------------------------------------

def dw_shapes():
    """(tag, layout, M, G, sub3 or None) of every dw call on a model path:
    the CGS-16x LSTM's dU (G=4, M=4800), the libri GRU's v3 dw (G=3, K=2048,
    R=4, with the submask) and its dU (G=1 over q(r*h), G=2 over q(h); K=H,
    R=2), the CGS-16x Li-GRU's dU (G=2) and the CGS-16x minimalGRU's and
    RNN's (G=1) at T=300, B=8."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    cgs = cgs_layout(1024, 230)[1]
    mask, v3 = gru_layout(1024, 2048, 231, pad_k=True)
    rec = gru_layout(1024, 1024, 232)[1]
    sub = BS.stack_w3_gates([BS.pack_w3(mask, v3)] * 3)
    return (("cgs16x_lstm_G4", cgs, 4800, 4, None),
            ("libri_v3_G3", v3, 6400, 3, sub),
            ("libri_dU_G1", rec, 6400, 1, None),
            ("libri_dU_G2", rec, 6400, 2, None),
            ("cgs16x_ligru_G2", cgs, 2400, 2, None),
            ("cgs16x_mgru_rnn_G1", cgs, 2400, 1, None))


def legacy_dw_shapes():
    """(tag, layout, M, G) of the timed legacy dw calls (rows 9 and 12):
    the libri x-projection (Kb=16, R=4) at G=1 and 3, M=6400; the CGS-16x
    LSTM's 1024 x 1024 (Kb=8, R=2) at G=4, M=4800."""
    (_, libri, _, _, _), (_, cgs, _, _, _) = legacy_layouts()[2:4]
    return (("libri_G1", libri, LB_M, 1), ("libri_G3", libri, LB_M, 3),
            ("cgs16x_G4", cgs, LB_CGS_M, 4))


def dw_bound_ms(M, layout, G, sub=False):
    """Least time for one dw call in float32: dg (M, Nb*G*bs) and x (M,
    K) in (and sub3), dw3g out; 2*M*Nb*G*bs*R*bs FMAs over the float32
    peak."""
    w = layout.Nb * G * layout.bs * layout.R * layout.bs
    return roofline_ms((M * layout.Nb * G * layout.bs + M * layout.K
                        + w * (2 if sub else 1)) * 4, 2 * M * w)


def phase_bs_gemm_times(dev, reps=20):
    """CUDA-event ms per call of row 15 (the dw kernel) at every shape of
    dw_shapes beside torch.bmm of the same gathered operands (the same
    function in one PyTorch call) and its bound, and of row 13 (the v3
    forward) at the libri GRU's training and serving M with and without
    the 8-bit quantizer and the submask beside the dense-masked
    torch.matmul, and row 14 (dx) re-timed; the legacy API's three
    kernels (bsl_fwd / bsl_dx / bsl_dw at G=1, the _multi wrappers above:
    rows 7-12) at legacy_dw_shapes in f32 and bf16, the forward and dx
    beside the dense-masked torch.matmul, the dw beside torch.bmm of the
    pre-gathered operands, each in the same dtype, and their bounds; the
    device kernels of one call of each (``device_kernels``), its host
    time per call (``host_ms``) and its kernels' device time per call
    (``kernel_ms``). Only the
    public wrappers are called, so the same phase times an earlier tree's
    kernels (``--gemm-times DIR``)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    times = {}
    gen = torch.Generator(device=dev).manual_seed(233)
    with torch.no_grad():
        for tag, layout, M, G, sub in dw_shapes():
            bs, Nb = layout.bs, layout.Nb
            dg = torch.randn(M, Nb * G * bs, device=dev, generator=gen)
            x = torch.randn(M, layout.K, device=dev, generator=gen)
            sub3 = None if sub is None else torch.tensor(sub, device=dev)
            dgb = dg.reshape(M, Nb, G * bs).permute(1, 2, 0).contiguous()
            xg = BS.gather_cols(x, layout).contiguous()
            times["dw_%s_ms" % tag] = cuda_ms(
                lambda: BS.block_sparse_dw(dg, x, layout, G, sub3), reps=reps)
            times["dw_%s_library_ms" % tag] = cuda_ms(
                lambda: torch.bmm(dgb, xg), reps=reps)
            times["dw_%s_bound_ms" % tag], times["dw_%s_bound_by" % tag] = \
                dw_bound_ms(M, layout, G, sub is not None)
            times["dw_%s_shape" % tag] = {
                "M": M, "G": G, "K": layout.K, "Nb": Nb, "R": layout.R,
                "bs": bs, "sub3": sub is not None}
            times["dw_%s_device_launches" % tag] = device_kernels(
                lambda: BS.block_sparse_dw(dg, x, layout, G, sub3))
            del dg, x, dgb, xg
        # the v3 pair at the libri layout (G=3, K=2048, R=4), qbits 8 with
        # the submask as the libri GRU runs it (and without), at the
        # training M = T*32 and (the forward) the serving M = 398*16;
        # gru_rows reads these keys
        G = 3
        for pre, (T, B, _) in (("block_sparse_v3_fwd", GR_TRAIN_TBH),
                               ("serve_v3_fwd", GR_SERVE_TBH)):
            M = T * B
            train = pre == "block_sparse_v3_fwd"
            v = v3_inputs(M, G, 234, dev)
            vl, sub3, w3 = v["layout"], v["sub3"], v["w3"]
            x = BS.pad_cols(v["x"], vl.K).contiguous()
            times[pre + "_ms"] = cuda_ms(
                lambda: BS.block_sparse_v3_fwd(x, w3, vl, G, 8, sub3),
                reps=reps)
            times[pre + "_ms_q0"] = cuda_ms(
                lambda: BS.block_sparse_v3_fwd(x, w3, vl, G, 0, None),
                reps=reps)
            times[pre + "_device_launches"] = device_kernels(
                lambda: BS.block_sparse_v3_fwd(x, w3, vl, G, 8, sub3))
            times[pre + "_bound_ms"], times[pre + "_bound_by"] = \
                v3_bound_ms(M, vl, G)
            W = torch.randn(G * vl.N, vl.K, device=dev, generator=gen)
            times[("" if train else "serve_") + "dense_masked_fwd_ms"] = \
                cuda_ms(lambda: x @ W.T, reps=reps)
            if train:
                gy = v["gy"]
                times[pre + "_plain_ms"] = cuda_ms(
                    lambda: BS.block_sparse_v3_fwd_plain(x, w3, vl, G, 8,
                                                         sub3),
                    reps=3, warmup=1)
                dx = "block_sparse_v3_dx"
                times[dx + "_ms"] = cuda_ms(
                    lambda: BS.block_sparse_v3_dx(gy, w3, vl, G, 8, sub3),
                    reps=reps)
                times[dx + "_plain_ms"] = cuda_ms(
                    lambda: BS.block_sparse_v3_dx_plain(gy, w3, vl, G, 8,
                                                        sub3),
                    reps=3, warmup=1)
                times[dx + "_bound_ms"], times[dx + "_bound_by"] = \
                    v3_bound_ms(M, vl, G)
                # its device kernels, each one's ms (the weight pass apart
                # from the GEMM) and, on the legacy dx's tile, the plan's
                # pick (dx_plan_sweep times every split beside it)
                dxcall = lambda: BS.block_sparse_v3_dx(gy, w3, vl, G, 8, sub3)
                times[dx + "_device_launches"] = device_kernels(dxcall)
                times[dx + "_kernels_ms"] = kernels_by_name(dxcall)
                if hasattr(BS, "v3_weight_packed_plain"):
                    pick = dx_plan_of(vl, M, G, "gemm", dev)
                    times[dx + "_plan"] = {"split": list(pick.split),
                                           "parts": pick.parts,
                                           "model_us": pick.cost_us}
                dy = torch.randn(M, G * vl.N, device=dev, generator=gen)
                times["dense_masked_dx_ms"] = cuda_ms(lambda: dy @ W,
                                                      reps=reps)
                del gy, dy
            del v, x, W
        torch.cuda.empty_cache()
        for tag, layout, M, G in legacy_dw_shapes():
            bs = layout.bs
            rows = torch.as_tensor(layout.rows, dtype=torch.long, device=dev)
            cols = torch.as_tensor(layout.cols, dtype=torch.long, device=dev)
            for dt in ("f32", "bf16"):
                x, w, gy = legacy_operands(layout, G, M, 235, dev, dt, dt)
                if G == 1:
                    w = w.reshape(layout.nnz, bs, bs)
                W = dense_of(w, layout, G).reshape(G * layout.N, layout.K) \
                    .to(x.dtype)
                gyd = gy.reshape(M, layout.Nb, G, bs).permute(0, 2, 1, 3) \
                    .reshape(M, G * layout.N).contiguous()
                gb = gy.reshape(M, layout.Nb, G * bs).transpose(0, 1)[rows] \
                    .transpose(1, 2).contiguous()         # (nnz, G*bs, M)
                xb = x.reshape(M, layout.Kb, bs).transpose(0, 1)[cols] \
                    .contiguous()                          # (nnz, M, bs)
                library = {"fwd": lambda: x @ W.T, "dx": lambda: gyd @ W,
                           "dw": lambda: torch.bmm(gb, xb)}
                for wname, call, _ in legacy_calls(layout, G, x, w, gy):
                    op = wname.split("_")[1]
                    key = "bsl_%s_%s_%s" % (op, tag, dt)
                    # 100 calls: a bf16 call takes 0.02-0.1 ms
                    times[key + "_ms"] = cuda_ms(call, reps=100)
                    times[key + "_library_ms"] = cuda_ms(library[op],
                                                         reps=100)
                    times[key + "_bound_ms"], times[key + "_bound_by"] = \
                        legacy_bound_ms(M, layout, G, op, dt)
                    times[key + "_device_launches"] = device_kernels(call)
                    # what bounds a short call: its host path per call
                    # against its kernels' device time per call
                    times[key + "_host_ms"] = host_ms(call)
                    times[key + "_kernel_ms"] = kernel_ms(call)
                del x, w, gy, W, gyd, gb, xb
            torch.cuda.empty_cache()
    print("[bs_gemm_times] %s" % json.dumps(times))
    return times


def host_path_us(dev, n=2000):
    """Host us per call of each piece of the legacy bf16 forward's path
    at the libri G=1 shape (the "mma" route): the output's torch.empty,
    the operand checks, the route, the device context and the Stream
    object the launch helper no longer builds where the device is
    current, the raw stream handle it reads instead, the ctypes launcher
    alone (cudaFuncSetAttribute once, then the launch), the launch helper
    whole and bsl_fwd whole; with a package that has the legacy dx's
    plan, the dx's route, its plan and table lookup (``_dx_work``) and
    bsl_dx whole at the same shape; calls enqueued back to back."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    _, layout, M, G = legacy_dw_shapes()[0]
    x, w, gy = legacy_operands(layout, G, M, 235, dev, "bf16", "bf16")
    w = w.reshape(layout.nnz, layout.bs, layout.bs)
    ys = torch.empty((1, M, layout.N), dtype=x.dtype, device=dev)
    dev = x.device
    ptrs = (x.data_ptr(), w.data_ptr(),
            layout.device_index("col_idx", dev).data_ptr(), None,
            ys.data_ptr())
    ints = (1, 1, M, layout.K, layout.N, layout.Nb, layout.R, layout.bs, 1,
            0)
    _, fn = BS._lib_fn("block_sparse_v3", "block_sparse_v3_fwd_packed",
                       len(ptrs), len(ints))
    stream = BS._raw_stream(dev.index)
    shape = (layout.nnz, layout.bs, layout.bs)

    def context():
        with torch.cuda.device(dev):
            pass
    parts = {
        "torch_empty": lambda: torch.empty((1, M, layout.N), dtype=x.dtype,
                                           device=dev),
        "check_operands": lambda: BS._check_operands(
            x, (("x", x, (M, layout.K)), ("w", w, shape)),
            BS._LEGACY_DTYPES),
        "legacy_fwd_route": lambda: BS.legacy_fwd_route(x, w, layout.bs),
        "device_context": context,
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: BS._raw_stream(dev.index),
        "ctypes_launcher": lambda: fn(*ptrs, *ints, stream),
        "launch_helper": lambda: BS._launch(
            "block_sparse_v3", "block_sparse_v3_fwd_packed", dev, ptrs, ints),
        "bsl_fwd": lambda: BS.bsl_fwd(x, w, layout)}
    if hasattr(BS, "legacy_dx_route"):
        parts.update({
            "legacy_dx_route": lambda: BS.legacy_dx_route(gy, w, layout.bs),
            "dx_work": lambda: BS._dx_work(layout, M, G, "mma", dev),
            "bsl_dx": lambda: BS.bsl_dx(gy, w, layout)})
    return {k: host_ms(f, n) * 1e3 for k, f in parts.items()}


def dx_plan_of(layout, M, G, route, dev, split=None):
    """The legacy dx's plan (BS.legacy_dx_plan) of a call on ``route``
    ("gemm" or "mma") at M and G on device ``dev``, or the forced
    ``split``."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    return BS.legacy_dx_plan(layout, M, G, route,
                             BS.gemm_grid(dev, BS.DX_TILE[route]), split)


def dx_plan_sweep(dev):
    """The legacy dx at each timed shape (legacy_dw_shapes), f32 and bf16,
    and, with a package that runs the v3 dx on the legacy dx's float32
    tile, the v3 dx at the libri GRU's training shape (M = 6400, G=3,
    qbits 8 with the submask, bs_gemm_times' operands), at every split the
    plan weighs (BS.dx_splits; splits that give the same items timed
    once), forced through the wrapper: per split the device time of one
    call's kernels (kernel_ms), the call's CUDA-event ms, the modelled us
    and the partial planes, beside the split the plan picks. ->
    {shape_dtype: ...}."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    out = {}
    plan_fn = BS.dx_plan

    def sweep(key, call, layout, M, G, route):
        pick = dx_plan_of(layout, M, G, route, dev)
        r = {"pick": list(pick.split), "pick_model_us": pick.cost_us}
        seen = set()
        for sp in BS.dx_splits(BS.column_counts(layout)):
            forced = dx_plan_of(layout, M, G, route, dev, sp)
            if forced.items in seen:
                continue
            seen.add(forced.items)
            # the wrapper asks dx_plan for its plan: force this one
            BS.dx_plan = lambda *a, forced=forced: forced
            try:
                r["S%d_%d" % sp] = {
                    "kernel_ms": kernel_ms(call),
                    "ms": cuda_ms(call, reps=50),
                    "model_us": forced.cost_us, "parts": forced.parts}
            finally:
                BS.dx_plan = plan_fn
        out[key] = r
        print("[dx_plan_sweep] %s %s" % (key, json.dumps(r)), flush=True)

    for tag, layout, M, G in legacy_dw_shapes():
        for dt, route in (("f32", "gemm"), ("bf16", "mma")):
            _, w, gy = legacy_operands(layout, G, M, 236, dev, dt, dt)
            if G == 1:
                w = w.reshape(layout.nnz, layout.bs, layout.bs)
            call = (lambda: BS.bsl_dx(gy, w, layout)) if G == 1 else \
                (lambda: BS.bsl_dx_multi(gy, w, layout, G))
            sweep("bsl_dx_%s_%s" % (tag, dt), call, layout, M, G, route)
            del w, gy
        torch.cuda.empty_cache()
    if hasattr(BS, "v3_weight_packed_plain"):
        M = GR_TRAIN_TBH[0] * GR_TRAIN_TBH[1]
        v = v3_inputs(M, 3, 234, dev)
        sweep("v3_dx_libri_G3_f32", lambda: BS.block_sparse_v3_dx(
            v["gy"], v["w3"], v["layout"], 3, 8, v["sub3"]), v["layout"], M,
            3, "gemm")
        del v
        torch.cuda.empty_cache()
    return out


def gemm_times_main(root):
    """``python3 chip_smoke.py --gemm-times [DIR]``: phase_bs_gemm_times
    and the f32 train steps of the libri GRU and the CGS-16x LSTM (CUDA
    events, mean of 5 after 2) with the package of this checkout or of
    the tree unpacked at DIR inside it (an earlier commit's, to compare
    kernels on one card), and with a package that has the legacy
    forward's routes the pieces of its host path (``host_path_us``), with
    one that has the legacy dx's plan the dx at every split it weighs
    (``dx_plan_sweep``); one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    here = os.path.realpath(ROOT)
    root = os.path.realpath(os.path.join(ROOT, root))
    if os.path.commonpath([here, root]) != here:
        print("chip_smoke: --gemm-times takes a directory inside %s" % here,
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from pytorch_kaldi_cgs_tpu_torch.ops import _build
    _build.build(_build.SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    out = {"root": os.path.relpath(root, here),
           "package": os.path.relpath(os.path.dirname(_build.CSRC), here),
           "card": smi_card(),
           "times": phase_bs_gemm_times(dev)}
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    if hasattr(BS, "legacy_fwd_route"):     # the legacy forward's routes
        out["host_path_us"] = host_path_us(torch.device(dev))
    if hasattr(BS, "legacy_dx_route"):      # this tree's package
        out["dx_plan_sweep"] = dx_plan_sweep(dev)
    for tag, make in (("libri_gru", gru_train_runner),
                      ("cgs16x_lstm", cgs_train_runner)):
        runner, (inp, mask) = make(dev)
        inp = torch.as_tensor(inp, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        out["%s_step_ms_f32" % tag] = cuda_ms(
            lambda: runner.train_step(inp, mask), reps=5)
        del runner
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def kernels_by_name(fn, reps=5):
    """Device ms per call of each kernel one call of ``fn`` launches, by
    short name (torch.profiler, ``reps`` calls after one warm-up)."""
    out = {}
    for e in trace_events(fn, reps):
        if e.get("cat") == "kernel":
            k = kernel_short_name(str(e.get("name", "")))
            out[k] = out.get(k, 0.0) + float(e.get("dur", 0)) / reps / 1e3
    return out


#: a BPTT's chain kernels (the GRUs' and the liGRU's recompute one), both
#: routes; every other kernel of a call is its rebuild (the forward
#: quantities that do not depend on dh)
CHAIN_KERNELS = ("gru_torch_bwd_step", "gru_torch_bwd_persist",
                 "gru_bwd_carry", "gru_bwd_ds", "gru_bwd_persist",
                 "ligru_bwd_step", "ligru_bwd_persist",
                 "gru_dense_bwd_persist", "rnn_bwd_step", "rnn_bwd_persist",
                 "rnn_sparse_bwd_step", "rnn_sparse_bwd_persist")


def bptt_split(fn, reps=5):
    """A BPTT call's device ms split into its rebuild and its chain, with
    the kernels by name; None where the trace holds no kernel."""
    by = kernels_by_name(fn, reps)
    if not by:
        return None
    chain = sum(v for k, v in by.items() if k in CHAIN_KERNELS)
    return {"rebuild_ms": sum(by.values()) - chain, "chain_ms": chain,
            "kernels_ms": by}


def port_gru_layer_times(dev, T, B, H, reps=10):
    """The port's GRU_cudnn layer as cudnn_times times nn.GRU(H, H): the
    input projection x @ W_ih^T + b_ih and the recurrence
    (gru_cudnn_scan_fused), forward and forward + backward (row 23, the
    dW_hh matmul and db sum of its Function, the projection's backward),
    the backward as their difference."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    gen = torch.Generator(device=dev).manual_seed(352)
    k = 1.0 / np.sqrt(H)

    def param(*shape):
        return ((torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * k
                ).requires_grad_()
    W_ih, W_hh, b_ih, b_hh = (param(3 * H, H), param(3 * H, H),
                              param(3 * H), param(3 * H))
    x = torch.randn(T, B, H, device=dev, generator=gen).requires_grad_()
    dy = torch.randn(T, B, H, device=dev, generator=gen)

    def fwd():
        return R.gru_cudnn_scan_fused(x @ W_ih.T + b_ih, W_hh, b_hh)
    fwd_ms = cuda_ms(fwd, reps)
    fb_ms = cuda_ms(lambda: fwd().backward(dy), reps)
    return {"port_layer_fwd_ms": fwd_ms, "port_layer_fwd_bwd_ms": fb_ms,
            "port_layer_bwd_ms": fb_ms - fwd_ms}


def port_lstm_layer_times(dev, T, B, H, reps=10):
    """The port's dense LSTM layer as cudnn_times times nn.LSTM(H, H): the
    input projection x @ W^T + b and the recurrence (lstm_scan_fused, no
    dropout, no quantizer), forward and forward + backward (row 3, the
    dU matmul of its Function, the projection's backward), the backward
    as their difference."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    gen = torch.Generator(device=dev).manual_seed(353)
    k = 1.0 / np.sqrt(H)

    def param(*shape):
        return ((torch.rand(*shape, device=dev, generator=gen) * 2 - 1) * k
                ).requires_grad_()
    W, U, b = param(4 * H, H), param(4 * H, H), param(4 * H)
    x = torch.randn(T, B, H, device=dev, generator=gen).requires_grad_()
    dy = torch.randn(T, B, H, device=dev, generator=gen)
    one = torch.ones(1, 1, device=dev)

    def fwd():
        return F.lstm_scan_fused(x @ W.T + b, U, one)
    fwd_ms = cuda_ms(fwd, reps)
    fb_ms = cuda_ms(lambda: fwd().backward(dy), reps)
    return {"port_layer_fwd_ms": fwd_ms, "port_layer_fwd_bwd_ms": fb_ms,
            "port_layer_bwd_ms": fb_ms - fwd_ms}


def forced_plan_ms(kernel, call_plan, reps, shapes=((4, 8), (2, 16))):
    """ms per call of ``kernel``'s persistent route at each block shape
    (bi, units) of ``shapes`` (by default the blocks of 256 outputs its
    plan weighs, 8 units x 32 rows and 16 x 16) where it fits and its
    grid is co-resident:
    ``call_plan(shape)`` returns the plan forced to (bi, units),
    ``call_plan(shape, run=True)`` runs one call on it; {} for a package
    without the route. The plan the route picks is timed by the caller."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    plan_fn = {"fused_ligru_bwd": "ligru_bwd_plan",
               "fused_gru_fwd_sparse": "gru_fwd_sparse_plan",
               "fused_gru_fwd": "gru_fwd_plan",
               "fused_mgru_fwd": "gru_fwd_plan",
               "fused_ligru_fwd": "ligru_fwd_plan",
               "fused_mgru_bwd": "mgru_bwd_plan",
               "fused_lstm_fwd": "lstm_fwd_plan",
               "fused_lstm_bwd_stash": "lstm_bwd_stash_plan",
               "fused_gru_bwd_stash": "gru_bwd_stash_plan",
               "fused_rnn_fwd": "rnn_fwd_plan",
               "fused_rnn_bwd": "rnn_bwd_plan",
               "fused_mgru_fwd_sparse": "gru_fwd_sparse_plan",
               "fused_mgru_bwd_sparse": "mgru_bwd_sparse_plan",
               "fused_rnn_fwd_sparse": "rnn_fwd_sparse_plan",
               "fused_rnn_bwd_sparse": "rnn_bwd_sparse_plan",
               "fused_lstm_fwd_sparse": "lstm_fwd_sparse_plan",
               "fused_lstm_bwd_sparse_stash": "lstm_bwd_sparse_stash_plan",
               }[kernel]
    if not hasattr(F if kernel in LSTM_PERSIST + LSTM_SPARSE else R,
                   plan_fn):
        return {}
    out = {}
    for shape_ in shapes:
        plan = call_plan(shape_)
        if plan.smem + plan.static > R._SMEM_MAX or not co_resident(
                kernel, plan):
            continue
        out["%dx%d" % (plan.units, 8 * plan.bi)] = {
            "ms": cuda_ms(lambda: call_plan(shape_, run=True), reps),
            "slabs": plan.slabs, "smem": plan.smem,
            "staged_bytes_per_block_per_step": plan.staged}
    return out


def co_resident(kernel, plan, bf16=False):
    """Whether a (forced) plan of ``kernel`` (a key of PERSIST_ROUTES) has
    a co-resident grid on this card, as its route asks."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    _, lib, entry, ints = PERSIST_ROUTES[kernel]
    return R._route(plan, lib, entry, ints(plan, bf16),
                    torch.device("cuda")) == "persist"


def lstm_turn_times(dev, t):
    """phase_rnn_turn_times' rows 1 and 3 into ``t``: the forward (tanh,
    no quantizer, the stash) and the stash BPTT at the flagship train
    shape, 2x1024 at 8 (the shipped CGS-16x cfg) and 16 rows, each also
    at the other block shapes of its plan's table that are co-resident
    (forced), with its route and plan; the forward without the stash, at
    the flagship serve shape and as a seeded chunk of 100 (qbits 16), and
    its output digests in f32 and bf16, zero and seeded, qbits 0 and 16
    (equal across trees: the same bits); nn.LSTM(H)'s forward and
    backward beside the port's whole layer's (port_lstm_layer_times)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    with torch.no_grad():
        for tag, (T, B, H), seed in (("flagship", TRAIN_TBH, 380),
                                     ("h1024_b8", CS_TRAIN_TBH, 383),
                                     ("h1024_b16", SP_TRAIN_TBH, 386)):
            g, U, drop, h0, c0 = lstm_inputs(T, B, H, seed, dev, True)
            dhs = torch.randn(T, B, H, device=dev, generator=torch.Generator(
                device=dev).manual_seed(seed)) * 0.01
            hs, cs, acts = F.fused_lstm_fwd(g, U, drop, stash=True)
            c_prev = shifted(hs, cs, None, None)[1]
            fcall = lambda: F.fused_lstm_fwd(g, U, drop, stash=True)
            bcall = lambda: F.fused_lstm_bwd_stash(acts, U, drop, cs, c_prev,
                                                   dhs)

            def fwd_plan(shape_, run=False):
                plan = F.lstm_fwd_plan(B, H, shape_)
                return (F._fwd_persist(plan, g, U, drop, None, None, "tanh",
                                       0, False, True) if run else plan)

            def bwd_plan(shape_, run=False):
                plan = F.lstm_bwd_stash_plan(B, H, shape_)
                return (F._bwd_stash_persist(plan, acts, U, drop, cs, c_prev,
                                             dhs, None, None, "tanh", False)
                        if run else plan)
            shapes = getattr(F, "LSTM_FWD_SHAPES", ())
            t["row1_" + tag] = {
                "ms": cuda_ms(fcall, 10),
                "ms_nostash": cuda_ms(lambda: F.fused_lstm_fwd(g, U, drop),
                                      10),
                "ms_bf16": cuda_ms(lambda: F.fused_lstm_fwd(
                    g, U, drop, bf16=True, stash=True), 10),
                "bound_ms": lstm_bound_ms(T, B, H, "f32", "fwd_stash")[0],
                "plan": chain_route(dev, "fused_lstm_fwd", B, H)[1],
                "by_block_shape": forced_plan_ms("fused_lstm_fwd", fwd_plan,
                                                 10, shapes),
                "digest": digest(fcall())}
            t["row3_" + tag] = {
                "ms": cuda_ms(bcall, 10),
                "ms_bf16": cuda_ms(lambda: F.fused_lstm_bwd_stash(
                    acts, U, drop, cs, c_prev, dhs, bf16=True), 10),
                "bound_ms": lstm_bound_ms(T, B, H, "f32", "bwd_stash")[0],
                "plan": chain_route(dev, "fused_lstm_bwd_stash", B, H)[1],
                "by_block_shape": forced_plan_ms(
                    "fused_lstm_bwd_stash", bwd_plan, 10,
                    getattr(F, "LSTM_BWD_SHAPES", ())),
                "digest": digest(bcall())}
            if tag == "flagship":
                digests = {}
                for bf16 in (False, True):
                    for seeded in (False, True):
                        for qb in (0, 16):
                            carry = (h0, c0) if seeded else (None, None)
                            digests["%s_%s_q%d" % (
                                "bf16" if bf16 else "f32",
                                "seeded" if seeded else "zero", qb)] = \
                                digest(F.fused_lstm_fwd(
                                    g, U, drop, *carry, qbits=qb, bf16=bf16,
                                    stash=True))
                t["row1_flagship"]["digests"] = digests
            del g, U, drop, h0, c0, dhs, hs, cs, acts, c_prev
        T, B, H = SERVE_TBH
        sv = lstm_inputs(T, B, H, 389, dev, False)
        ck = lstm_inputs(100, B, H, 390, dev, True)
        t["row1_flagship_serve"] = {
            "ms": cuda_ms(lambda: F.fused_lstm_fwd(*sv[:3]), 10),
            "bound_ms": lstm_bound_ms(T, B, H)[0],
            "plan": chain_route(dev, "fused_lstm_fwd", B, H)[1],
            "by_block_shape": forced_plan_ms(
                "fused_lstm_fwd", lambda shape_, run=False: (
                    F._fwd_persist(F.lstm_fwd_plan(B, H, shape_), sv[0],
                                   sv[1], torch.broadcast_to(
                                       sv[2], (B, H)).contiguous(), None,
                                   None, "tanh", 0, False, False)
                    if run else F.lstm_fwd_plan(B, H, shape_)), 10,
                getattr(F, "LSTM_FWD_SHAPES", ())),
            "digest": digest(F.fused_lstm_fwd(*sv[:3])),
            "seeded_chunk100_ms": cuda_ms(lambda: F.fused_lstm_fwd(
                *ck, qbits=16), 10),
            "seeded_chunk100_digest": digest(F.fused_lstm_fwd(*ck,
                                                              qbits=16))}
        del sv, ck
    for tag, (T, B, H) in (("flagship", TRAIN_TBH), ("h1024_b8", CS_TRAIN_TBH),
                           ("h1024_b16", SP_TRAIN_TBH)):
        t["lstm_layer_" + tag] = dict(
            cudnn_times(dev, T, B, H, T, B, torch.nn.LSTM(H, H), "cudnn_lstm"),
            **port_lstm_layer_times(dev, T, B, H))
    torch.cuda.empty_cache()


def digest(x):
    """The first 16 hex digits of the sha256 of a call's output bytes (a
    tensor or a tuple of them): its bits, to compare across trees."""
    h = hashlib.sha256()
    for v in (x if isinstance(x, tuple) else (x,)):
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rnn_bwd_turn_times(dev, g, U, drop, h_prev, dhs, reps=10):
    """Row 29 (relu, as the TIMIT RNN cfg runs it) at the TIMIT RNN's
    train shape: ms per call without and with the 16-bit quantizer, the
    route's plan, the rebuild / chain split, each block shape of
    RNN_BWD_SHAPES forced, and, with a package that has the persistent
    route, the step route forced; the output digests (qbits 0 and
    16)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = g.shape
    call = lambda: R.fused_rnn_bwd(g, U, drop, h_prev, dhs, "relu")
    call16 = lambda: R.fused_rnn_bwd(g, U, drop, h_prev, dhs, "relu", 16)

    def bwd_plan(shape_, run=False):
        plan = R.rnn_bwd_plan(B, H, shape_)
        return (R._rnn_bwd_persist(plan, g, U, drop, h_prev, dhs, "relu", 0)
                if run else plan)
    out = {"ms": cuda_ms(call, reps), "ms_q16": cuda_ms(call16, reps),
           "plan": chain_route(dev, "fused_rnn_bwd", B, H)[1],
           "split": bptt_split(call, 3),
           "by_block_shape": forced_plan_ms(
               "fused_rnn_bwd", bwd_plan, reps,
               getattr(R, "RNN_BWD_SHAPES", ())),
           "digest": digest(call()), "digest_q16": digest(call16())}
    if hasattr(R, "rnn_bwd_plan"):
        out["step_route_ms"] = cuda_ms(lambda: R._rnn_bwd_step(
            R.fused_rnn_bwd, g, U, drop, h_prev, dhs, "relu", 0, False),
            reps)
    return out


def mgru_sparse_turn_times(dev, t):
    """phase_rnn_turn_times' rows 34 and 35 into ``t`` (relu, qbits 16, as
    the CGS-16x minimalGRU runs them) at its train shape: ms per call,
    row 34 also without the quantizer and at the serve shape; route and
    plan, row 35's rebuild / chain split, each block shape of their tables
    forced (co-resident ones), the step routes forced where the package
    has the persistent ones, and the output digests (row 34's equal across
    trees: its persistent route gives the step route's bits; row 35's
    chain sums in another order than its step route)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = MG_TRAIN_TBH
    sp = cgs_ligru_inputs(T, B, H, 421, dev, "relu")
    g, w3g, drop, dhs, lay = (sp[n] for n in ("g", "w3g", "drop", "dhs",
                                              "layout"))
    sv = cgs_ligru_inputs(MG_SERVE_TBH[0], B, H, 423, dev, "relu")
    dbh = torch.broadcast_to(drop, (B, H)).contiguous()
    new = hasattr(R, "mgru_bwd_sparse_route")
    with torch.no_grad():
        fcall = lambda: R.fused_mgru_fwd_sparse(g, w3g, drop, lay, "relu", 16)
        scall = lambda: R.fused_mgru_fwd_sparse(
            sv["g"], sv["w3g"], sv["drop"], sv["layout"], "relu", 16)
        hs = fcall()
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        bcall = lambda: R.fused_mgru_bwd_sparse(g, w3g, drop, h_prev, dhs,
                                                lay, "relu", 16)

        def fwd_plan(shape_, run=False):
            plan = R.gru_fwd_sparse_plan(B, lay, shape_, G=2)
            return (R._gru_fwd_sparse_persist(plan, g, w3g, dbh, lay, "relu",
                                              16, False) if run else plan)

        def bwd_plan(shape_, run=False):
            plan = R.mgru_bwd_sparse_plan(B, H, lay.bs, lay.C, shape_)
            return (R._mgru_bwd_sparse_persist(plan, g, w3g, dbh, h_prev, dhs,
                                               lay, "relu", 16, False)
                    if run else plan)
        t["row34"] = {
            "ms": cuda_ms(fcall, 10),
            "ms_q0": cuda_ms(lambda: R.fused_mgru_fwd_sparse(
                g, w3g, drop, lay, "relu", 0), 10),
            "serve_ms": cuda_ms(scall, 10),
            "plan": chain_route(dev, "fused_mgru_fwd_sparse", B,
                                layout=lay)[1],
            "by_block_shape": forced_plan_ms(
                "fused_mgru_fwd_sparse", fwd_plan, 10,
                R.GRU_FWD_SPARSE_SHAPES) if new else {},
            "digest": digest(fcall()), "serve_digest": digest(scall()),
            "digest_q0": digest(R.fused_mgru_fwd_sparse(
                g, w3g, drop, lay, "relu", 0))}
        t["row35"] = {
            "ms": cuda_ms(bcall, 10),
            "plan": chain_route(dev, "fused_mgru_bwd_sparse", B,
                                layout=lay)[1],
            "split": bptt_split(bcall, 3),
            "by_block_shape": forced_plan_ms(
                "fused_mgru_bwd_sparse", bwd_plan, 10,
                R.GRU_BWD_SPARSE_SHAPES) if new else {},
            "digest": digest(bcall())}
        if new:
            t["row34"]["step_route_ms"] = cuda_ms(
                lambda: R._gru_fwd_sparse_step(
                    R.fused_mgru_fwd_sparse, g, w3g, dbh, lay, "relu", 16,
                    False), 10)
            t["row35"]["step_route_ms"] = cuda_ms(
                lambda: R._gru_bwd_sparse_step(
                    R.fused_mgru_bwd_sparse, g, w3g, dbh, h_prev, dhs, lay,
                    "relu", 16, False), 10)
    del sp, sv, hs, h_prev


def rnn_sparse_block_shapes(g, w3g, drop, h_prev, dhs, lay, act, qb,
                            reps=10):
    """ms per call of rows 36 and 37's persistent routes forced to each
    block shape of their tables (forced_plan_ms: co-resident ones only)
    on these operands: {"fused_rnn_{fwd,bwd}_sparse_by_block_shape": ...};
    {} each for a package without the routes."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    B, H = g.shape[1], g.shape[2]
    dbh = torch.broadcast_to(drop, (B, H)).contiguous()

    def fwd_plan(shape_, run=False):
        plan = R.rnn_fwd_sparse_plan(B, lay, shape_)
        return (R._rnn_fwd_sparse_persist(plan, g, w3g, dbh, lay, act, qb,
                                          False) if run else plan)

    def bwd_plan(shape_, run=False):
        plan = R.rnn_bwd_sparse_plan(B, H, lay.bs, lay.C, shape_)
        return (R._rnn_bwd_sparse_persist(plan, g, w3g, dbh, h_prev, dhs,
                                          lay, act, qb, False)
                if run else plan)
    return {
        "fused_rnn_fwd_sparse_by_block_shape": forced_plan_ms(
            "fused_rnn_fwd_sparse", fwd_plan, reps,
            getattr(R, "RNN_FWD_SPARSE_SHAPES", ())),
        "fused_rnn_bwd_sparse_by_block_shape": forced_plan_ms(
            "fused_rnn_bwd_sparse", bwd_plan, reps,
            getattr(R, "RNN_BWD_SPARSE_SHAPES", ()))}


def lstm_sparse_block_shapes(g, w3g, drop, dhs, lay, act, qb, reps=10):
    """ms per call of rows 4 and 5's persistent routes forced to each
    block shape of their tables (forced_plan_ms: co-resident ones only)
    on these operands (the forward with the stash, the chain over its
    output), f32 w3g:
    {"fused_lstm_{fwd_sparse,bwd_sparse_stash}_by_block_shape": ...}; {}
    each for a package without the routes."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    B, H = g.shape[1], g.shape[2] // 4
    dbh = torch.broadcast_to(drop, (B, H)).contiguous()
    hs, cs, acts = F.fused_lstm_fwd_sparse(g, w3g, drop, lay, act, qb,
                                           stash=True)
    c_prev = shifted(hs, cs, None, None)[1]

    def fwd_plan(shape_, run=False):
        plan = F.lstm_fwd_sparse_plan(B, lay, shape_)
        return (F._fwd_sparse_persist(plan, g, w3g, dbh, lay, act, qb, False,
                                      True) if run else plan)

    def bwd_plan(shape_, run=False):
        plan = F.lstm_bwd_sparse_stash_plan(B, H, lay.bs, lay.C, shape_)
        return (F._bwd_sparse_stash_persist(plan, acts, w3g, dbh, cs, c_prev,
                                            dhs, lay, act, False)
                if run else plan)
    return {
        "fused_lstm_fwd_sparse_by_block_shape": forced_plan_ms(
            "fused_lstm_fwd_sparse", fwd_plan, reps,
            getattr(F, "LSTM_FWD_SPARSE_SHAPES", ())),
        "fused_lstm_bwd_sparse_stash_by_block_shape": forced_plan_ms(
            "fused_lstm_bwd_sparse_stash", bwd_plan, reps,
            getattr(F, "LSTM_BWD_SPARSE_SHAPES", ()))}


def lstm_sparse_turn_times(dev, t):
    """phase_rnn_turn_times' rows 4 and 5 into ``t`` at the CGS-16x LSTM's
    train shape (the seed of phase_sparse_times; tanh, f32 w3g, the stash
    forward), row 4 also at the serve shape (no stash): ms and us per
    step of a call with the 16-bit quantizer (as the cfg runs it) and
    without, w3g in bf16; route and plan, each block shape of their
    tables forced (co-resident ones), the step routes forced where the
    package has the persistent ones, and the output digests: train (hs,
    cs, acts; the chain's dg over them) and serve (hs, cs), qbits 0 and
    16, tanh and relu, f32 and bf16 w3g (equal across trees: both routes
    give the step route's bits); row 5 also over a layout of C = 4, as the
    cfg's layers have (``C4``)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    T, B, H = SP_TRAIN_TBH
    Ts, Bs, _ = SP_SERVE_TBH
    fwd, bwd = F.fused_lstm_fwd_sparse, F.fused_lstm_bwd_sparse_stash
    new = hasattr(F, "lstm_fwd_sparse_route")
    with torch.no_grad():
        sp = sparse_inputs(T, B, H, 97, dev)
        sv = sparse_inputs(Ts, Bs, H, 96, dev)
        g, w3g, drop, dhs, lay = (sp[n] for n in ("g", "w3g", "drop", "dhs",
                                                  "layout"))
        sargs = (sv["g"], sv["w3g"], sv["drop"], sv["layout"])
        digests = {}
        for act in ("tanh", "relu"):
            for qb in (0, 16):
                for bf16 in (False, True):
                    tag = "%s_q%d_%s" % (act, qb, "bf16" if bf16 else "f32")
                    hs, cs, acts = fwd(g, w3g, drop, lay, act, qb, bf16,
                                       stash=True)
                    c_prev = shifted(hs, cs, None, None)[1]
                    digests["fwd_" + tag] = digest((hs, cs, acts))
                    digests["serve_fwd_" + tag] = digest(fwd(*sargs, act, qb,
                                                             bf16))
                    digests["bwd_" + tag] = digest(bwd(
                        acts, w3g, drop, cs, c_prev, dhs, lay, act, bf16))
        fcall = lambda: fwd(g, w3g, drop, lay, "tanh", 16, stash=True)
        hs, cs, acts = fcall()
        c_prev = shifted(hs, cs, None, None)[1]
        bcall = lambda: bwd(acts, w3g, drop, cs, c_prev, dhs, lay)
        shapes = lstm_sparse_block_shapes(g, w3g, drop, dhs, lay, "tanh", 16)
        fms, bms = cuda_ms(fcall, 10), cuda_ms(bcall, 10)
        sms = cuda_ms(lambda: fwd(*sargs, "tanh", 16), 10)
        t["row4"] = {
            "ms": fms, "us_per_step": 1e3 * fms / T,
            "ms_q0": cuda_ms(lambda: fwd(g, w3g, drop, lay, stash=True), 10),
            "ms_bf16": cuda_ms(lambda: fwd(g, w3g, drop, lay, "tanh", 16,
                                           True, stash=True), 10),
            "serve_ms": sms, "serve_us_per_step": 1e3 * sms / Ts,
            "serve_ms_q0": cuda_ms(lambda: fwd(*sargs), 10),
            "bound_ms": lstm_bound_ms(T, B, H, "f32", "fwd_stash",
                                      lay.R * lay.bs)[0],
            "serve_bound_ms": lstm_bound_ms(Ts, Bs, H, "f32", "fwd",
                                            lay.R * lay.bs)[0],
            "plan": chain_route(dev, "fused_lstm_fwd_sparse", B,
                                layout=lay)[1],
            "serve_plan": chain_route(dev, "fused_lstm_fwd_sparse", Bs,
                                      layout=sv["layout"])[1],
            "by_block_shape": shapes["fused_lstm_fwd_sparse_by_block_shape"],
            "digests": {k[4:]: v for k, v in digests.items()
                        if k.startswith("fwd_")},
            "serve_digests": {k[10:]: v for k, v in digests.items()
                              if k.startswith("serve_fwd_")}}
        t["row5"] = {
            "ms": bms, "us_per_step": 1e3 * bms / T,
            "ms_bf16": cuda_ms(lambda: bwd(acts, w3g, drop, cs, c_prev, dhs,
                                           lay, bf16=True), 10),
            "bound_ms": lstm_bound_ms(T, B, H, "f32", "bwd_stash",
                                      lay.R * lay.bs)[0],
            "plan": chain_route(dev, "fused_lstm_bwd_sparse_stash", B,
                                layout=lay)[1],
            "by_block_shape": shapes[
                "fused_lstm_bwd_sparse_stash_by_block_shape"],
            "digests": {k[4:]: v for k, v in digests.items()
                        if k.startswith("bwd_")}}
        # row 5 over a layout whose heaviest column holds 4 blocks, as the
        # CGS-16x cfg's two layers' do (seed 0 of the model)
        c4 = sparse_inputs(T, B, H, 96, dev)
        hs4, cs4, acts4 = fwd(c4["g"], c4["w3g"], c4["drop"], c4["layout"],
                              "tanh", 16, stash=True)
        cp4 = shifted(hs4, cs4, None, None)[1]
        ms4 = cuda_ms(lambda: bwd(acts4, c4["w3g"], c4["drop"], cs4, cp4,
                                  c4["dhs"], c4["layout"]), 10)
        t["row5"]["C4"] = {
            "C": c4["layout"].C, "ms": ms4, "us_per_step": 1e3 * ms4 / T,
            "plan": chain_route(dev, "fused_lstm_bwd_sparse_stash", B,
                                layout=c4["layout"])[1],
            "by_block_shape": lstm_sparse_block_shapes(
                c4["g"], c4["w3g"], c4["drop"], c4["dhs"], c4["layout"],
                "tanh", 16)["fused_lstm_bwd_sparse_stash_by_block_shape"],
            "digest": digest(bwd(acts4, c4["w3g"], c4["drop"], cs4, cp4,
                                 c4["dhs"], c4["layout"]))}
        del c4, hs4, cs4, acts4, cp4
        if new:
            dbh = torch.broadcast_to(drop, (B, H)).contiguous()
            t["row4"]["step_route_ms"] = cuda_ms(
                lambda: F._fwd_sparse_step(g, w3g, dbh, lay, "tanh", 16,
                                           False, True), 10)
            t["row5"]["step_route_ms"] = cuda_ms(
                lambda: F._bwd_sparse_step(bwd, acts, w3g, dbh, None, cs,
                                           c_prev, dhs, lay, "tanh", 0,
                                           False, True), 10)
    del sp, sv, hs, cs, acts, c_prev


def rnn_sparse_turn_times(dev, t):
    """phase_rnn_turn_times' rows 36 and 37 into ``t`` (relu, qbits 16, as
    the CGS-16x RNN runs them, f32 w3g) at its train shape (the seed of
    phase_rnn_sparse_times): ms and us per step of a call, row 36 also
    without the quantizer and at the serve shape; route and plan, row
    37's rebuild / chain split, each block shape of their tables forced
    (co-resident ones), the step routes forced where the package has the
    persistent ones, and the output digests: train (and serve for row
    36), qbits 0 and 16, relu and tanh, f32 and bf16 w3g (equal across
    trees: both routes give the step route's bits)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = RS_TRAIN_TBH
    Ts, Bs, _ = RS_SERVE_TBH
    new = hasattr(R, "rnn_fwd_sparse_route")
    with torch.no_grad():
        digests = {}
        for act in ("relu", "tanh"):
            sp = cgs_ligru_inputs(T, B, H, 530, dev, act, 1)
            sv = cgs_ligru_inputs(Ts, Bs, H, 531, dev, act, 1)
            for qb in (0, 16):
                for bf16 in (False, True):
                    tag = "%s_q%d_%s" % (act, qb, "bf16" if bf16 else "f32")
                    hs = R.fused_rnn_fwd_sparse(sp["g"], sp["w3g"],
                                                sp["drop"], sp["layout"],
                                                act, qb, bf16)
                    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
                    digests["fwd_" + tag] = digest(hs)
                    digests["serve_fwd_" + tag] = digest(
                        R.fused_rnn_fwd_sparse(sv["g"], sv["w3g"], sv["drop"],
                                               sv["layout"], act, qb, bf16))
                    digests["bwd_" + tag] = digest(R.fused_rnn_bwd_sparse(
                        sp["g"], sp["w3g"], sp["drop"], h_prev, sp["dhs"],
                        sp["layout"], act, qb, bf16))
            del sv
        sp = cgs_ligru_inputs(T, B, H, 530, dev, "relu", 1)
        g, w3g, drop, dhs, lay = (sp[n] for n in ("g", "w3g", "drop", "dhs",
                                                  "layout"))
        sv = cgs_ligru_inputs(Ts, Bs, H, 531, dev, "relu", 1)
        dbh = torch.broadcast_to(drop, (B, H)).contiguous()
        fcall = lambda: R.fused_rnn_fwd_sparse(g, w3g, drop, lay, "relu", 16)
        hs = fcall()
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        bcall = lambda: R.fused_rnn_bwd_sparse(g, w3g, drop, h_prev, dhs,
                                               lay, "relu", 16)
        shapes = rnn_sparse_block_shapes(g, w3g, drop, h_prev, dhs, lay,
                                         "relu", 16)
        fms, bms = cuda_ms(fcall, 10), cuda_ms(bcall, 10)
        t["row36"] = {
            "ms": fms, "us_per_step": 1e3 * fms / T,
            "ms_q0": cuda_ms(lambda: R.fused_rnn_fwd_sparse(
                g, w3g, drop, lay, "relu", 0), 10),
            "serve_ms": cuda_ms(lambda: R.fused_rnn_fwd_sparse(
                sv["g"], sv["w3g"], sv["drop"], sv["layout"], "relu", 16),
                10),
            "plan": chain_route(dev, "fused_rnn_fwd_sparse", B,
                                layout=lay)[1],
            "by_block_shape": shapes["fused_rnn_fwd_sparse_by_block_shape"],
            "digests": {k[4:]: v for k, v in digests.items()
                        if k.startswith("fwd_")},
            "serve_digests": {k[10:]: v for k, v in digests.items()
                              if k.startswith("serve_fwd_")}}
        t["row37"] = {
            "ms": bms, "us_per_step": 1e3 * bms / T,
            "plan": chain_route(dev, "fused_rnn_bwd_sparse", B,
                                layout=lay)[1],
            "split": bptt_split(bcall, 3),
            "by_block_shape": shapes["fused_rnn_bwd_sparse_by_block_shape"],
            "digests": {k[4:]: v for k, v in digests.items()
                        if k.startswith("bwd_")}}
        if new:
            t["row36"]["step_route_ms"] = cuda_ms(
                lambda: R._rnn_fwd_sparse_step(g, w3g, dbh, lay, "relu", 16,
                                               False), 10)
            t["row37"]["step_route_ms"] = cuda_ms(
                lambda: R._rnn_bwd_sparse_step(g, w3g, dbh, h_prev, dhs, lay,
                                               "relu", 16, False), 10)
    del sp, sv, hs, h_prev


def phase_rnn_turn_times(dev):
    """The redesigned rows at their timed shapes (gru_torch_times',
    gru_times', ligru_times', libri_ligru_times', timit_gru_times' and
    mgru_times' shapes): ms per call (CUDA events), the route and its
    plan, a BPTT's device time split into rebuild and chain by kernel
    (torch.profiler), and the digest of a call's output bits (equal
    digests across trees: the same bits); rows 18 and 16 at the TIMIT
    (qbits 16) and libri (qbits 0) shapes, row 16 with and without the
    stash, at its serving shape and as a seeded chunk of 100; row 32 at
    the libri train and serve shapes (qbits 16); each of rows 18, 32 and
    16 (libri) also at the block shapes its plan could take
    (forced_plan_ms); rows 19 (tanh, no quantizer) and 24 (relu, qbits
    16) at their train shapes with and without the stash, their serve
    shapes and a seeded chunk of 100 frames, each also at 4 and 16 units
    a block; row 26 (relu, qbits 16) with its rebuild / chain split;
    nn.GRU(550)'s forward, backward (fwd+bwd minus fwd) and the port's
    whole GRU_cudnn layer backward the same way beside row 23; row 20 at
    the TIMIT GRU's train shape and each block shape of its table; row 27
    (relu) at the TIMIT RNN's train (stash and not) and serve shapes and
    as the CGS-16x RNN's seeded chunk of 100, each block shape of its
    table at the train shape, its output digests; row 29 (relu) at the
    TIMIT RNN's train shape (rnn_bwd_turn_times); rows 34 and 35 at the
    CGS-16x minimalGRU's shapes (mgru_sparse_turn_times); rows 36 and 37
    at the CGS-16x RNN's (rnn_sparse_turn_times); rows 4 and 5 at the
    CGS-16x LSTM's (lstm_sparse_turn_times); rows 17, 21,
    22, 23, 25, 28, 33, 13 (libri G=3, 8-bit, submask) and 15 (the libri
    v3 dw) as the rows that must not move; rows 1 and 3
    (lstm_turn_times). Public wrappers only (and the forced plans where
    the package has them), so an earlier tree's package runs it too."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    t = {}
    with torch.no_grad():
        T, B, H = GT_TRAIN_TBH
        gi = gru_torch_inputs(T, B, H, 350, dev)
        g, W, b, dhs = (gi[n] for n in ("g", "W", "b", "dhs"))
        hs = R.fused_gru_torch_fwd(g, W, b)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        call = lambda: R.fused_gru_torch_bwd(g, W, b, h_prev, dhs)
        t["row23"] = {"ms": cuda_ms(call, 20),
                      "plan": bptt_route(dev, B, H)[1],
                      "split": bptt_split(call), "digest": digest(call())}
        t["row22_ms"] = cuda_ms(lambda: R.fused_gru_torch_fwd(g, W, b), 20)
        del gi, g, W, b, dhs, hs, h_prev
        # rows 18 and 16 at both shapes, row 17 at the TIMIT one; row 16
        # (relu, the stash forward) also without the stash, at its serving
        # shape and as a seeded chunk of 100, at the libri shape also at
        # both blocks of 256 outputs, forced
        for tag, (T, B, H), (Ts, Bs), qb, seed in (
                ("timit", LG_TRAIN_TBH, LG_SERVE_TBH[:2], 16, 240),
                ("libri", LL_TRAIN_TBH, LL_SERVE_TBH[:2], 0, 230)):
            li = gated_inputs(T, B, H, seed, dev, "relu")
            g, U, drop, dhs = (li[n] for n in ("g", "U", "drop", "dhs"))
            hs, acts = R.fused_ligru_fwd(g, U, drop, act="relu", qbits=qb,
                                         stash=True)
            h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
            call = lambda: R.fused_ligru_bwd(g, U, drop, h_prev, dhs, "relu",
                                             qb)

            def call_plan(shape_, run=False):
                plan = R.ligru_bwd_plan(B, H, shape_)
                return (R._ligru_bwd_persist(plan, g, U, drop, h_prev, dhs,
                                             "relu", qb) if run else plan)
            t["row18_" + tag] = {
                "ms": cuda_ms(call, 10), "qbits": qb,
                "plan": chain_route(dev, "fused_ligru_bwd", B, H)[1],
                "split": bptt_split(call, 3),
                "by_block_shape": forced_plan_ms("fused_ligru_bwd",
                                                 call_plan, 10),
                "digest": digest(call())}
            sv = gated_inputs(Ts, Bs, H, seed + 5, dev, "relu")
            ck = gated_inputs(100, B, H, seed + 6, dev, "relu")
            fcall = lambda: R.fused_ligru_fwd(g, U, drop, act="relu",
                                              qbits=qb, stash=True)

            def fwd_plan(shape_, run=False):
                plan = R.ligru_fwd_plan(B, H, shape_)
                return (R._ligru_fwd_persist(plan, g, U, drop, None, "relu",
                                             qb, True) if run else plan)
            t["row16_" + tag] = {
                "ms": cuda_ms(fcall, 10),
                "ms_nostash": cuda_ms(lambda: R.fused_ligru_fwd(
                    g, U, drop, act="relu", qbits=qb), 10),
                "serve_ms": cuda_ms(lambda: R.fused_ligru_fwd(
                    sv["g"], sv["U"], sv["drop"], act="relu", qbits=qb), 10),
                "seeded_chunk100_ms": cuda_ms(lambda: R.fused_ligru_fwd(
                    ck["g"], ck["U"], ck["drop"], ck["h0"], act="relu",
                    qbits=qb), 10),
                "qbits": qb, "serve_rows": Bs,
                "plan": chain_route(dev, "fused_ligru_fwd", B, H)[1],
                "by_block_shape": forced_plan_ms("fused_ligru_fwd", fwd_plan,
                                                 10) if tag == "libri" else {},
                "digest": digest(fcall())}
            if tag == "timit":
                t["row17_ms"] = cuda_ms(lambda: R.fused_ligru_bwd_stash(
                    acts, U, drop, h_prev, dhs, "relu"), 10)
            del li, g, U, drop, dhs, hs, acts, h_prev, sv, ck
        T, B, H = GR_TRAIN_TBH
        si = gru_inputs(T, B, H, 150, dev)
        g, w3g, drop, dhs, lay = (si[n] for n in ("g", "w3g", "drop", "dhs",
                                                  "layout"))
        hs = R.fused_gru_fwd_sparse(g, w3g, drop, lay, "tanh", 16)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        call = lambda: R.fused_gru_bwd_sparse(g, w3g, drop, h_prev, dhs, lay,
                                              "tanh", 16)
        t["row33"] = {"ms": cuda_ms(call, 10),
                      "plan": bptt_route(dev, B, layout=lay)[1],
                      "split": bptt_split(call, 3), "digest": digest(call())}
        del hs, h_prev
        # row 32 at the train and serve shapes
        for tag, (T, B, H), seed in (("train", GR_TRAIN_TBH, 150),
                                     ("serve", GR_SERVE_TBH, 151)):
            fi = si if tag == "train" else gru_inputs(T, B, H, seed, dev)
            g, w3g, drop, lay = (fi[n] for n in ("g", "w3g", "drop",
                                                 "layout"))

            def call_plan(shape_, run=False):
                plan = R.gru_fwd_sparse_plan(B, lay, shape_)
                return (R._gru_fwd_sparse_persist(plan, g, w3g, drop, lay,
                                                  "tanh", 16, False)
                        if run else plan)
            t["row32_" + tag] = {
                "ms": cuda_ms(lambda: R.fused_gru_fwd_sparse(
                    g, w3g, drop, lay, "tanh", 16), 10),
                "ms_q0": cuda_ms(lambda: R.fused_gru_fwd_sparse(
                    g, w3g, drop, lay, "tanh", 0), 10),
                "plan": chain_route(dev, "fused_gru_fwd_sparse", B,
                                    layout=lay)[1],
                "by_block_shape": forced_plan_ms(
                    "fused_gru_fwd_sparse", call_plan, 10)
                if lay.bs % 16 == 0 else {},
                "digest": digest(R.fused_gru_fwd_sparse(g, w3g, drop, lay,
                                                        "tanh", 16))}
            del fi, g, w3g, drop, lay
        del si
        # rows 19 and 24 at their train shapes (stash and not), serve
        # shapes and a seeded chunk of 100, each also at the other block
        # shapes instantiated for 8 rows; rows 20, 21 and 26 beside them
        for row, kernel, G, (T, B, H), Ts, act, qb, seed in (
                ("row19", "fused_gru_fwd", 3, TG_TRAIN_TBH, TG_SERVE_TBH[0],
                 "tanh", 0, 360),
                ("row24", "fused_mgru_fwd", 2, MG_TRAIN_TBH, MG_SERVE_TBH[0],
                 "relu", 16, 363)):
            w = getattr(R, kernel)
            fi = gated_inputs(T, B, H, seed, dev, act, G)
            g, U, drop, dhs = (fi[n] for n in ("g", "U", "drop", "dhs"))
            sv = gated_inputs(Ts, B, H, seed + 1, dev, act, G)
            ck = gated_inputs(100, B, H, seed + 2, dev, act, G)

            def call_plan(shape_, run=False):
                plan = R.gru_fwd_plan(B, H, G, shape_)
                return (R._gru_fwd_persist(w, plan, g, U, drop, None, act,
                                           qb, True) if run else plan)
            t[row] = {
                "digest": digest(w(g, U, drop, act=act, qbits=qb,
                                   stash=True)),
                "ms": cuda_ms(lambda: w(g, U, drop, act=act, qbits=qb,
                                        stash=True), 10),
                "ms_nostash": cuda_ms(lambda: w(g, U, drop, act=act,
                                                qbits=qb), 10),
                "serve_ms": cuda_ms(lambda: w(sv["g"], sv["U"], sv["drop"],
                                              act=act, qbits=qb), 10),
                "seeded_chunk100_ms": cuda_ms(lambda: w(
                    ck["g"], ck["U"], ck["drop"], ck["h0"], act=act,
                    qbits=qb), 10),
                "act": act, "qbits": qb,
                "plan": chain_route(dev, kernel, B, H)[1],
                "by_block_shape": forced_plan_ms(kernel, call_plan, 10,
                                                 ((1, 4), (1, 16)))}
            hs, acts = w(g, U, drop, act=act, qbits=qb, stash=True)
            h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
            if G == 3:
                call = lambda: R.fused_gru_bwd_stash(acts, U, drop, h_prev,
                                                     dhs, act)

                def bwd_plan(shape_, run=False):
                    plan = R.gru_bwd_stash_plan(B, H, shape_)
                    return (R._gru_bwd_stash_persist(plan, acts, U, drop,
                                                     h_prev, dhs, act)
                            if run else plan)
                t["row20"] = {
                    "ms": cuda_ms(call, 10),
                    "plan": chain_route(dev, "fused_gru_bwd_stash", B, H)[1],
                    "by_block_shape": forced_plan_ms(
                        "fused_gru_bwd_stash", bwd_plan, 10,
                        getattr(R, "GRU_BWD_SHAPES", ())),
                    "digest": digest(call())}
                t["row21_ms"] = cuda_ms(lambda: R.fused_gru_bwd(
                    g, U, drop, h_prev, dhs, act, qb), 10)
            else:
                call = lambda: R.fused_mgru_bwd(g, U, drop, h_prev, dhs, act,
                                                qb)
                t["row26"] = {"ms": cuda_ms(call, 10),
                              "plan": chain_route(dev, "fused_mgru_bwd", B,
                                                  H)[1],
                              "split": bptt_split(call, 3),
                              "digest": digest(call())}
                t["row25_ms"] = cuda_ms(lambda: R.fused_mgru_bwd_stash(
                    acts, U, drop, h_prev, dhs, act), 10)
            del fi, g, U, drop, dhs, sv, ck, hs, acts, h_prev
        # row 27 (relu, as the TIMIT RNN cfg runs it) at its train shape
        # with and without the stash, its serve shape and the CGS-16x
        # RNN's dense stream (a seeded chunk of 100 at 8 rows of 1024,
        # qbits 16), each block shape of its table, and its output digests
        # (zero and seeded, qbits 0 and 16, the stash: equal across trees,
        # the step route's bits); rows 28 and 29 beside it (row 29 redesigned:
        # its route, plan, split, block shapes and digests)
        T, B, H = TR_TRAIN_TBH
        fi = gated_inputs(T, B, H, 370, dev, "relu", 1)
        g, U, drop, h0, dhs = (fi[n] for n in ("g", "U", "drop", "h0",
                                               "dhs"))
        sv = gated_inputs(TR_SERVE_TBH[0], B, H, 371, dev, "relu", 1)
        ck = gated_inputs(100, B, RS_TRAIN_TBH[2], 372, dev, "relu", 1)
        fcall = lambda: R.fused_rnn_fwd(g, U, drop, act="relu", stash=True)

        def rnn_plan(shape_, run=False):
            plan = R.rnn_fwd_plan(B, H, shape_)
            return (R._rnn_fwd_persist(plan, g, U, drop, None, "relu", 0,
                                       True) if run else plan)
        ckcall = lambda: R.fused_rnn_fwd(ck["g"], ck["U"], ck["drop"],
                                         ck["h0"], act="relu", qbits=16)
        t["row27"] = {
            "ms": cuda_ms(fcall, 10),
            "ms_nostash": cuda_ms(lambda: R.fused_rnn_fwd(g, U, drop,
                                                          act="relu"), 10),
            "serve_ms": cuda_ms(lambda: R.fused_rnn_fwd(
                sv["g"], sv["U"], sv["drop"], act="relu"), 10),
            "cgs16x_chunk100_ms": cuda_ms(ckcall, 10),
            "plan": chain_route(dev, "fused_rnn_fwd", B, H)[1],
            "by_block_shape": forced_plan_ms(
                "fused_rnn_fwd", rnn_plan, 10,
                getattr(R, "RNN_FWD_SHAPES", ())),
            "digests": {"%s_q%d" % ("seeded" if seed is not None else "zero",
                                    qb): digest(R.fused_rnn_fwd(
                                        g, U, drop, seed, act="relu",
                                        qbits=qb, stash=True))
                        for seed in (None, h0) for qb in (0, 16)},
            "serve_digest": digest(R.fused_rnn_fwd(
                sv["g"], sv["U"], sv["drop"], act="relu")),
            "cgs16x_chunk100_digest": digest(ckcall())}
        hs, acts = fcall()
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        t["row28_ms"] = cuda_ms(lambda: R.fused_rnn_bwd_stash(
            acts, U, drop, dhs, "relu"), 10)
        t["row29"] = rnn_bwd_turn_times(dev, g, U, drop, h_prev, dhs)
        del fi, g, U, drop, h0, dhs, sv, ck, hs, acts, h_prev
        mgru_sparse_turn_times(dev, t)
        rnn_sparse_turn_times(dev, t)
        lstm_sparse_turn_times(dev, t)
        M = GR_TRAIN_TBH[0] * GR_TRAIN_TBH[1]
        v = v3_inputs(M, 3, 234, dev)
        x = BS.pad_cols(v["x"], v["layout"].K).contiguous()
        t["row13_ms"] = cuda_ms(lambda: BS.block_sparse_v3_fwd(
            x, v["w3"], v["layout"], 3, 8, v["sub3"]), 20)
        t["row15_ms"] = cuda_ms(lambda: BS.block_sparse_dw(
            v["gy"], x, v["layout"], 3, v["sub3"]), 20)
        del v, x
    T, B, H = GT_TRAIN_TBH
    t.update(cudnn_times(dev, T, B, H, *GT_SERVE_TBH[:2], torch.nn.GRU(H, H),
                         "cudnn_gru550"))
    t.update(port_gru_layer_times(dev, T, B, H))
    torch.cuda.empty_cache()
    lstm_turn_times(dev, t)
    print("[rnn_turn_times] %s" % json.dumps(t), flush=True)
    return t


def rnn_times_main(root):
    """``python3 chip_smoke.py --rnn-times [DIR]``: phase_rnn_turn_times,
    the f32 train steps of the libri GRU, the libri and TIMIT Li-GRUs,
    the TIMIT GRU, the TIMIT RNN, the minimalGRU, the CGS-16x minimalGRU,
    the CGS-16x RNN, the flagship LSTM, the CGS-16x LSTM as shipped (the
    dense kernels, 8 rows) and under ``auto`` (CUDA events, mean of 5
    after 2; each also profiled once: device ms and kernel records by
    class of kernel, busy share), and the TIMIT GRU's, the TIMIT RNN's,
    both minimalGRUs', the CGS-16x RNN's and LSTM's and the TIMIT and
    libri Li-GRUs' recognize (8 x 4 s:
    serve_timings, launches by kernel), with
    the package of this checkout or of the tree unpacked at DIR inside it
    (as ``--gemm-times``; run parent, change, change, parent in one
    call); one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    here = os.path.realpath(ROOT)
    root = os.path.realpath(os.path.join(ROOT, root))
    if os.path.commonpath([here, root]) != here:
        print("chip_smoke: --rnn-times takes a directory inside %s" % here,
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from pytorch_kaldi_cgs_tpu_torch.ops import _build
    _build.build(_build.SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    out = {"root": os.path.relpath(root, here),
           "package": os.path.relpath(os.path.dirname(_build.CSRC), here),
           "card": smi_card(), "times": phase_rnn_turn_times(dev)}
    for tag, make in (("libri_gru", gru_train_runner),
                      ("libri_ligru", libri_ligru_train_runner),
                      ("timit_ligru", ligru_train_runner),
                      ("timit_gru", timit_gru_train_runner),
                      ("timit_rnn", timit_rnn_train_runner),
                      ("mgru", mgru_train_runner),
                      ("cgs_mgru", cgs_mgru_train_runner),
                      ("cgs16x_rnn", rnn_sparse_train_runner),
                      ("flagship", train_runner),
                      ("cgs16x_lstm_shipped", cgs_shipped_train_runner),
                      ("cgs16x_lstm", cgs_train_runner)):
        runner, (inp, mask) = make(dev)
        inp = torch.as_tensor(inp, device=dev)
        mask = torch.as_tensor(mask, device=dev)
        out["%s_step_ms_f32" % tag] = cuda_ms(
            lambda: runner.train_step(inp, mask), reps=5)
        busy = device_busy(lambda: runner.train_step(inp, mask), top=8)
        by_name = busy.pop("by_name")
        out["%s_step_device_ms_by_class" % tag] = kernel_classes(by_name)
        out["%s_step_launches_by_class" % tag] = kernel_classes(
            by_name, launches=True)
        out["%s_step_busy" % tag] = busy
        del runner
        torch.cuda.empty_cache()
    audio, lens = make_audio()
    for tag, stack in (("timit_gru", build_timit_gru_stack),
                       ("timit_rnn", build_timit_rnn_stack),
                       ("mgru", build_mgru_stack),
                       ("cgs_mgru", build_cgs_mgru_stack),
                       ("cgs16x_rnn", build_rnn_sparse_stack),
                       ("cgs16x_lstm", build_cgs_stack),
                       ("timit_ligru", build_ligru_stack),
                       ("libri_ligru", build_libri_ligru_stack)):
        rec = build_recognizer(dev, stack)
        _, launches = counted(lambda: rec.recognize(audio, lens))
        out["%s_recognize" % tag] = dict(
            serve_timings(rec, audio, lens),
            launches={k: v for k, v in launches.items() if v})
        del rec
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


# ---------------------------------------------------------------------------
# the LibriSpeech Li-GRU cfg (rows 16-18; no new kernel)
# ---------------------------------------------------------------------------

LIBRI_LIGRU_CFG = os.path.join(ROOT, "cfg", "LibriSpeech_baselines",
                               "libri_liGRU_fmllr.cfg")
LL_SERVE_TBH = (398, 16, 1024)   # 8 utterances, both directions
LL_TRAIN_TBH = (200, 32, 1024)   # start_seq_len_train; 16 x 2 directions
LL_LAYERS = 5
# the random-init decode as a check: on an H100 x30000 decodes 3 of 8
# utterances to two phones, x3000 one, x300 none
LIBRI_LIGRU_HEAD_GAIN = 30000.0


def libri_ligru_sections(compute_dtype="", act=None):
    """The libri Li-GRU cfg's sections (cfg_sections: N_out_lab_cd =
    1944, as for the libri GRU); ``act`` replaces every layer's
    activation (the strict gradient check's tanh)."""
    secs = cfg_sections(LIBRI_LIGRU_CFG, compute_dtype)
    if act:
        secs["architecture1"]["ligru_act"] = ",".join([act] * LL_LAYERS)
    return secs


def check_libri_ligru(rnn):
    """The cfg as shipped: 5 x 1024 bidirectional, no layout, every
    layer on the dense fused liGRU."""
    if list(rnn.lay) != [1024] * LL_LAYERS or not rnn.bidir or \
            rnn._rec_layouts or rnn._bs_layouts or \
            not all(rnn._fused_ok(i, True) for i in range(LL_LAYERS)):
        raise AssertionError("the libri Li-GRU is not 5 x 1024 bidirectional "
                             "on the dense fused liGRU")


def build_libri_ligru_stack(dev, feat_dim=GR_FEAT):
    """The libri Li-GRU -> its 1944-way cd head (weights from init(0) /
    init(1), the head times LIBRI_LIGRU_HEAD_GAIN)."""
    from pytorch_kaldi_cgs_tpu_torch.models import MLP, liGRU
    secs = libri_ligru_sections()
    rnn = liGRU(dict(secs["architecture1"], to_do="forward"), feat_dim,
                seed=0, device=dev)
    mlp = MLP(dict(secs["architecture2"], to_do="forward"), rnn.out_dim,
              seed=1, device=dev)
    check_libri_ligru(rnn)
    with torch.no_grad():
        mlp.params["w0"].mul_(LIBRI_LIGRU_HEAD_GAIN)
    return Stack(rnn, mlp).eval()


def libri_ligru_expect_serve(T):
    """Launches per recognize: 5 layer calls of the forward at 16 rows
    (both directions in one call), each its route's
    (ligru_fwd_launches)."""
    return expected(fused_ligru_fwd=LL_LAYERS * ligru_fwd_launches(
        "cuda", T, *LL_SERVE_TBH[1:])[1])


def libri_ligru_train_runner(dev, compute_dtype="", act=None):
    """A ChunkRunner over the libri Li-GRU's sections and its one batch
    (16 sentences of 200 frames = 32 rows, fMLLR x of width 40)."""
    from pytorch_kaldi_cgs_tpu_torch.models import liGRU
    from pytorch_kaldi_cgs_tpu_torch.runtime.chunk import ChunkRunner
    from pytorch_kaldi_cgs_tpu_torch.runtime.graph import NetGraph
    T, B, _ = LL_TRAIN_TBH
    config, chunk, batch = chunk_setup(
        libri_ligru_sections(compute_dtype, act), T, B // 2,
        "fmllr", GR_FEAT, CD_LABELS)
    graph = NetGraph(config, chunk, seed=0, device=dev)
    rnn = graph.nets["liGRU_layers"]
    if type(rnn) is not liGRU:
        raise AssertionError("the libri Li-GRU cfg did not build a liGRU")
    check_libri_ligru(rnn)
    return ChunkRunner(graph, config), batch


def phase_libri_ligru_stream(dev, rec, audio, lens):
    """The cfg is bidirectional: a StreamingRecognizer's first chunk
    raises (as the JAX package's apply_streaming does) and launches
    nothing."""
    def first_chunk():
        try:
            stream_run(dev, rec, audio, lens, 100)
        except ValueError as e:
            return str(e)
        raise AssertionError("the bidirectional libri Li-GRU streamed")
    msg, launches = counted(first_chunk)
    print("[libri_ligru_stream] raises: %s; launches %s"
          % (msg, {k: v for k, v in launches.items() if v}))
    if "bidirectional models cannot stream" not in msg or \
            launches != expected():
        raise AssertionError("libri_ligru_stream: %s, launches %s"
                             % (msg, launches))
    return msg


def phase_libri_ligru_train(dev):
    """One train step on the card against the CPU: at TOL_GRAD_REL, or,
    where relu' flips between the card's and the CPU's sums, GRAD_FLIP_K
    times the CPU's own one-ulp sensitivity and then the same step with
    tanh at TOL_GRAD_REL. Launches per step with the recompute backward
    (the default; the forward's and its launches a layer call their
    routes', ligru_fwd_launches and ligru_bwd_launches) and the stash one
    (PKC_BWD_STASH_CELLS=ligru), 10 steps in f32 and bf16 at the cfg's
    learning rates (the loss falls on random labels there, unlike the
    TIMIT Li-GRU's)."""
    T = LL_TRAIN_TBH[0]
    knob = "PKC_BWD_STASH_CELLS"

    def bar(worst):
        if worst <= TOL_GRAD_REL:
            return TOL_GRAD_REL
        inp, mask = libri_ligru_train_runner("cpu")[1]
        sens, where = ulp_sensitivity(libri_ligru_train_runner, inp, mask,
                                      GR_FEAT)
        print("[libri_ligru_train] the CPU's own gradients under a one-ulp "
              "change of x: worst rel change %.3g at %s" % (sens, where))
        return max(TOL_GRAD_REL, GRAD_FLIP_K * sens)
    route, n_bwd = ligru_bwd_launches(dev, T, LL_TRAIN_TBH[1],
                                      LL_TRAIN_TBH[2], 0)
    f_route, n_fwd = ligru_fwd_launches(dev, *LL_TRAIN_TBH)
    print("[libri_ligru_train] forward: route %s, %d launches a layer call, "
          "plan %s; recompute BPTT: route %s, %d launches a layer call; plan "
          "%s" % (f_route, n_fwd, json.dumps(chain_route(
              dev, "fused_ligru_fwd", *LL_TRAIN_TBH[1:])[1]), route, n_bwd,
              json.dumps(chain_route(dev, "fused_ligru_bwd",
                                     *LL_TRAIN_TBH[1:])[1])))
    out = phase_train(dev, libri_ligru_train_runner, "libri_ligru_train", (
        ("recompute", knob, None,
         expected(fused_ligru_fwd=LL_LAYERS * n_fwd,
                  fused_ligru_bwd=LL_LAYERS * n_bwd)),
        ("stash", knob, "ligru",
         expected(fused_ligru_fwd=LL_LAYERS * n_fwd,
                  fused_ligru_bwd_stash=LL_LAYERS * T))),
        grad_tol=bar)
    if out["grad_rel_err_max"] <= TOL_GRAD_REL:
        return out                  # relu' flipped nowhere that mattered

    def tanh(d, cdt=""):
        return libri_ligru_train_runner(d, cdt, act="tanh")
    runner, (inp, mask) = tanh(dev)
    with env(knob, None):
        loss_err = runner.train_step(inp, mask, dropout_gen())
    out["tanh"] = card_vs_cpu(runner, tanh("cpu")[0], inp, mask, loss_err,
                              knob, None, "libri_ligru_train, ligru_act=tanh")
    return out


def phase_libri_ligru_times(dev, rec, audio, lens):
    """The liGRU kernels (rows 16-18) per layer call at the cfg's shapes:
    T=200, 32 rows, H=1024, relu, no quantizer (the stash forward, both
    BPTT kernels; the recompute one's plan and rebuild / chain split) and
    the forward at T=398, 16 rows; their bounds; the libri Li-GRU train
    step (f32, bf16) and recognize."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as R
    T, B, H = LL_TRAIN_TBH
    act = "relu"
    inp = gated_inputs(T, B, H, 230, dev, act)
    g, U, drop, dhs = (inp[n] for n in ("g", "U", "drop", "dhs"))
    times = {}
    with torch.no_grad():
        hs, acts = R.fused_ligru_fwd(g, U, drop, act=act, stash=True)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        for name, fn, kind in (
                ("fused_ligru_fwd", lambda: R.fused_ligru_fwd(
                    g, U, drop, act=act, stash=True), "fwd_stash"),
                ("fused_ligru_bwd_stash", lambda: R.fused_ligru_bwd_stash(
                    acts, U, drop, h_prev, dhs, act), "bwd_stash"),
                ("fused_ligru_bwd", lambda: R.fused_ligru_bwd(
                    g, U, drop, h_prev, dhs, act, 0), "bwd")):
            times[name + "_ms"] = cuda_ms(fn, reps=10)
            times[name + "_bound_ms"], times[name + "_bound_by"] = \
                ligru_bound_ms(T, B, H, kind)
            if name == "fused_ligru_bwd":
                times[name + "_split"] = bptt_split(fn, 3)
            if name != "fused_ligru_bwd_stash":
                times[name + "_plan"] = chain_route(dev, name, B, H)[1]
        Ts, Bs, _ = LL_SERVE_TBH
        sv = gated_inputs(Ts, Bs, H, 231, dev, act)
        times["serve_fwd_ms"] = cuda_ms(
            lambda: R.fused_ligru_fwd(sv["g"], sv["U"], sv["drop"], act=act),
            reps=10)
        times["serve_fwd_bound_ms"], times["serve_fwd_bound_by"] = \
            ligru_bound_ms(Ts, Bs, H, "fwd")
    print("[libri_ligru_times] liGRU kernels at T=%d, %d rows, H=%d (relu, "
          "no quantizer), serving T=%d, %d rows: %s"
          % (T, B, H, Ts, Bs, json.dumps(times)))
    step = train_step_times(dev, libri_ligru_train_runner,
                            "libri_ligru_times", 5, 3)
    serve = serve_timings(rec, audio, lens)
    print("[libri_ligru_times] libri Li-GRU recognizer (8 x 4 s batch): %s"
          % json.dumps(serve))
    return times, step, serve


def kernels_line(fwd_checks, train_checks, serve_times, times, launches,
                 sp_times, cs_times, dev):
    """The kernels JSON: every kernel of the port with its numbers from
    this run. ``ms``/``plain_ms``/``bound_ms``/``library_ms`` are per layer
    call at the training shape (f32); ``launches`` counts the main path
    that runs the kernel: one train step (stash backward; the recompute
    backward for fused_lstm_bwd); ``launches_by_path`` all paths. Rows 1
    and 3 also name their routes and plans (``kernel_route``: the
    training, serving and 2x1024 shapes) and their times at 2x1024 with
    8 (the shipped CGS-16x cfg, phase_cgs_shipped_times) and 16 rows (the
    CGS-16x layer, phase_sparse_times), beside their bounds and cuDNN's
    nn.LSTM(1024)."""
    T, B, H = TRAIN_TBH

    def routed(kernel):
        shapes = {"train": TRAIN_TBH, "h1024_b8": CS_TRAIN_TBH,
                  "h1024_b16": SP_TRAIN_TBH}
        if kernel == "fused_lstm_fwd":
            shapes["serve"] = SERVE_TBH
        return {tag: dict(zip(("route", "plan"), chain_route(
            dev, kernel, B_, H_))) for tag, (_, B_, H_) in shapes.items()}

    def h1024(kind, dense, cs_key, cudnn):
        T16, B16, H16 = SP_TRAIN_TBH
        return {
            "B8": {"T": CS_TRAIN_TBH[0], "ms": cs_times[cs_key + "_ms"],
                   "ms_bf16": cs_times[cs_key + "_ms_bf16"],
                   "bound_ms": cs_times[cs_key + "_bound_ms"],
                   "library_ms": cs_times["cudnn_lstm1024_%s_ms" % cudnn]},
            "B16": {"T": T16, "ms": sp_times["dense_%s_ms" % dense],
                    "ms_bf16": sp_times["dense_%s_ms_bf16" % dense],
                    "bound_ms": lstm_bound_ms(T16, B16, H16, "f32", kind)[0],
                    "library_ms": sp_times["cudnn_%s_ms" % cudnn]}}

    def err_at(kernel):
        return [c for c in train_checks if c["kernel"] == kernel
                and (c["T"], c["B"], c["H"]) == TRAIN_TBH
                and c["dtype"] == "f32" and c["carry"] == "zero"
                and c["qbits"] == 0][0]["max_abs_err"]

    def row(name, replaces, library_ms, **extra):
        checks = [c for c in train_checks if c["kernel"].startswith(name)]
        r = {"name": name, "route": "cuda",
             "source": "pytorch_kaldi_cgs_tpu_torch/ops/csrc/%s.cu"
             % ("fused_lstm_fwd" if name == "fused_lstm_fwd"
                else "fused_lstm_bwd"),
             "replaces": "pytorch_kaldi_cgs_tpu/ops/fused_lstm.py:%d" % replaces,
             "launches": launches[name]["train"],
             "launches_by_path": launches[name],
             "max_abs_err": err_at(name if name != "fused_lstm_fwd"
                                   else "fused_lstm_fwd/stash"),
             "ms": times[name + "_ms"], "plain_ms": times[name + "_plain_ms"],
             "bound_ms": times[name + "_bound_ms"],
             "bound_by": times[name + "_bound_by"], "library_ms": library_ms,
             "ms_bf16": times[name + "_ms_bf16"],
             "bound_ms_bf16": times[name + "_bound_ms_bf16"],
             "shape": {"T": T, "B": B, "H": H},
             "checks": len(checks), "checks_ok": all(c["ok"] for c in checks)}
        r.update(extra)
        return r

    main_fwd = [c for c in fwd_checks if (c["T"], c["B"], c["H"]) == SERVE_TBH
                and c["dtype"] == "f32" and c["carry"] == "zero"
                and c["qbits"] == 0][0]
    fwd = row("fused_lstm_fwd", 92, times["cudnn_fwd_ms"],
              variant="stash (training forward)",
              kernel_route=routed("fused_lstm_fwd"),
              h1024=h1024("fwd_stash", "fused_lstm_fwd", "fwd", "fwd"),
              serve={"T": SERVE_TBH[0], "B": SERVE_TBH[1], "H": SERVE_TBH[2],
                     "ms": serve_times["ms"],
                     "ms_bf16": serve_times["ms_bf16"],
                     "plain_ms": serve_times["plain_ms"],
                     "bound_ms": serve_times["bound_ms"],
                     "bound_by": serve_times["bound_by"],
                     "library_ms": serve_times["library_ms"],
                     "max_abs_err": main_fwd["max_abs_err"],
                     "checks": len(fwd_checks),
                     "checks_ok": all(c["ok"] for c in fwd_checks)})
    return {"kernels": [
        fwd,
        row("fused_lstm_bwd_stash", 339, times["cudnn_bwd_ms"],
            library_note="cuDNN nn.LSTM backward (fwd+bwd minus fwd)",
            kernel_route=routed("fused_lstm_bwd_stash"),
            h1024=h1024("bwd_stash", "fused_lstm_bwd_stash", "bwd_stash",
                        "bwd")),
        row("fused_lstm_bwd", 218, times["cudnn_bwd_ms"],
            library_note="cuDNN nn.LSTM backward (fwd+bwd minus fwd)")]}


def dw_by_shape(bs_times):
    """Row 15 at every shape of dw_shapes (bs_gemm_times): ms, torch.bmm
    of the gathered operands, the bound, the shape and the device kernels
    of one call as the profiler counted them."""
    return {tag: dict(bs_times["dw_%s_shape" % tag],
                      **{k: bs_times["dw_%s_%s" % (tag, k)] for k in (
                          "ms", "library_ms", "bound_ms", "bound_by",
                          "device_launches")})
            for tag, *_ in dw_shapes()}


def check_gemm_launches(bs_times, dev):
    """The device kernels of one call as bs_gemm_times counted them
    against the design: the v3 forward v3_weight_t then v3_fwd_gemm; the
    v3 dx v3_weight_packed then dx_gemm, and dx_reduce where dx_plan
    splits a column; the dw one dw_gemm, and one dw_reduce where dw_plan splits M; the legacy
    dw the same, dw_mma in place of dw_gemm in bf16; the legacy forward
    packed_weight_t then v3_fwd_gemm in float32, fwd_mma alone in bf16;
    the legacy dx dx_gemm in float32, dx_mma in bf16, each then
    dx_reduce where dx_plan splits a column (where the trace held only
    launch calls, their number). Raises on a difference; where the
    profiler showed nothing there is nothing to hold."""
    from pytorch_kaldi_cgs_tpu_torch.ops import block_sparse as BS
    want = {"block_sparse_v3_fwd": {"v3_weight_t": 1, "v3_fwd_gemm": 1},
            "serve_v3_fwd": {"v3_weight_t": 1, "v3_fwd_gemm": 1}}
    want["block_sparse_v3_dx"] = dict(
        {"v3_weight_packed": 1, "dx_gemm": 1},
        **({"dx_reduce": 1} if bs_times["block_sparse_v3_dx_plan"]["parts"]
           else {}))
    for tag, layout, M, G, _ in dw_shapes():
        splits = BS.dw_plan(M, layout.Nb, G, layout.R, layout.bs,
                            BS.gemm_grid(dev))[1]
        want["dw_" + tag] = dict({"dw_gemm": 1},
                                 **({"dw_reduce": 1} if splits > 1 else {}))
    # the legacy dw: float32 on dw_gemm, bf16 on dw_mma (the timed
    # operands are fresh, so 16-byte aligned, at bs=128); the forward:
    # float32 on packed_weight_t + v3_fwd_gemm, bf16 on fwd_mma; the dx on
    # dx_gemm and dx_mma
    for tag, layout, M, G in legacy_dw_shapes():
        for dt, tile, kernel in (("f32", "bs_gemm", "dw_gemm"),
                                 ("bf16", "bs_mma", "dw_mma")):
            splits = BS.dw_plan(M, layout.Nb, G, layout.R, layout.bs,
                                BS.gemm_grid(dev, tile))[1]
            want["bsl_dw_%s_%s" % (tag, dt)] = dict(
                {kernel: 1}, **({"dw_reduce": 1} if splits > 1 else {}))
        want["bsl_fwd_%s_f32" % tag] = {"packed_weight_t": 1,
                                        "v3_fwd_gemm": 1}
        want["bsl_fwd_%s_bf16" % tag] = {"fwd_mma": 1}
        for dt, route, kernel in (("f32", "gemm", "dx_gemm"),
                                  ("bf16", "mma", "dx_mma")):
            plan = dx_plan_of(layout, M, G, route, dev)
            want["bsl_dx_%s_%s" % (tag, dt)] = dict(
                {kernel: 1}, **({"dx_reduce": 1} if plan.parts else {}))
    def agrees(got, v):
        if got is None or got == v:
            return True
        return list(got) == ["cuda_launch_calls"] and \
            got["cuda_launch_calls"] == sum(v.values())
    bad = {k: bs_times[k + "_device_launches"] for k, v in want.items()
           if not agrees(bs_times[k + "_device_launches"], v)}
    if bad:
        raise AssertionError("device kernels per call differ from the "
                             "design %s: %s" % (want, bad))
    print("[bs_gemm_times] device kernels per call: %s" % json.dumps(
        {k: bs_times[k + "_device_launches"] for k in want}))


def sparse_rows(checks, times, launches, bs_times):
    """The kernels JSON rows of the block-sparse slice. ``ms`` etc. are
    per layer call at the CGS-16x training shape (f32 w3g); ``launches``
    counts one CGS-16x train step (stash backward; the recompute
    backward for fused_lstm_bwd_sparse); ``dense_h1024_ms`` is the
    dense fused kernel on the same layer (the masked U); rows 4 and 5
    name their routes and plans (``kernel_route``), us a step and each
    block shape's ms (row 6 has only the step route). Row 15 also at
    every shape a model path gives it (``by_shape``, bs_gemm_times)."""
    T, B, H = SP_TRAIN_TBH
    csrc = "pytorch_kaldi_cgs_tpu_torch/ops/csrc/%s.cu"
    jax_fl = "pytorch_kaldi_cgs_tpu/ops/fused_lstm.py:%d"
    cudnn_bwd = "cuDNN nn.LSTM(1024, 1024) backward (fwd+bwd minus fwd)"

    def err_at(kernel, **want):
        hits = [c for c in checks if c["kernel"] == kernel
                and (c["T"], c["B"], c["H"]) == SP_TRAIN_TBH
                and all(c.get(k) == v for k, v in want.items())]
        return hits[0]["max_abs_err"]

    def row(name, source, replaces, library_ms, library_note, err, dense,
            **extra):
        mine = [c for c in checks if c["kernel"].split("/")[0] == name]
        r = {"name": name, "route": "cuda", "source": csrc % source,
             "replaces": replaces, "launches": launches[name]["main"],
             "launches_by_path": launches[name], "max_abs_err": err,
             "ms": times[name + "_ms"], "plain_ms": times[name + "_plain_ms"],
             "bound_ms": times[name + "_bound_ms"],
             "bound_by": times[name + "_bound_by"], "library_ms": library_ms,
             "library_note": library_note,
             "shape": {"T": T, "B": B, "H": H, "Kb": 8, "R": 2, "bs": 128},
             "checks": len(mine), "checks_ok": all(c["ok"] for c in mine)}
        if dense:
            r.update(ms_bf16=times[name + "_ms_bf16"],
                     bound_ms_bf16=times[name + "_bound_ms_bf16"],
                     dense_h1024_ms=times["dense_%s_ms" % dense],
                     dense_h1024_ms_bf16=times["dense_%s_ms_bf16" % dense])
        r.update(extra)
        return r

    f32 = {"w3g": "f32", "qbits": 0, "act": "tanh"}
    return [
        row("fused_lstm_fwd_sparse", "fused_lstm_sparse", jax_fl % 707,
            times["cudnn_fwd_ms"], "cuDNN nn.LSTM(1024, 1024) forward",
            err_at("fused_lstm_fwd_sparse/stash", **f32), "fused_lstm_fwd",
            variant="stash (training forward)",
            kernel_route=times["fused_lstm_fwd_sparse_kernel_route"],
            us_per_step=times["fused_lstm_fwd_sparse_us_per_step"],
            by_block_shape=times["fused_lstm_fwd_sparse_by_block_shape"],
            serve={"T": SP_SERVE_TBH[0], "B": SP_SERVE_TBH[1], "H": H,
                   "kernel_route": times["serve_fwd_sparse_kernel_route"],
                   "us_per_step": times["serve_fwd_sparse_us_per_step"],
                   "ms": times["serve_fwd_sparse_ms"],
                   "ms_bf16": times["serve_fwd_sparse_ms_bf16"],
                   "plain_ms": times["serve_fwd_sparse_plain_ms"],
                   "bound_ms": times["serve_fwd_sparse_bound_ms"],
                   "bound_by": times["serve_fwd_sparse_bound_by"],
                   "library_ms": times["cudnn_serve_fwd_ms"],
                   "dense_h1024_ms": times["serve_dense_fwd_ms"],
                   "dense_h1024_ms_bf16": times["serve_dense_fwd_ms_bf16"]}),
        row("fused_lstm_bwd_sparse_stash", "fused_lstm_sparse", jax_fl % 788,
            times["cudnn_bwd_ms"], cudnn_bwd,
            err_at("fused_lstm_bwd_sparse_stash", **f32),
            "fused_lstm_bwd_stash",
            kernel_route=times["fused_lstm_bwd_sparse_stash_kernel_route"],
            us_per_step=times["fused_lstm_bwd_sparse_stash_us_per_step"],
            by_block_shape=times[
                "fused_lstm_bwd_sparse_stash_by_block_shape"]),
        row("fused_lstm_bwd_sparse", "fused_lstm_sparse", jax_fl % 859,
            times["cudnn_bwd_ms"], cudnn_bwd,
            err_at("fused_lstm_bwd_sparse", **f32), "fused_lstm_bwd",
            kernel_route={"route": "step"}),
        row("block_sparse_dw", "block_sparse_dw",
            "pytorch_kaldi_cgs_tpu/ops/block_sparse.py:856",
            times["block_sparse_dw_library_ms"],
            "torch.bmm over the pre-gathered operands",
            err_at("block_sparse_dw", fuse_sub=False, act="tanh"), None,
            ms_fuse_sub=times["block_sparse_dw_ms_fuse_sub"],
            by_shape=dw_by_shape(bs_times),
            deterministic=all(c["ok"] for c in checks if c["kernel"]
                              == "block_sparse_dw/determinism"))]


def timed(name, fn, *args):
    """Run one phase, printing its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print("[timing] %s: %.1f s" % (name, time.perf_counter() - t0))
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = "cuda"
    t_start = time.perf_counter()
    print("[env] python %s, torch %s, CUDA %s, %s x%d" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()))
    smi = timed("build", phase_build)
    fwd_checks = timed("kernels", phase_kernels, dev)
    train_checks = timed("train_kernels", phase_train_kernels, dev)
    sp_checks = timed("sparse_kernels", phase_sparse_kernels, dev)
    lg_checks = timed("ligru_kernels", phase_ligru_kernels, dev)
    audio, lens = make_audio()
    rec, phones, logp, serve_launches, post_err = timed(
        "serve", phase_serve, dev, audio, lens, build_stack, "serve",
        "fused_lstm_fwd", TOL_POST, flagship_expect_serve)
    serve_launches = serve_launches["fused_lstm_fwd"]
    stream_launches, _ = timed(
        "stream", phase_stream, dev, rec, audio, lens, phones, logp, 100,
        "stream", TOL_STREAM, "fused_lstm_fwd", 2,
        lambda T, c: lstm_stream_launches(dev, T, c, N_UTT, SERVE_TBH[2], 2))
    timed("entry", phase_entry, dev)
    train = timed("train", phase_train, dev)
    sp_rec, sp_phones, sp_logp, sp_serve_launches, sp_post_err = timed(
        "sparse_serve", phase_serve, dev, audio, lens, build_cgs_stack,
        "sparse_serve", "fused_lstm_fwd_sparse", TOL_POST, cgs_expect_serve)
    sp_serve_launches = sp_serve_launches["fused_lstm_fwd_sparse"]
    sp_stream_launches, sp_stream_err = timed(
        "sparse_stream", phase_chunked_stream, dev, sp_rec, audio, lens,
        sp_phones, sp_logp, "sparse_stream", "fused_lstm_fwd", 2,
        lambda T, c: lstm_stream_launches(dev, T, c, N_UTT, SP_SERVE_TBH[2],
                                          2))
    sp_train = timed("sparse_train", phase_sparse_train, dev)
    cs_train = timed("cgs_shipped_train", phase_cgs_shipped_train, dev)
    lg_rec, lg_phones, lg_logp, lg_serve_launches, lg_post_err = timed(
        "ligru_serve", phase_serve, dev, audio, lens, build_ligru_stack,
        "ligru_serve", "fused_ligru_fwd", TOL_POST_Q16, ligru_expect_serve)
    lg_serve_launches = lg_serve_launches["fused_ligru_fwd"]
    lg_post_err_noq = timed(
        "ligru_serve_noq", phase_serve, dev, audio, lens,
        lambda d: build_ligru_stack(d, quant_inp=False),
        "ligru_serve, ligru_quant_inp=False", "fused_ligru_fwd", TOL_POST,
        ligru_expect_serve)[4]
    lg_stream_launches, lg_stream_err = timed(
        "ligru_stream", phase_ligru_stream, dev, lg_rec, audio, lens,
        lg_phones, lg_logp)
    lg_train = timed("ligru_train", phase_ligru_train, dev)
    gr_checks = timed("gru_kernels", phase_gru_kernels, dev)
    gr_rec, gr_phones, gr_logp, gr_serve_launches, gr_post_err = timed(
        "gru_serve", phase_serve, dev, audio, lens, build_gru_stack,
        "gru_serve", "fused_gru_fwd_sparse", gru_serve_bar, gru_expect_serve)
    gr_post_err_noq = None          # needed where the shipped cfg is
    if gr_post_err > TOL_POST:      # held to its measured sensitivity
        gr_post_err_noq = timed(
            "gru_serve_noq", phase_serve, dev, audio, lens,
            lambda d: build_gru_stack(d, quant_inp=False),
            "gru_serve, gru_quant_inp=False", "fused_gru_fwd_sparse",
            TOL_POST, gru_expect_serve)[4]
    gr_train = timed("gru_train", phase_gru_train, dev)
    tg_checks = timed("timit_gru_kernels", phase_timit_gru_kernels, dev)
    tg_rec, tg_phones, tg_logp, tg_serve_launches, tg_post_err = timed(
        "timit_gru_serve", phase_serve, dev, audio, lens,
        build_timit_gru_stack, "timit_gru_serve", "fused_gru_fwd", TOL_POST,
        timit_gru_expect_serve)
    tg_stream_launches, tg_stream_err = timed(
        "timit_gru_stream", phase_stream, dev, tg_rec, audio, lens, tg_phones,
        tg_logp, 100, "timit_gru_stream", TOL_STREAM, "fused_gru_fwd",
        2 * TG_LAYERS, lambda T, c: dense_fwd_stream_launches(
            dev, "fused_gru_fwd", T, c, N_UTT, TG_TRAIN_TBH[2], TG_LAYERS, 0))
    tg_train = timed("timit_gru_train", phase_timit_gru_train, dev)
    large = timed("gru_large_batch", phase_gru_large_batch, dev)
    tr_checks = timed("timit_rnn_kernels", phase_timit_rnn_kernels, dev)
    tr_rec, tr_phones, tr_logp, tr_serve_launches, tr_post_err = timed(
        "timit_rnn_serve", phase_serve, dev, audio, lens,
        build_timit_rnn_stack, "timit_rnn_serve", "fused_rnn_fwd", TOL_POST,
        timit_rnn_expect_serve)
    tr_stream_launches, tr_stream_err = timed(
        "timit_rnn_stream", phase_chunked_stream, dev, tr_rec, audio, lens,
        tr_phones, tr_logp, "timit_rnn_stream", "fused_rnn_fwd", TR_LAYERS,
        rnn_stream_count(dev, TR_LAYERS, N_UTT, TR_TRAIN_TBH[2]))
    tr_train = timed("timit_rnn_train", phase_timit_rnn_train, dev)
    cudnn = timed("cudnn_wrappers", phase_cudnn_wrappers, dev)
    cl_checks = timed("cgs_ligru_kernels", phase_cgs_ligru_kernels, dev)
    cl_rec, cl_phones, cl_logp, cl_serve_launches, cl_post_err = timed(
        "cgs_ligru_serve", phase_serve, dev, audio, lens,
        build_cgs_ligru_stack, "cgs_ligru_serve", "fused_ligru_fwd_sparse",
        TOL_POST_Q16, cgs_ligru_expect_serve)
    cl_noq = timed(
        "cgs_ligru_serve_noq", phase_serve, dev, audio, lens,
        lambda d: build_cgs_ligru_stack(d, quant_inp=False),
        "cgs_ligru_serve, ligru_quant_inp=False", "fused_ligru_fwd_sparse",
        TOL_POST, cgs_ligru_expect_serve)
    cl_stream_launches, cl_stream_err = timed(
        "cgs_ligru_stream", phase_cgs_ligru_stream, dev, cl_rec, audio, lens,
        cl_phones, cl_logp, cl_noq)
    cl_train = timed("cgs_ligru_train", phase_cgs_ligru_train, dev)
    gt_checks = timed("gru_torch_kernels", phase_gru_torch_kernels, dev)
    gt_cudnn = timed("gru_cudnn", phase_gru_cudnn, dev)
    mg_checks = timed("mgru_kernels", phase_mgru_kernels, dev)
    mg = {}
    for sparse, tag, stack, kernel, expect in (
            (False, "mgru", build_mgru_stack, "fused_mgru_fwd",
             mgru_expect_serve),
            (True, "cgs_mgru", build_cgs_mgru_stack, "fused_mgru_fwd_sparse",
             cgs_mgru_expect_serve)):
        r = mg[tag] = {}
        r["rec"], phones_, logp_, r["serve_launches"], r["post_err"] = \
            timed(tag + "_serve", phase_serve, dev, audio, lens, stack,
                  tag + "_serve", kernel, TOL_POST_Q16, expect)
        noq = timed(tag + "_serve_noq", phase_serve, dev, audio, lens,
                    lambda d, s=stack: s(d, quant_inp=False),
                    tag + "_serve, minimalgru_quant_inp=False", kernel,
                    TOL_POST, expect)
        r["post_err_noq"] = noq[4]
        r["stream_launches"], r["stream"] = timed(
            tag + "_stream", phase_mgru_stream, dev, r["rec"], audio, lens,
            phones_, logp_, noq, sparse)
        r["train"] = timed(tag + "_train", phase_mgru_train, dev, sparse)
    mg_large = timed("mgru_large_batch", phase_mgru_large_batch, dev)
    mg_tanh = timed("mgru_stream_tanh", phase_mgru_stream_tanh, dev, audio,
                    lens, mg["mgru"]["stream"])
    rs_checks = timed("rnn_sparse_kernels", phase_rnn_sparse_kernels, dev)
    rs_rec, rs_phones, rs_logp, rs_serve_launches, rs_post_err = timed(
        "rnn_sparse_serve", phase_serve, dev, audio, lens,
        build_rnn_sparse_stack, "rnn_sparse_serve", "fused_rnn_fwd_sparse",
        TOL_POST_Q16, rnn_sparse_expect_serve)
    rs_noq = timed(
        "rnn_sparse_serve_noq", phase_serve, dev, audio, lens,
        lambda d: build_rnn_sparse_stack(d, quant_inp=False),
        "rnn_sparse_serve, rnn_quant_inp=False", "fused_rnn_fwd_sparse",
        TOL_POST, rnn_sparse_expect_serve)
    rs_stream_launches, rs_stream = timed(
        "rnn_sparse_stream", phase_rnn_sparse_stream, dev, rs_rec, audio,
        lens, rs_phones, rs_logp, rs_noq)
    rs_train = timed("rnn_sparse_train", phase_rnn_sparse_train, dev)
    lb_checks, lb_api = timed("legacy_bs_kernels", phase_legacy_bs_kernels,
                              dev)
    ll_rec, ll_phones, ll_logp, ll_serve_launches, ll_post_err = timed(
        "libri_ligru_serve", phase_serve, dev, audio, lens,
        build_libri_ligru_stack, "libri_ligru_serve", "fused_ligru_fwd",
        TOL_POST, libri_ligru_expect_serve)
    ll_stream = timed("libri_ligru_stream", phase_libri_ligru_stream, dev,
                      ll_rec, audio, lens)
    ll_train = timed("libri_ligru_train", phase_libri_ligru_train, dev)
    width = timed("dense_width", phase_dense_width, dev)
    serve_times, serve = timed("times", phase_times, dev, rec, audio, lens)
    serve["posteriors_vs_cpu_max_abs_err"] = post_err
    times, step = timed("train_times", phase_train_times, dev)
    sp_times, sp_step, sp_serve = timed("sparse_times", phase_sparse_times,
                                        dev, sp_rec, audio, lens)
    cs_times, cs_step = timed("cgs_shipped_times", phase_cgs_shipped_times,
                              dev)
    lg_times, lg_step, lg_serve = timed("ligru_times", phase_ligru_times,
                                        dev, lg_rec, audio, lens)
    gr_times, gr_step, gr_serve = timed("gru_times", phase_gru_times, dev,
                                        gr_rec, audio, lens)
    tg_times, tg_step, tg_serve = timed("timit_gru_times",
                                        phase_timit_gru_times, dev, tg_rec,
                                        audio, lens)
    tr_times, tr_step, tr_serve = timed("timit_rnn_times",
                                        phase_timit_rnn_times, dev, tr_rec,
                                        audio, lens)
    cl_times, cl_step, cl_serve = timed("cgs_ligru_times",
                                        phase_cgs_ligru_times, dev, cl_rec,
                                        audio, lens)
    gt_times = timed("gru_torch_times", phase_gru_torch_times, dev)
    mg_times, mg_steps, mg_serves = timed(
        "mgru_times", phase_mgru_times, dev, mg["mgru"]["rec"],
        mg["cgs_mgru"]["rec"], audio, lens)
    rs_times, rs_step, rs_serve = timed("rnn_sparse_times",
                                        phase_rnn_sparse_times, dev, rs_rec,
                                        audio, lens)
    lb_times = timed("legacy_bs_times", phase_legacy_bs_times, dev)
    bs_times = timed("bs_gemm_times", phase_bs_gemm_times, dev)
    check_gemm_launches(bs_times, dev)
    ll_times, ll_step, ll_serve = timed("libri_ligru_times",
                                        phase_libri_ligru_times, dev, ll_rec,
                                        audio, lens)
    sp_serve.update(posteriors_vs_cpu_max_abs_err=sp_post_err,
                    stream_vs_whole_max_abs_err=sp_stream_err,
                    dense_stream_launches=sp_stream_launches)
    sp_stash, sp_rec_l = sp_train["launches_stash"], \
        sp_train["launches_recompute"]
    sp_launches = {
        "fused_lstm_fwd_sparse": {
            "main": sp_stash["fused_lstm_fwd_sparse"],
            "sparse_train_recompute": sp_rec_l["fused_lstm_fwd_sparse"],
            "sparse_serve": sp_serve_launches},
        "fused_lstm_bwd_sparse_stash": {
            "main": sp_stash["fused_lstm_bwd_sparse_stash"]},
        "fused_lstm_bwd_sparse": {"main": sp_rec_l["fused_lstm_bwd_sparse"]},
        "block_sparse_dw": {
            "main": sp_stash["block_sparse_dw"],
            "sparse_train_recompute": sp_rec_l["block_sparse_dw"]}}
    for name, paths in sp_launches.items():
        if not paths["main"]:
            raise AssertionError("%s was not launched on its path" % name)
    launches = {
        "fused_lstm_fwd": {"train": train["launches_stash"]["fused_lstm_fwd"],
                           "train_recompute":
                               train["launches_recompute"]["fused_lstm_fwd"],
                           "serve": serve_launches, "stream": stream_launches},
        "fused_lstm_bwd_stash": {
            "train": train["launches_stash"]["fused_lstm_bwd_stash"]},
        "fused_lstm_bwd": {
            "train": train["launches_recompute"]["fused_lstm_bwd"]}}
    cs_st, cs_rc = cs_train["launches_stash"], cs_train["launches_recompute"]
    launches["fused_lstm_fwd"].update(
        cgs_shipped_train=cs_st["fused_lstm_fwd"],
        cgs_dense_stream=sp_stream_launches)
    launches["fused_lstm_bwd_stash"]["cgs_shipped_train"] = \
        cs_st["fused_lstm_bwd_stash"]
    launches["fused_lstm_bwd"]["cgs_shipped_train"] = cs_rc["fused_lstm_bwd"]
    for name, paths in launches.items():
        if not (paths["train"] and paths["cgs_shipped_train"]):
            raise AssertionError("%s was not launched on its path" % name)
    print("[summary] %s" % json.dumps({
        "serve": serve, "train": train, "train_step": step,
        "cudnn_yardstick": {k: times[k] for k in (
            "cudnn_fwd_ms", "cudnn_fwd_bwd_ms", "cudnn_bwd_ms")},
        "dU_matmul_ms": times["dU_matmul_ms"]}))
    print("[summary] CGS-16x as shipped (lstm_block_sparse = False) %s"
          % json.dumps({"cgs_shipped_train": cs_train,
                        "cgs_shipped_train_step": cs_step,
                        "rows_1_3_at_its_shape": cs_times}))
    print("[summary] CGS-16x %s" % json.dumps({
        "sparse_serve": sp_serve, "sparse_train": sp_train,
        "sparse_train_step": sp_step,
        "sparse_vs_dense_h1024": {k: v for k, v in sp_times.items()
                                  if "dense" in k or "cudnn" in k}}))
    lg_serve.update(posteriors_vs_cpu_max_abs_err=lg_post_err,
                    posteriors_vs_cpu_max_abs_err_no_quant_inp=lg_post_err_noq,
                    stream_vs_whole_max_abs_err=lg_stream_err)
    lg_rc, lg_st = lg_train["launches_recompute"], lg_train["launches_stash"]
    lg_launches = {
        "fused_ligru_fwd": {"main": lg_rc["fused_ligru_fwd"],
                            "ligru_train_stash": lg_st["fused_ligru_fwd"],
                            "ligru_serve": lg_serve_launches,
                            "ligru_stream": lg_stream_launches},
        "fused_ligru_bwd_stash": {"main": lg_st["fused_ligru_bwd_stash"]},
        "fused_ligru_bwd": {"main": lg_rc["fused_ligru_bwd"]}}
    for name, paths in lg_launches.items():
        if not paths["main"]:
            raise AssertionError("%s was not launched on its path" % name)
    print("[summary] Li-GRU %s" % json.dumps({
        "ligru_serve": lg_serve, "ligru_train": lg_train,
        "ligru_train_step": lg_step,
        "yardsticks": {k: v for k, v in lg_times.items()
                       if "cudnn" in k or "dU" in k}}))
    gr_serve.update(posteriors_vs_cpu_max_abs_err=gr_post_err,
                    posteriors_vs_cpu_max_abs_err_no_quant_inp=gr_post_err_noq)
    gr_tr = gr_train["launches_recompute"]
    gr_launches = {
        name: {"main": gr_tr[name], "gru_serve": gr_serve_launches[name]}
        for name in ("fused_gru_fwd_sparse", "fused_gru_bwd_sparse",
                     "block_sparse_v3_fwd", "block_sparse_v3_dx")}
    for name in ("fused_gru_fwd_sparse", "block_sparse_v3_fwd"):
        if not (gr_tr[name] and gr_serve_launches[name]):
            raise AssertionError("%s was not launched in recognize and in "
                                 "train_step" % name)
    for name in ("fused_gru_bwd_sparse", "block_sparse_v3_dx",
                 "block_sparse_dw"):
        if not gr_tr[name]:
            raise AssertionError("%s was not launched in train_step" % name)
    sp_launches["block_sparse_dw"].update(
        gru_train=gr_tr["block_sparse_dw"],
        gru_train_by_G=gr_train["block_sparse_dw_by_G"])
    sp_launches["fused_lstm_fwd_sparse"]["large_batch_160_rows"] = \
        large["lstm"]["launches"]
    gr_launches["fused_gru_fwd_sparse"]["large_batch_160_rows"] = \
        large["gru"]["launches"]
    print("[summary] LibriSpeech GRU %s" % json.dumps({
        "gru_serve": gr_serve, "gru_train": gr_train,
        "gru_train_step": gr_step,
        "yardsticks": {k: v for k, v in gr_times.items()
                       if "cudnn" in k or "dense" in k or "dw" in k}}))
    tg_serve.update(posteriors_vs_cpu_max_abs_err=tg_post_err,
                    stream_vs_whole_max_abs_err=tg_stream_err)
    tg_st, tg_rc = tg_train["launches_stash"], tg_train["launches_recompute"]
    tg_launches = {
        "fused_gru_fwd": {"main": tg_st["fused_gru_fwd"],
                          "timit_gru_train_recompute": tg_rc["fused_gru_fwd"],
                          "timit_gru_serve": tg_serve_launches["fused_gru_fwd"],
                          "timit_gru_stream": tg_stream_launches},
        "fused_gru_bwd_stash": {"main": tg_st["fused_gru_bwd_stash"]},
        "fused_gru_bwd": {"main": tg_rc["fused_gru_bwd"]}}
    for name, paths in tg_launches.items():
        if not all(paths.values()):
            raise AssertionError("%s was not launched on every path: %s"
                                 % (name, paths))
    print("[summary] TIMIT GRU %s" % json.dumps({
        "timit_gru_serve": tg_serve, "timit_gru_train": tg_train,
        "timit_gru_train_step": tg_step,
        "gru_large_batch": large,
        "yardsticks": {k: v for k, v in tg_times.items()
                       if "cudnn" in k or "dU" in k}}))
    tr_serve.update(posteriors_vs_cpu_max_abs_err=tr_post_err,
                    stream_vs_whole_max_abs_err=tr_stream_err)
    tr_rc, tr_st = tr_train["launches_recompute"], tr_train["launches_stash"]
    rc_eval, rc_train = (cudnn["RNN_cudnn"]["launches_eval"],
                         cudnn["RNN_cudnn"]["launches_train"])
    tr_launches = {
        "fused_rnn_fwd": {"main": tr_rc["fused_rnn_fwd"],
                          "timit_rnn_train_stash": tr_st["fused_rnn_fwd"],
                          "timit_rnn_serve":
                              tr_serve_launches["fused_rnn_fwd"],
                          "timit_rnn_stream": tr_stream_launches,
                          "rnn_cudnn_eval": rc_eval["fused_rnn_fwd"],
                          "rnn_cudnn_train": rc_train["fused_rnn_fwd"]},
        "fused_rnn_bwd_stash": {"main": tr_st["fused_rnn_bwd_stash"]},
        "fused_rnn_bwd": {"main": tr_rc["fused_rnn_bwd"],
                          "rnn_cudnn_train": rc_train["fused_rnn_bwd"]}}
    for name, paths in tr_launches.items():
        if not all(paths.values()):
            raise AssertionError("%s was not launched on every path: %s"
                                 % (name, paths))
    lc_eval, lc_train = (cudnn["LSTM_cudnn"]["launches_eval"],
                         cudnn["LSTM_cudnn"]["launches_train"])
    launches["fused_lstm_fwd"].update(
        lstm_cudnn_eval=lc_eval["fused_lstm_fwd"],
        lstm_cudnn_train=lc_train["fused_lstm_fwd"])
    launches["fused_lstm_bwd_stash"]["lstm_cudnn_train"] = \
        lc_train["fused_lstm_bwd_stash"]
    print("[summary] TIMIT RNN %s" % json.dumps({
        "timit_rnn_serve": tr_serve, "timit_rnn_train": tr_train,
        "timit_rnn_train_step": tr_step, "cudnn_wrappers": cudnn,
        "yardsticks": {k: v for k, v in tr_times.items()
                       if "cudnn" in k or "dU" in k}}))
    cl_serve.update(posteriors_vs_cpu_max_abs_err=cl_post_err,
                    posteriors_vs_cpu_max_abs_err_no_quant_inp=cl_noq[4],
                    stream=cl_stream_err,
                    dense_stream_launches=cl_stream_launches)
    cl_tr = cl_train["launches_recompute"]
    cl_launches = {
        "fused_ligru_fwd_sparse": {
            "main": cl_tr["fused_ligru_fwd_sparse"],
            "cgs_ligru_serve": cl_serve_launches["fused_ligru_fwd_sparse"],
            "large_batch_%d_rows" % CL_LARGE_ROWS:
                large["ligru"]["launches"]},
        "fused_ligru_bwd_sparse": {"main": cl_tr["fused_ligru_bwd_sparse"]}}
    gc_eval, gc_train = (cudnn["GRU_cudnn"]["launches_eval"],
                         cudnn["GRU_cudnn"]["launches_train"])
    gt_launches = {
        "fused_gru_torch_fwd": {
            "main": gt_cudnn["launches_train"]["fused_gru_torch_fwd"],
            "gru_cudnn_eval": gt_cudnn["launches_eval"],
            "gru_cudnn_stream": gt_cudnn["launches_stream"],
            "cudnn_wrappers_eval": gc_eval["fused_gru_torch_fwd"],
            "cudnn_wrappers_train": gc_train["fused_gru_torch_fwd"]},
        "fused_gru_torch_bwd": {
            "main": gt_cudnn["launches_train"]["fused_gru_torch_bwd"],
            "cudnn_wrappers_train": gc_train["fused_gru_torch_bwd"]}}
    for name, paths in list(cl_launches.items()) + list(gt_launches.items()):
        if not all(paths.values()):
            raise AssertionError("%s was not launched on every path: %s"
                                 % (name, paths))
    print("[summary] CGS-16x Li-GRU %s" % json.dumps({
        "cgs_ligru_serve": cl_serve, "cgs_ligru_train": cl_train,
        "cgs_ligru_train_step": cl_step,
        "yardsticks": {k: v for k, v in cl_times.items()
                       if "cudnn" in k or "dU" in k or "dense" in k}}))
    print("[summary] GRU_cudnn %s" % json.dumps({
        "gru_cudnn": gt_cudnn, "yardsticks": {
            k: v for k, v in gt_times.items() if "cudnn" in k}}))
    dn, sp_ = mg["mgru"], mg["cgs_mgru"]
    dn_rc, dn_st = dn["train"]["launches_recompute"], \
        dn["train"]["launches_stash"]
    sp_rc = sp_["train"]["launches_recompute"]
    mg_launches = {
        "fused_mgru_fwd": {
            "main": dn_rc["fused_mgru_fwd"],
            "mgru_train_stash": dn_st["fused_mgru_fwd"],
            "mgru_serve": dn["serve_launches"]["fused_mgru_fwd"],
            "mgru_stream": dn["stream_launches"],
            "cgs_mgru_stream": sp_["stream_launches"]},
        "fused_mgru_bwd_stash": {"main": dn_st["fused_mgru_bwd_stash"]},
        "fused_mgru_bwd": {"main": dn_rc["fused_mgru_bwd"]},
        "fused_mgru_fwd_sparse": {
            "main": sp_rc["fused_mgru_fwd_sparse"],
            "cgs_mgru_serve": sp_["serve_launches"]["fused_mgru_fwd_sparse"],
            "large_batch_%d_rows" % MG_LARGE_ROWS: mg_large["launches"]},
        "fused_mgru_bwd_sparse": {"main": sp_rc["fused_mgru_bwd_sparse"]}}
    for name, paths in mg_launches.items():
        if not all(paths.values()):
            raise AssertionError("%s was not launched on every path: %s"
                                 % (name, paths))
    sp_launches["block_sparse_dw"]["cgs_mgru_train"] = \
        sp_rc["block_sparse_dw"]
    sp_launches["block_sparse_dw"]["cgs_ligru_train"] = \
        cl_tr["block_sparse_dw"]
    print("[summary] minimalGRU %s" % json.dumps({
        tag: {"serve": dict(mg_serves[tag],
                            posteriors_vs_cpu_max_abs_err=r["post_err"],
                            posteriors_vs_cpu_max_abs_err_no_quant_inp=r[
                                "post_err_noq"],
                            stream=r["stream"]),
              "train": r["train"], "train_step": mg_steps[tag]}
        for tag, r in mg.items()}))
    print("[summary] minimalGRU large batch %s; yardsticks %s; stream "
          "with tanh %s" % (json.dumps(mg_large), json.dumps({
              k: v for k, v in mg_times.items() if "cudnn" in k or "dU" in k}),
              json.dumps(mg_tanh)))
    rs_rc = rs_train["launches_recompute"]
    rs_launches = {
        "fused_rnn_fwd_sparse": {
            "main": rs_rc["fused_rnn_fwd_sparse"],
            "rnn_sparse_serve": rs_serve_launches["fused_rnn_fwd_sparse"]},
        "fused_rnn_bwd_sparse": {"main": rs_rc["fused_rnn_bwd_sparse"]}}
    for name, paths in rs_launches.items():
        if not all(paths.values()):
            raise AssertionError("%s was not launched on every path: %s"
                                 % (name, paths))
    tr_launches["fused_rnn_fwd"]["rnn_sparse_stream"] = rs_stream_launches
    sp_launches["block_sparse_dw"]["rnn_sparse_train"] = \
        rs_rc["block_sparse_dw"]
    rs_serve.update(posteriors_vs_cpu_max_abs_err=rs_post_err,
                    posteriors_vs_cpu_max_abs_err_no_quant_inp=rs_noq[4],
                    stream=rs_stream, dense_stream_launches=rs_stream_launches)
    print("[summary] CGS-16x RNN %s" % json.dumps({
        "rnn_sparse_serve": rs_serve, "rnn_sparse_train": rs_train,
        "rnn_sparse_train_step": rs_step, "dense_width": width,
        "yardsticks": {k: v for k, v in rs_times.items()
                       if "cudnn" in k or "dU" in k or "dense" in k}}))
    ll_rc, ll_st = ll_train["launches_recompute"], \
        ll_train["launches_stash"]
    lg_launches["fused_ligru_fwd"].update(
        libri_ligru_train=ll_rc["fused_ligru_fwd"],
        libri_ligru_serve=ll_serve_launches["fused_ligru_fwd"])
    lg_launches["fused_ligru_bwd"]["libri_ligru_train"] = \
        ll_rc["fused_ligru_bwd"]
    lg_launches["fused_ligru_bwd_stash"]["libri_ligru_train_stash"] = \
        ll_st["fused_ligru_bwd_stash"]
    for name, paths in lg_launches.items():
        if not all(v for k, v in paths.items() if k.startswith("libri")):
            raise AssertionError("%s was not launched on every libri Li-GRU "
                                 "path: %s" % (name, paths))
    ll_serve.update(posteriors_vs_cpu_max_abs_err=ll_post_err,
                    stream_raises=ll_stream)
    print("[summary] LibriSpeech Li-GRU %s" % json.dumps({
        "libri_ligru_serve": ll_serve, "libri_ligru_train": ll_train,
        "libri_ligru_train_step": ll_step, "rows_16_18_at_its_shape": ll_times,
        "head_gain": LIBRI_LIGRU_HEAD_GAIN}))
    print("[summary] legacy block-sparse API %s" % json.dumps({
        "api_launches": lb_api, "checks": len(lb_checks), "times": lb_times}))
    line = kernels_line(fwd_checks, train_checks, serve_times, times,
                        launches, sp_times, cs_times, dev)
    line["kernels"] += sparse_rows(sp_checks, sp_times, sp_launches,
                                   bs_times)
    line["kernels"] += dense_rnn_rows(
        lg_checks, lg_times, lg_launches, "ligru", (28, 112, 168),
        LG_TRAIN_TBH, LG_SERVE_TBH, "relu", 16,
        "cuDNN nn.GRU(1024, 1024) (three gates, no quantizer)",
        {"ms_nostash": "fused_ligru_fwd_nostash_ms",
         "ms_repeat": "fused_ligru_fwd_stash_ms",
         "ms_q0": "fused_ligru_fwd_stash_ms_q0",
         "ms_nostash_q0": "fused_ligru_fwd_nostash_ms_q0",
         "plan": "fused_ligru_fwd_plan"},
        bwd_extra={
            "plan": lg_times["fused_ligru_bwd_plan"],
            "split": lg_times["fused_ligru_bwd_split"],
            "libri": {"T": LL_TRAIN_TBH[0], "B": LL_TRAIN_TBH[1],
                      "H": LL_TRAIN_TBH[2], "qbits": 0,
                      "ms": ll_times["fused_ligru_bwd_ms"],
                      "bound_ms": ll_times["fused_ligru_bwd_bound_ms"],
                      "bound_by": ll_times["fused_ligru_bwd_bound_by"],
                      "plan": ll_times["fused_ligru_bwd_plan"],
                      "split": ll_times["fused_ligru_bwd_split"]}})
    line["kernels"] += gru_rows(gr_checks, dict(gr_times, **bs_times),
                                gr_launches)
    line["kernels"] += dense_rnn_rows(
        tg_checks, tg_times, tg_launches, "gru", (301, 386, 449),
        TG_TRAIN_TBH, TG_SERVE_TBH, "tanh", 0,
        "cuDNN nn.GRU(550, 550) (torch's gate order, no dropout)",
        {"ms_nostash": "fused_gru_fwd_nostash_ms",
         "ms_q16": "fused_gru_fwd_ms_q16", "plan": "fused_gru_fwd_plan"},
        stash_extra={"kernel_route": "fused_gru_bwd_stash_kernel_route",
                     "by_block_shape": "fused_gru_bwd_stash_by_block_shape"})
    line["kernels"] += dense_rnn_rows(
        tr_checks, tr_times, tr_launches, "rnn", (1047, 1116, 1160),
        TR_TRAIN_TBH, TR_SERVE_TBH, "relu", 0,
        "cuDNN nn.RNN(550, 550, nonlinearity='relu') (no dropout)",
        {"ms_nostash": "fused_rnn_fwd_nostash_ms",
         "ms_q16": "fused_rnn_fwd_ms_q16",
         "kernel_route": "fused_rnn_fwd_kernel_route",
         "by_block_shape": "fused_rnn_fwd_by_block_shape",
         "cgs16x_stream_chunk100_ms": "cgs16x_stream_chunk100_ms",
         "cgs16x_stream_chunk100_bound_ms":
             "cgs16x_stream_chunk100_bound_ms"}, "cudnn_rnn",
        bwd_extra={k: tr_times["fused_rnn_bwd_" + k] for k in (
            "kernel_route", "split", "by_block_shape")})
    line["kernels"] += slice8_rows(cl_checks, cl_times, cl_launches,
                                   gt_checks, gt_times, gt_launches)
    line["kernels"] += slice9_rows(mg_checks, mg_times, mg_launches)
    line["kernels"] += slice10_rows(rs_checks, rs_times, rs_launches)
    line["kernels"] += slice11_rows(lb_checks, lb_times, lb_api)
    print("[timing] total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gemm-times"]:
        sys.exit(gemm_times_main(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--rnn-times"]:
        sys.exit(rnn_times_main(sys.argv[2] if len(sys.argv) > 2 else "."))
    sys.exit(main())
