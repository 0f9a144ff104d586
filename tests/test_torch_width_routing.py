"""Width routing of the port's dense fused recurrences
(pytorch_kaldi_cgs_tpu_torch: ``fused_lstm.dense_max_width`` and the
wrappers' width checks in ops/fused_lstm.py and ops/fused_rnn.py,
``_RecurrentBase._fused_ok`` and the cuDNN-class ``_scan`` in
models/recurrent.py).

Each dense kernel stages rows of its (B, H) operands in a block's shared
memory, so it takes a width only up to a limit (the JAX package's
``fits_vmem`` is its own rule for its VMEM). On the card a wrapper above
its kernel's limit raises a ValueError that names it; a model decides up
front, on every device, that a layer wider than its cell's limit (the
forward's, and under autograd the backward's) runs the cell's plain step
loop, as the JAX package runs its ``lax.scan`` beyond its size rule.

- The limits follow from each kernel's shared memory (a table worked out
  by hand from ``csrc/*.cu``).
- Each wrapper checks its own kernel's limit: with the card's check
  applied to CPU tensors and ``_SMEM_MAX`` cut to the bytes one width
  needs, that width passes and the next raises.
- A layer of each cell (and of each cuDNN-class wrapper) above its limit
  takes the plain loop and gives the fused path's outputs and gradients
  (float32, sums in the same order but for the BPTT: atol 1e-5 of each
  one's scale); a layer whose forward fits but whose backward does not
  runs the kernels in eval and the plain loop under autograd.
- On the card (skips here): a 2048-wide LSTM layer, beyond both LSTM
  backwards, trains on the plain loop and agrees with the CPU.
"""
import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import models
from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as tfl
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr

T, B, H, F_IN = 5, 3, 16, 6
ATOL = 1e-5

#: The widest H of each cell's dense kernels (forward; stash and
#: recompute backward) on sm_90's 232,448 bytes a block: 8 staged rows
#: of q(h) in each forward (32 B a unit of H, plus the static usm), of
#: dg_{t+1} (4H, 2H, 2H for the GRU's [z | r], H, 3H) in each backward,
#: and of q(h) in the LSTM's and liGRU's recompute one.
LIMITS = {"lstm": (7248, 1806, 1444), "ligru": (7248, 3620, 2413),
          "gru": (7256, 3628, 3628), "mgru": (7256, 7256, 7256),
          "rnn": (7256, 7256, 7256), "gru_torch": (7252, None, 2418)}


@pytest.mark.parametrize("cell", sorted(LIMITS))
def test_limits_follow_the_kernels_shared_memory(cell):
    fwd, stash, recompute = LIMITS[cell]
    assert tfl.dense_max_width(cell) == fwd
    assert tfl.dense_max_width(cell, "recompute") == recompute
    if stash is not None:
        assert tfl.dense_max_width(cell, "stash") == stash
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    tfl.check_dense_width(cell, recompute, "recompute", cuda)
    tfl.check_dense_width(cell, 10 ** 5, "recompute", cpu)
    with pytest.raises(ValueError, match="H <= %d, got %d"
                       % (recompute, recompute + 1)):
        tfl.check_dense_width(cell, recompute + 1, "recompute", cuda)


def _seq(*shape, seed=0):
    return torch.tensor(np.random.RandomState(seed).randn(*shape)
                        .astype(np.float32) * 0.3)


def _cell_kind(name):
    """The cell and the kernel kind ("fwd", "stash", "recompute") of the
    dense wrapper ``name``."""
    cell = name.split("_")[1] if "torch" not in name else "gru_torch"
    kind = ("stash" if name.endswith("stash") else
            "recompute" if "bwd" in name else "fwd")
    return cell, kind


def _call(name, h):
    """Call wrapper ``name`` at width h on CPU tensors."""
    cell, kind = _cell_kind(name)
    seq = _seq(T, B, h, seed=1)
    drop = torch.ones(B, h)
    G = {"lstm": 4, "ligru": 2, "gru": 3, "mgru": 2, "rnn": 1,
         "gru_torch": 3}
    lead = _seq(T, B, G[cell] * h, seed=2)
    U = _seq(G[cell] * h, h, seed=3) / h
    fn = getattr(tfl if cell == "lstm" else tfr, name)
    if cell == "gru_torch":
        b_hh = torch.zeros(3 * h)
        args = (lead, U, b_hh) + ((seq, seq) if kind != "fwd" else ())
    elif cell == "lstm" and kind != "fwd":
        args = (lead, U, drop, seq, seq, seq)
    elif cell == "rnn" and kind == "stash":
        args = (lead, U, drop, seq)
    else:
        args = (lead, U, drop) + ((seq, seq) if kind != "fwd" else ())
    fn(*args)


WRAPPERS = ["fused_lstm_fwd", "fused_lstm_bwd_stash", "fused_lstm_bwd",
            "fused_ligru_fwd", "fused_ligru_bwd_stash", "fused_ligru_bwd",
            "fused_gru_fwd", "fused_gru_bwd_stash", "fused_gru_bwd",
            "fused_mgru_fwd", "fused_mgru_bwd_stash", "fused_mgru_bwd",
            "fused_rnn_fwd", "fused_rnn_bwd_stash", "fused_rnn_bwd",
            "fused_gru_torch_fwd", "fused_gru_torch_bwd"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_raises_above_its_kernels_limit(monkeypatch, name):
    """The card's width check applied to CPU tensors: with _SMEM_MAX cut
    to the bytes the wrapper's kernel needs at width H it runs, at H + 1
    it raises a ValueError naming the limit H."""
    real = tfl.check_dense_width

    def as_on_card(cell, h, backward, dev):
        return real(cell, h, backward, torch.device("cuda"))
    monkeypatch.setattr(tfl, "check_dense_width", as_on_card)
    monkeypatch.setattr(tfr, "check_dense_width", as_on_card)
    cell, kind = _cell_kind(name)
    need = [per * H + static for per, static in
            (tfl._DENSE_SMEM[cell][k] for k in {"fwd", kind})]
    monkeypatch.setattr(tfl, "_SMEM_MAX", max(need))
    _call(name, H)
    with pytest.raises(ValueError, match="H <= %d, got %d" % (H, H + 1)):
        _call(name, H + 1)


# ---------------------------------------------------------------------------
# the models: a layer beyond its cell's limit takes the plain step loop
# ---------------------------------------------------------------------------

def cell_opts(prefix):
    """2 x H, tanh, no norm, no HCGS, no quantizers, dropout 0."""
    p = prefix
    return {p + "_lay": "%d,%d" % (H, H), p + "_drop": "0.0,0.0",
            p + "_use_batchnorm": "False,False",
            p + "_use_laynorm": "False,False",
            p + "_use_laynorm_inp": "False",
            p + "_use_batchnorm_inp": "False", p + "_act": "tanh,tanh",
            p + "_orthinit": "True", p + "_bidir": "False",
            p + "_hcgs": "False", "to_do": "forward"}


#: class -> (its options, the fused entry point a layer takes)
CELLS = {
    "LSTM": (cell_opts("lstm"), (tfl, "lstm_scan_fused")),
    "GRU": (cell_opts("gru"), (tfr, "gru_scan_fused")),
    "liGRU": (cell_opts("ligru"), (tfr, "ligru_scan_fused")),
    "minimalGRU": (cell_opts("minimalgru"), (tfr, "mgru_scan_fused")),
    "RNN": (cell_opts("rnn"), (tfr, "rnn_scan_fused")),
    "LSTM_cudnn": ({"hidden_size": str(H), "num_layers": "2",
                    "bidirectional": "True"}, (tfl, "lstm_scan_fused")),
    "GRU_cudnn": ({"hidden_size": str(H), "num_layers": "2",
                   "bidirectional": "True"}, (tfr, "gru_cudnn_scan_fused")),
    "RNN_cudnn": ({"hidden_size": str(H), "num_layers": "2",
                   "bidirectional": "True", "nonlinearity": "relu"},
                  (tfr, "rnn_scan_fused")),
}


def _run(cls_name, monkeypatch, smem):
    """Eval output, then train-mode output and gradients of a fresh
    model under _SMEM_MAX = smem; -> (outputs, fused calls in eval, in
    train)."""
    opts, (mod, entry) = CELLS[cls_name]
    calls = []
    real = getattr(mod, entry)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(mod, entry, spy)
    monkeypatch.setattr(tfl, "_SMEM_MAX", smem)
    model = getattr(models, cls_name)(opts, F_IN, seed=4, device="cpu")
    x = _seq(T, B, F_IN, seed=5)
    with torch.no_grad():
        y_eval = model.run(x, train=False)
    n_eval = len(calls)
    y = model.run(x, train=True, generator=torch.Generator().manual_seed(0))
    y.square().sum().backward()
    out = [y_eval, y.detach()] + [p.grad for _, p in
                                  sorted(model.params.items())]
    return out, n_eval, len(calls) - n_eval


@pytest.mark.parametrize("cls_name", sorted(CELLS))
def test_wide_layer_takes_plain_loop(monkeypatch, cls_name):
    """The same model with the card's shared memory (every layer on the
    fused kernels' twins), with _SMEM_MAX cut so that the forward kernel
    takes H but the backward kernel autograd runs does not (eval fused,
    train plain; the LSTM, liGRU, GRU and torch-GRU, whose backwards
    stage more), and cut below the forward's need (both plain): the same
    outputs and gradients."""
    module = models.recurrent
    cell = getattr(module, cls_name).cell
    layers = 4 if cls_name.endswith("_cudnn") else 2    # both directions
    ref, n_eval, n_train = _run(cls_name, monkeypatch, tfl._SMEM_MAX)
    assert (n_eval, n_train) == (layers, layers)
    per, static = tfl._DENSE_SMEM[cell]["fwd"]
    cuts = [(per * H + static - 1, 0)]
    backward = tfl.grad_backward(cell, True)
    if tfl._DENSE_SMEM[cell][backward] != (per, static):
        cuts.append((per * H + static, layers))
    for smem, want_eval in cuts:
        got, n_eval, n_train = _run(cls_name, monkeypatch, smem)
        assert (n_eval, n_train) == (want_eval, 0), smem
        for a, b in zip(got, ref):
            scale = max(float(b.abs().max()), 1e-30)
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=ATOL * scale)


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU "
                    "mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wide_lstm_trains_on_plain_loop(cuda_device):
    """A 2048-wide LSTM layer (beyond both LSTM backwards' limits, within
    the forward's): eval on the forward kernel, a train-mode forward and
    backward on the plain loop with no LSTM kernel launched, outputs and
    gradients as on the CPU; the BPTT wrapper raises at that width."""
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = dict(cell_opts("lstm"), lstm_lay="2048")
    opts.update(lstm_drop="0.0", lstm_use_batchnorm="False",
                lstm_use_laynorm="False", lstm_act="tanh")
    x = _seq(T, B, F_IN, seed=6)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = models.LSTM(opts, F_IN, seed=1, device=dev)
        before = tfl.fused_lstm_fwd.launches
        with torch.no_grad():
            y_eval = model.run(x.to(dev), train=False)
        n_eval = tfl.fused_lstm_fwd.launches - before
        before = [w.launches for w in (tfl.fused_lstm_fwd,
                                       tfl.fused_lstm_bwd_stash,
                                       tfl.fused_lstm_bwd)]
        y = model.run(x.to(dev), train=True)
        y.square().sum().backward()
        n_train = [w.launches - b for w, b in zip(
            (tfl.fused_lstm_fwd, tfl.fused_lstm_bwd_stash,
             tfl.fused_lstm_bwd), before)]
        if dev.type == "cuda":
            assert n_eval == T and n_train == [0, 0, 0]
        out[dev.type] = [y_eval.cpu(), y.detach().cpu()] + [
            p.grad.cpu() for _, p in sorted(model.params.items())]
    for a, b in zip(out["cuda"], out["cpu"]):
        scale = max(float(b.abs().max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4 * scale)
    g = torch.zeros(2, 1, 4 * 2048, device=cuda_device)
    U = torch.zeros(4 * 2048, 2048, device=cuda_device)
    z = torch.zeros(2, 1, 2048, device=cuda_device)
    with pytest.raises(ValueError, match="H <= 1806, got 2048"):
        tfl.fused_lstm_bwd_stash(g, U, z[0], z, z, z)
