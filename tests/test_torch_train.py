"""The port's training slice (pytorch_kaldi_cgs_tpu_torch: runtime/optim,
config/dsl + experiment, runtime/graph, runtime/chunk) against the JAX
package on the same inputs.

The slice as a whole: a synthetic LSTM+HCGS+8-bit chunk config from the
JAX package's make_synth_cfg + create_lists + create_configs, its chunk
read by the JAX package's read_chunk_data, the same make_seq_batches
batches (same RandomState), 3 ChunkRunner.train_steps from the same init
seeds in both packages. Bars: per-step loss and err to 1e-5; raw
(unquantized) parameters and BN running statistics to 1e-4 after the 3
steps. Both hold with the 8-bit ceil weight quantizer on, at the small
learning rate 0.002: the parameters agree to ~5e-7, so none sits on
another side of a ceil step. bf16 meets the same bars against the JAX
package's fused Pallas recurrence (interpret mode, lstm_fused_scan);
against its lax.scan recurrence it does not (the scan rounds dh to bf16
through the dot's transpose, the fused VJPs of both packages keep it in
float32), so that pairing is not compared. Dropout is 0, as in the
flagship: masks from two RNGs cannot match (the kernel tests feed
explicit masks).
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch.config import dsl as tdsl
from pytorch_kaldi_cgs_tpu_torch.config import experiment as texp
from pytorch_kaldi_cgs_tpu_torch.data import dataset as tdata
from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
from pytorch_kaldi_cgs_tpu_torch.runtime import optim as toptim

SEED = 3
STEPS = 3
LOSS_TOL = 1e-5      # per-step loss and err
VAR_TOL = 1e-4       # raw parameters and BN running statistics


@pytest.fixture(scope="module")
def jax_pkg():
    pytest.importorskip("jax")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pytorch_kaldi_cgs_tpu import config as C
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu.runtime import optim as JO
    return {"C": C, "JC": JC, "JG": JG, "JO": JO}


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory, jax_pkg):
    from pytorch_kaldi_cgs_tpu.data import synth
    tmp = tmp_path_factory.mktemp("torch_train")
    root = str(tmp / "data")
    synth.generate(root, synth.SynthSpec(
        num_utts=12, num_phones=4, states_per_phone=2, feat_dim=6,
        min_len=20, max_len=40, noise=0.4, seed=7))
    return tmp, root


def _train_chunk_cfg(jax_pkg, synth_data, name, **kw):
    """make_synth_cfg -> check_cfg -> create_lists -> create_configs;
    returns the first train chunk config (parsed) and its path."""
    from pytorch_kaldi_cgs_tpu.utils import make_synth_cfg
    C = jax_pkg["C"]
    tmp, root = synth_data
    out = str(tmp / name)
    args = dict(model="LSTM", hidden=16, n_epochs=1, n_chunks=1,
                batch_size=4, lr=0.002, opt="rmsprop", cw=0, hcgs=True,
                hcgs_block="8,2", hcgs_sparse="25,50", quant=True,
                param_quant="8,8")
    args.update(kw)
    cfg = make_synth_cfg(str(tmp / (name + ".cfg")), root, out, **args)
    config = configparser.ConfigParser()
    config.read(cfg)
    config, _, _ = C.check_cfg(cfg, config, "proto/global.proto")
    C.create_lists(config)
    C.create_configs(config)
    chunks = open(os.path.join(out, "exp_files",
                               "list_chunks.txt")).read().split()
    path = [c for c in chunks if os.path.basename(c).startswith("train")][0]
    cc = configparser.ConfigParser()
    cc.read(path)
    return cc, path


def _port_chunk(jchunk):
    """The port's ChunkData from the JAX package's loaded arrays."""
    fea = {n: tdata.FeaStream(s.name, s.fea_lst, s.fea_opts, s.cw_left,
                              s.cw_right, s.col_start, s.col_end)
           for n, s in jchunk.fea_streams.items()}
    lab = {n: tdata.LabStream(s.name, s.lab_folder, s.lab_opts,
                              s.lab_count_file, s.lab_data_folder,
                              s.lab_graph, s.col)
           for n, s in jchunk.lab_streams.items()}
    return tdata.ChunkData(list(jchunk.names), np.array(jchunk.data),
                           np.array(jchunk.end_index), fea, lab)


def _set_arch(cc, **fields):
    for sec in cc.sections():
        if "architecture" in sec:
            for k, v in fields.items():
                cc[sec][k] = v


def _max_tree_diff(ref, got):
    """Max |ref - got| over the leaves of two nested dicts of arrays."""
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(got)
        return max([_max_tree_diff(ref[k], got[k]) for k in ref] or [0.0])
    return float(np.abs(np.asarray(ref) - np.asarray(got)).max())


# ---------------------------------------------------------------------------
# (a) optimizers
# ---------------------------------------------------------------------------

_OPT_BASE = {"opt_momentum": "0", "opt_weight_decay": "0",
             "opt_dampening": "0", "opt_nesterov": "False",
             "opt_alpha": "0.95", "opt_eps": "1e-8", "opt_centered": "False",
             "opt_betas": "0.9,0.999"}
OPTIMIZERS = {
    "sgd_momentum": {"arch_opt": "sgd", "opt_momentum": "0.9"},
    "sgd_nesterov_wd": {"arch_opt": "sgd", "opt_momentum": "0.8",
                        "opt_nesterov": "True", "opt_weight_decay": "0.01"},
    "rmsprop": {"arch_opt": "rmsprop"},
    "rmsprop_centered_momentum": {"arch_opt": "rmsprop", "opt_alpha": "0.9",
                                  "opt_centered": "True",
                                  "opt_momentum": "0.5"},
    "adam_wd": {"arch_opt": "adam", "opt_weight_decay": "0.01",
                "opt_betas": "0.85,0.99"},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(jax_pkg, name):
    """Five updates on the same numpy grads, the learning rate changed
    after the third, equal the JAX package's optax transforms to 1e-6."""
    import jax.numpy as jnp
    import optax
    opts = dict(_OPT_BASE, arch_lr="0.05", **OPTIMIZERS[name])
    rng = np.random.RandomState(0)
    w0 = rng.randn(3, 4).astype(np.float32)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(5)]

    JO = jax_pkg["JO"]
    tx = JO.make_optimizer(opts)
    jp = {"w": jnp.asarray(w0)}
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = toptim.make_optimizer(opts, [p])
    for k, g in enumerate(grads):
        if k == 3:
            state = JO.set_learning_rate(state, 0.02)
            toptim.set_learning_rate(opt, 0.02)
        upd, state = tx.update({"w": jnp.asarray(g)}, state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp["w"]),
                                   atol=1e-6, err_msg="step %d" % k)


def test_set_learning_rate_keeps_state():
    p = torch.nn.Parameter(torch.ones(2))
    opt = toptim.make_optimizer(dict(_OPT_BASE, arch_opt="rmsprop",
                                     arch_lr="0.1"), [p])
    p.grad = torch.ones(2)
    opt.step()
    sq = opt.state[p]["square_avg"].clone()
    assert toptim.set_learning_rate(opt, 0.5) is opt
    assert opt.param_groups[0]["lr"] == 0.5
    assert torch.equal(opt.state[p]["square_avg"], sq)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer({"arch_opt": "lbfgs", "arch_lr": "1"}, [p])


# ---------------------------------------------------------------------------
# (b) config parsing
# ---------------------------------------------------------------------------

def test_chunk_config_parses_as_in_jax(jax_pkg, synth_data):
    from pytorch_kaldi_cgs_tpu.config import dsl as jdsl
    from pytorch_kaldi_cgs_tpu.config import experiment as jexp
    cc, _ = _train_chunk_cfg(jax_pkg, synth_data, "parse")
    jf, jl, ja = jexp.dict_fea_lab_arch(cc)
    tf, tl, ta = texp.dict_fea_lab_arch(cc)
    assert ta == ja
    assert [vars(s) for s in tf] == [vars(s) for s in jf]
    assert [vars(s) for s in tl] == [vars(s) for s in jl]
    assert texp.is_sequential(cc, ta) == jexp.is_sequential(cc, ja) is True
    args = (cc["model"]["model"], cc["model"]["model_proto"],
            [s.name for s in jf], [s.name for s in jl], list(ja))
    jg, tg = jdsl.parse_model_lines(*args), tdsl.parse_model_lines(*args)
    assert [(o.out, o.op, o.inputs) for o in tg.ops] == \
        [(o.out, o.op, o.inputs) for o in jg.ops]
    with pytest.raises(ValueError, match="not declared"):
        tdsl.parse_model_lines("loss_final=cost_xx(a,b)", args[1], *args[2:])


# ---------------------------------------------------------------------------
# (c) the slice as a whole
# ---------------------------------------------------------------------------

def _run_both(jax_pkg, cc, path, steps=STEPS):
    """Same init seeds, same batches, `steps` train steps in each
    package. -> (losses/errs JAX, port, JAX variables, port graph)."""
    import jax
    import jax.numpy as jnp
    JC, JG = jax_pkg["JC"], jax_pkg["JG"]
    jchunk = JC.read_chunk_data(path)
    pchunk = _port_chunk(jchunk)
    jg = JG.NetGraph(cc, jchunk)
    jr = JC.ChunkRunner(jg, cc)
    jv = jg.init_variables(SEED)
    jo = jr.init_opt_states(jv)
    jstep = jr.train_step()
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    bs = int(cc["batches"]["batch_size_train"])
    jb = list(JC.make_seq_batches(jchunk, bs, True, np.random.RandomState(SEED)))
    tb = list(tchunk.make_seq_batches(pchunk, bs, True,
                                      np.random.RandomState(SEED)))
    assert len(tb) == len(jb) >= steps
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
    jres, tres = [], []
    for k, (inp, mask, _, _) in enumerate(tb[:steps]):
        jv, jo, jl, je = jstep(jv, jo, jnp.asarray(inp), jnp.asarray(mask),
                               jax.random.PRNGKey(k))
        jres.append((float(jl), float(je)))
        tl, te = tr.train_step(inp, mask)
        tres.append((float(tl), float(te)))
    return jres, tres, jax.device_get(jv), tg


SLICE_CASES = {
    # (compute dtype, JAX recurrence, stash backward, recurrent quantizer)
    "f32-jaxscan-stash": ("", "scan", True, False),
    "f32-jaxfused-recompute-q16": ("", "fused", False, True),
    "bf16-jaxfused-stash": ("bf16", "fused", True, False),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_train_steps_match_jax(jax_pkg, synth_data, monkeypatch, case):
    cdt, rec, stash, quant_inp = SLICE_CASES[case]
    monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "0" if stash else "1")
    monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)
    cc, path = _train_chunk_cfg(jax_pkg, synth_data, "slice_" + case,
                                quant_inp=quant_inp)
    if cdt:
        _set_arch(cc, compute_dtype=cdt)
    if rec == "fused":
        _set_arch(cc, lstm_fused_scan="True")
    jres, tres, jv, tg = _run_both(jax_pkg, cc, path)
    np.testing.assert_allclose(tres, jres, atol=LOSS_TOL)
    assert tres[-1][0] < tres[0][0]            # it learns
    tv = tg.jax_variables()
    for arch in jv:
        for coll in ("params", "state"):
            assert _max_tree_diff(jv[arch][coll], tv[arch][coll]) <= VAR_TOL, \
                (arch, coll)
        assert _max_tree_diff(jv[arch]["masks"], tv[arch]["masks"]) == 0.0


def test_eval_step_matches_jax(jax_pkg, synth_data):
    import jax.numpy as jnp
    JC, JG = jax_pkg["JC"], jax_pkg["JG"]
    cc, path = _train_chunk_cfg(jax_pkg, synth_data, "eval")
    jchunk = JC.read_chunk_data(path)
    jg = JG.NetGraph(cc, jchunk)
    jv = jg.init_variables(SEED)
    tg = tgraph.NetGraph(cc, _port_chunk(jchunk), seed=SEED, device="cpu")
    inp, mask, _, _ = next(JC.make_seq_batches(
        jchunk, 4, False, np.random.RandomState(0)))
    jl, je = JC.ChunkRunner(jg, cc).eval_step()(jv, jnp.asarray(inp),
                                                jnp.asarray(mask))
    tl, te = tchunk.ChunkRunner(tg, cc).eval_step(inp, mask)
    np.testing.assert_allclose([float(tl), float(te)],
                               [float(jl), float(je)], atol=LOSS_TOL)


# ---------------------------------------------------------------------------
# (d) frozen nets, (e) regularizers
# ---------------------------------------------------------------------------

def test_frozen_net_is_not_updated_and_runs_in_eval(jax_pkg, synth_data):
    JC = jax_pkg["JC"]
    cc, path = _train_chunk_cfg(jax_pkg, synth_data, "frozen")
    cc["architecture1"]["arch_freeze"] = "True"
    pchunk = _port_chunk(JC.read_chunk_data(path))
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    assert tg.trainable_filter() == {"LSTM_layers": False, "MLP_out": True}
    before = {a: {c: {k: v.clone() for k, v in t.items()}
                  for c, t in tg.nets[a].variables().items()}
              for a in tg.net_order}
    inp, mask, _, _ = next(tchunk.make_seq_batches(
        pchunk, 4, True, np.random.RandomState(0)))
    lstm = tg.nets["LSTM_layers"]
    x = torch.from_numpy(inp[..., tg.fea_cols["feats"][0]:
                             tg.fea_cols["feats"][1]])
    with torch.no_grad():
        h_eval = lstm.run(x, train=False)
    tr.train_step(inp, mask)
    after = {a: tg.nets[a].variables() for a in tg.net_order}
    for c in ("params", "state"):        # no update, no BN statistics
        for k, v in before["LSTM_layers"][c].items():
            assert torch.equal(after["LSTM_layers"][c][k], v), (c, k)
    assert any(not torch.equal(after["MLP_out"]["params"][k], v)
               for k, v in before["MLP_out"]["params"].items())
    outs = tg.forward(torch.from_numpy(inp), train=True)
    np.testing.assert_array_equal(outs["out_rnn"].detach().numpy(),
                                  h_eval.numpy())


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "noskip"])
def test_cost_l2_skip_regularization(jax_pkg, synth_data, skip):
    """cost_l2 sums sqrt(sum w^2) over the >=2-D params of every net
    without skip_regularization; equal to the JAX graph's."""
    import jax.numpy as jnp
    JC, JG = jax_pkg["JC"], jax_pkg["JG"]
    cc, path = _train_chunk_cfg(jax_pkg, synth_data, "l2")
    cc["model"]["model"] = cc["model"]["model"].replace(
        "loss_final=cost_nll(out_dnn1,lab_cd)",
        "loss_nll=cost_nll(out_dnn1,lab_cd)\n"
        "loss_reg=cost_l2(out_dnn1,0.01)\n"
        "loss_final=sum(loss_nll,loss_reg)")
    cc["architecture1"]["skip_regularization"] = str(skip)
    jchunk = JC.read_chunk_data(path)
    jg = JG.NetGraph(cc, jchunk)
    jv = jg.init_variables(SEED)
    tg = tgraph.NetGraph(cc, _port_chunk(jchunk), seed=SEED, device="cpu")
    assert tg.nets["LSTM_layers"].spec.skip_regularization is skip
    inp, mask, _, _ = next(JC.make_seq_batches(
        jchunk, 4, False, np.random.RandomState(0)))
    jouts, _ = jg.forward(jv, jnp.asarray(inp), train=False,
                          frame_mask=jnp.asarray(mask))
    with torch.no_grad():
        touts = tg.forward(torch.from_numpy(inp), train=False,
                           frame_mask=torch.from_numpy(mask))
    reg = float(touts["loss_reg"])
    np.testing.assert_allclose(reg, float(jouts["loss_reg"]), rtol=1e-6)
    nets = ["MLP_out"] + ([] if skip else ["LSTM_layers"])
    expect = 0.01 * sum(float(torch.sqrt((w.detach() ** 2).sum()))
                        for a in nets
                        for w in tg.nets[a].params.values() if w.ndim >= 2)
    np.testing.assert_allclose(reg, expect, rtol=1e-6)
    np.testing.assert_allclose(float(touts["loss_final"]),
                               float(jouts["loss_final"]), atol=LOSS_TOL)


def test_post_chunk_refresh_raises_where_needed(jax_pkg, synth_data):
    JC = jax_pkg["JC"]
    cc, path = _train_chunk_cfg(jax_pkg, synth_data, "refresh")
    pchunk = _port_chunk(JC.read_chunk_data(path))
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tg.post_chunk_refresh(if_prune=True)      # nothing to refresh: no-op
    tg.nets["LSTM_layers"].spec.if_pattern = True
    with pytest.raises(NotImplementedError, match="not ported"):
        tg.post_chunk_refresh(if_prune=False)


def test_init_variables_reseeds_each_net(jax_pkg, synth_data):
    JC, JG = jax_pkg["JC"], jax_pkg["JG"]
    cc, path = _train_chunk_cfg(jax_pkg, synth_data, "init")
    jchunk = JC.read_chunk_data(path)
    tg = tgraph.NetGraph(cc, _port_chunk(jchunk), seed=0, device="cpu")
    tg.init_variables(SEED + 1)
    jv = JG.NetGraph(cc, jchunk).init_variables(SEED + 1)
    assert _max_tree_diff(jv, tg.jax_variables()) == 0.0


# ---------------------------------------------------------------------------
# without JAX: an in-memory chunk config (these also run on the card)
# ---------------------------------------------------------------------------

_MEM_CFG = """[exp]
to_do = train
seed = 0

[data_chunk]
fea = fea_name=fea
\tfea_lst=none
\tfea_opts=none
\tcw_left=0
\tcw_right=0
lab = lab_name=lab
\tlab_folder=none
\tlab_opts=ali-to-pdf

[architecture1]
arch_name = LSTM_layers
arch_library = pytorch_kaldi_cgs_tpu_torch.models
arch_class = LSTM
arch_freeze = False
arch_seq_model = True
lstm_lay = 16,16
lstm_drop = {drop},{drop}
lstm_use_batchnorm = True,True
lstm_use_laynorm = False,False
lstm_use_laynorm_inp = False
lstm_use_batchnorm_inp = False
lstm_act = tanh,tanh
lstm_orthinit = True
lstm_bidir = False
lstm_hcgs = True
hcgsx_block = 8,2
hcgsx_sparse = 25,50
hcgsh_block = 8,2
hcgsh_sparse = 25,50
lstm_quant = True
param_quant = 8,8
lstm_quant_inp = True
inp_quant = 16
{opt}

[architecture2]
arch_name = MLP_out
arch_library = pytorch_kaldi_cgs_tpu_torch.models
arch_class = MLP
arch_freeze = False
arch_seq_model = False
dnn_lay = 8
dnn_drop = 0.0
dnn_use_batchnorm = False
dnn_use_laynorm = False
dnn_use_laynorm_inp = False
dnn_use_batchnorm_inp = False
dnn_act = softmax
{opt}

[model]
model_proto = proto/model.proto
model = out_rnn=compute(LSTM_layers,fea)
\tout_dnn1=compute(MLP_out,out_rnn)
\tloss_final=cost_nll(out_dnn1,lab)
\terr_final=cost_err(out_dnn1,lab)
"""
_MEM_OPT = ("arch_lr = 0.002\narch_opt = rmsprop\nopt_alpha = 0.95\n"
            "opt_eps = 1e-8\nopt_momentum = 0.0\nopt_centered = False\n"
            "opt_weight_decay = 0.0")


def _mem_runner(dev, drop=0.0, T=12, B=4, F=6):
    """A 2x16 HCGS + 8-bit (+16-bit recurrent input) LSTM -> 8-way head
    on one in-memory chunk of B sentences of T frames."""
    cc = configparser.ConfigParser()
    cc.read_string(_MEM_CFG.format(drop=drop, opt=_MEM_OPT))
    rng = np.random.RandomState(5)
    x = rng.randn(T, B, F).astype(np.float32)
    lab = rng.randint(0, 8, (T, B)).astype(np.float32)
    data = np.concatenate([np.concatenate([x[:, b], lab[:, b, None]], 1)
                           for b in range(B)])
    chunk = tdata.ChunkData(
        ["u%d" % b for b in range(B)], data, np.cumsum([T] * B),
        {"fea": tdata.FeaStream("fea", "none", col_start=0, col_end=F)},
        {"lab": tdata.LabStream("lab", "none", col=F)})
    g = tgraph.NetGraph(cc, chunk, seed=SEED, device=dev)
    inp, mask, _, _ = next(tchunk.make_seq_batches(
        chunk, B, True, np.random.RandomState(0), bucket=T))
    return tchunk.ChunkRunner(g, cc), inp, mask


def test_dropout_masks_follow_the_generator():
    """Recurrent dropout masks come from the torch.Generator passed to
    the step: the same seed gives the same step, another seed another."""
    losses = []
    for seed in (1, 1, 2):
        runner, inp, mask = _mem_runner("cpu", drop=0.3)
        gen = torch.Generator().manual_seed(seed)
        losses.append([float(runner.train_step(inp, mask, gen)[0])
                       for _ in range(2)])
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU "
                    "mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stash", [True, False], ids=["stash", "recompute"])
def test_cuda_train_step_matches_cpu(cuda_device, monkeypatch, stash):
    """One ChunkRunner.train_step on the card (the kernels) against the
    same step on the CPU (the twins): loss, every gradient, and the
    kernel launches per step (2 layers, each way a call on the route its
    plan names: the persistent forward and stash BPTT once a call, the
    recompute BPTT T times)."""
    from pytorch_kaldi_cgs_tpu_torch.ops import fused_lstm as F
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("PKC_LSTM_BWD_RECOMPUTE", "0" if stash else "1")
    T, B, H = 12, 4, 16
    bwd = F.fused_lstm_bwd_stash if stash else F.fused_lstm_bwd
    runner, inp, mask = _mem_runner(cuda_device, T=T, B=B)
    cpu, _, _ = _mem_runner("cpu", T=T, B=B)
    F.fused_lstm_fwd.launches = bwd.launches = 0
    loss, err = runner.train_step(inp, mask)
    torch.cuda.synchronize()
    fwd_route = F.lstm_fwd_route(B, H, False, cuda_device)[0]
    bwd_route = F.lstm_bwd_stash_route(B, H, False, cuda_device)[0]
    assert (fwd_route, bwd_route) == ("persist", "persist")
    want = 2 * (F.lstm_bwd_stash_launches(bwd_route, T, False) if stash
                else T)
    assert (F.fused_lstm_fwd.launches, bwd.launches) == (
        2 * F.lstm_fwd_launches(fwd_route, T), want)
    loss_c, err_c = cpu.train_step(inp, mask)
    # f32 on both sides; cuBLAS and the CPU sum in other orders
    np.testing.assert_allclose(float(loss), float(loss_c), atol=1e-5)
    assert float(err) == float(err_c)
    for arch, net in cpu.graph.nets.items():
        for k, p in net.params.items():
            got = runner.graph.nets[arch].params[k].grad.cpu().numpy()
            np.testing.assert_allclose(got, p.grad.numpy(), atol=1e-5,
                                       err_msg="%s/%s" % (arch, k))
