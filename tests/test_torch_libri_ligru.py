"""The LibriSpeech Li-GRU cfg (cfg/LibriSpeech_baselines/libri_liGRU_fmllr.cfg)
in the port (pytorch_kaldi_cgs_tpu_torch: models/recurrent.py liGRU over
the dense fused liGRU of ops/fused_rnn.py, TPU rows 16-18) against the
JAX package on the same numpy inputs, its Pallas kernels run in
interpret mode.

The cfg's [architecture1..2] and [model] are read from the file and
narrowed in width only: 5 bidirectional relu liGRU layers of 32 (the
cfg's 1024), BN, dropout 0.2, orthogonal init, no HCGS and no
quantizers; the head 64 -> 40 (the cfg's N_out_lab_cd).

- ``liGRU.init(seed)`` array for array, the orthogonal recurrent
  weights included;
- eval in f32 and bf16 against JAX ``apply`` (``ligru_fused_scan=True``:
  its Pallas liGRU), every layer on the fused kernels (their twins here);
- train mode with dropout 0: output, BN statistics and every gradient
  against ``jax.grad``, under the recompute backward (the default) and
  the stash one (``PKC_BWD_STASH_CELLS=ligru``);
- the stream raises in both packages (the cfg is bidirectional);
- 3 ``ChunkRunner.train_step``s against the JAX runner.

Tolerances: float32 atol 1e-5 (no quantizers: the sums run in another
order than XLA's, over 5 layers of BN and 11 steps); gradients 1e-4 of
each one's largest magnitude (products of two such sums). bf16 compute:
the fused liGRU stays float32 in both packages and only the
x-projections round to bf16, at the same places, so the float32 bar
holds. The train steps: per-step loss and err within 1e-5, parameters
and BN statistics within 1e-4; RMSprop runs at the cfg's eps 1e-8 (in
float32 no cancelled gradient is amplified here, unlike
tests/test_torch_ligru.py's narrow net); under bf16 see
test_train_steps_match_jax.

JAX comes in through fixtures, so that the ``cuda`` cases also run where
JAX is not installed (``python -m pytest --noconftest -m cuda
tests/test_torch_libri_ligru.py``): there the recompute BPTT's persistent
route (TPU row 18) is held against its twin at the cfg's training shape
(T=200, 32 rows, H=1024: its chain stages dg_{t+1} in slabs), at both
blocks of 256 outputs the plan weighs, and at a ragged width, each within
1e-4 of the twin's scale and bit for bit over two calls; the forward's
persistent route (TPU row 16) at the cfg's shape, at both blocks of 256
outputs, bit for bit its step route and within 1e-4 of the twin's
scale.
"""
import configparser
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_cgs_tpu_torch import convert
from pytorch_kaldi_cgs_tpu_torch.models import liGRU
from pytorch_kaldi_cgs_tpu_torch.ops import fused_rnn as tfr

LIBRI_LIGRU_CFG = os.path.join(os.path.dirname(__file__), os.pardir, "cfg",
                               "LibriSpeech_baselines",
                               "libri_liGRU_fmllr.cfg")
F_IN = 40               # fMLLR, --delta-order=0, cw 0
WIDTH, LAYERS = 32, 5
ATOL = 1e-5
GRAD_REL = 1e-4
tt = torch.from_numpy


@pytest.fixture
def jm():
    pytest.importorskip("jax")
    import pytorch_kaldi_cgs_tpu.models as JM
    return JM


def _cfg():
    src = configparser.ConfigParser()
    if not src.read(LIBRI_LIGRU_CFG):
        raise FileNotFoundError(LIBRI_LIGRU_CFG)
    return src


def libri_opts(cdt="", drop=None):
    """The cfg's [architecture1], narrowed to 5 x WIDTH; ``drop``
    overrides the dropout of every layer; ``ligru_fused_scan`` (read by
    the JAX package only) puts JAX on its Pallas liGRU."""
    opts = dict(_cfg()["architecture1"])
    assert opts["ligru_lay"] == ",".join(["1024"] * LAYERS)
    assert opts["ligru_bidir"] == "True" and opts["ligru_orthinit"] == "True"
    opts.update(ligru_lay=",".join([str(WIDTH)] * LAYERS), to_do="forward",
                compute_dtype=cdt, ligru_fused_scan="True")
    if drop is not None:
        opts["ligru_drop"] = ",".join([drop] * LAYERS)
    return opts


def _perturbed(tree, seed):
    """Non-trivial BN statistics and parameters."""
    rng = np.random.RandomState(seed)
    out = {"params": dict(tree["params"]), "state": dict(tree["state"]),
           "masks": tree["masks"]}
    for k, v in tree["state"].items():
        n = v["mean"].shape
        out["state"][k] = {
            "mean": (rng.randn(*n) * 0.3).astype(np.float32),
            "var": (rng.rand(*n) + 0.5).astype(np.float32)}
    for k, v in tree["params"].items():
        if isinstance(v, dict):
            out["params"][k] = {kk: (vv + rng.randn(*vv.shape) * 0.2)
                                .astype(np.float32) for kk, vv in v.items()}
    return out


def _port(opts, tree):
    return liGRU(opts, F_IN, device="cpu").load_variables(
        convert.from_jax_variables(tree))


@pytest.fixture
def route(monkeypatch):
    """Counts the port's calls into the three fused liGRU wrappers (rows
    16-18); a layer on the plain step loop calls none of them."""
    calls = dict.fromkeys(("fused_ligru_fwd", "fused_ligru_bwd",
                           "fused_ligru_bwd_stash"), 0)
    for name in calls:
        real = getattr(tfr, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tfr, name, spy)
    return calls


def _set_stash(monkeypatch, stash):
    monkeypatch.delenv("PKC_LSTM_BWD_RECOMPUTE", raising=False)
    if stash:
        monkeypatch.setenv("PKC_BWD_STASH_CELLS", "ligru")
    else:
        monkeypatch.delenv("PKC_BWD_STASH_CELLS", raising=False)


def test_init_equals_jax_init(jm):
    """init(seed) gives the JAX package's arrays; the recurrent weights
    are orthogonal (``ligru_orthinit``); no layout, every layer dense."""
    opts = libri_opts()
    for seed in (0, 7):
        port = liGRU(opts, F_IN, seed=seed, device="cpu")
        jtree = jm.liGRU(opts, F_IN).init(seed)
        fa = convert.flatten(convert.to_jax_variables(port.variables()))
        fb = convert.flatten(jtree)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]),
                                          np.asarray(fb[k]), err_msg=k)
        assert port._rec_layouts == {} and port._bs_layouts == {}
        assert port.out_dim == 2 * WIDTH
        for i in range(LAYERS):
            u = port.params["uh%d" % i].detach().numpy()
            np.testing.assert_allclose(u @ u.T, np.eye(WIDTH), atol=1e-5)


@pytest.mark.parametrize("cdt", ["", "bf16"], ids=["f32", "bf16"])
def test_eval_matches_jax_fused(jm, route, cdt):
    """The 5-layer bidirectional stack against JAX apply on its Pallas
    liGRU: every layer's recurrence on the fused forward (twice the rows:
    both directions in one call), none on the step loop."""
    opts = libri_opts(cdt)
    jmod = jm.liGRU(opts, F_IN)
    tree = _perturbed(jmod.init(0), 1)
    x = np.random.RandomState(2).randn(11, 3, F_IN).astype(np.float32)
    y_ref, _ = jmod.apply(tree, x, train=False)
    with torch.no_grad():
        y = _port(opts, tree).eval()(tt(x))
    assert y.shape == (11, 3, 2 * WIDTH)
    assert route == {"fused_ligru_fwd": LAYERS, "fused_ligru_bwd": 0,
                     "fused_ligru_bwd_stash": 0}
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)


@pytest.mark.parametrize("stash", [False, True], ids=["recompute", "stash"])
def test_train_mode_and_grads_match_jax(jm, monkeypatch, route, stash):
    """Train mode, dropout 0: the output, the updated BN statistics and
    the gradient of every parameter against jax.grad (the JAX fused
    VJP); the port's backward on rows 18 (recompute, the default) or 17
    (``PKC_BWD_STASH_CELLS=ligru``), once per layer."""
    import jax
    import jax.numpy as jnp
    _set_stash(monkeypatch, stash)
    opts = libri_opts(drop="0.0")
    jmod = jm.liGRU(opts, F_IN)
    tree = _perturbed(jmod.init(3), 4)
    x = np.random.RandomState(5).randn(10, 2, F_IN).astype(np.float32)
    wy = np.random.RandomState(6).randn(10, 2, 2 * WIDTH).astype(np.float32)

    def loss(params):
        y, st = jmod.apply({**tree, "params": params}, jnp.asarray(x),
                           train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(y * wy), (y, st)
    (_, (y_ref, state_ref)), grads = jax.value_and_grad(
        loss, has_aux=True)(tree["params"])
    port = _port(opts, tree).train()
    y = port(tt(x))
    (y * tt(wy)).sum().backward()
    bwd = "fused_ligru_bwd_stash" if stash else "fused_ligru_bwd"
    assert route == {"fused_ligru_fwd": LAYERS, "fused_ligru_bwd": 0,
                     "fused_ligru_bwd_stash": 0, bwd: LAYERS}
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=ATOL)
    got = convert.flatten(convert.to_jax_variables(port.variables())["state"])
    for k, v in convert.flatten(state_ref).items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=ATOL,
                                   err_msg=k)
    ref_g = convert.flatten(jax.device_get(grads))
    got_g = {k: p.grad.numpy() for k, p in port.params.items()}
    assert sorted(ref_g) == sorted(got_g)
    for k, v in ref_g.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(got_g[k], np.asarray(v),
                                   atol=GRAD_REL * scale, err_msg=k)


def test_stream_raises_in_both_packages(jm):
    """The cfg is bidirectional: a stream needs the future, and both
    packages refuse it with the same error."""
    opts = libri_opts()
    jmod = jm.liGRU(opts, F_IN)
    tree = jmod.init(0)
    x = np.zeros((4, 2, F_IN), np.float32)
    with pytest.raises(ValueError, match="bidirectional models cannot "
                                         "stream") as jerr:
        jmod.apply_streaming(tree, x)
    with pytest.raises(ValueError, match="bidirectional models cannot "
                                         "stream") as terr:
        _port(opts, tree).eval().apply_streaming(tt(x))
    assert str(jerr.value) == str(terr.value)


# ---------------------------------------------------------------------------
# 3 train steps of the narrowed cfg against the JAX runner
# ---------------------------------------------------------------------------

N_CD, ST_T, ST_B, SEED, STEPS = 40, 12, 4, 3, 3


def chunk_config(cdt=""):
    """The cfg's [architecture1..2] and [model] read from the file,
    narrowed to 5 x WIDTH and a head of N_CD, dropout 0, over an
    in-memory chunk of fMLLR-width features and cd labels."""
    src = _cfg()
    cc = configparser.ConfigParser()
    cc.read_string("[exp]\nto_do = train\nseed = 0\n\n[batches]\n"
                   "batch_size_train = %d\n\n[data_chunk]\n"
                   "fea = fea_name=fmllr\n\tfea_lst=none\n\tfea_opts=none\n"
                   "\tcw_left=0\n\tcw_right=0\n"
                   "lab = lab_name=lab_cd\n\tlab_folder=none\n"
                   "\tlab_opts=ali-to-pdf\n" % ST_B)
    cc["architecture1"] = dict(src["architecture1"])
    cc["architecture2"] = dict(src["architecture2"], dnn_lay=str(N_CD))
    cc["architecture1"].update({
        "ligru_lay": ",".join([str(WIDTH)] * LAYERS),
        "ligru_drop": ",".join(["0.0"] * LAYERS),
        "ligru_fused_scan": "True"})
    for sec in ("architecture1", "architecture2"):
        cc[sec]["compute_dtype"] = cdt
    cc["model"] = dict(src["model"])
    return cc


def _chunks():
    """The same in-memory chunk for both packages."""
    from pytorch_kaldi_cgs_tpu.data import dataset as jdata
    from pytorch_kaldi_cgs_tpu_torch.data import dataset as tdata
    rng = np.random.RandomState(0)
    x = rng.randn(ST_T, ST_B, F_IN).astype(np.float32)
    cd = rng.randint(0, N_CD, (ST_T, ST_B))
    data = np.concatenate([np.concatenate([x[:, b], cd[:, b, None]], 1)
                           for b in range(ST_B)]).astype(np.float32)
    ends = np.cumsum([ST_T] * ST_B)
    names = ["u%d" % b for b in range(ST_B)]
    return [mod.ChunkData(
        names, data, ends,
        {"fmllr": mod.FeaStream("fmllr", "none", col_start=0,
                                col_end=F_IN)},
        {"lab_cd": mod.LabStream("lab_cd", "none", col=F_IN)})
        for mod in (jdata, tdata)]


@pytest.mark.parametrize("case", ["f32-recompute", "f32-stash",
                                  "bf16-recompute"])
def test_train_steps_match_jax(jm, monkeypatch, route, case):
    """3 steps: per-step loss and err within 1e-5 (relative), every
    parameter and BN statistic within 1e-4 of the JAX runner's after
    each step (RMSprop's first step moves each by about lr / sqrt(1 -
    alpha) = 1.8e-3, so a wrong or missing gradient shows); every
    recurrence on the fused liGRU forward and the backward asked for.

    Under bf16 the first step is held so too. The next two start from
    parameters 5e-5 apart, which bf16 rounding of the x-projections
    turns into gradients an ulp apart; RMSprop makes a near-zero one
    whose sign that flips a whole step each way, 2 lr / sqrt(1 - alpha)
    = 3.6e-3 (measured after the second step: 3.57e-3 in a layer-3
    x-weight at the cfg's eps 1e-8, 3.36e-3 at eps 1e-6). Their loss is
    held to 1e-3."""
    import jax
    import jax.numpy as jnp
    from pytorch_kaldi_cgs_tpu.runtime import chunk as JC
    from pytorch_kaldi_cgs_tpu.runtime import graph as JG
    from pytorch_kaldi_cgs_tpu_torch.runtime import chunk as tchunk
    from pytorch_kaldi_cgs_tpu_torch.runtime import graph as tgraph
    cdt, bwd = case.split("-")
    _set_stash(monkeypatch, bwd == "stash")
    cc = chunk_config("" if cdt == "f32" else cdt)
    jchunk, pchunk = _chunks()
    jg = JG.NetGraph(cc, jchunk)
    jv = jg.init_variables(SEED)
    jr = JC.ChunkRunner(jg, cc)
    jo = jr.init_opt_states(jv)
    jstep = jr.train_step()
    tg = tgraph.NetGraph(cc, pchunk, seed=SEED, device="cpu")
    tr = tchunk.ChunkRunner(tg, cc)
    net = tg.nets["liGRU_layers"]
    assert type(net) is liGRU and net.bidir and net._rec_layouts == {}
    inp, mask, _, _ = next(tchunk.make_seq_batches(
        pchunk, ST_B, True, np.random.RandomState(SEED), bucket=ST_T))
    jres, tres = [], []
    for k in range(STEPS):
        jv, jo, jl, je = jstep(jv, jo, jnp.asarray(inp), jnp.asarray(mask),
                               jax.random.PRNGKey(k))
        jres.append((float(jl), float(je)))
        tl, te = tr.train_step(inp, mask)
        tres.append((float(tl), float(te)))
        if cdt == "bf16" and k > 0:
            continue
        ref, got = jax.device_get(jv), tg.jax_variables()
        for arch in ref:
            for coll in ("params", "state"):
                fa = convert.flatten(ref[arch][coll])
                fb = convert.flatten(got[arch][coll])
                assert sorted(fa) == sorted(fb)
                for key in fa:
                    np.testing.assert_allclose(
                        fb[key], np.asarray(fa[key], np.float32), atol=1e-4,
                        err_msg="step %d %s/%s" % (k, arch, key))
    back = "fused_ligru_bwd_stash" if bwd == "stash" else "fused_ligru_bwd"
    assert route == {"fused_ligru_fwd": LAYERS * STEPS, "fused_ligru_bwd": 0,
                     "fused_ligru_bwd_stash": 0, back: LAYERS * STEPS}
    later = 1e-3 if cdt == "bf16" else 1e-5
    np.testing.assert_allclose(tres[:1], jres[:1], rtol=1e-5)
    np.testing.assert_allclose(tres[1:], jres[1:], rtol=later)
    assert tres[-1][0] < tres[0][0]


# ---------------------------------------------------------------------------
# on the card: the recompute BPTT at the cfg's shape (skips without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU "
                    "mode (chip_smoke.py runs them on the H100)")
    return torch.device("cuda")


def _bwd_args(t, b, h, seed, act):
    """The recompute BPTT's operands at (t, b, h), relu's pre-activations
    kept away from its kink (the candidate's gate inputs at +-(4 +
    |N(0, 0.5)|), the forward run on the card."""
    rng = np.random.RandomState(seed)
    g = rng.randn(t, b, 2 * h) * 0.5
    u_scale = 1.0
    if act == "relu":
        sign = np.where(rng.rand(1, b, h) > 0.5, 1.0, -1.0)
        g[..., :h] = sign * (4.0 + np.abs(g[..., :h]))
        u_scale = 0.2
    d = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    g, U = d(g), d(rng.randn(2 * h, h) * u_scale / np.sqrt(h))
    drop, dhs = d(rng.rand(b, h) > 0.2), d(rng.randn(t, b, h) * 0.1)
    with torch.no_grad():
        hs = tfr.fused_ligru_fwd(g, U, drop, act=act)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    return g, U, drop, h_prev, dhs, act, 0


def _close(got, ref):
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_cuda_bwd_persist_at_the_cfg_shape(cuda_device, act):
    """T=200, 32 rows, H=1024, no quantizer: 128 blocks of 16 units x 16
    rows, dg_{t+1} staged in 5 slabs; 2 launches (the rebuild's GEMM and
    the chain); the twin within 1e-4 of scale; two calls bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    route, plan = tfr.ligru_bwd_route(32, 1024, cuda_device)
    assert route == "persist" and (plan.units, plan.slabs) == (16, 5)
    args = _bwd_args(200, 32, 1024, 71, act)
    with torch.no_grad():
        before = tfr.fused_ligru_bwd.launches
        dg = tfr.fused_ligru_bwd(*args)
        assert tfr.fused_ligru_bwd.launches == before + 2
        dg2 = tfr.fused_ligru_bwd(*args)
        ref = tfr.fused_ligru_bwd_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(dg, dg2)
    _close(dg, ref)


@pytest.mark.cuda
def test_cuda_bwd_persist_8_by_32_blocks(cuda_device):
    """The plan's other block of 256 outputs, 8 units x 32 rows (4 slabs
    of 512), forced, gives the twin's dg too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _bwd_args(40, 32, 1024, 73, "relu")
    plan = tfr.ligru_bwd_plan(32, 1024, (4, 8))
    assert plan.slabs == 4
    with torch.no_grad():
        dg = tfr._ligru_bwd_persist(plan, *args)
        ref = tfr.fused_ligru_bwd_plain(*args)
    torch.cuda.synchronize()
    _close(dg, ref)


@pytest.mark.cuda
def test_cuda_bwd_persist_ragged_slabs(cuda_device):
    """H=777 at 20 rows: 49 unit groups of 16 (the last of 9), a ragged
    second batch tile, and 3 slabs of 544 with a short last one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    route, plan = tfr.ligru_bwd_route(20, 777, cuda_device)
    assert route == "persist" and (plan.slab, plan.slabs) == (544, 3)
    args = _bwd_args(6, 20, 777, 79, "tanh")
    with torch.no_grad():
        dg = tfr.fused_ligru_bwd(*args)
        ref = tfr.fused_ligru_bwd_plain(*args)
    torch.cuda.synchronize()
    _close(dg, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16), (4, 8)], ids=["16x16", "8x32"])
def test_cuda_fwd_persist_at_the_cfg_shape(cuda_device, shape):
    """The forward at 32 rows of 1024, no quantizer (the cfg's), with and
    without the stash: the plan's 8 units x 32 rows (128 blocks, one
    launch a call) and 16 x 16 forced, each bit for bit the step route's,
    and within 1e-4 of the twin's scale; T=40 (the step route's 40
    launches a call)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    route, plan = tfr.ligru_fwd_route(32, 1024, cuda_device)
    assert route == "persist" and (plan.bi, plan.units, plan.grid) == (
        4, 8, 128)
    g, U, drop = _bwd_args(40, 32, 1024, 83, "relu")[:3]
    plan = tfr.ligru_fwd_plan(32, 1024, shape)
    with torch.no_grad():
        for stash in (False, True):
            before = tfr.fused_ligru_fwd.launches
            got = tfr._ligru_fwd_persist(plan, g, U, drop, None, "relu", 0,
                                         stash)
            want = tfr._ligru_fwd_step(g, U, drop, None, "relu", 0, stash)
            assert tfr.fused_ligru_fwd.launches == before + 1 + 40
            ref = tfr.fused_ligru_fwd_plain(g, U, drop, None, "relu", 0,
                                            stash)
            got, want, ref = ((x,) if not stash else x
                              for x in (got, want, ref))
            for a, w, r in zip(got, want, ref):
                assert torch.equal(a, w)
                _close(a, r)
