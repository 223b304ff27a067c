"""The port's MINE, its loss and the MC-dropout encoder against the JAX
package's, on the CPU.

Models: a tiny SimCLR (``stage_sizes=(1,1,1,1)``, width 2, feature_dim
64, compressed_dim 16) in float32 and a ``MineNet`` of hidden width 32,
their weights made by the port from a seed and carried to JAX with
``simclr_to_jax``; 16x16 inputs from a numpy seed. The JAX oracles are
jitted once each (the frozen encoder's forward, MineNet's step per mode);
no JAX training loop runs.

Tolerances and why:

* ``log_mean_exp`` and ``mine_loss``: rtol 1e-6 on values and gradients
  (float32 on both sides; a logsumexp and a mean sum in other orders).
* ``MineNet``: outputs and gradients rtol 1e-5, atol 1e-6 (three float32
  products of width 32 summed in other orders).
* the frozen encoder's features (h, z), with MC dropout at rate 0 and 1:
  rtol 1e-4, atol 1e-5, as tests/test_torch_model.py holds the float32
  forward (XLA and PyTorch sum the convolutions in other orders).
* one MINE step: the (joint, marginal) inputs as the features; loss, MI
  and the new log-EMA rtol 1e-5; MineNet's gradients within 1e-5 of each
  tensor's largest entry; its parameters after Adam's first step rtol
  1e-5, atol 1e-7. That step moves an entry by lr g / (|g| + eps), about
  lr = 5e-4 for most, but by a fraction of it that rests on float noise
  where |g| is near eps = 1e-8: in ``orig`` mode one of 25,088 entries
  moved 3.6e-8 less than JAX's (measured), 7e-5 of the step.
* the correlated-Gaussian check: the DV bound after 400 steps above 0.3
  of the analytic 2.2 nats, as tests/test_downstream.py holds JAX's.
"""

import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simclr_tpu import config as jcfg
from simclr_tpu.models.mine import MineNet as JMineNet
from simclr_tpu.models.simclr import SimCLR as JSimCLR
from simclr_tpu.ops import losses as jl
from simclr_tpu.train import common as jcommon
from simclr_tpu_torch import config as tcfg
from simclr_tpu_torch.data import pipeline as tpipe
from simclr_tpu_torch.data.datasets import synthetic_dataset
from simclr_tpu_torch.models.mine import MineNet
from simclr_tpu_torch.models.resnet import MCDropout
from simclr_tpu_torch.models.simclr import SimCLR
from simclr_tpu_torch.ops import losses as tl
from simclr_tpu_torch.scripts import train_mine as cli
from simclr_tpu_torch.train import common as tcommon
from simclr_tpu_torch.train import lin_eval as tlin
from simclr_tpu_torch.train import mine as tmine
from simclr_tpu_torch.train import pretrain as tpre
from simclr_tpu_torch.train import ssl as tssl
from simclr_tpu_torch.utils import checkpoint as ck
from simclr_tpu_torch.utils.weights import simclr_from_jax, simclr_to_jax

SIZE, B, HIDDEN = 16, 8, 32
TINY = dict(feature_dim=64, compressed_dim=16, stage_sizes=(1, 1, 1, 1),
            width=2, compute_dtype="float32", bn_dtype="float32")
TDS = dataclasses.replace(tcfg.CIFAR10, img_size=SIZE)
EXPORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))),
    "results/simclr_bs16_nepoch8_cifar10_temp05.msgpack")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are tiny: PyTorch's thread pool costs more
    than it gives."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _model_cfg(**over):
    return tcfg.ModelConfig(**{**TINY, **over})


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


# ---------------------------------------------------------------------------
# The loss and the statistics network.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first", [True, False])
def test_mine_loss_and_log_mean_exp_match_jax(first):
    rng = np.random.default_rng(0)
    # T as large as 120: exp(T) overflows float32, its log-space form not.
    t_j = rng.normal(2.0, 3.0, (B, 1)).astype(np.float32)
    t_m = np.concatenate([rng.normal(0.0, 2.0, (B - 1, 1)),
                          [[120.0]]]).astype(np.float32)
    last = None if first else np.float32(-0.7)
    rate = 0.05

    def jax_loss(tj, tm):
        last_ma = None if last is None else jnp.asarray(last)
        loss, mi, ma = jl.mine_loss(tj, tm, last_ma, rate)
        return loss, (mi, ma)

    (jloss, (jmi, jma)), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(t_j),
                                               jnp.asarray(t_m))
    tj = torch.from_numpy(t_j).requires_grad_()
    tm = torch.from_numpy(t_m).requires_grad_()
    loss, mi, ma = tl.mine_loss(
        tj, tm, None if last is None else torch.tensor(last), rate)
    loss.backward()
    for got, want in ((loss, jloss), (mi, jmi), (ma, jma)):
        assert np.isfinite(float(got))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(tj.grad.numpy(), np.asarray(jgrads[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgrads[1]),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(tl.log_mean_exp(torch.from_numpy(t_m))),
                               float(jl.log_mean_exp(jnp.asarray(t_m))),
                               rtol=1e-6)
    if first:
        # The first step's EMA is log mean exp(T_marginal) itself.
        assert float(ma) == float(tl.log_mean_exp(tm.detach()))


def _mine_weights(in_features):
    net = MineNet(in_features, HIDDEN,
                  generator=torch.Generator().manual_seed(2))
    params, stats = simclr_to_jax(net.state_dict())
    assert stats == {}
    return net, params


def test_minenet_matches_jax_and_carries_both_ways():
    net, params = _mine_weights(12)
    assert set(params) == {"fc1", "fc2", "out"}
    want_shapes = jax.eval_shape(lambda: JMineNet(hidden_size=HIDDEN).init(
        jax.random.key(0), jnp.zeros((2, 12))))["params"]
    assert jax.tree.map(np.shape, params) == jax.tree.map(
        lambda a: a.shape, want_shapes)
    back = simclr_from_jax(params, {})
    assert back.keys() == net.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in net.state_dict().items())
    assert all(p.dtype == torch.float32 for p in net.parameters())
    x = np.random.default_rng(1).normal(size=(B, 12)).astype(np.float32)
    jnet = JMineNet(hidden_size=HIDDEN)

    def objective(p, x):
        t = jnet.apply({"params": p}, x)
        return jnp.sum(t * jnp.arange(1.0, B + 1)[:, None]), t

    (_, jt), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        params, x)
    t = net(torch.from_numpy(x))
    assert t.shape == (B, 1)
    (t * torch.arange(1.0, B + 1)[:, None]).sum().backward()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jt),
                               rtol=1e-5, atol=1e-6)
    tgrads = dict(_flat(simclr_to_jax(
        {k: p.grad for k, p in net.named_parameters()})[0]))
    for name, g in _flat(jax.device_get(jgrads)):
        np.testing.assert_allclose(tgrads[name], g, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_minenet_recovers_a_known_mi():
    """For correlated Gaussians (y = x + noise) the DV bound must reach a
    fair share of the analytic MI, 0.5 log(1 + var_x / var_n) per
    dimension: 2.2 nats at d = 4 (tests/test_downstream.py's check, in
    PyTorch)."""
    rng = np.random.RandomState(0)
    d = 4
    torch.manual_seed(0)
    net = MineNet(2 * d, 64, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(net.parameters(), lr=5e-3)
    true_mi = d * 0.5 * np.log(1 + 1.0 / 0.5)
    log_ma = None
    for _ in range(400):
        x = rng.randn(128, d).astype(np.float32)
        y = x + rng.randn(128, d).astype(np.float32) * np.sqrt(0.5)
        y_m = (rng.randn(128, d).astype(np.float32)
               + rng.randn(128, d).astype(np.float32) * np.sqrt(0.5))
        joint = torch.from_numpy(np.concatenate([x, y], 1))
        marginal = torch.from_numpy(np.concatenate([x, y_m], 1))
        if log_ma is None:
            with torch.no_grad():
                log_ma = tl.log_mean_exp(net(marginal))
        loss, mi, log_ma = tl.mine_loss(net(joint), net(marginal), log_ma,
                                        1e-2)
        log_ma = log_ma.detach()
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert float(mi) > 0.3 * true_mi


# ---------------------------------------------------------------------------
# MC dropout.
# ---------------------------------------------------------------------------

def test_mc_dropout_keeps_with_flax_arithmetic():
    """At rate 0.3 the output is x * mask / 0.7 for the masks its
    generator draws (4-D in NHWC order, so channels_last stays so); rate
    0 is the input and rate 1 zeros, neither drawing; no generator
    raises."""
    x4 = torch.randn(2, 5, 3, 4).contiguous(memory_format=torch.channels_last)
    x2 = torch.randn(6, 7)
    drop = MCDropout(0.3)
    drop.record = True
    for x in (x4, x2):
        gen = torch.Generator().manual_seed(4)
        out = drop(x, gen)
        again = torch.Generator().manual_seed(4)
        if x.dim() == 4:
            n, c, h, w = x.shape
            u = torch.rand((n, h, w, c), generator=again).permute(0, 3, 1, 2)
            assert out.is_contiguous(memory_format=torch.channels_last)
        else:
            u = torch.rand(x.shape, generator=again)
        mask = u < 0.7
        assert torch.equal(drop.mask, mask)
        assert torch.equal(out, torch.where(mask, x / 0.7,
                                            torch.zeros_like(x)))
        assert 0 < int(mask.sum()) < mask.numel()
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    assert MCDropout(0.0)(x4, gen) is x4
    assert torch.equal(MCDropout(1.0)(x4, gen), torch.zeros_like(x4))
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="generator"):
        drop(x2, None)


def _count_sites(model):
    calls = []
    sites = [m for m in model.modules() if isinstance(m, MCDropout)]
    for m in sites:
        m.register_forward_hook(lambda *a: calls.append(1))
    return sites, calls


def test_dropout_sites_stay_on_in_eval_and_need_a_generator():
    """1 + 4 sites in the encoder and num_proj_layers - 1 in the head, all
    drawing in eval mode; a model without dropout draws nothing."""
    cfg = _model_cfg(encoder="dropout", num_proj_layers=3)
    model = SimCLR(cfg, generator=torch.Generator().manual_seed(0)).eval()
    sites, calls = _count_sites(model)
    assert len(sites) == 1 + 4 + 2
    x = torch.randn(4, 3, SIZE, SIZE)
    with torch.no_grad():
        h1, z1 = model(x, torch.Generator().manual_seed(1))
        h1b, z1b = model(x, torch.Generator().manual_seed(1))
        h2, z2 = model(x, torch.Generator().manual_seed(2))
    assert len(calls) == 3 * 7
    assert torch.equal(h1, h1b) and torch.equal(z1, z1b)
    assert not torch.equal(h1, h2) and not torch.equal(z1, z2)
    with pytest.raises(ValueError, match="generator"):
        model(x)
    plain = SimCLR(_model_cfg(num_proj_layers=3)).eval()
    assert not [m for m in plain.modules() if isinstance(m, MCDropout)]
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    with torch.no_grad():
        plain(x, gen)
    assert torch.equal(gen.get_state(), state)
    # The fine-tune model's encoder draws too; its head g never runs.
    fine = tssl.SimCLRFineTune(cfg, 10).eval()
    sites, calls = _count_sites(fine)
    with torch.no_grad():
        fine(x, torch.Generator().manual_seed(1))
    assert len(sites) == 7 and len(calls) == 5


@pytest.fixture(scope="module")
def encoder():
    """The tiny SimCLR's weights (the port's init from seed 5, running
    statistics perturbed) and JAX's eval-mode forward of its dropout
    twin at rates 0 and 1."""
    model = SimCLR(_model_cfg(), generator=torch.Generator().manual_seed(5))
    params, stats = simclr_to_jax(model.state_dict())
    rng = np.random.default_rng(6)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rng.uniform(0.5, 1.5, leaf.shape)
                            if path[-1].key == "var"
                            else rng.normal(0.0, 0.2, leaf.shape)
                            ).astype(np.float32), stats)
    forwards = {}
    for rate in (0.0, 1.0):
        jmodel = JSimCLR(cfg=jcfg.ModelConfig(**TINY, encoder="dropout",
                                               drop_prob=rate))
        forwards[rate] = jax.jit(
            lambda v, x, k, m=jmodel: m.apply(v, x, train=False,
                                              rngs={"dropout": k}))
    return dict(params=params, stats=stats, forwards=forwards,
                variables={"params": params, "batch_stats": stats})


def _port_simclr(weights, **over):
    model = SimCLR(_model_cfg(**over))
    model.load_state_dict(simclr_from_jax(weights["params"],
                                          weights["stats"]))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_dropout_at_rates_0_and_1_matches_jax(encoder, rate):
    """flax returns its input at rate 0 and zeros at rate 1: so do the
    port's sites, in eval mode, from any generator."""
    x = np.random.default_rng(7).normal(size=(B, SIZE, SIZE, 3)).astype(
        np.float32)
    jh, jz = encoder["forwards"][rate](encoder["variables"], x,
                                       jax.random.key(0))
    model = _port_simclr(encoder, encoder="dropout", drop_prob=rate)
    with torch.no_grad():
        h, z = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.Generator().manual_seed(9))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4,
                               atol=1e-5)
    if rate == 1.0:
        assert not h.any()


# ---------------------------------------------------------------------------
# One MINE step against JAX's step body.
# ---------------------------------------------------------------------------

def _jax_mine_step(in_features):
    """JAX's mine_step body (train/mine.py:142-159) on given (joint,
    marginal): MineNet, mine_loss, torch-semantics Adam at mine_lr."""
    jnet = JMineNet(hidden_size=HIDDEN)
    tx = jcommon.adam_torch(5e-4)

    @jax.jit
    def step(params, joint, marginal, log_ma):
        def objective(p):
            t_j = jnet.apply({"params": p}, joint)
            t_m = jnet.apply({"params": p}, marginal)
            loss, mi, new_ma = jl.mine_loss(t_j, t_m, log_ma, 0.05)
            return loss, (mi, new_ma)

        (loss, (mi, new_ma)), grads = jax.value_and_grad(
            objective, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return (loss, mi, new_ma, grads,
                jax.tree.map(lambda p, u: p + u, params, updates))

    return step


@pytest.mark.parametrize("repr_mode,hidden_feat", [(True, True),
                                                   (False, False)])
def test_one_mine_step_matches_jax(encoder, repr_mode, hidden_feat):
    """From the same frozen encoder (MC dropout at rate 0), views and
    MineNet weights: the (joint, marginal) features, the loss, MI, new
    EMA, gradients and parameters after Adam."""
    rng = np.random.default_rng(8)
    views = [rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
             for _ in range(3 if repr_mode else 2)]
    fwd = encoder["forwards"][0.0]
    feats = []
    for i, v in enumerate(views):
        h, z = fwd(encoder["variables"], v, jax.random.key(i))
        feats.append(np.asarray(h if hidden_feat else z))
    if repr_mode:
        joint = np.concatenate([feats[0], feats[1]], 1)
        marginal = np.concatenate([feats[0], feats[2]], 1)
    else:
        flat = views[0].reshape(B, -1)
        joint = np.concatenate([flat, feats[0]], 1)
        marginal = np.concatenate([flat, feats[1]], 1)
    net, params = _mine_weights(joint.shape[1])
    log_ma = np.float32(0.3)
    jloss, jmi, jma, jgrads, jparams = jax.device_get(
        _jax_mine_step(joint.shape[1])(params, joint, marginal, log_ma))

    cfg = tcfg.Config(dataset=TDS, model=_model_cfg(encoder="dropout",
                                                    drop_prob=0.0))
    simclr = _port_simclr(encoder, encoder="dropout", drop_prob=0.0)
    opt = tcommon.adam_torch(net.parameters(), 5e-4)
    engine = tmine.MineEngine(cfg, simclr, net, opt, 0.05, repr_mode,
                              hidden_feat)
    tj, tm = engine.pairs([torch.from_numpy(v) for v in views],
                          torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tj.numpy(), joint, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), marginal, rtol=1e-4, atol=1e-5)
    engine.log_ma = torch.tensor(log_ma)
    loss, mi = engine.update_on_pairs(torch.from_numpy(joint),
                                      torch.from_numpy(marginal))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(mi), jmi, rtol=1e-5)
    np.testing.assert_allclose(float(engine.log_ma), jma, rtol=1e-5)
    tgrads = dict(_flat(simclr_to_jax(
        {k: p.grad for k, p in net.named_parameters()})[0]))
    for name, g in _flat(jgrads):
        np.testing.assert_allclose(tgrads[name], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)
    got = dict(_flat(simclr_to_jax(net.state_dict())[0]))
    for name, p in _flat(jparams):
        np.testing.assert_allclose(got[name], p, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    # The frozen model has no gradient and did not move.
    assert all(p.grad is None and not p.requires_grad
               for p in simclr.parameters())
    assert all(torch.equal(a, b) for a, b in zip(
        simclr.state_dict().values(),
        _port_simclr(encoder).state_dict().values()))


# ---------------------------------------------------------------------------
# train_mine, the stream, the CLI and the other dropout paths.
# ---------------------------------------------------------------------------

def _dataset(n=40, seed=1):
    images, labels = synthetic_dataset(n, SIZE, seed=seed)
    return tpipe.DeviceDataset.from_numpy(images, labels, "cpu")


def test_train_mine_repr_mode_with_the_dropout_encoder(monkeypatch):
    """4 steps in chunks of 2: finite traces of 2, a log line per chunk,
    three training views a step (each one colour-kernel call) and three
    for the EMA's start."""
    views = []
    apply = tmine.augment_train_apply

    def spy(images, params, ds, out_size=None):
        views.append(images.shape[0])
        return apply(images, params, ds, out_size)

    monkeypatch.setattr(tmine, "augment_train_apply", spy)
    cfg = tcfg.Config(dataset=TDS, model=_model_cfg(encoder="dropout"))
    sd = SimCLR(cfg.model).state_dict()
    lines = []
    result = tmine.train_mine(cfg, _dataset(), sd, n_iter=4,
                              take_avg_every=2, print_every=2, batch_size=B,
                              hidden_size=HIDDEN, log=lines.append,
                              device="cpu")
    assert views == [B] * 3 * (1 + 4)
    assert result.state.step == 4 and len(result.chunk_seconds) == 2
    assert result.loss_trace.shape == result.mi_trace.shape == (2,)
    assert np.all(np.isfinite(result.loss_trace))
    assert np.all(np.isfinite(result.mi_trace))
    assert result.final_mi == pytest.approx(result.mi_trace[-1])
    assert [line.split(":")[0] for line in lines] == ["iteration #2",
                                                      "iteration #4"]
    assert result.state.model.fc1.in_features == 2 * 64


def test_train_mine_from_either_export_in_orig_mode(tmp_path):
    """``orig`` mode (image and z, width 16^2 * 3 + 16) from the JAX
    package's .msgpack export and from the port's .pt of the same
    weights: the same run."""
    with open(EXPORT + ".json") as f:
        m = json.load(f)["model"]
    m["stage_sizes"] = tuple(m["stage_sizes"])
    cfg = tcfg.Config(dataset=TDS, model=tcfg.ModelConfig(**m))
    sd, _ = ck.load_pretrained(EXPORT)
    ck.export_model(str(tmp_path / "m.pt"), sd, "{}")
    results = [tmine.train_mine_from_export(
        cfg, _dataset(), path, n_iter=2, take_avg_every=1, batch_size=B,
        hidden_size=HIDDEN, mi_between_repr=False, use_hidden_feat=False,
        log=lambda m: None, device="cpu")
        for path in (EXPORT, str(tmp_path / "m.pt"))]
    for r in results:
        assert r.state.model.fc1.in_features == SIZE * SIZE * 3 + 16
        assert r.loss_trace.shape == (2,)
        assert np.all(np.isfinite(r.loss_trace))
    np.testing.assert_array_equal(results[0].loss_trace,
                                  results[1].loss_trace)


def test_infinite_stream_runs_past_an_epoch():
    ds = _dataset(10)
    stream = tpipe.infinite_stream(ds, torch.Generator().manual_seed(0), 4)
    batches = list(itertools.islice(stream, 5))
    assert all(x.shape == (4, SIZE, SIZE, 3) and y.shape == (4,)
               for x, y in batches)
    # Two batches an epoch (the remainder dropped), each epoch a new
    # permutation without repeats.
    for e in range(2):
        seen = torch.cat([batches[2 * e][1], batches[2 * e + 1][1]])
        assert seen.shape == (8,)
    first = torch.cat([b[0] for b in batches[:2]])
    assert len({bytes(img.numpy()) for img in first}) == 8


def test_cli_flags(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--mine_bs", "--mi_with_orig", "--use_final_feat",
                 "--device"):
        assert flag in out
    args = cli.parse_args(["m.pt", "--mine_bs", "64", "--n_iter", "7",
                           "--mi_with_orig"])
    assert (args.simclr_model_path, args.mine_bs, args.n_iter,
            args.mi_with_orig, args.device) == ("m.pt", 64, 7, True, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["m.pt"])


def test_the_other_paths_draw_dropout_masks_from_their_generators():
    """With encoder='dropout': the pretrain step and eval step, the
    fine-tune step and eval batch, and feature extraction each run, and
    draw their masks from their generator (a step without one raises)."""
    cfg = tcfg.Config(dataset=TDS, model=_model_cfg(encoder="dropout"),
                      train=tcfg.TrainConfig(batch_size=B,
                                             micro_batch_size=B))
    images = torch.from_numpy(synthetic_dataset(2 * B, SIZE, seed=2)[0])
    idx = torch.arange(B)
    model, state, opt = tpre.init_simclr(cfg, seed=0, device="cpu")
    engine = tpre.build_engine(cfg, model, opt)
    gen = torch.Generator().manual_seed(0)
    params = engine.sample_pair_params(gen, B, SIZE, SIZE)
    with pytest.raises(ValueError, match="generator"):
        engine.train_step_on_params(state, images[:B], params)
    state, (loss, _) = engine.train_step(state, images, idx, gen)
    eval_loss, _ = engine.eval_step(state, images, idx, gen)
    assert np.isfinite(float(loss)) and np.isfinite(float(eval_loss))

    ft, ft_state, ft_opt = tssl.init_finetune(cfg, device="cpu")
    ft_engine = tssl.SupervisedEngine(ft, ft_opt, cfg)
    labels = torch.zeros(2 * B, dtype=torch.int32)
    ft_state, (loss, _) = ft_engine.train_step(ft_state, images, labels,
                                               idx, gen)
    nll, _ = ft_engine.eval_batch(ft_state, images, labels, gen)
    assert np.isfinite(float(loss)) and np.isfinite(float(nll))

    ds = tpipe.DeviceDataset(images, labels)
    a, _ = tlin.extract_features(model, ds, cfg, batch_size=B)
    b, _ = tlin.extract_features(model, ds, cfg, batch_size=B)
    c, _ = tlin.extract_features(model, ds, cfg, batch_size=B,
                                 generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
