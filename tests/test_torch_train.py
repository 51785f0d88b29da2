"""The port's training slice against the JAX package's on the CPU: losses,
mixup, the schedule, the trainable set, one to three train steps of
ExprModel, EmotionResNet50 and TemporalLSTM (dropout off on both sides: on
the JAX side flax's ``nn.Dropout.__call__`` is monkeypatched to the identity
here; the JAX package is not edited), the dropout placement, the int8
modules' straight-through gradient, the attention route of the encoder
layers, and ``fit``'s artefacts. Toy sizes: the tiny wav2vec2 of
tests/test_train.py."""

from __future__ import annotations

import glob
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from avcer_tpu.core.config import OptimConfig as JaxOptimConfig
from avcer_tpu.core.config import TrainConfig as JaxTrainConfig
from avcer_tpu.train import losses as jax_losses
from avcer_tpu.train import schedules as jax_schedules
from avcer_tpu_torch.core import convert
from avcer_tpu_torch.core.config import OptimConfig, TrainConfig
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models import wav2vec2 as wav2vec2_module
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config, attention_route
from avcer_tpu_torch.train import losses, schedules
from avcer_tpu_torch.train.trainer import Trainer, default_trainable

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            conv_dim=(16,) * 7)
SAMPLES = 17600  # 54 frames: the time downsample needs 51
LR = 1e-3


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# losses, mixup, schedule
# ---------------------------------------------------------------------------


def test_losses_match_jax(rng):
    """Every loss of train/losses.py against the JAX function, rtol 1e-6."""
    logits = rng.normal(size=(16, 8)).astype(np.float32)
    labels = rng.integers(0, 8, 16)
    weights = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    soft = rng.random((16, 8)).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    pred = rng.normal(size=(16, 2)).astype(np.float32)
    target = rng.normal(size=(16, 2)).astype(np.float32)
    j, p = jnp.asarray, t
    cases = {
        "weighted_ce": (jax_losses.weighted_cross_entropy(j(logits), j(labels), j(weights), 0.2),
                        losses.weighted_cross_entropy(p(logits), p(labels), p(weights), 0.2)),
        "ce": (jax_losses.weighted_cross_entropy(j(logits), j(labels)),
               losses.weighted_cross_entropy(p(logits), p(labels))),
        "ce_smoothed": (jax_losses.weighted_cross_entropy(j(logits), j(labels), None, 0.2),
                        losses.weighted_cross_entropy(p(logits), p(labels), None, 0.2)),
        "focal": (jax_losses.focal_loss(j(logits), j(labels), j(alpha), gamma=2.0),
                  losses.focal_loss(p(logits), p(labels), p(alpha), gamma=2.0)),
        "focal_sum": (jax_losses.focal_loss(j(logits), j(labels), gamma=1.0, reduction="sum"),
                      losses.focal_loss(p(logits), p(labels), gamma=1.0, reduction="sum")),
        "soft_focal": (jax_losses.soft_focal_loss(j(logits), j(soft), j(alpha), gamma=1.5),
                       losses.soft_focal_loss(p(logits), p(soft), p(alpha), gamma=1.5)),
        "soft_focal_onehot": (jax_losses.soft_focal_loss_onehot(j(logits), j(labels), 8),
                              losses.soft_focal_loss_onehot(p(logits), p(labels), 8)),
        "ccc": (jax_losses.ccc_loss(j(pred), j(target)), losses.ccc_loss(p(pred), p(target))),
        "mse": (jax_losses.mse_loss(j(pred), j(target)), losses.mse_loss(p(pred), p(target))),
    }
    for name, (want, got) in cases.items():
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=name)


def test_mixup_matches_jax(rng):
    """With lambda and the permutation injected, the mix equals the JAX
    function's with its own draws; the port's own draws are a permutation and
    a lambda in (0, 1), reproducible from the generator's seed."""
    x = rng.normal(size=(6, 40)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want, perm, lam = jax_losses.mixup_batch(key, jnp.asarray(x), 0.3)
    got, perm_got, lam_got = losses.mixup_batch(None, t(x), 0.3, lam=float(lam),
                                                perm=t(np.asarray(perm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert float(lam_got) == float(lam)
    a = losses.mixup_batch(torch.Generator().manual_seed(5), t(x), 0.3)
    b = losses.mixup_batch(torch.Generator().manual_seed(5), t(x), 0.3)
    assert sorted(a[1].tolist()) == list(range(6)) and 0 < float(a[2]) < 1
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("t_mult", [1, 2])
def test_schedule_matches_jax(t_mult):
    """cosine_warm_restarts over 200 steps, atol 1e-9; the optimizer takes
    the schedule at its update count (0 before the first update)."""
    base_lr, t0, iters = 1e-4, 10, 7
    want = jax_schedules.cosine_warm_restarts(base_lr, t0, iters, t_mult)
    got = schedules.cosine_warm_restarts(base_lr, t0, iters, t_mult)
    for step in range(200):
        assert abs(got(step) - float(want(step))) < 1e-9, step
    w = torch.nn.Parameter(torch.zeros(1))
    opt = schedules.make_optimizer([w], base_lr, t0, iters, t_mult)
    for step in range(3):
        w.grad = torch.ones(1)
        assert opt.step() == got(step) and opt.count == step + 1
    assert isinstance(opt.optimizer, torch.optim.Adam)
    assert isinstance(schedules.make_optimizer([w], 1e-4, 10, 7, weight_decay=0.1).optimizer,
                      torch.optim.AdamW)


# ---------------------------------------------------------------------------
# ExprModel: trainable set, train steps against the JAX Trainer
# ---------------------------------------------------------------------------


def jax_expr_trainer(tmp_path, **cfg_kw):
    from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
    from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V
    from avcer_tpu.train.trainer import Trainer as JaxTrainer

    model = JaxExprModel(variant="v3", num_classes=8, wav2vec2_config=JaxW2V(**TINY),
                         dtype=jnp.float32)
    cfg = JaxTrainConfig(batch_size=4, epochs=2, optim=JaxOptimConfig(lr=LR),
                         log_root=str(tmp_path / "jax"), model="v3", **cfg_kw)
    return JaxTrainer(model, cfg, iters_per_epoch=2, unfreeze_last_n=1, wav2vec2_layers=2)


def port_expr_trainer(tmp_path, **cfg_kw) -> Trainer:
    cfg = TrainConfig(batch_size=4, epochs=2, optim=OptimConfig(lr=LR),
                      log_root=str(tmp_path / "port"), model="v3", **cfg_kw)
    return Trainer(ExprModel("v3", 8, Wav2Vec2Config(**TINY)), cfg, iters_per_epoch=2,
                   unfreeze_last_n=1, wav2vec2_layers=2, device="cpu")


@pytest.fixture(scope="module")
def jax_expr(tmp_path_factory):
    """The JAX Trainer of the tiny ExprModel, its ``init_state`` and a batch
    (one init for the file: it costs a compile)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, SAMPLES)).astype(np.float32)
    y = rng.integers(0, 8, 4).astype(np.int32)
    jt = jax_expr_trainer(tmp_path_factory.mktemp("jax_expr"))
    return jt, jt.init_state(x), x, y


def test_trainable_set_matches_jax_mask(jax_expr):
    """The JAX ``_trainable_mask`` as a tree of 0/1 values, carried through
    ``convert.expr_model``, gives the port's ``default_trainable`` for every
    parameter name."""
    jt, js, _, _ = jax_expr
    mask = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                        jt._trainable_mask, js.params)
    sd = convert.expr_model({"params": mask})
    model = ExprModel("v3", 8, Wav2Vec2Config(**TINY))
    names = dict(model.named_parameters())
    assert set(names) <= set(sd)
    for name in names:
        want = bool(sd[name].flatten()[0])
        assert bool((sd[name] == float(want)).all()), name
        assert default_trainable(name, 1, 2) == want, name
    trainable = [n for n in names if default_trainable(n, 1, 2)]
    assert any(n.startswith("wav2vec2.encoder.layers.1.") for n in trainable)
    assert not any(n.startswith("wav2vec2.encoder.layers.0.") for n in trainable)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def jax_grads(jt, state, x, y):
    """d loss / d params of the JAX train step's loss (no mixup), with the
    updated batch statistics."""
    def loss_fn(params):
        logits, new_stats = jt._loss_and_logits(params, state.batch_stats,
                                                jax.random.PRNGKey(0), x, y, True)
        return jt.loss_fn(logits, y), new_stats

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    return float(loss), grads, stats


def port_sd(params, stats, walker=convert.expr_model):
    return walker({"params": numpy_tree(params), "batch_stats": numpy_tree(stats)})


def rel_l2(got: dict, want: dict, names) -> float:
    """|got - want| / |want| over the tensors ``names`` taken as one vector."""
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum()) for n in names)
    den = sum(float((want[n].double() ** 2).sum()) for n in names)
    return (num / den) ** 0.5


def assert_grads(model: torch.nn.Module, want: dict, rtol: float, atol_frac: float) -> None:
    """Every trainable parameter's gradient against the JAX gradient carried
    to its name: within ``rtol`` and ``atol_frac`` times the largest
    gradient magnitude of the model (a gradient that is zero in exact
    arithmetic, such as the key projection's bias under softmax, is f32
    noise on both sides)."""
    trained = {name: p for name, p in model.named_parameters() if p.requires_grad}
    scale = max(float(np.abs(want[name].numpy()).max()) for name in trained)
    for name, p in model.named_parameters():
        if name not in trained:
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=rtol,
                                   atol=atol_frac * scale, err_msg=name)


#: Adam's bound on one update in units of lr (Kingma and Ba, section 2.1:
#: (1 - beta1) / sqrt(1 - beta2) at optax's and torch's betas 0.9, 0.999)
ADAM_STEP_BOUND = 0.1 / 0.001 ** 0.5


def assert_adam_steps(jt, js, pt, ps, x, y, g0: dict, walker=convert.expr_model,
                      steps: int = 3) -> None:
    """``steps`` train steps each side from the same state. Losses: the first
    within rtol 1e-5 (same weights), the later ones within rtol 1e-4. The
    trainable parameters after the last step. Adam's update is lr * m /
    (sqrt(v) + 1e-8): it carries the relative rounding error of each step's
    gradient, not the absolute one, and an element whose gradient passes
    near zero at a later step takes a different update on the two sides (a
    few hundredths of lr, measured), so no element-wise atol holds. Held
    instead, by the size of the first step's JAX gradient ``g0`` against its
    largest magnitude:
    - where |g0| >= 1e-4 of the largest, each tensor's updates agree within
      1e-2 relative L2 over those elements;
    - below that the gradient is zero in exact arithmetic (a bias ahead of a
      batch-statistics BatchNorm, the key bias under softmax) and Adam
      scales each side's f32 noise up to a full step;
    - every element's movement, on each side, within Adam's bound, steps *
      3.16 lr."""
    start = {k: v.clone() for k, v in ps.model.state_dict().items()}
    j0 = walker({"params": numpy_tree(js.params), "batch_stats": numpy_tree(js.batch_stats)})
    for i in range(steps):
        js, jloss, _ = jt.train_step(js, x, y, jax.random.PRNGKey(0))
        ps, ploss, _ = pt.train_step(ps, x, y)
        np.testing.assert_allclose(ploss, float(jloss), rtol=1e-5 if i == 0 else 1e-4,
                                   err_msg=f"step {i}")
    assert ps.step == steps and ps.optimizer.count == steps
    want = walker({"params": numpy_tree(js.params), "batch_stats": numpy_tree(js.batch_stats)})
    trained = {n: p for n, p in ps.model.named_parameters() if p.requires_grad}
    scale = max(float(g0[n].abs().max()) for n in trained)
    bound = steps * ADAM_STEP_BOUND * LR * (1 + 1e-4)
    for name, value in ps.model.named_parameters():
        got, w = value.detach().numpy(), want[name].numpy()
        if name not in trained:
            np.testing.assert_array_equal(got, start[name].numpy(), err_msg=name)
            continue
        noise = g0[name].abs().numpy() < 1e-4 * scale
        dg, dw = (got - start[name].numpy())[~noise], (w - j0[name].numpy())[~noise]
        assert np.linalg.norm(dg - dw) <= 1e-2 * np.linalg.norm(dw), name
        assert np.abs(got - start[name].numpy()).max() <= bound, name
        assert np.abs(w - j0[name].numpy()).max() <= bound, name


def test_expr_model_train_steps_match_jax(tmp_path, jax_expr, no_jax_dropout):
    """One ExprModel V3 train step against the JAX Trainer's from the same
    weights (the JAX ``init_state`` params carried over by
    ``convert.expr_model``), dropout off on both sides, f32: the loss within
    rtol 1e-5; every trainable gradient within rtol 1e-3 and 1e-4 of the
    model's largest gradient magnitude; the time downsample's running statistics
    after the step within rtol 1e-5 and 1e-5 of each tensor's largest
    magnitude. Then 3 Adam steps at lr 1e-3 each
    side (``assert_adam_steps``)."""
    jt, js, x, y = jax_expr
    sd = port_sd(js.params, js.batch_stats)

    loss, grads, stats = jax_grads(jt, js, jnp.asarray(x), jnp.asarray(y))
    g0 = port_sd(grads, stats)
    pt = port_expr_trainer(tmp_path)
    ps = pt.init_state(params=sd)
    layers.set_dropout(ps.model, p=0.0)
    model = ps.model.train()
    got = pt.loss_fn(model(t(x)), t(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), loss, rtol=1e-5)
    assert_grads(model, g0, rtol=1e-3, atol_frac=1e-4)
    want_stats = port_sd(js.params, stats)
    for name in ("time_downsample.1.running_mean", "time_downsample.1.running_var",
                 "time_downsample.5.running_mean", "time_downsample.5.running_var"):
        w = want_stats[name].numpy()
        np.testing.assert_allclose(model.state_dict()[name].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=name)

    # three steps each side, from the start again
    pt = port_expr_trainer(tmp_path)
    ps = pt.init_state(params=sd)
    layers.set_dropout(ps.model, p=0.0)
    assert_adam_steps(jt, js, pt, ps, x, y, g0)


def test_emotion_resnet_train_steps_match_jax(tmp_path, rng, no_jax_dropout):
    """EmotionResNet50 through the static CLI's wrapper at [2, 64, 64, 3]
    uint8 crops, f32, every BatchNorm on batch statistics with momentum 0.01
    (pinned). Fifty f32 convolutions with batch statistics over two crops
    (8 values a channel in layer4) make the f32 gradient itself uncertain:
    each side's is about 0.7 % (relative L2 over the model) from the port's
    f64 gradient at this input, ReLU decisions near zero taken either way.
    So: loss rtol 1e-4; the gradient as a whole within 3e-2 relative L2;
    the running statistics after the step rtol 1e-4 and 1e-4 of each
    tensor's largest magnitude (the f32 forward drifts by 4e-5 of the
    largest activation by layer4, against f64); after 3 Adam steps the parameters within
    3e-2 relative L2 of the JAX side's (measured 1.5e-2) and the two sides'
    updates pointing the same way (cosine >= 0.85, measured 0.94): Adam
    turns the gradient's small, uncertain elements into full steps of either
    sign, so no element-wise bound holds there."""
    from avcer_tpu.models import emotion_resnet as jax_er
    from avcer_tpu.ops.image import vggface_normalize as jax_norm
    from avcer_tpu.train.trainer import Trainer as JaxTrainer
    from avcer_tpu_torch.cli.train_visual import StaticWrapper
    from avcer_tpu_torch.models import emotion_resnet

    assert emotion_resnet.BN_MOMENTUM == jax_er.BN_MOMENTUM == 0.01
    bns = [m for m in StaticWrapper(7).modules() if isinstance(m, layers.BatchNorm)]
    assert len(bns) == 53 and {m.momentum for m in bns} == {0.01}

    class JaxStatic(jax_er.EmotionResNet50):
        def __call__(self, x, train=False, deterministic=True, return_features=False):
            logits, feats = super().__call__(jax_norm(x), train=not deterministic)
            return (logits, feats) if return_features else logits

    x = rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    y = np.array([1, 4], np.int32)
    kw = dict(model="static", num_classes=7, batch_size=2, loss="weighted_ce",
              label_smoothing=0.0)
    jt = JaxTrainer(JaxStatic(num_classes=7, dtype=jnp.float32),
                    JaxTrainConfig(optim=JaxOptimConfig(lr=LR), log_root=str(tmp_path), **kw),
                    iters_per_epoch=2, unfreeze_last_n=0, wav2vec2_layers=0)
    js = jt.init_state(x)
    sd = port_sd(js.params, js.batch_stats, convert.emotion_resnet50)
    loss, grads, stats = jax_grads(jt, js, jnp.asarray(x), jnp.asarray(y))
    cfg = TrainConfig(optim=OptimConfig(lr=LR), log_root=str(tmp_path), **kw)

    pt = Trainer(StaticWrapper(7), cfg, iters_per_epoch=2, unfreeze_last_n=0,
                 wav2vec2_layers=0, device="cpu")
    ps = pt.init_state(params=sd)
    model = ps.model.train()
    got = pt.loss_fn(model(t(x)), t(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), loss, rtol=1e-4)
    g0 = port_sd(grads, stats, convert.emotion_resnet50)
    params = dict(model.named_parameters())
    assert rel_l2({n: p.grad for n, p in params.items()}, g0, params) <= 3e-2
    want_stats = port_sd(js.params, stats, convert.emotion_resnet50)
    for name, value in model.state_dict().items():
        if "running_" in name:
            w = want_stats[name].numpy()
            np.testing.assert_allclose(value.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w).max()), err_msg=name)

    pt = Trainer(StaticWrapper(7), cfg, iters_per_epoch=2, unfreeze_last_n=0,
                 wav2vec2_layers=0, device="cpu")
    ps = pt.init_state(params=sd)
    start = {n: p.detach().clone() for n, p in ps.model.named_parameters()}
    for i in range(3):
        js, jloss, _ = jt.train_step(js, x, y, jax.random.PRNGKey(0))
        ps, ploss, _ = pt.train_step(ps, x, y)
        assert np.isfinite(ploss), i
    want = port_sd(js.params, js.batch_stats, convert.emotion_resnet50)
    got = {n: p.detach() for n, p in ps.model.named_parameters()}
    assert rel_l2(got, want, got) <= 3e-2
    dg = torch.cat([(got[n] - start[n]).flatten() for n in got]).double()
    dw = torch.cat([(want[n] - start[n]).flatten() for n in got]).double()
    assert float(torch.dot(dg, dw) / (dg.norm() * dw.norm())) >= 0.85


def test_temporal_lstm_train_steps_match_jax(tmp_path, rng):
    """TemporalLSTM through the dynamic CLI's wrapper, [4, 10, 512] f32: loss
    rtol 1e-5, gradients rtol 1e-3 and 1e-4 of the model's largest
    gradient magnitude, 3 Adam steps each side (``assert_adam_steps``)."""
    from avcer_tpu.models.temporal_lstm import TemporalLSTM as JaxLSTM
    from avcer_tpu.train.trainer import Trainer as JaxTrainer
    from avcer_tpu_torch.cli.train_visual import LSTMWrap

    class JaxWrap(JaxLSTM):
        def __call__(self, x, deterministic=True, return_features=False):
            out = super().__call__(x)
            return (out, out) if return_features else out

    x = rng.normal(size=(4, 10, 512)).astype(np.float32)
    y = rng.integers(0, 7, 4).astype(np.int32)
    kw = dict(model="dynamic", num_classes=7, batch_size=4, label_smoothing=0.0)
    jt = JaxTrainer(JaxWrap(7, dtype=jnp.float32),
                    JaxTrainConfig(optim=JaxOptimConfig(lr=LR), log_root=str(tmp_path), **kw),
                    iters_per_epoch=2, unfreeze_last_n=0, wav2vec2_layers=0)
    js = jt.init_state(x)
    sd = convert.temporal_lstm({"params": numpy_tree(js.params)})
    loss, grads, _ = jax_grads(jt, js, jnp.asarray(x), jnp.asarray(y))
    cfg = TrainConfig(optim=OptimConfig(lr=LR), log_root=str(tmp_path), **kw)
    pt = Trainer(LSTMWrap(7), cfg, iters_per_epoch=2, unfreeze_last_n=0, wav2vec2_layers=0,
                 device="cpu")
    ps = pt.init_state(params=sd)
    model = ps.model.train()
    got = pt.loss_fn(model(t(x)), t(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), loss, rtol=1e-5)
    g0 = convert.temporal_lstm({"params": numpy_tree(grads)})
    assert_grads(model, g0, rtol=1e-3, atol_frac=1e-4)
    pt = Trainer(LSTMWrap(7), cfg, iters_per_epoch=2, unfreeze_last_n=0, wav2vec2_layers=0,
                 device="cpu")
    ps = pt.init_state(params=sd)
    assert_adam_steps(jt, js, pt, ps, x, y, g0, walker=convert.temporal_lstm)


# ---------------------------------------------------------------------------
# dropout, STE, attention route
# ---------------------------------------------------------------------------

#: the JAX package's dropout positions in ExprModel V3 (wav2vec2.py:116,
#: :273, :219, :228, :230; attention.py:117-130, :79, :96)
DROPOUTS = (["wav2vec2.feature_projection.dropout", "wav2vec2.encoder.dropout"]
            + [f"wav2vec2.encoder.layers.{i}.{n}" for i in range(2)
               for n in ("dropout", "feed_forward.intermediate_dropout",
                         "feed_forward.output_dropout")]
            + [f"{tl}.{n}" for tl in ("tl1", "tl2")
               for n in ("dropout", "add_norm_after_attention.dropout",
                         "add_norm_after_ff.dropout", "feed_forward.dropout")])


def test_dropout_placement(rng):
    """Dropout sits at the JAX positions, p = 0.1, active only in training:
    a train forward differs from the batch-statistics forward (dropouts in
    eval mode), and with every probability 0 equals it bit for bit; serving
    (eval) is unchanged by the generator. A training forward without a
    generator raises."""
    model = ExprModel("v3", 8, Wav2Vec2Config(**TINY))
    layers.seeded_init_(model, torch.Generator().manual_seed(0))
    got = {n: m.p for n, m in model.named_modules() if isinstance(m, layers.Dropout)}
    assert got == {n: 0.1 for n in DROPOUTS}
    x = t(rng.normal(size=(3, SAMPLES)).astype(np.float32))
    model.eval()
    with torch.no_grad():
        served = model(x)

    def batch_stats_forward():
        model.train()
        for m in model.modules():
            if isinstance(m, layers.Dropout):
                m.eval()
        with torch.no_grad():
            return model(x)

    before = model.state_dict()["time_downsample.1.running_mean"].clone()
    want = batch_stats_forward()
    assert not torch.equal(model.state_dict()["time_downsample.1.running_mean"], before)
    model.train()
    with pytest.raises(RuntimeError, match="generator"):
        model(x)
    layers.set_dropout(model, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        dropped = model(x)
    assert not torch.allclose(dropped, want)
    layers.set_dropout(model, p=0.0)
    with torch.no_grad():
        assert torch.equal(model(x), want)
    model.eval()
    with torch.no_grad():
        assert not torch.equal(model(x), served)  # the running statistics moved
    layers.set_dropout(model, p=0.1)
    drop = layers.Dropout(0.1).train()
    drop.generator = torch.Generator().manual_seed(2)
    ones = torch.ones(20000)
    kept = drop(ones)
    assert set(kept.unique().tolist()) == {0.0, float(np.float32(1) / np.float32(0.9))}
    assert 0.08 < float((kept == 0).float().mean()) < 0.12


@pytest.mark.parametrize("kind", ["dense", "conv", "conv1d"])
def test_int8_modules_straight_through(kind, rng):
    """An int8 module differentiated: the int8 program's forward (bit for bit
    the no-grad call's), the exact module's gradient (avcer_tpu's ``_ste``),
    to the input and the weight."""
    torch.manual_seed(0)
    if kind == "dense":
        q = layers.QDense(16, 8)
        x = torch.randn(5, 16)

        def exact(xx, w):
            return xx @ w.t()
    elif kind == "conv":
        q = layers.QConv(4, 6, 3, stride=2, padding=1, bias=True)
        x = torch.randn(2, 4, 9, 9)

        def exact(xx, w):
            return torch.nn.functional.conv2d(xx, w, stride=2, padding=1)
    else:
        q = layers.QConv1d(4, 6, 3, stride=2)
        x = torch.randn(2, 4, 19)

        def exact(xx, w):
            return torch.nn.functional.conv1d(xx, w, stride=2)
    torch.nn.init.normal_(q.weight)
    g = torch.randn_like(q(x))
    with torch.no_grad():
        served = q(x)
    xg = x.clone().requires_grad_(True)
    y = q(xg)
    assert torch.equal(y.detach(), served)
    (y * g).sum().backward()
    xe = x.clone().requires_grad_(True)
    we = q.weight.detach().clone().requires_grad_(True)
    (exact(xe, we) * g).sum().backward()
    torch.testing.assert_close(xg.grad, xe.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(q.weight.grad, we.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(q.bias.grad, g.sum(dim=[d for d in range(g.dim()) if d != 1]
                                                  if kind != "dense" else 0))


def test_training_caches_and_fused_switches():
    """While training the int8 modules quantise anew at every call and keep
    no cache, and ``folded`` refuses; ``drop_caches`` forgets both."""
    q = layers.QDense(8, 4)
    torch.nn.init.normal_(q.weight)
    q.eval()
    q(torch.randn(3, 8))
    assert q._wq is not None
    layers.drop_caches(q)
    assert q._wq is None
    q.train()
    q(torch.randn(3, 8))
    assert q._wq is None
    cache = layers.FoldCache().train()
    with pytest.raises(RuntimeError, match="training"):
        cache.folded("k", lambda: 1)
    cache.eval()
    assert cache.folded("k", lambda: 1) == 1
    layers.drop_caches(cache)
    assert cache._folds == {}


def test_attention_route_keeps_the_gradient(tmp_path, rng, monkeypatch):
    """The fault-1 rule: in a train step the frozen layer's attention runs
    the kernel wrapper ``mha`` (once a step) and the trainable layer's the
    autograd attention; q, k and v of the trainable ``layers.1`` get a
    non-zero gradient. Without a gradient to carry (eval, no_grad) every
    layer routes to the kernel."""
    calls = []
    real = wav2vec2_module.mha

    def counting(q, k, v):
        calls.append(tuple(q.shape))
        return real(q, k, v)

    monkeypatch.setattr(wav2vec2_module, "mha", counting)
    pt = port_expr_trainer(tmp_path)
    ps = pt.init_state()
    enc = ps.model.wav2vec2.encoder
    h = torch.zeros(2, 54, 64)
    assert attention_route(enc.layers[0], h) == "kernel"
    assert attention_route(enc.layers[1], h) == "autograd"
    assert attention_route(enc.layers[1], h.requires_grad_(True)) == "autograd"
    with torch.no_grad():
        assert attention_route(enc.layers[1], h) == "kernel"
    x = rng.normal(size=(4, SAMPLES)).astype(np.float32)
    y = rng.integers(0, 8, 4)
    pt.train_step(ps, x, y)
    assert calls == [(4, 4, 54, 16)]
    attn = enc.layers[1].attention
    for proj in (attn.q_proj, attn.k_proj, attn.v_proj):
        assert proj.weight.grad is not None and float(proj.weight.grad.norm()) > 0
    assert enc.layers[0].attention.q_proj.weight.grad is None
    pt.eval_step(ps, x, y)
    assert len(calls) == 3


def test_remat_recomputes_with_the_same_masks(rng):
    """``Wav2Vec2Config.remat``: the trainable layers recomputed in the
    backward pass, with dropout on, give the gradients of the plain backward
    bit for bit, and leave the generator where the plain forward left it."""
    x = t(rng.normal(size=(2, SAMPLES)).astype(np.float32))
    grads, states = [], []
    for remat in (False, True):
        model = ExprModel("v3", 8, Wav2Vec2Config(**TINY, remat=remat))
        layers.seeded_init_(model, torch.Generator().manual_seed(0))
        for name, p in model.named_parameters():
            p.requires_grad_(default_trainable(name, 1, 2))
        gen = torch.Generator().manual_seed(7)
        layers.set_dropout(model, generator=gen)
        model.train()(x).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad})
        states.append(gen.get_state())
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
    assert torch.equal(states[0], states[1])


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

#: the columns the JAX Trainer's run_epoch writes (classification)
JAX_STATS_COLUMNS = ["epoch", "phase", "loss", "seconds", "uar", "accuracy", "f1", "precision",
                     "mean"]


def test_fit_writes_exports_stats_checkpoint_and_provenance(tmp_path, rng):
    """At tests/test_train.py's fit size: the best export (a reference-layout
    state dict that loads strictly through ``core.checkpoint``), stats.csv
    with the JAX columns, TensorBoard events, the confusion SVGs, the
    ``latest`` checkpoint that a fresh trainer resumes from, and
    source.log."""
    from avcer_tpu_torch.core import checkpoint

    pt = port_expr_trainer(tmp_path, augmentation=True)
    x = rng.normal(size=(4, SAMPLES)).astype(np.float32)
    y = rng.integers(0, 8, 4)

    class Loader:
        def __iter__(self):
            for _ in range(2):
                yield x, y

    msgs = []
    pt.write_provenance()
    ps = pt.fit(pt.init_state(), Loader(), log_fn=msgs.append)
    assert ps.step == 4
    stats = pd.read_csv(os.path.join(pt.log_dir, "stats.csv"))
    assert list(stats.columns) == JAX_STATS_COLUMNS
    assert stats["epoch"].tolist() == [0, 1] and np.isfinite(stats["loss"]).all()
    assert glob.glob(os.path.join(pt.log_dir, "train", "events.out.tfevents.*"))
    svgs = glob.glob(os.path.join(pt.log_dir, "confusion", "*.svg"))
    assert len(svgs) == 2 and all("train" in os.path.basename(s) for s in svgs)
    best = os.path.join(pt.cfg.log_root, "best_v3.pth")
    sd = convert.release_state_dict("expr_model", checkpoint.load_torch_state_dict(best),
                                    num_layers=2)
    ExprModel("v3", 8, Wav2Vec2Config(**TINY)).load_state_dict(sd, strict=True)
    source = open(os.path.join(pt.log_dir, "source.log")).read()
    assert '"mixup_alpha": 0.3' in source and "class ExprModel" in source
    assert os.path.exists(os.path.join(pt.log_dir, "ckpt", "latest_aux.json"))

    pt2 = port_expr_trainer(tmp_path, augmentation=True)
    ps2 = pt2.init_state(seed=1)
    msgs2 = []
    ps2 = pt2.fit(ps2, Loader(), epochs=3, resume=True, log_fn=msgs2.append)
    assert any("resumed from epoch 1" in m for m in msgs2)
    assert [h["epoch"] for h in pt2.history] == [0, 1, 2]
    assert ps2.step == 6 and ps2.optimizer.count == 6
    assert pt2.best["metric"] >= pt.best["metric"]
    # the resumed run continues the one that stopped: same weights after
    # epoch 2 as an unbroken run of 3 epochs from the same start
    pt3 = port_expr_trainer(tmp_path / "unbroken", augmentation=True)
    ps3 = pt3.fit(pt3.init_state(), Loader(), epochs=3)
    for name, value in ps3.model.state_dict().items():
        assert torch.equal(value, ps2.model.state_dict()[name]), name


def test_trainer_refuses_a_mesh_and_the_cpu_is_asked_for():
    from avcer_tpu_torch.core.config import MeshConfig

    with pytest.raises(NotImplementedError, match="queue 1, parallelism"):
        Trainer(ExprModel("v3", 8, Wav2Vec2Config(**TINY)),
                TrainConfig(mesh=MeshConfig(data=2)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(ExprModel("v3", 8, Wav2Vec2Config(**TINY)), TrainConfig())
