"""The port's trainer on a mesh against its plain step and against the JAX
trainer on its virtual CPU mesh: one step of the tiny ExprModel V3 at data
2, at data 2 x model 2 and at pipe 2 with 2 microbatches (over ``["cpu"] *
4``; dropout off on both sides, f32), the GPipe schedule's logits and
gradients against the sequential encoder, the BatchNorm running statistics
of the global batch against the JAX ``TorchBatchNorm``, and dropout masks
that differ across data shards. Tolerances: the loss 1e-6 relative;
gradients rtol 5e-4 with 2e-4 of the model's largest gradient magnitude;
updated parameters rtol 5e-4 and atol 2e-4 where the gradient is not f32
noise (Adam turns a gradient that is zero in exact arithmetic into a step of
either sign, so those elements are held to Adam's bound instead); the GPipe
forward 2e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avcer_tpu.core.config import MeshConfig as JaxMeshConfig
from avcer_tpu.core.config import OptimConfig as JaxOptimConfig
from avcer_tpu.core.config import TrainConfig as JaxTrainConfig
from avcer_tpu.parallel import pipeline as jax_pp

from avcer_tpu_torch.core import convert
from avcer_tpu_torch.core.config import MeshConfig, OptimConfig, TrainConfig
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models import wav2vec2 as wav2vec2_module
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.wav2vec2 import EncoderLayerStableLN, Wav2Vec2Config
from avcer_tpu_torch.parallel import pipeline as pp
from avcer_tpu_torch.train.trainer import Trainer

from test_torch_train import ADAM_STEP_BOUND, jax_grads, no_jax_dropout, numpy_tree  # noqa: F401

torch.set_num_threads(2)

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            conv_dim=(16,) * 7)
SAMPLES, BATCH, LR = 17600, 4, 1e-3
CPU4 = ["cpu"] * 4
MESHES = {"data2": dict(data=2), "data2_model2": dict(data=2, model=2),
          "pipe2": dict(pipe=2, pipe_microbatches=2)}


def jax_trainer(tmp_path, mesh: dict):
    from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
    from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V
    from avcer_tpu.train.trainer import Trainer as JaxTrainer

    model = JaxExprModel(variant="v3", num_classes=8, wav2vec2_config=JaxW2V(**TINY),
                         dtype=jnp.float32)
    cfg = JaxTrainConfig(batch_size=BATCH, optim=JaxOptimConfig(lr=LR), augmentation=False,
                         log_root=str(tmp_path), mesh=JaxMeshConfig(**mesh))
    return JaxTrainer(model, cfg, iters_per_epoch=2, unfreeze_last_n=1, wav2vec2_layers=2)


def port_trainer(tmp_path, mesh: dict, sd: dict):
    cfg = TrainConfig(batch_size=BATCH, optim=OptimConfig(lr=LR), augmentation=False,
                      log_root=str(tmp_path), mesh=MeshConfig(**mesh))
    tr = Trainer(ExprModel("v3", 8, Wav2Vec2Config(**TINY, remat=True)), cfg, iters_per_epoch=2,
                 unfreeze_last_n=1, wav2vec2_layers=2, device="cpu", devices=CPU4)
    state = tr.init_state(params=sd)
    for rep in tr.replicas:
        layers.set_dropout(rep, p=0.0)
    return tr, state


def port_tree(params, stats, pipe: bool) -> dict:
    params = numpy_tree(params)
    if pipe:
        params = jax_pp.unstack_encoder_params(params, TINY["num_layers"])
    return convert.expr_model({"params": params, "batch_stats": numpy_tree(stats)})


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(BATCH, SAMPLES)).astype(np.float32),
            rng.integers(0, 8, BATCH).astype(np.int32))


@pytest.fixture(scope="module")
def plain(tmp_path_factory, batch):
    """The JAX plain trainer's start (the same for every mesh: one seed) and
    the port's plain step from it: (start state dict, loss, grads, params,
    running statistics)."""
    x, y = batch
    jt = jax_trainer(tmp_path_factory.mktemp("jax_plain"), {})
    js = jt.init_state(x)
    sd = port_tree(js.params, js.batch_stats, False)
    tr, st = port_trainer(tmp_path_factory.mktemp("port_plain"), {}, sd)
    st, loss, _ = tr.train_step(st, x, y)
    grads = {n: p.grad.clone() for n, p in st.model.named_parameters() if p.grad is not None}
    return sd, loss, grads, {k: v.clone() for k, v in st.model.state_dict().items()}


def assert_grads_close(got: dict, want: dict, names) -> None:
    scale = max(float(want[n].abs().max()) for n in names)
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=5e-4,
                                   atol=2e-4 * scale, err_msg=n)


def assert_params_close(got: dict, want: dict, start: dict, g0: dict, trained) -> None:
    scale = max(float(g0[n].abs().max()) for n in trained)
    bound = ADAM_STEP_BOUND * LR * (1 + 1e-4)
    for n, w in want.items():
        if n not in start or n.endswith("num_batches_tracked") or "running" in n:
            continue
        g, w, s = got[n].numpy(), w.numpy(), start[n].numpy()
        if n not in trained:
            np.testing.assert_array_equal(g, s, err_msg=n)
            continue
        signal = g0[n].abs().numpy() >= 1e-4 * scale
        np.testing.assert_allclose(g[signal], w[signal], rtol=5e-4, atol=2e-4, err_msg=n)
        assert np.abs(g - s).max() <= bound and np.abs(w - s).max() <= bound, n


@pytest.mark.parametrize("name", list(MESHES))
def test_train_step_on_mesh(name, tmp_path, batch, plain, no_jax_dropout, monkeypatch):
    """One step on the mesh (remat on: the trained layer is recomputed in
    the backward pass) against the plain port step and the JAX trainer on
    the same mesh of its virtual devices: loss, every trainable gradient, the
    updated parameters (the frozen ones unchanged) and the time downsample's
    running statistics (rtol 1e-5 and 1e-5 of the largest, as
    tests/test_torch_train.py); the replicas refreshed from the master before
    the next forward. K2's route: only the frozen encoder layer's attention
    calls the kernel's wrapper, once a data row (and a model shard, and a
    microbatch)."""
    mesh = MESHES[name]
    x, y = batch
    sd, loss_p, grads_p, params_p = plain
    calls = []
    inner = wav2vec2_module.mha
    monkeypatch.setattr(wav2vec2_module, "mha", lambda *a, **k: (calls.append(a[0].shape),
                                                                  inner(*a, **k))[1])
    tr, st = port_trainer(tmp_path / "port", mesh, sd)
    st, loss, logits = tr.train_step(st, x, y)
    assert logits.shape == (BATCH, 8)
    grads = {n: p.grad.clone() for n, p in st.model.named_parameters() if p.grad is not None}
    trained = {n for n, p in st.model.named_parameters() if p.requires_grad}
    assert set(grads) == trained and any(n.startswith("wav2vec2.encoder.layers.1.")
                                         for n in trained)
    shards = mesh.get("model", 1) * mesh.get("pipe_microbatches", 1) if mesh.get("pipe") \
        else mesh.get("model", 1)
    rows = mesh.get("data", 1)
    assert len(calls) == rows * shards, calls
    heads = TINY["num_heads"] // mesh.get("model", 1)
    assert all(c[1] == heads for c in calls)

    jt = jax_trainer(tmp_path / "jax", mesh)
    js = jt.init_state(x)
    jloss, jg, jstats = jax_grads(jt, js, jnp.asarray(x), jnp.asarray(y))
    g_jax = port_tree(jg, jstats, bool(mesh.get("pipe")))
    js, _, _ = jt.train_step(js, x, y, jax.random.PRNGKey(0))
    after_jax = port_tree(js.params, js.batch_stats, bool(mesh.get("pipe")))

    np.testing.assert_allclose(loss, loss_p, rtol=1e-6)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    assert_grads_close(grads, grads_p, trained)
    assert_grads_close(grads, g_jax, trained)
    after = st.model.state_dict()
    assert_params_close(after, params_p, sd, g_jax, trained)
    assert_params_close(after, after_jax, sd, g_jax, trained)
    for n in ("time_downsample.1.running_mean", "time_downsample.1.running_var",
              "time_downsample.5.running_mean", "time_downsample.5.running_var"):
        for want in (params_p[n], after_jax[n]):
            w = want.numpy()
            np.testing.assert_allclose(after[n].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=n)
        for rep in tr.replicas[1:]:
            assert torch.equal(rep.state_dict()[n], after[n]), n
    # the next forward refreshes every replica from the updated master
    tr.eval_step(st, x)
    for rep in tr.replicas[1:]:
        for n, p in rep.state_dict().items():
            assert torch.equal(p, after[n].to(p.device)), n

def test_gpipe_schedule_order():
    """S = 2 stages, 3 microbatches: n_micro + S - 1 = 4 ticks; within a tick
    the later stage runs first, on what the earlier one handed over."""
    seen = []

    def stage_fn(s, x):
        seen.append((s, int(x[0, 0])))
        return x + 10 * (s + 1)

    h = torch.arange(3.0)[:, None].repeat(1, 2)
    out = pp.gpipe_schedule([torch.device("cpu")] * 2, stage_fn, h, 3)
    assert seen == [(0, 0), (1, 10), (0, 1), (1, 11), (0, 2), (1, 12)]
    assert torch.equal(out, h + 30)


def test_gpipe_matches_sequential_logits_and_grads(rng):
    """``expr_logits_pipelined`` on a (data 2, pipe 2) mesh with 2
    microbatches against the sequential model: logits rtol and atol 2e-5,
    every gradient rtol 5e-4 and atol 1e-5 (tests/test_pipeline_pp.py's
    bounds); the stacked layout round-trips and ``expr_logits_stacked``
    gives the same logits."""
    model = ExprModel("v3", 8, Wav2Vec2Config(**dict(TINY, num_layers=4)))
    layers.seeded_init_(model, torch.Generator().manual_seed(3))
    wav = torch.from_numpy(rng.normal(size=(4, SAMPLES)).astype(np.float32))
    y = torch.tensor([0, 3, 5, 7])
    mesh = pp.make_mesh_dp_pp(2, 2, CPU4)

    def grads_of(fn):
        model.zero_grad()
        logits = fn()
        torch.nn.functional.cross_entropy(logits, y).backward()
        return logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    want, g_seq = grads_of(lambda: model.eval()(wav))
    got, g_pp = grads_of(lambda: pp.expr_logits_pipelined(model, wav, mesh, 2))
    assert torch.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    for n, g in g_seq.items():
        np.testing.assert_allclose(g_pp[n].numpy(), g.numpy(), rtol=5e-4, atol=1e-5, err_msg=n)
    sd = dict(model.state_dict())
    stacked = pp.stack_encoder_params(sd, 4)
    assert stacked["wav2vec2.encoder.layers_stacked.attention.q_proj.weight"].shape[0] == 4
    back = pp.unstack_encoder_params(stacked, 4)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    with torch.no_grad():
        again = pp.expr_logits_stacked(model, stacked, wav, mesh, 2)
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=2e-5, atol=2e-5)


def test_gpipe_bad_configs_raise():
    """As tests/test_pipeline_pp.py: layers that do not divide over the
    stages, a batch that does not divide data x n_micro, a mesh without a
    pipe axis; and pipe with model."""
    from avcer_tpu_torch.parallel import mesh as mesh_lib

    c = Wav2Vec2Config(**dict(TINY, num_layers=4))
    layer = EncoderLayerStableLN(c)
    stacked = {n: torch.stack([p.detach()] * 4) for n, p in layer.named_parameters()}
    h = torch.zeros(4, 24, c.hidden_size)
    with pytest.raises(ValueError, match="do not divide"):
        pp.gpipe_apply(pp.make_mesh_dp_pp(1, 3, ["cpu"] * 3), layer, stacked, h, 2)
    with pytest.raises(ValueError, match="batch"):
        pp.gpipe_apply(pp.make_mesh_dp_pp(2, 2, CPU4), layer, stacked, h, 3)
    with pytest.raises(ValueError, match="pipe"):
        pp.gpipe_apply(mesh_lib.make_mesh(2, 2, CPU4), layer, stacked, h, 2)
    with pytest.raises(ValueError, match="exclusive"):
        Trainer(ExprModel("v3", 8, c), TrainConfig(mesh=MeshConfig(model=2, pipe=2)),
                device="cpu", devices=CPU4)


def test_dropout_differs_across_data_shards():
    """Identical rows at the same position of two data shards draw different
    dropout masks: in ``gpipe_apply`` (a generator a stage and data row,
    from ``rng``) and in the trainer's replicas (a generator a row, from the
    step's seed and the row's index); with dropout off they agree."""
    c = Wav2Vec2Config(**TINY)
    layer = EncoderLayerStableLN(c)
    layers.seeded_init_(layer, torch.Generator().manual_seed(1))
    layers.set_dropout(layer, generator=torch.Generator())
    stacked = {n: torch.stack([p.detach()] * 2) for n, p in layer.named_parameters()}
    h = torch.randn(1, 52, c.hidden_size, generator=torch.Generator().manual_seed(2))
    h = h.expand(4, -1, -1).contiguous()
    mesh = pp.make_mesh_dp_pp(2, 2, CPU4)
    with torch.no_grad():
        det = pp.gpipe_apply(mesh, layer, stacked, h, 2, True)
        np.testing.assert_allclose(det[0].numpy(), det[2].numpy(), rtol=1e-5, atol=1e-6)
        out = pp.gpipe_apply(mesh, layer, stacked, h, 2, False, rng=7)
    assert torch.isfinite(out).all() and not torch.allclose(out[0], out[2], rtol=1e-4, atol=1e-5)

    cfg = TrainConfig(batch_size=4, mesh=MeshConfig(data=2), log_root="unused")
    tr = Trainer(ExprModel("v3", 8, c), cfg, unfreeze_last_n=1, wav2vec2_layers=2,
                 device="cpu", devices=CPU4)
    st = tr.init_state()
    x = np.repeat(np.random.default_rng(4).normal(size=(1, SAMPLES)).astype(np.float32), 4, 0)
    with torch.no_grad():
        st.model.train()
        tr._seed(0)
        logits = tr._forward(st.model, torch.from_numpy(x))
    assert not torch.allclose(logits[0], logits[2])
    for rep in tr.replicas:
        layers.set_dropout(rep, p=0.0)
    with torch.no_grad():
        logits = tr._forward(st.model, torch.from_numpy(x))
    np.testing.assert_allclose(logits[0].numpy(), logits[2].numpy(), rtol=1e-5, atol=1e-6)
