"""The port's data-parallel serving and its parallel helpers against the JAX
package on the CPU: ``DetectStage`` and ``VisualStage`` over a mesh of
``["cpu"] * 2`` against their unsharded selves and the JAX stages on the
virtual 8-device mesh (scores 1e-4, boxes 5e-2: tests/test_pipeline.py's
sharded-stage tolerances), the mesh error, the tensor-parallel rules with
their replication fallback, ``initialize``'s all-or-none contract, and
``shard_videos`` / ``FileShardedSampler`` against the JAX helpers. Toy
sizes (detector bucket 64, CNN crops 64)."""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.core.config import DetectorConfig as JaxDetectorConfig
from avcer_tpu.models.audio_heads import ExprModel as JaxExprModel
from avcer_tpu.models.emotion_resnet import EmotionResNet50 as JaxEmotionResNet50
from avcer_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from avcer_tpu.models.temporal_lstm import TemporalLSTM as JaxTemporalLSTM
from avcer_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2V
from avcer_tpu.parallel import distributed as jax_distributed
from avcer_tpu.parallel import mesh as jax_mesh
from avcer_tpu.pipeline.detect import DetectStage as JaxDetectStage
from avcer_tpu.pipeline.visual import VisualStage as JaxVisualStage

from avcer_tpu_torch.core import convert
from avcer_tpu_torch.core.config import DetectorConfig, MeshConfig, PipelineConfig
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.parallel import distributed
from avcer_tpu_torch.parallel import mesh as mesh_lib
from avcer_tpu_torch.pipeline.builder import build_pipeline
from avcer_tpu_torch.pipeline.detect import DetectStage
from avcer_tpu_torch.pipeline.visual import VisualStage

from test_torch_models import randomize_stats

torch.set_num_threads(2)

CPU2 = ["cpu"] * 2


@pytest.fixture(scope="module")
def detector():
    """tests/test_pipeline.py's sharded-stage case (the r50 detector from the
    default seed, eight frames at the 64 bucket), with the frames already at
    the bucket's 48 x 64, so both packages see the same pixels (the JAX
    package letterboxes with cv2 on the host, the port on the device)."""
    variables = init_variables(JaxRetinaFace(backbone="resnet50", dtype=jnp.float32),
                               (jnp.zeros((1, 64, 64, 3), jnp.float32),))
    model = RetinaFace()
    model.load_state_dict(convert.retinaface(variables), strict=True)
    frames = np.random.default_rng(0).integers(0, 255, (8, 48, 64, 3), dtype=np.uint8)
    return variables, model.eval(), frames


@pytest.mark.parametrize("stride", [1, 2])
def test_detect_stage_data_parallel(detector, stride):
    """Eight frames over ``["cpu"] * 2``: every shard's network, decode,
    top-K and NMS on its replica; the gathered detections against the
    unsharded stage (equal keep masks, scores 1e-4, boxes 5e-2, the JAX
    test's sharded-against-unsharded bounds) and against the JAX stage
    sharded over ``make_mesh(data=2)`` at the cross-package bounds of
    tests/test_torch_pipeline.py's ``test_detect_stage_matches_jax`` (scores
    1e-4 and rtol 1e-3, boxes 1e-2 and rtol 1e-3: the random detector decodes
    boxes of up to 3e4 px, where f32 rounding alone is 1e-5 relative)."""
    variables, model, frames = detector
    cfg = DetectorConfig(long_side=64, batch_size=8, transfer_format="bgr", dtype="float32",
                         stride=stride)
    sharded = DetectStage(cfg, model, device="cpu", mesh=mesh_lib.make_mesh(2, 1, CPU2))
    plain = DetectStage(cfg, model, device="cpu")
    assert [dev for dev, _ in sharded.replicas] == [torch.device("cpu")] * 2
    packed, scale, _ = sharded.dispatch(frames)
    got = sharded.unpack(packed.numpy(), scale)
    packed, scale, _ = plain.dispatch(frames)
    ref = plain.unpack(packed.numpy(), scale)
    assert got.keep.shape == (8 // stride, 64) and got.keep.sum() > 8
    np.testing.assert_array_equal(got.keep, ref.keep)
    np.testing.assert_allclose(got.scores, ref.scores, atol=1e-4)
    np.testing.assert_allclose(got.boxes, ref.boxes, atol=5e-2)
    jcfg = JaxDetectorConfig(long_side=64, batch_size=8, transfer_format="bgr", stride=stride)
    want = JaxDetectStage(jcfg, variables, dtype=jnp.float32,
                          mesh=jax_mesh.make_mesh(data=2, model=1))
    packed, scale, _ = want.dispatch(frames)
    want = want.unpack(np.asarray(packed, np.float32), scale)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=1e-2, rtol=1e-3)
    np.testing.assert_array_equal(got.keep, want.keep)


def test_visual_stage_data_parallel(rng):
    """Six 64 x 64 crops in CNN batches of 4 over ``["cpu"] * 2`` (two
    shards of 2 a batch, the last batch filled up): probabilities and
    features against the unsharded stage and the JAX stage on
    ``make_mesh(data=2)`` (1e-4 absolute on the probabilities and 1e-4 of
    the largest feature); a batch size the axis does not divide raises."""
    static = randomize_stats(init_variables(JaxEmotionResNet50(7), (jnp.zeros((1, 64, 64, 3)),),
                                            1), 1)
    lstm = init_variables(JaxTemporalLSTM(7), (jnp.zeros((1, 10, 512)),), 2)
    cnn, rnn = EmotionResNet50(7), TemporalLSTM(7)
    cnn.load_state_dict(convert.emotion_resnet50(static), strict=True)
    rnn.load_state_dict(convert.temporal_lstm(lstm), strict=True)
    crops = rng.integers(0, 255, (6, 64, 64, 3), dtype=np.uint8)
    mesh = mesh_lib.make_mesh(2, 1, CPU2)
    sharded = VisualStage(cnn.eval(), rnn.eval(), batch_size=4, device="cpu", mesh=mesh)
    plain = VisualStage(cnn, rnn, batch_size=4, device="cpu")
    probs, feats = sharded.run_static(crops)
    probs_p, feats_p = plain.run_static(crops)
    jstage = JaxVisualStage(static, lstm, dtype=jnp.float32, batch_size=4,
                            mesh=jax_mesh.make_mesh(data=2, model=1))
    probs_j, feats_j = jstage.run_static(crops)
    scale = float(np.abs(feats_j).max())
    for p, f in ((probs_p, feats_p), (probs_j, feats_j)):
        np.testing.assert_allclose(probs, p, atol=1e-4)
        np.testing.assert_allclose(feats, f, atol=1e-4 * scale)
    with pytest.raises(ValueError, match="does not divide over the data axis of 2"):
        VisualStage(cnn, rnn, batch_size=3, device="cpu", mesh=mesh)


def test_build_pipeline_mesh_turns_fused_off_and_needs_devices():
    """``MeshConfig(data=2)``: the build on the one CPU raises the JAX
    package's mesh error; over ``["cpu"] * 2`` the stages share the mesh and
    the fused switches are off, as in the JAX package."""
    cfg = PipelineConfig(detector=DetectorConfig(batch_size=4, long_side=64,
                                                 transfer_format="bgr", fused_tails=True,
                                                 fused_ssh=True),
                         mesh=MeshConfig(data=2), weights_dir="/nonexistent")
    cfg = dataclasses.replace(cfg, visual=dataclasses.replace(cfg.visual, batch_size=4,
                                                              fused=True))
    with pytest.raises(ValueError, match=re.escape("mesh 2x1 exceeds 1 devices")):
        build_pipeline(cfg, device="cpu")
    tiny = Wav2Vec2Config(hidden_size=64, num_layers=1, num_heads=4, intermediate_size=128,
                          conv_dim=(16,) * 7)
    pipe = build_pipeline(cfg, tiny, device="cpu", mesh_devices=CPU2)
    assert pipe.mesh is pipe.detect.mesh is pipe.visual.mesh is pipe.audio.mesh
    assert pipe.mesh.shape == {"data": 2, "model": 1}
    assert not pipe.detect.model.fused_ssh and not pipe.visual.static_model.fused


def test_mesh_error_matches_jax():
    """``make_mesh`` raises where the JAX function does, with its message;
    ``data=-1`` takes every device; an explicit list may name one device
    twice."""
    for data, model in ((16, 1), (4, 4), (3, 3)):
        with pytest.raises(ValueError) as want:
            jax_mesh.make_mesh(data, model)
        with pytest.raises(ValueError) as got:
            mesh_lib.make_mesh(data, model, ["cpu"] * 8)
        assert str(got.value) == str(want.value)
    m = mesh_lib.make_mesh(-1, 2, ["cpu"] * 8)
    assert m.shape == jax_mesh.make_mesh(-1, 2).shape == {"data": 4, "model": 2}
    assert m.row(0) == [torch.device("cpu")] * 2


def test_tensor_parallel_rules_match_jax():
    """The rules on the port's names against ``param_shardings`` of the JAX
    package on the same ExprModel V3 (hidden 96, intermediate 128, model
    axis 3): each torch weight's split dim is the JAX kernel's transposed
    one; 128 does not divide by 3, so the FFN's matrices fall back to
    replication on both sides, while the attention and the heads split. At
    model 1 everything replicates."""
    w2v = dict(hidden_size=96, num_layers=2, num_heads=4, intermediate_size=128,
               conv_dim=(16,) * 7)
    jmodel = JaxExprModel("v3", 8, JaxW2V(**w2v))
    variables = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 17600))))

    jm = jax_mesh.make_mesh(1, 3)
    shardings = jax_mesh.param_shardings(variables, jm)

    def tag(s, leaf):
        spec = tuple(s.spec) + (None,) * (len(leaf.shape) - len(tuple(s.spec)))
        if "model" not in spec:
            return np.zeros(leaf.shape, np.float32)
        dim = spec.index("model")
        torch_dim = dim if len(leaf.shape) == 1 else (len(leaf.shape) - 1 - dim)
        return np.full(leaf.shape, 1.0 + torch_dim, np.float32)

    tags = jax.tree.map(tag, shardings, variables)
    want = convert.expr_model(tags)
    model = ExprModel("v3", 8, Wav2Vec2Config(**w2v))
    specs = mesh_lib.param_specs(model.named_parameters(), mesh_lib.make_mesh(1, 3, ["cpu"] * 3))
    split = {n for n, d in specs.items() if d is not None}
    for name, dim in specs.items():
        assert float(want[name].flatten()[0]) == (0.0 if dim is None else 1.0 + dim), name
    assert any("q_proj" in n for n in split) and any("query_w" in n for n in split)
    assert not any("intermediate_dense" in n or "output_dense" in n for n in split)
    ones = mesh_lib.param_specs(model.named_parameters(), mesh_lib.make_mesh(1, 1, ["cpu"]))
    assert all(d is None for d in ones.values())
    mods = dict(mesh_lib.tensor_parallel_modules(model, specs, 3))
    # split modules: the wav2vec2 attention (4 heads do not divide by 3: it
    # stays whole) and the heads' layer_1/layer_2 FFN; tl1's 32 heads do not
    # divide either, tl2's 16 neither
    assert "tl1.feed_forward" in mods and "wav2vec2.encoder.layers.0.attention" not in mods
    assert "wav2vec2.encoder.layers.0.feed_forward" not in mods


def test_initialize_all_or_none(monkeypatch):
    """Nothing configured: a no-op; a partial configuration, in arguments or
    in torchrun's environment, raises as the JAX ``initialize`` does; a
    whole one brings up gloo and a second call is safe."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "JAX_COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert jax_distributed.initialize() is False
    for kw in (dict(num_processes=4, process_id=1), dict(coordinator_address="localhost:1")):
        with pytest.raises(ValueError, match="incomplete"):
            jax_distributed.initialize(**kw)
        with pytest.raises(ValueError, match="incomplete"):
            distributed.initialize(**kw)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="incomplete"):
        distributed.initialize()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")  # no MASTER_PORT
    with pytest.raises(ValueError, match="incomplete"):
        distributed.initialize()
    from avcer_tpu_torch.parallel.launch_sim import free_port

    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        assert distributed.initialize(backend="gloo") is True
        assert distributed.initialize() is True
        assert distributed.process_count() == 1 and not distributed.is_multiprocess()
    finally:
        distributed.shutdown()


def test_sharding_helpers_match_jax():
    """``shard_videos`` and ``FileShardedSampler`` (uneven files, wrap
    padding without ``drop_last``) equal the JAX helpers for every process."""
    paths = [f"b_{i}.mp4" for i in range(5)] + [f"a_{i}.mp4" for i in range(6)]
    for pc in (1, 2, 3):
        for pi in range(pc):
            assert distributed.shard_videos(paths, pi, pc) == \
                jax_distributed.shard_videos(paths, pi, pc)

    def file_of(i):
        return f"f{i // 6}"

    for drop_last in (True, False):
        for pi in range(2):
            kw = dict(local_batch=4, process_index=pi, process_count=2, seed=3,
                      drop_last=drop_last)
            got = distributed.FileShardedSampler(30, file_of, **kw)
            want = jax_distributed.FileShardedSampler(30, file_of, **kw)
            np.testing.assert_array_equal(got.local_indices, want.local_indices)
            assert got.batches_per_epoch == want.batches_per_epoch
            for epoch in range(2):
                for a, b in zip(got.epoch(epoch), want.epoch(epoch)):
                    np.testing.assert_array_equal(a, b)
    local = np.arange(12).reshape(6, 2)
    mesh = mesh_lib.make_mesh(2, 1, CPU2)
    assert torch.equal(distributed.global_batch(mesh, local), torch.as_tensor(local))
    np.testing.assert_array_equal(distributed.local_rows(torch.as_tensor(local)), local)
