"""The detect stage's piecewise graphs (``models.piecewise``) on the CPU,
where nothing is captured: the detector's forward and decode, their K3 / K4
call sites marked as a capture marks them, give the stage's own result bit
for bit; every kernel call made through the ``retinaface`` module's
attributes; the routes that stay eager, counted; the device constants kept
per (h, w, device); the launch log that a replay counts again. The graphs
themselves are held against the eager route on the card
(``tests/test_torch_cuda.py``)."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avcer_tpu_torch.core.config import DetectorConfig
from avcer_tpu_torch.models import layers, piecewise, retinaface
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.ops.image import bgr_batch_to_i420, retinaface_normalize
from avcer_tpu_torch.parallel import mesh as mesh_lib
from avcer_tpu_torch.pipeline.detect import DetectStage, HostCopy
from avcer_tpu_torch.utils import trace

torch.set_num_threads(2)

FUSED = dict(fused_layer1=True, fused_tails=True, fused_entries=True, fused_ssh=True,
             fused_fpn=True)
#: name: (model switches, quant, K3 calls, K4 calls)
DETECTORS = {
    "r50_fused": (dict(FUSED), False, 5, 3),
    "r50_unfused": ({}, False, 0, 0),
    "mobilenet_fused": (dict(FUSED, backbone="mobilenet0.25"), False, 0, 3),
    "r50_int8_fused": (dict(FUSED), True, 5, 3),
}


def frames_of(seed: int, n: int = 2) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 255, (n, 64, 64, 3),
                                                                 np.uint8))


@pytest.fixture(scope="module")
def stages():
    out = {}
    for name, (switches, quant, *_) in DETECTORS.items():
        model = RetinaFace(quant=quant, **switches)
        layers.seeded_init_(model, torch.Generator().manual_seed(0))
        model.eval().requires_grad_(False)
        cfg = DetectorConfig(long_side=64, batch_size=2, dtype="float32",
                             backbone=model.backbone, quant="int8" if quant else "none")
        out[name] = DetectStage(cfg, model, device="cpu")
    return out


class Counted:
    """A kernel wrapper with a count of its calls."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args, **kwargs):
        self.n += 1
        return self.fn(*args, **kwargs)


@pytest.fixture
def counted(monkeypatch):
    k3, k4 = Counted(retinaface.fused_chain), Counted(retinaface.fused_ssh_heads)
    monkeypatch.setattr(retinaface, "fused_chain", k3)
    monkeypatch.setattr(retinaface, "fused_ssh_heads", k4)
    return k3, k4


class Marking:
    """Stands in for a capture on this thread (``piecewise.call`` hands it
    each kernel call): makes the call and keeps it as a ``piecewise._Call``,
    as a capture keeps the calls between its pieces."""

    def __init__(self):
        self.calls: list = []

    def eager_call(self, resolve, args, kwargs):
        out = resolve()(*args, **kwargs)
        self.calls.append(piecewise._Call(resolve, args, kwargs, out))
        return out


@pytest.mark.parametrize("name", list(DETECTORS))
def test_pieces_compose_to_forward_and_decode(stages, counted, name):
    """What a capture runs, its kernel calls marked (``piecewise.call``)
    and kept, against the model's forward and the stage's decode made
    directly: equal bits, and the calls where the model makes them (K3 and
    K4 in their order). A kept call made again, as a replay makes it, writes
    into the results it gave (``out=``) the same bits."""
    stage = stages[name]
    _, _, n_k3, n_k4 = DETECTORS[name]
    frames = frames_of(1)
    marking = Marking()
    with torch.inference_mode():
        want = stage._decode(frames, *stage.model(retinaface_normalize(frames)))
        counted[0].n = counted[1].n = 0
        piecewise._local.capture = marking
        try:
            got = stage._network_decode(stage.model, frames)
        finally:
            piecewise._local.capture = None
    assert torch.equal(got, want)
    assert (counted[0].n, counted[1].n) == (n_k3, n_k4)
    calls = marking.calls
    assert [c.resolve() for c in calls] == [counted[0]] * n_k3 + [counted[1]] * n_k4
    for c in calls:
        before = [t.clone() for t in ((c.out,) if torch.is_tensor(c.out) else c.out)]
        with torch.inference_mode():
            again = c()
        again = (again,) if torch.is_tensor(again) else again
        assert all(a is b for a, b in zip(again, (c.out,) if torch.is_tensor(c.out) else c.out))
        assert all(torch.equal(a, b) for a, b in zip(again, before))


@pytest.mark.parametrize("name", ["r50_fused", "mobilenet_fused"])
def test_forward_calls_the_kernels_through_the_module(stages, counted, name):
    """The stage's forward calls ``retinaface.fused_chain`` five times (none
    in the mobilenet body) and ``retinaface.fused_ssh_heads`` three times,
    looked up on the module at each call."""
    _, _, n_k3, n_k4 = DETECTORS[name]
    with torch.inference_mode():
        stages[name].forward(frames_of(2))
        stages[name].forward(frames_of(3))
    assert (counted[0].n, counted[1].n) == (2 * n_k3, 2 * n_k4)


@pytest.mark.parametrize("case", ["training", "calibrating", "cpu", "mesh"])
def test_eager_routes_are_counted(stages, case):
    """Training, calibrating, a mesh and a CPU tensor take the eager route:
    the reason given for the card (a device the CPU can name), and a batch
    served here counted as eager in the clip's ``detect.graph_eager``."""
    stage = stages["r50_unfused"]
    model = stage.model
    if case == "mesh":
        stage = DetectStage(stage.cfg, model, device="cpu",
                            mesh=mesh_lib.make_mesh(2, 1, ["cpu"] * 2))
    card = torch.device("cuda")
    assert stages["r50_unfused"].eager_reason(model, card) is None
    try:
        if case == "training":
            model.train()
        with profile(activities=[ProfilerActivity.CPU]), trace.clip() as clip:
            if case == "calibrating":
                with layers.calibrating(model):
                    reason = stage.eager_reason(model, card)
                    with torch.inference_mode():
                        stage._forward_shard(model, frames_of(4))
            else:
                reason = stage.eager_reason(model, torch.device("cpu") if case == "cpu"
                                            else card)
                with torch.inference_mode():
                    stage.forward(frames_of(4))
    finally:
        model.eval()
    assert reason == {"training": "training", "calibrating": "calibrating",
                      "cpu": "not on the card", "mesh": "a mesh"}[case]
    shards = 2 if case == "mesh" else 1
    assert clip.counts["detect.graph_eager"] == shards
    assert "detect.graph_replays" not in clip.counts
    assert "detect.graph_captures" not in clip.counts


def test_device_constants_are_kept_per_shape_and_device(stages):
    """The normalisation mean, the anchors and the decode's two scales are
    made once per (h, w, device), with the values the decode used to make
    at every batch."""
    stage = DetectStage(stages["r50_unfused"].cfg, stages["r50_unfused"].model, device="cpu")
    cpu = torch.device("cpu")
    first = stage._consts_for(64, 96, cpu)
    assert all(a is b for a, b in zip(first, stage._consts_for(64, 96, cpu)))
    other = stage._consts_for(96, 64, cpu)
    assert not any(a is b for a, b in zip(first, other))
    mean, priors, scale, lscale = first
    assert mean.tolist() == [104.0, 117.0, 123.0]
    assert scale.tolist() == [96, 64, 96, 64] and lscale.tolist() == [96, 64] * 5
    assert priors is stage._priors_for(64, 96, cpu)
    assert set(stage._consts) == {(64, 96, cpu), (96, 64, cpu)}
    frames = frames_of(5)
    assert torch.equal(retinaface_normalize(frames, mean=stage._consts_for(64, 64, cpu)[0]),
                       retinaface_normalize(frames))


def test_graphs_route_a_key_warm_then_capture_never_under_a_profiler():
    """A key's first batch is its warm-up (eager); the next asks to capture,
    except while a profiler records; each key warms up apart, on each
    thread apart, and ``clear`` makes every key warm up again."""
    graphs = piecewise.Graphs()
    assert graphs.route("k") == ("warm-up", None)
    with profile(activities=[ProfilerActivity.CPU]):
        assert graphs.route("k") == ("eager", None)
    assert graphs.route("k") == ("capture", None)
    assert graphs.route("other") == ("warm-up", None)
    graphs.clear()
    assert graphs.route("k") == ("warm-up", None)
    other: list = []
    thread = threading.Thread(target=lambda: other.append(graphs.route("k")))
    thread.start()
    thread.join()
    assert other == [("warm-up", None)] and graphs.route("k") == ("capture", None)


def test_launch_log_counts_a_replay_again():
    """A launch counted while a capture notes them (``launched``) is
    counted again by ``relaunched``, with its per-key dict."""
    def kernel():
        pass

    kernel.launches, kernel.launches_by_mode = 0, {}
    log: list = []
    trace.note_launches(log)
    try:
        trace.launched(kernel, launches_by_mode=True)
    finally:
        trace.note_launches(None)
    trace.launched(kernel, launches_by_mode=False)
    trace.relaunched(log)
    assert kernel.launches == 3 and kernel.launches_by_mode == {True: 2, False: 1}
    assert len(log) == 1


def test_wire_into_a_given_buffer_and_host_copy():
    """``bgr_batch_to_i420`` writes into a buffer it is given (the stage's
    pinned one on the card) the bytes it would make; ``HostCopy`` of a CPU
    tensor is that tensor's array."""
    frames = frames_of(6).numpy()
    buf = np.zeros((2, 96, 64), np.uint8)
    out = bgr_batch_to_i420(frames, out=buf)
    assert out is buf and np.array_equal(buf, bgr_batch_to_i420(frames))
    t = torch.arange(12.0).reshape(3, 4)
    assert np.array_equal(HostCopy(t).numpy(), t.numpy())
