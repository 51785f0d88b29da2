"""The port's tracer (``avcer_tpu_torch.utils.trace``) on the CPU: nothing
recorded without a profiler, spans on the profiler's clock with their
parents, threads and clips under one, a small ``Pipeline.run`` under
``cli.profiled`` with the spans and counts it should give, the set-up spans
of ``build_pipeline``, and the join of spans with device intervals."""

import concurrent.futures
import contextvars
import json
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avcer_tpu_torch.core import registry
from avcer_tpu_torch.core.config import (AudioConfig, DetectorConfig, PipelineConfig,
                                         VisualConfig)
from avcer_tpu_torch.models.audio_heads import ExprModel
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.models.wavlm import WavLMConfig
from avcer_tpu_torch.pipeline.audio_stage import AudioStage
from avcer_tpu_torch.pipeline import media
from avcer_tpu_torch.pipeline.visual import build_temporal_plan
from avcer_tpu_torch.utils import trace

from test_torch_models import TINY_W2V2

torch.set_num_threads(2)

H, W, N_FRAMES, FPS = 72, 128, 20, 25
DET_BATCH = 8
#: the serving thread's spans of a clip on the device path (stride 1, fused)
SERVING = {"clip", "detect.upload", "detect.rebuild", "detect.network", "detect.decode", "k3",
           "k4", "runner.fetch", "runner.track", "runner.chunk", "visual.static",
           "visual.upload", "visual.fetch", "visual.dynamic", "runner.audio_wait", "fusion",
           "runner.save"}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_nothing_is_recorded(monkeypatch):
    """No profiler: ``span`` and ``clip`` give the shared no-op, enter no
    ``record_function``, and counters and attributes go nowhere."""

    def refused(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(trace._profiler, "record_function", refused)
    before = len(trace.spans()), len(trace.clips())
    with trace.clip() as c, trace.span("detect.upload", n=1) as sp:
        trace.count("detect.upload_bytes", 10)
        trace.annotate("detect.upload", x=1)
        assert not sp and sp is trace.NULL and c is trace.NULL
    assert (len(trace.spans()), len(trace.clips())) == before


def test_parents_threads_and_clips_under_a_profiler():
    """Under a CPU profiler: a span's parent is the innermost span open on
    its own thread; the prefetch thread and a worker given a copied context
    carry the clip's id; counters from every thread reach the clip."""
    with cpu_profile():
        with trace.clip() as c:
            with trace.span("outer"):
                with trace.span("inner") as inner:
                    inner.note(shape=(1, 2))
                trace.count("n", 2)

            def produce():
                for i in range(3):
                    with trace.span("prefetched"):
                        trace.count("n", 1)
                    yield i

            assert list(media.prefetch_iter(produce())) == [0, 1, 2]
            with concurrent.futures.ThreadPoolExecutor(1) as ex:
                ex.submit(contextvars.copy_context().run, trace.count, "n", 10).result()
    by = {s.name: s for s in trace.spans() if s.clip == c.id}
    assert by["clip"].id == c.id and by["clip"].parent is None
    assert by["outer"].parent == c.id and by["inner"].parent == by["outer"].id
    assert by["inner"].attrs == {"shape": (1, 2)}
    main = threading.get_ident()
    assert by["outer"].thread == by["inner"].thread == c.thread == main
    pre = [s for s in trace.spans() if s.name == "prefetched" and s.clip == c.id]
    assert len(pre) == 3 and all(s.thread != main and s.parent is None for s in pre)
    assert c.counts == {"n": 15}
    assert c.start <= by["outer"].start <= by["inner"].start <= by["inner"].end \
        <= by["outer"].end <= c.end


def test_counters_and_spans_of_many_threads_are_all_kept():
    """Sixteen threads given the clip's context count into it and record
    spans at once, the interpreter switching threads every microsecond: no
    update and no span is lost."""
    import sys

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            with trace.clip() as c:
                def work():
                    for _ in range(200):
                        with trace.span("stress"):
                            trace.count("n", 1)

                threads = [threading.Thread(target=contextvars.copy_context().run, args=(work,))
                           for _ in range(16)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert c.counts == {"n": 16 * 200}
    assert sum(s.name == "stress" and s.clip == c.id for s in trace.spans()) == 16 * 200


def test_stamps_are_on_the_profilers_clock():
    """Each span's start lies within 50 us (median) of the start of its own
    ``avcer:`` range among the profiler's events."""
    with cpu_profile() as prof:
        made = []
        for i in range(200):
            with trace.span(f"stamp{i}") as sp:
                torch.ones(2).add_(1)
            made.append(sp)
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith(trace.PREFIX + "stamp")}
    gaps = [abs(starts[trace.PREFIX + s.name] - s.start) for s in made]
    assert len(gaps) == 200 and statistics.median(gaps) < 50_000


class FacedDetect:
    """The pipeline's own detect stage, whose detections are one centred face
    a frame (seeded weights find none)."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def unpack(self, packed_np, scale):
        det = self.inner.unpack(packed_np, scale)
        det.keep = np.zeros_like(det.keep)
        det.keep[:, 0] = True
        det.scores = np.array(det.scores)
        det.scores[:, 0] = 0.99
        det.boxes = np.array(det.boxes)
        det.boxes[:, 0] = [W * 0.3, H * 0.2, W * 0.7, H * 0.8]
        return det


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A small fused ``Pipeline.run`` on the I420 wire under ``cli.profiled``,
    the pipeline built without a profiler."""
    from avcer_tpu_torch.cli import run as cli
    from avcer_tpu_torch.pipeline.builder import build_pipeline

    tmp = tmp_path_factory.mktemp("traced")
    fused = dict(fused_layer1=True, fused_tails=True, fused_entries=True, fused_ssh=True,
                 fused_fpn=True)
    cfg = PipelineConfig(
        detector=DetectorConfig(batch_size=DET_BATCH, long_side=64, dtype="float32", **fused),
        visual=VisualConfig(batch_size=8, dtype="float32", fused=True, fused_entries=True),
        audio=AudioConfig(batch_size=4, dtype="float32"),
        weights_dir=str(tmp / "no_weights"), save_plot=False)
    built_from = len(trace.spans())
    pipe = build_pipeline(cfg, Wav2Vec2Config(**TINY_W2V2), device="cpu")
    built = trace.spans()[built_from:]
    pipe.detect = FacedDetect(pipe.detect)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (N_FRAMES, H, W, 3), np.uint8)
    wav = (rng.normal(size=int(N_FRAMES / FPS * 16000)) * 0.1).astype(np.float32)
    launches0 = trace.launches()
    with cli.profiled(str(tmp / "profile"), device="cpu"):
        result = pipe.run(media.ArrayReader(frames, FPS, "clip.avi"), str(tmp / "out"), wav=wav)
    launches1 = trace.launches()
    clip = trace.clips()[-1]
    spans = [s for s in trace.spans() if s.clip == clip.id]
    report = json.loads((tmp / "profile" / cli.SPANS_FILE).read_text())
    return dict(result=result, clip=clip, spans=spans, built=built, report=report,
                launches=(launches0, launches1))


def test_pipeline_run_gives_the_serving_threads_spans(traced_run):
    """The clip's spans: the serving thread's at every site of the device
    path, the wire on the prefetch thread, the audio half on its worker
    (the encoder's forward and its K2 calls inside it)."""
    clip, spans = traced_run["clip"], traced_run["spans"]
    serving = {s.name for s in spans if s.thread == clip.thread}
    assert serving - {"setup.fold", "setup.pack"} == SERVING
    others = {s.name for s in spans if s.thread != clip.thread}
    assert others == {"runner.wire", "audio", "audio.encode", "k2"}
    assert clip.attrs == {"video": "clip", "frames": N_FRAMES, "fps": FPS}
    ids = {s.id for s in spans}
    assert all(s.parent in ids for s in spans if s.name != "clip" and s.thread == clip.thread)
    k3 = [s for s in spans if s.name == "k3"]
    assert k3 and all({"shape", "dtype", "int8"} <= set(s.attrs) for s in k3)


def test_pipeline_run_counts(traced_run):
    """One ``detect.upload`` a detect batch and its bytes, the network's
    frames, a crop a present frame, the LSTM's windows, the audio windows,
    and the launch differences of the kernel wrappers."""
    result, clip, spans = traced_run["result"], traced_run["clip"], traced_run["spans"]
    batches = -(-N_FRAMES // DET_BATCH)
    uploads = [s for s in spans if s.name == "detect.upload"]
    assert len(uploads) == batches == sum(s.name == "runner.wire" for s in spans)
    assert clip.counts["detect.upload_bytes"] == batches * DET_BATCH * 36 * 3 // 2 * 64
    assert clip.counts["detect.frames"] == batches * DET_BATCH
    present = result.face_boxes[:, 0] >= 0
    assert present.all() and clip.counts["visual.crops"] == present.sum()
    plan = build_temporal_plan(present, registry.dynamic_step(FPS))
    assert clip.counts["visual.lstm_windows"] == plan.step_frames.size > 0
    assert clip.counts["audio.windows"] == len(result.audio_window_logits) > 0
    before, after = traced_run["launches"]
    assert clip.launches == {k: after[k] - before[k] for k in before}


def test_setup_spans_are_recorded_without_a_profiler(traced_run):
    """``build_pipeline`` is the span ``setup.build_pipeline`` with no
    profiler on; the folds of the fused sections are ``setup.fold`` spans
    inside the clip's detector and CNN spans."""
    built = [s for s in traced_run["built"] if s.name == "setup.build_pipeline"]
    assert len(built) == 1 and built[0].clip is None and built[0].seconds > 0
    folds = [s for s in traced_run["spans"] if s.name == "setup.fold"]
    assert folds and {s.attrs["model"] for s in folds} == {"ResNet50Body", "RetinaFace",
                                                        "EmotionResNet50"}


def test_profiled_writes_spans_json(traced_run):
    """``cli.profiled`` (``cli.run --profile_dir``) writes ``spans.json``:
    the clip with its spans by name (self time within total time, and on the
    CPU, which has no device, all of a serving span's self time idle), its
    counters and launches, and the process's set-up spans."""
    report, clip = traced_run["report"], traced_run["clip"]
    (row,) = [c for c in report["clips"] if c["id"] == clip.id]
    assert row["counts"] == clip.counts and row["launches"] == clip.launches
    assert set(row["spans"]) >= SERVING | {"runner.wire", "audio"}
    for name, s in row["spans"].items():
        assert 0 <= s["self_s"] <= s["total_s"] + 1e-9
        if s["thread"] == "serving":
            assert s["idle_s"] == pytest.approx(s["self_s"], abs=1e-6)
        else:
            assert s["idle_s"] is None
    assert row["busy_s"] == 0 and row["wall_s"] == pytest.approx(clip.seconds)
    assert sum(s["self_s"] for s in row["spans"].values() if s["thread"] == "serving") \
        == pytest.approx(row["wall_s"], rel=1e-6)
    assert "setup.build_pipeline" in report["setup"]


#: (spans, busy intervals, [start, stop], idle in each span's self time,
#: idle in no span)
JOINS = {
    "nested": ([(0, 10), (2, 6), (3, 4)], [(1, 3), (5, 7)], (0, 10),
               [1 + 3, 1, 1], 0),
    "siblings_and_outside": ([(1, 3), (4, 8)], [(2, 5)], (0, 10), [1, 3], 1 + 2),
    "busy_overlaps_and_clipped": ([(0, 10)], [(-5, 2), (1, 4), (6, 20)], (0, 10), [2], 0),
    "always_busy": ([(0, 4), (1, 2)], [(0, 4)], (0, 4), [0, 0], 0),
    "no_device": ([(0, 4), (1, 2)], [], (0, 5), [3, 1], 1),
}


@pytest.mark.parametrize("case", sorted(JOINS))
def test_idle_self_on_synthetic_intervals(case):
    """The join gives the known idle seconds in each span's self time."""
    spans, busy, (start, stop), want, outside = JOINS[case]
    idle, out = trace.idle_self(spans, busy, start, stop)
    assert idle == pytest.approx(want) and out == pytest.approx(outside)


def test_report_joins_a_clip_with_device_intervals():
    """``report`` on a clip and synthetic device intervals: the card's idle
    time under each serving-thread span, the clip's busy and idle seconds."""
    with cpu_profile():
        with trace.clip() as c:
            with trace.span("detect.upload") as up:
                pass
            with trace.span("runner.fetch"):
                pass
    # the card busy over all of the upload, idle everywhere else
    rep = trace.report([(up.start, up.end)], since=c.start)
    (row,) = [r for r in rep["clips"] if r["id"] == c.id]
    assert row["spans"]["detect.upload"]["idle_s"] == 0
    fetch = row["spans"]["runner.fetch"]
    assert fetch["idle_s"] == pytest.approx(fetch["self_s"])
    assert row["busy_s"] == pytest.approx(up.seconds)
    assert row["idle_s"] == pytest.approx(c.seconds - up.seconds)


#: a WavLM small enough for the CPU, with the published extractor's strides
#: (199 frames a 4 s window) and buckets
TINY_WAVLM = dict(TINY_W2V2, num_layers=3, num_buckets=320, max_bucket_distance=800)


def test_wavlm_through_the_audio_stage_records_its_spans_and_counts():
    """Under a CPU profiler, a tiny WavLM forward through ``AudioStage``
    records ``audio.encode`` once a batch (with its attributes) and ``k2``
    once a layer of each batch, every call biased, and nothing else; the
    counters ``k2.calls`` and ``k2.bias_calls`` count layers x batches. The
    same forward without a profiler records nothing."""
    cfg = WavLMConfig(**TINY_WAVLM)
    model = ExprModel("v3", 8, cfg).eval().requires_grad_(False)
    stage = AudioStage(model, AudioConfig(batch_size=2, dtype="float32", encoder="wavlm-large"),
                       device="cpu")
    wav = (np.random.default_rng(2).normal(size=int(1.2 * 16000)) * 0.1).astype(np.float32)
    before = len(trace.spans()), len(trace.clips())
    logits, windows = stage.run_from_wav(wav, FPS)
    assert (len(trace.spans()), len(trace.clips())) == before
    batches = -(-len(windows.spans) // 2)
    with cpu_profile():
        with trace.clip() as c:
            traced, _ = stage.run_from_wav(wav, FPS)
    np.testing.assert_array_equal(traced, logits)
    spans = [s for s in trace.spans() if s.clip == c.id and s.name != "clip"]
    assert {s.name for s in spans} == {"audio.encode", "k2"}
    encode = [s for s in spans if s.name == "audio.encode"]
    sizes = [min(2, len(windows.spans) - i) for i in range(0, len(windows.spans), 2)]
    assert len(encode) == batches == len(sizes) > 1
    assert [s.attrs for s in encode] == [
        dict(encoder="wavlm-large", layers=3, windows=n, frames=199) for n in sizes]
    k2 = [s for s in spans if s.name == "k2"]
    assert len(k2) == 3 * batches
    assert all(s.attrs["bias"] is True and s.attrs["t"] == 199 and s.attrs["d"] == 16
               and s.attrs["heads"] == 4 and s.attrs["nb"] == 320 for s in k2)
    assert {s.parent for s in k2} <= {s.id for s in encode}
    assert c.counts == {"k2.calls": 3 * batches, "k2.bias_calls": 3 * batches}
