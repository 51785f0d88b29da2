"""Host milliseconds a video-second in which the serving thread waits for
a result: the program's spans ``runner.fetch`` (a detect batch's packed
output to the host), ``visual.fetch`` (the emotion CNN's) and
``runner.audio_wait`` (the audio worker's result), on the thread that
served the clip, over the profiled clips."""

LAYER = "runner"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"
SPANS = ("runner.fetch", "visual.fetch", "runner.audio_wait")


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    p = obs.profile
    serving = {c.id: c.thread for c in trace.clips()}
    spans = [s for s in trace.spans()
             if s.name in SPANS and s.clip in serving and s.thread == serving[s.clip]]
    if p is None or not p.video_s or not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / p.video_s
