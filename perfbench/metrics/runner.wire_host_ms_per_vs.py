"""Host milliseconds a video-second in ``DetectStage.prepare_wire``: the
letterbox and the I420 conversion on the runner's prefetch thread, over the
window (span ``runner.wire``)."""

LAYER = "runner"
UNIT = "ms/video-s"
MOVES = "video_s_per_s"


def read(obs):
    if "runner.wire" not in obs.host or not obs.window["video_s"]:
        return None
    return 1e3 * obs.host["runner.wire"] / obs.window["video_s"]
