"""The share of the profiled clips' detect batches that replayed the
detector's piecewise CUDA graphs (the program's counters
``detect.graph_replays`` and ``detect.graph_eager``): replayed / (replayed
+ eager). A batch that runs eagerly pays the launches of some two hundred
small operations on the serving thread. Nothing is read from a program
without those counters."""

LAYER = "detect"
UNIT = "%"
MOVES = "video_s_per_s"


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    if obs.profile is None:
        return None
    replayed = eager = 0
    for c in trace.clips():
        replayed += c.counts.get("detect.graph_replays", 0)
        eager += c.counts.get("detect.graph_eager", 0)
    if replayed + eager == 0:
        return None
    return 100.0 * replayed / (replayed + eager)
