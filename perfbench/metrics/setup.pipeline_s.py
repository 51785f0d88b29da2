"""Seconds in the program's span ``setup.build_pipeline``: the models built
at full width, their weights loaded and placed on the card in the compute
dtype, the stages made (int8 scales seeded where a stage is int8)."""

LAYER = "setup"
UNIT = "s"
MOVES = "setup_s"


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    spans = [s for s in trace.spans() if s.name == "setup.build_pipeline"]
    if not spans:
        return None
    return sum(s.seconds for s in spans)
