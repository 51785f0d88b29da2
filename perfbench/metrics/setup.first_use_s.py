"""Seconds in the program's set-up spans outside ``setup.build_pipeline``:
what the first clips pay once a process (``setup.kernel_load``: a kernel
library built with nvcc or loaded; ``setup.fold``: a fused section's folded
weights; ``setup.pack``: int8 weights packed; ``setup.occupancy``: the
card's occupancy of a launch configuration). A set-up span inside another is
counted once, in the outer one."""

LAYER = "setup"
UNIT = "s"
MOVES = "setup_s"


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    spans = trace.spans()
    by_id = {s.id: s for s in spans}

    def inside_setup(s) -> bool:
        parent = by_id.get(s.parent)
        while parent is not None:
            if parent.name.startswith(trace.SETUP):
                return True
            parent = by_id.get(parent.parent)
        return False

    setup = [s for s in spans if s.name.startswith(trace.SETUP)]
    if not setup:
        return None
    return sum(s.seconds for s in setup
               if s.name != "setup.build_pipeline" and not inside_setup(s))
