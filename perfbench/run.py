"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and clips from the seed, the pipeline built, one clip of
each length served), then ``--seconds`` of clips back to back, then (with
``--trace 1``) a few whole clips under the profiler, then the check of a
sample of the window's clips against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, ``breakdown`` (traced runs) and ``checks`` (each
number compared, with its limit). A machine without the CUDA devices the
cell asks for gets no result and a non-zero exit.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
