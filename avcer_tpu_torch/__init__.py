"""PyTorch / CUDA port of avcer_tpu for one NVIDIA H100.

The package mirrors ``avcer_tpu``'s module paths so each counterpart is easy
to find, and keeps its public layouts (NHWC frames, ``[B, A, 4|2|10]``
detector head rows, ``[B, H, T, D]`` attention operands).

Import rule: this package imports ``torch`` and never ``jax``, ``flax`` or
anything of ``avcer_tpu``. It keeps its own copies of the four jax-free
modules it needs: ``core.config`` (the dataclasses), ``core.registry``,
``pipeline.tracker`` and ``utils.viz``.

Kernels: every Pallas kernel on the ported path is a CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built at first use by ``_build``. Each wrapper in
``ops/cuda/`` takes its plain PyTorch version for a CPU tensor and launches
the kernel (or raises) for a CUDA tensor; nothing falls back.
"""
