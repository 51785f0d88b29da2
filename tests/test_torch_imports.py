"""The port's import rule, checked on the sources: no module of
avcer_tpu_torch, nor chip_smoke.py, imports jax, flax or anything of the JAX
package (``avcer_tpu_torch`` itself is not ``avcer_tpu``)."""

import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|avcer_tpu)(\s|\.|,|$)|from\s+(jax|flax|avcer_tpu)(\s|\.))")
SOURCES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "avcer_tpu_torch").rglob("*.py"))
SOURCES.append("chip_smoke.py")


def test_sources_found():
    assert len(SOURCES) > 30 and "avcer_tpu_torch/core/config.py" in SOURCES


@pytest.mark.parametrize("line,hit", [
    ("import jax", True), ("import jax.numpy as jnp", True), ("    from jax import lax", True),
    ("from flax import linen", True), ("import avcer_tpu", True),
    ("from avcer_tpu.core import registry", True), ("from avcer_tpu import ops", True),
    ("import numpy, avcer_tpu", False),  # not written that way anywhere; see below
    ("from avcer_tpu_torch.core import registry", False), ("import avcer_tpu_torch", False),
    ("# import jax here would break the rule", False), ("import jaxtyping", False),
])
def test_pattern(line, hit):
    assert bool(FORBIDDEN.search(line)) is hit


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for rel in SOURCES:
        for no, line in enumerate((ROOT / rel).read_text().splitlines(), 1):
            # one import per statement in these sources: a second name after a
            # comma would escape the pattern, so refuse the comma form outright
            if FORBIDDEN.search(line) or re.match(r"^\s*import\s+\w[\w.]*\s*,", line):
                bad.append(f"{rel}:{no}: {line.strip()}")
    assert not bad, "\n".join(bad)
