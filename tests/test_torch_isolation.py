"""The PyTorch port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, checked by reading the
sources and by importing the port in a fresh interpreter."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
SOURCES.append("chip_smoke.py")

FORBIDDEN = re.compile(
    r"\bimport\s+jax\b|\bfrom\s+jax\b"
    r"|\bfrom\s+repro\b(?!_torch)|\bimport\s+repro\b(?!_torch)|\brepro\.")


@pytest.mark.parametrize("rel", SOURCES)
def test_source_names_neither_jax_nor_reference(rel):
    text = (ROOT / rel).read_text()
    hits = [f"{i}: {line.strip()}" for i, line in enumerate(text.splitlines(), 1)
            if FORBIDDEN.search(line)]
    assert not hits, f"{rel} reaches JAX or the JAX package:\n" + "\n".join(hits)


def test_port_imports_without_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.convert, repro_torch.sparse\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
