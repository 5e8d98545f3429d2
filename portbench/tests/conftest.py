"""CPU tests of the benchmark harness.  ``tiny_bench`` copies the
benchmark's files into a temporary checkout and adds small cells to it by
new files and entries alone, as a later change would."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

LIMITS = {"berr_max": 1e-12, "ferr_max": 1e-8}


def add_cell(root: Path, cell: str, config: str, traffic: str, limits=LIMITS):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                              "chips": 1, "why": "a small CPU cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    (root / "portbench" / "limits" / f"{cell}.json").write_text(json.dumps(limits))


def add_config(root: Path, name: str, base: str, args: dict):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench" / "configs" / f"{base}.json").read_text())
    cfg["name"] = name
    cfg["matrix"]["args"].update(args)
    path = f"portbench/configs/{name}.json"
    (root / path).write_text(json.dumps(cfg))
    spec["configs"].append({"name": name, "source": cfg["source"], "file": path,
                            "reduced": [], "why": "a small CPU configuration"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


@pytest.fixture
def tiny_bench(tmp_path):
    """A checkout with three small cells: ``tinyh.newton``, ``tinyg.sweep``
    and ``tinyh.ac`` (a 10 x 6 grid, an 8 x 8 grid)."""
    from portbench.harness import Bench

    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    add_config(root, "tinyh", "grid128", {"nx": 10, "ny": 6, "seed": 4})
    add_config(root, "tinyg", "grid128", {"nx": 8, "ny": 8})
    add_cell(root, "tinyh.newton", "tinyh", "newton")
    add_cell(root, "tinyg.sweep", "tinyg", "sweep")
    add_cell(root, "tinyh.ac", "tinyh", "ac")
    return Bench(root)


@pytest.fixture
def card():
    """Skips without a CUDA device; decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
