"""A configuration, a traffic mix, a metric and a cell are added as new
files and entries alone, and the harness resolves them: no file the
benchmark already has changes."""
import hashlib
import json

from conftest import ROOT, add_cell, add_config

from portbench.harness import run_cell


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "tests" not in p.parts and "__pycache__" not in p.parts}


def test_new_files_and_entries_only(tiny_bench):
    root = tiny_bench.root
    before = _digests(ROOT)
    add_config(root, "grid5x7", "grid128", {"nx": 5, "ny": 7})
    mix = json.loads((root / "portbench/traffic/newton.json").read_text())
    mix.update(pool=5, refine=1)
    (root / "portbench/traffic/newton_refined.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/calls_per_s.py").write_text(
        '"""Calls a second."""\n\n\ndef read(rec):\n'
        '    return rec["calls"] / rec["window_s"]\n')
    add_cell(root, "grid5x7.newton_refined", "grid5x7", "newton_refined")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["grid5x7.newton_refined"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    from portbench.harness import Bench

    out = run_cell(Bench(root), "grid5x7.newton_refined", 3, 0.3, False, device="cpu",
                   log=lambda *a, **k: None)
    assert out["correct"]
    assert set(out["metrics"]) == {"setup_s", "systems_per_s", "calls_per_s"}
    assert out["metrics"]["calls_per_s"]["unit"] == "calls/s"
    assert out["metrics"]["calls_per_s"]["value"] > 0
    copied = {k: v for k, v in _digests(root).items() if k in before}
    assert copied == before                          # nothing that was there changed
    assert set(_digests(root)) - set(before) >= {
        "portbench/configs/grid5x7.json", "portbench/traffic/newton_refined.json",
        "portbench/metrics/calls_per_s.py", "portbench/limits/grid5x7.newton_refined.json"}


def test_every_named_file_exists():
    """Every name in BENCHMARK.json leads to its file."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
