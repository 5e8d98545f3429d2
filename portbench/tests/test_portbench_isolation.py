"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is the port, ``repro`` the
JAX package), and the plain reference names nothing of the port."""
import re
import subprocess
import sys

from conftest import ROOT

from portbench.harness import FORBIDDEN

SNIPPET = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import portbench.run, portbench.harness, portbench.calibrate
from portbench.harness import Bench, run_cell
b = Bench()
for w in b.spec["workloads"]:
    cfg, mix = b.config(w["config"]), b.traffic(w["traffic"])
    b.rule(cfg["matrix"]["rule"]); b.rule(mix["perturb"])
    if "capacitance" in cfg:
        b.rule(cfg["capacitance"]["rule"])
for m in b.spec["end_to_end"] + b.spec["per_layer"]:
    b.reader(m["name"])
import repro_torch, repro_torch.core, repro_torch.sparse
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_nothing_loads_jax_or_the_jax_package():
    code = SNIPPET.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "portbench" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_a_run_loads_neither(tiny_bench):
    """A whole small run in a fresh interpreter, then its modules."""
    code = ("import sys, json\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from portbench.harness import Bench, run_cell, forbidden_modules\n"
            f"out = run_cell(Bench({str(tiny_bench.root)!r}), 'tinyh.newton', 1, 0.2, False,"
            " device='cpu', log=lambda *a, **k: None)\n"
            "print(json.dumps([out['correct'], forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


def test_reference_names_nothing_of_the_port():
    text = (ROOT / "portbench" / "reference.py").read_text()
    assert not re.search(r"repro|portbench\.(harness|workload|counting|tracing)", text)
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text, flags=re.M)
    assert set(imports) <= {"__future__", "numpy", "torch"}, imports


def test_forbidden_names_are_whole(monkeypatch):
    import portbench.harness as h

    monkeypatch.setitem(sys.modules, "repro_torchish", sys.modules["portbench"])
    assert h.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys.modules["portbench"])
    assert h.forbidden_modules() == ["repro"]
