"""``correct`` separates: the program as configured passes, and the
control (the program in the next precision down) and every fault a cell
can have fail.  Small cells on the CPU, the harness's look for a card
skipped; the same runs on the card at the cells' own sizes are
``calibrate.py``'s."""
import numpy as np
import pytest

from portbench.calibrate import LOWER
from portbench.harness import run_cell

CELLS = ["tinyh.newton", "tinyg.sweep", "tinyh.ac"]


def _run(bench, cell, **kw):
    return run_cell(bench, cell, 2**31 + 77, 0.3, False, device="cpu",
                    log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(tiny_bench, cell):
    out = _run(tiny_bench, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["berr_max"]["value"] < 1e-14


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_bench, cell):
    w = tiny_bench.cell(cell)
    cfg, mix = tiny_bench.config(w["config"]), tiny_bench.traffic(w["traffic"])
    low = LOWER[cfg["dtypes"]["complex" if mix["values"] == "complex" else "real"]]
    out = _run(tiny_bench, cell, overrides={"dtype": low})
    assert not out["correct"]
    assert out["checks"]["berr_max"]["value"] > out["checks"]["berr_max"]["limit"]


def _stale(monkeypatch):
    """A step that returns its state unchanged: every factorization after
    the first keeps the old factors."""
    from repro_torch import GLU

    for name in ("factorize", "factorize_batched"):
        real = getattr(GLU, name)

        def stale(self, *a, _real=real, **k):
            if getattr(self, "_faulted", False):
                return self
            self._faulted = True
            return _real(self, *a, **k)

        monkeypatch.setattr(GLU, name, stale)


def _half_batch(monkeypatch):
    """Half of the batch left out: its rows come back as the other half's."""
    from repro_torch import GLU

    real = GLU.refactorize_solve

    def half(self, *a, **k):
        x = real(self, *a, **k)
        h = len(x) // 2
        x[h:2 * h] = x[:h]
        return x

    monkeypatch.setattr(GLU, "refactorize_solve", half)


def _altered(monkeypatch):
    """One answer altered where it is produced: the first window call's
    solution, one entry moved by a part in a million."""
    from repro_torch import GLU

    calls = {"n": 0}
    for name in ("solve", "refactorize_solve"):
        real = getattr(GLU, name)

        def altered(self, *a, _real=real, **k):
            x = _real(self, *a, **k)
            calls["n"] += 1
            if calls["n"] == 2:            # the warm call is the first
                x[(0,) * np.ndim(x)] *= 1 + 1e-6
            return x

        monkeypatch.setattr(GLU, name, altered)


FAULTS = [(c, f) for c in CELLS for f in (_stale, _altered)] + \
         [(c, _half_batch) for c in ("tinyg.sweep", "tinyh.ac")]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(tiny_bench, cell)
    assert not out["correct"]


def test_card_run(tiny_bench, card):
    """The small cells on the card, through the same harness."""
    for cell in CELLS:
        out = run_cell(tiny_bench, cell, 5, 0.5, True, device="cuda",
                       log=lambda *a, **k: None)
        assert out["correct"] and out["device"]["platform"] == "gpu"
