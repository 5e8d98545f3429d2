"""PyTorch port, the paper's kernel-mode ablation (Table III):
``mode_override`` on ``GLU`` and ``TorchFactorizer``, ``disable_modes`` on
``TorchFactorizer``, against the JAX package's ``GLU(use_pallas=True,
mode_override=...)`` and ``JaxFactorizer(use_pallas=True,
disable_modes=...)`` on the CPU (Pallas in interpret mode).

Each level's route (the flat step or kernel K1) must equal the
reference's; factors must agree to 1e-10 and solutions to 1e-9 (the
reference's own tolerances for this path, tests/test_batched.py), on
``circuit_jacobian(200, avg_degree=6.0)``: a flat level, SEGMENTED and
PANEL levels and a dense tail.  ``kernels_disabled_reason`` says when K1
is off the path, and two variants on one plan never share built steps.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch
import repro_torch.sparse as tsparse
from repro.core.factorize import JaxFactorizer
from repro_torch.core import TorchFactorizer
from repro_torch.core.executor import ExecutableCache

FACT_TOL = 1e-10
SOLVE_TOL = 1e-9
MATRIX = dict(n=200, avg_degree=6.0, seed=0)
OVERRIDES = [None, "flat", "segmented", "panel"]
DISABLED = [(), ("flat",), ("segmented",), ("panel",), ("segmented", "panel"),
            ("flat", "segmented", "panel")]


@pytest.fixture(scope="module")
def pair():
    """The matrix in both packages, the reference GLU (its plan), the
    port's on the same plan, the scaled permuted values and a rhs."""
    Aj = jsparse.circuit_jacobian(**MATRIX)
    At = tsparse.circuit_jacobian(**MATRIX)
    gj = jcore.GLU(Aj, dtype=jnp.float64, use_pallas=True, plan_cache=None)
    sp = repro_torch.symbolic_plan_from_arrays(
        repro_torch.plan_to_arrays(gj.symbolic_plan))
    b = np.random.default_rng(3).normal(size=At.n)
    return dict(Aj=Aj, At=At, gj=gj, sp=sp, b=b,
                vals=np.asarray(gj._A_perm.data))


@pytest.fixture(scope="module")
def reference_routes(pair):
    """Per-level routes of the reference factorizer for each variant."""
    def routes(f):
        out = []
        for g in f._groups:
            if g.kind == "dense":
                out.append("dense")
            else:
                out += ["pallas" if g.kind == "pallas" else "flat"] * g.n_levels
        return tuple(out)

    out = {}
    for m in OVERRIDES:
        out[("override", m)] = routes(JaxFactorizer(
            pair["gj"].plan, dtype=jnp.float64, use_pallas=True,
            mode_override=m))
    for d in DISABLED:
        out[("disable", d)] = routes(JaxFactorizer(
            pair["gj"].plan, dtype=jnp.float64, use_pallas=True,
            disable_modes=d))
    return out


def test_variants_route_differently(reference_routes):
    """The matrix exercises every route: the variants do not all agree."""
    assert len(set(reference_routes.values())) >= 3
    assert "flat" in reference_routes[("override", None)]
    assert "pallas" in reference_routes[("override", None)]


@pytest.mark.parametrize("mode", OVERRIDES, ids=str)
def test_mode_override_routes(pair, reference_routes, mode):
    f = TorchFactorizer(pair["sp"].fplan, device="cpu", mode_override=mode)
    assert f.kinds == reference_routes[("override", mode)]


@pytest.mark.parametrize("disabled", DISABLED, ids=str)
def test_disable_modes_routes(pair, reference_routes, disabled):
    f = TorchFactorizer(pair["sp"].fplan, device="cpu",
                        disable_modes=disabled)
    assert f.kinds == reference_routes[("disable", disabled)]


@pytest.mark.parametrize("mode", OVERRIDES, ids=str)
def test_mode_override_glu_matches_reference(pair, mode):
    gj = jcore.GLU(pair["Aj"], dtype=jnp.float64, use_pallas=True,
                   mode_override=mode, plan_cache=None)
    gt = repro_torch.GLU.from_plan(pair["sp"], pair["At"], device="cpu",
                                   mode_override=mode)
    xj = gj.factorize().solve(pair["b"])
    xt = gt.factorize().solve(pair["b"])
    np.testing.assert_allclose(gt.factorized_values().numpy(),
                               np.asarray(gj.factorized_values()),
                               rtol=FACT_TOL, atol=FACT_TOL)
    np.testing.assert_allclose(xt, xj, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    assert gt.residual(pair["b"], xt) < 1e-9


@pytest.mark.parametrize("disabled", DISABLED, ids=str)
def test_disable_modes_factors_match_reference(pair, disabled):
    fj = JaxFactorizer(pair["gj"].plan, dtype=jnp.float64, use_pallas=True,
                       disable_modes=disabled)
    ft = TorchFactorizer(pair["sp"].fplan, device="cpu",
                         disable_modes=disabled)
    want = np.asarray(fj.factorize(pair["vals"]))
    got = ft.factorize(pair["vals"]).numpy()
    np.testing.assert_allclose(got, want, rtol=FACT_TOL, atol=FACT_TOL)
    default = TorchFactorizer(pair["sp"].fplan, device="cpu")
    np.testing.assert_allclose(got, default.factorize(pair["vals"]).numpy(),
                               rtol=FACT_TOL, atol=FACT_TOL)


@pytest.mark.parametrize("option,reason", [
    (dict(mode_override="flat"), "mode_override='flat'"),
    (dict(disable_modes=("segmented", "panel")), "disable_modes"),
    (dict(), "device='cpu'"),
    (dict(mode_override="segmented"), "device='cpu'"),
], ids=["allflat", "no-k1-modes", "default", "allsegmented"])
def test_kernels_disabled_reason(pair, option, reason):
    f = TorchFactorizer(pair["sp"].fplan, device="cpu", **option)
    assert f.kernels_disabled_reason is not None
    assert reason in f.kernels_disabled_reason
    if "mode_override" in option:
        g = repro_torch.GLU.from_plan(pair["sp"], pair["At"], device="cpu",
                                      **option)
        g.factorize()
        assert reason in g.solve_info["kernels_disabled_reason"]


def test_variants_never_share_built_steps(pair):
    """The schedule key holds the per-level kinds: two variants on one plan
    build their own steps, one variant twice builds once."""
    cache = ExecutableCache()
    plan = pair["sp"].fplan
    default = TorchFactorizer(plan, device="cpu", executable_cache=cache)
    noflat = TorchFactorizer(plan, device="cpu", executable_cache=cache,
                             disable_modes=("flat",))
    allflat = TorchFactorizer(plan, device="cpu", executable_cache=cache,
                              mode_override="flat")
    assert len({default.kinds, noflat.kinds, allflat.kinds}) == 3
    assert len(cache) == 3 and cache.stats.builds == 3
    assert len({id(f._sched) for f in (default, noflat, allflat)}) == 3
    again = TorchFactorizer(plan, device="cpu", executable_cache=cache,
                            disable_modes=("flat",))
    assert again._sched is noflat._sched and cache.stats.hits == 1
    twin = noflat.twin()
    assert twin._sched is noflat._sched and twin._buf is not noflat._buf


def test_bad_modes_raise(pair):
    with pytest.raises(ValueError, match="mode_override"):
        TorchFactorizer(pair["sp"].fplan, device="cpu", mode_override="dense")
    with pytest.raises(ValueError, match="disable_modes"):
        TorchFactorizer(pair["sp"].fplan, device="cpu",
                        disable_modes=("scan",))


def test_noflat_joins_the_flat_levels_into_the_run(pair):
    """``disable_modes=("flat",)`` puts every level before the tail that
    has updates into K1 runs (a level with none stays a flat step)."""
    plan = pair["sp"].fplan
    f = TorchFactorizer(plan, device="cpu", disable_modes=("flat",))
    assert "run" in f.step_kinds
    segs = plan.segments[:len(f.kinds) - 1]
    assert all(k == "pallas" for k, s in zip(f.kinds, segs) if s.n_upd)
    got = f.factorize(torch.as_tensor(pair["vals"]))
    assert torch.isfinite(got).all()
