"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and a configuration's matrix, makes every value set
and right-hand side a run will send from ``--seed``, and drives one call of
the port's public API.

A mix's keys:

- ``call``: ``"factorize_solve"``, one matrix a call, ``GLU.factorize``
  then ``GLU.solve`` (a Newton iterate); or ``"refactorize_solve"``, a
  batch a call through ``GLU.refactorize_solve`` (a sweep).
- ``values``: ``"real"``, each system the configuration's matrix moved once
  by the ``perturb`` rule; or ``"complex"``, ``G + jwC`` with G and C each
  moved once a call and one system for each of ``points`` frequencies
  log-spaced over ``omega_log10``.
- ``batch``: systems a call of real values (1 for ``factorize_solve``).
- ``pool``: calls' worth of distinct values made in set-up; call i sends
  pool entry i modulo ``pool``, so no call repeats the previous values.
- ``rhs``: ``"dense"``, every entry drawn from the seed; or ``"sources"``,
  ``sources`` nodes chosen by ``source_seed`` (the same for every run
  seed, so every seed does the same work), values from the seed, passed to
  the solve as its ``rhs_pattern``.
- ``refine``: refinement sweeps a solve may take.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from portbench.matrix import Matrix


@dataclasses.dataclass
class Traffic:
    mix: dict
    matrix: Matrix                # the pattern and the values the plan is built on
    values: list                  # per pool entry: (B, nnz)
    rhs: list                     # per pool entry: (B, n)
    rhs_pattern: Optional[np.ndarray]
    refine: int

    @property
    def batch(self) -> int:
        return int(self.values[0].shape[0])

    @property
    def single(self) -> bool:
        return self.mix["call"] == "factorize_solve"

    @property
    def complex_values(self) -> bool:
        return bool(np.iscomplexobj(self.values[0]))


def _draw_rhs(rng, shape, complex_values: bool) -> np.ndarray:
    b = rng.standard_normal(shape)
    if complex_values:
        b = b + 1j * rng.standard_normal(shape)
    return b


def make(mix: dict, config: dict, load_rule: Callable, seed: int) -> Traffic:
    """Every input of a run, from ``seed``: ``load_rule(name)`` is the
    module of ``rules/<name>.py``."""
    spec = config["matrix"]
    G = load_rule(spec["rule"]).build(**spec["args"])
    perturb = load_rule(mix["perturb"]).perturb
    rng = np.random.default_rng(seed)
    pool = int(mix["pool"])
    if mix["call"] not in ("factorize_solve", "refactorize_solve"):
        raise ValueError(f"unknown call {mix['call']!r}")
    if mix["values"] == "real":
        batch = 1 if mix["call"] == "factorize_solve" else int(mix["batch"])
        base = G
        values = [np.stack([perturb(G, G.data, rng) for _ in range(batch)])
                  for _ in range(pool)]
    elif mix["values"] == "complex":
        cap = config["capacitance"]
        c = load_rule(cap["rule"]).build(G, **cap["args"])
        base = Matrix(G.n, G.indptr, G.indices, G.data + 1j * float(cap["omega"]) * c)
        omegas = np.logspace(*mix["omega_log10"], int(mix["points"]))
        values = []
        for _ in range(pool):
            g, cc = perturb(G, G.data, rng), perturb(G, c, rng)
            values.append(g[None, :] + 1j * omegas[:, None] * cc[None, :])
    else:
        raise ValueError(f"unknown values {mix['values']!r}")
    complex_values = bool(np.iscomplexobj(values[0]))
    shape = (values[0].shape[0], G.n)
    pattern = None
    if mix["rhs"] == "dense":
        rhs = [_draw_rhs(rng, shape, complex_values) for _ in range(pool)]
    elif mix["rhs"] == "sources":
        pattern = np.sort(np.random.default_rng(int(mix["source_seed"])).choice(
            G.n, size=int(mix["sources"]), replace=False))
        rhs = []
        for _ in range(pool):
            b = np.zeros(shape, dtype=values[0].dtype)
            b[:, pattern] = _draw_rhs(rng, (shape[0], len(pattern)), complex_values)
            rhs.append(b)
    else:
        raise ValueError(f"unknown rhs {mix['rhs']!r}")
    return Traffic(mix, base, values, rhs, pattern, int(mix.get("refine", 0)))


def call(glu, t: Traffic, p: int) -> np.ndarray:
    """One call of the timed path with pool entry ``p``: (B, n) answers."""
    if t.single:
        glu.factorize(t.values[p][0])
        return glu.solve(t.rhs[p][0], refine=t.refine,
                         rhs_pattern=t.rhs_pattern)[None]
    return glu.refactorize_solve(t.values[p], t.rhs[p], refine=t.refine,
                                 rhs_pattern=t.rhs_pattern)


def call_split(glu, t: Traffic, p: int, between: Callable[[], None]) -> np.ndarray:
    """The same call as :func:`call`, as its two public calls with
    ``between()`` run after the factorization returns: the split
    ``refactorize_solve`` itself makes."""
    if t.single:
        glu.factorize(t.values[p][0])
        between()
        return glu.solve(t.rhs[p][0], refine=t.refine,
                         rhs_pattern=t.rhs_pattern)[None]
    glu.factorize_batched(t.values[p])
    between()
    return glu.solve_batched(t.rhs[p], refine=t.refine,
                             rhs_pattern=t.rhs_pattern)
