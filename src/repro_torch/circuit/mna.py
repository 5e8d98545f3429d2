"""Modified nodal analysis (MNA) assembly.

Node 0 is ground and is eliminated.  Supported elements: resistors,
capacitors (backward-Euler companion model), DC/time-varying current
sources, AC small-signal current sources, and diodes (Newton companion
model).  The sparsity pattern is fixed across time steps and Newton
iterations — assembly produces a new value vector on the same pattern,
which is exactly the contract ``GLU.factorize(new_values)`` exposes (the
paper's SPICE use case).

``assemble_ac`` produces the AC small-signal systems ``A(w) = G + jwC``
(complex128) for a whole frequency sweep on that same fixed pattern: one
symbolic plan, one complex value vector per frequency point — the batched
refactorization workload.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..sparse.csc import CSC, csc_from_coo

__all__ = ["Circuit", "rc_grid_circuit"]


@dataclasses.dataclass
class _Stamp:
    rows: np.ndarray   # flat CSC entry position of each stamp contribution
    sign: np.ndarray   # +1 / -1
    elem: np.ndarray   # element index the contribution belongs to


class Circuit:
    """Element-stamp container with fixed-pattern fast assembly."""

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes          # including ground (node 0)
        self.n = n_nodes - 1            # unknowns
        self.resistors: list[tuple[int, int, float]] = []
        self.capacitors: list[tuple[int, int, float]] = []
        self.isources: list[tuple[int, int, Callable[[float], float]]] = []
        self.ac_isources: list[tuple[int, int, complex]] = []
        self.diodes: list[tuple[int, int, float, float]] = []
        self._pattern: Optional[CSC] = None

    # -- element builders ----------------------------------------------------
    def _invalidate_pattern(self) -> None:
        """Drop the cached pattern/stamp maps: any element added after a
        ``pattern()`` call must be reflected by later assembly (a stale
        cache silently ignored post-pattern ``add_*`` calls)."""
        self._pattern = None

    def add_resistor(self, a: int, b: int, ohms: float) -> None:
        self.resistors.append((a, b, 1.0 / ohms))
        self._invalidate_pattern()

    def add_capacitor(self, a: int, b: int, farads: float) -> None:
        self.capacitors.append((a, b, farads))
        self._invalidate_pattern()

    def add_current_source(self, a: int, b: int, i_fn) -> None:
        """Current flows from node a to node b through the source."""
        fn = i_fn if callable(i_fn) else (lambda t, v=float(i_fn): v)
        self.isources.append((a, b, fn))
        self._invalidate_pattern()

    def add_ac_current_source(self, a: int, b: int, phasor=1.0) -> None:
        """Small-signal excitation for AC analysis: a current phasor
        flowing from node a to node b.  Ignored by transient assembly
        (AC sources are zero at the DC operating point by definition)."""
        self.ac_isources.append((a, b, complex(phasor)))
        self._invalidate_pattern()

    def add_diode(self, a: int, b: int, i_sat: float = 1e-12, v_t: float = 0.02585) -> None:
        self.diodes.append((a, b, i_sat, v_t))
        self._invalidate_pattern()

    # -- pattern -------------------------------------------------------------
    def _conductance_pairs(self):
        pairs = [(a, b) for a, b, _ in self.resistors]
        pairs += [(a, b) for a, b, _ in self.capacitors]
        pairs += [(a, b, ) for a, b, *_ in self.diodes]
        return pairs

    def pattern(self) -> CSC:
        """Union sparsity pattern of all stamps (values = small placeholder)."""
        if self._pattern is not None:
            return self._pattern
        rows, cols = [], []
        for a, b in self._conductance_pairs():
            for (x, y) in ((a, a), (b, b), (a, b), (b, a)):
                if x > 0 and y > 0:
                    rows.append(x - 1)
                    cols.append(y - 1)
        # keep the diagonal structurally present for every node
        rows.extend(range(self.n))
        cols.extend(range(self.n))
        vals = np.ones(len(rows), dtype=np.float64)
        self._pattern = csc_from_coo(self.n, rows, cols, vals)
        # value placeholder 1.0 is irrelevant; only structure is used
        self._build_stamp_maps()
        return self._pattern

    def _entry_pos(self, i: int, j: int) -> int:
        p = self._pattern.value_index(i, j)
        assert p >= 0
        return p

    def _build_stamp_maps(self) -> None:
        """Precompute flat positions for each element's 4-point stamp."""
        def quad_positions(pairs):
            pos, sign, elem = [], [], []
            for e, (a, b) in enumerate(pairs):
                for (x, y, s) in ((a, a, 1.0), (b, b, 1.0), (a, b, -1.0), (b, a, -1.0)):
                    if x > 0 and y > 0:
                        pos.append(self._entry_pos(x - 1, y - 1))
                        sign.append(s)
                        elem.append(e)
            return _Stamp(np.asarray(pos, np.int64), np.asarray(sign), np.asarray(elem, np.int64))

        self._r_stamp = quad_positions([(a, b) for a, b, _ in self.resistors])
        self._c_stamp = quad_positions([(a, b) for a, b, _ in self.capacitors])
        self._d_stamp = quad_positions([(a, b) for a, b, *_ in self.diodes])

    # -- assembly --------------------------------------------------------------
    @staticmethod
    def _diode_vd(a: int, b: int, v: np.ndarray) -> float:
        """Clipped diode junction voltage at iterate ``v`` (the clip window
        keeps exp() finite during Newton transients)."""
        va = v[a - 1] if a > 0 else 0.0
        vb = v[b - 1] if b > 0 else 0.0
        return float(np.clip(va - vb, -5.0, 0.8))

    @staticmethod
    def _diode_gd(vd: float, isat: float, vt: float) -> float:
        """Companion-model conductance Gd = Is/Vt exp(vd/Vt) — shared by the
        transient Newton stamps and the AC small-signal linearization."""
        return isat / vt * np.exp(vd / vt)

    def assemble(self, v: np.ndarray, v_prev: np.ndarray, dt: float, t: float):
        """Values (CSC entry order) + rhs for one Newton iterate at time t.

        ``v`` is the current Newton iterate of node voltages (ground
        excluded), ``v_prev`` the solution at the previous time point.
        """
        pat = self.pattern()
        vals = np.zeros(pat.nnz, dtype=np.float64)
        rhs = np.zeros(self.n, dtype=np.float64)

        def vnode(x, arr):
            return arr[x - 1] if x > 0 else 0.0

        # resistors
        if self.resistors:
            g = np.asarray([g for *_ab, g in self.resistors])
            st = self._r_stamp
            np.add.at(vals, st.rows, st.sign * g[st.elem])
        # capacitors (backward Euler): Geq = C/dt, Ieq = Geq * v_prev(a,b)
        if self.capacitors and dt > 0:
            c = np.asarray([c for *_ab, c in self.capacitors])
            geq = c / dt
            st = self._c_stamp
            np.add.at(vals, st.rows, st.sign * geq[st.elem])
            for e, (a, b, _) in enumerate(self.capacitors):
                vab = vnode(a, v_prev) - vnode(b, v_prev)
                ieq = geq[e] * vab
                if a > 0:
                    rhs[a - 1] += ieq
                if b > 0:
                    rhs[b - 1] -= ieq
        # diodes (Newton companion): Gd = Is/Vt exp(vd/Vt), Ieq = Id - Gd vd
        if self.diodes:
            gd = np.empty(len(self.diodes))
            for e, (a, b, isat, vt) in enumerate(self.diodes):
                vd = self._diode_vd(a, b, v)
                g = self._diode_gd(vd, isat, vt)
                i_d = g * vt - isat      # = Is (exp(vd/Vt) - 1), one exp
                gd[e] = g
                ieq = i_d - g * vd
                if a > 0:
                    rhs[a - 1] -= ieq
                if b > 0:
                    rhs[b - 1] += ieq
            st = self._d_stamp
            np.add.at(vals, st.rows, st.sign * gd[st.elem])
        # current sources
        for a, b, fn in self.isources:
            i = fn(t)
            if a > 0:
                rhs[a - 1] -= i
            if b > 0:
                rhs[b - 1] += i
        return vals, rhs

    def assemble_ac(self, v_op: np.ndarray, freqs):
        """AC small-signal systems ``A(w) = G + jwC`` for a frequency sweep.

        ``v_op`` is the DC operating point (ground excluded): resistors and
        the diode companion conductances linearized there stamp ``G``,
        capacitors stamp ``C`` (the physical farads, not the backward-Euler
        ``C/dt``), and the AC current sources build the complex excitation.
        Returns ``(vals, rhs)``: ``vals`` is (F, nnz) complex128 — one value
        vector per frequency on the SAME pattern transient assembly uses —
        and ``rhs`` is (F, n) complex128 (frequency-independent phasors,
        broadcast per point).
        """
        pat = self.pattern()
        omega = 2.0 * np.pi * np.atleast_1d(np.asarray(freqs, dtype=np.float64))
        g_vals = np.zeros(pat.nnz, dtype=np.float64)
        c_vals = np.zeros(pat.nnz, dtype=np.float64)

        if self.resistors:
            g = np.asarray([g for *_ab, g in self.resistors])
            st = self._r_stamp
            np.add.at(g_vals, st.rows, st.sign * g[st.elem])
        if self.diodes:
            # small-signal conductance at the operating point: the same
            # companion-model Gd the transient Newton stamps use
            gd = np.empty(len(self.diodes))
            for e, (a, b, isat, vt) in enumerate(self.diodes):
                gd[e] = self._diode_gd(self._diode_vd(a, b, v_op), isat, vt)
            st = self._d_stamp
            np.add.at(g_vals, st.rows, st.sign * gd[st.elem])
        if self.capacitors:
            c = np.asarray([c for *_ab, c in self.capacitors])
            st = self._c_stamp
            np.add.at(c_vals, st.rows, st.sign * c[st.elem])

        vals = g_vals[None, :] + 1j * omega[:, None] * c_vals[None, :]
        rhs1 = np.zeros(self.n, dtype=np.complex128)
        for a, b, phasor in self.ac_isources:
            if a > 0:
                rhs1[a - 1] -= phasor
            if b > 0:
                rhs1[b - 1] += phasor
        rhs = np.broadcast_to(rhs1, (len(omega), self.n)).copy()
        return vals, rhs


def rc_grid_circuit(nx: int, ny: int, with_diodes: bool = True, seed: int = 0) -> Circuit:
    """Power-grid-flavoured test circuit: resistor mesh, capacitors to ground,
    switching current loads, and clamp diodes on a subset of nodes."""
    rng = np.random.default_rng(seed)
    n_nodes = nx * ny + 1
    ckt = Circuit(n_nodes)
    node = lambda x, y: 1 + y * nx + x
    for y in range(ny):
        for x in range(nx):
            if x + 1 < nx:
                ckt.add_resistor(node(x, y), node(x + 1, y), float(rng.uniform(0.5, 2.0)))
            if y + 1 < ny:
                ckt.add_resistor(node(x, y), node(x, y + 1), float(rng.uniform(0.5, 2.0)))
            ckt.add_resistor(node(x, y), 0, float(rng.uniform(50.0, 200.0)))
            ckt.add_capacitor(node(x, y), 0, float(rng.uniform(1e-3, 5e-3)))
    # switching loads on a few nodes
    for _ in range(max(2, nx * ny // 16)):
        tgt = int(rng.integers(1, n_nodes))
        amp = float(rng.uniform(0.05, 0.2))
        freq = float(rng.uniform(1.0, 5.0))
        ckt.add_current_source(tgt, 0, lambda t, a=amp, f=freq: a * (np.sin(2 * np.pi * f * t) > 0))
    if with_diodes:
        for _ in range(max(1, nx * ny // 32)):
            tgt = int(rng.integers(1, n_nodes))
            ckt.add_diode(tgt, 0)
    return ckt
