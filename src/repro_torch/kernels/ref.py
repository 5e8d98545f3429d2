"""Plain PyTorch versions of every hand-written kernel in this package.

They run for CPU tensors (the wrappers in ``level_update.py`` and
``dense_lu.py`` route CPU tensors here) and serve as the kernels' oracles on
the card.  Each repeats its kernel's arithmetic in eager PyTorch and is no
yardstick of speed.

Sums that must repeat the kernels' bits run in fixed-order rounds of
distinct targets (``round_order`` / ``add_in_rounds_``, also the flat
levels' and the sweeps' scatter-add): each target adds its entries one by
one, in their order, starting from its current value, on any device.
Other scatter-adds go through ``scatter_add_``: PyTorch's sorted
scatter-add under deterministic mode, so equal inputs give equal bits on
the card too (on the card it sums a target's duplicates before adding them
to the target, so it is not the kernels' order).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import deterministic
from ..sparse.layout import pdiv, pmul

__all__ = ["segmented_accumulate_ref", "level_run_ref", "dense_lu_ref",
           "dense_lu_planar_ref", "lu_backward_error", "spmv_ref",
           "scatter_add_", "round_order", "add_in_rounds_", "perturb_diags"]


def scatter_add_(dst, idx, src):
    """``dst[idx] += src`` in place, duplicates summed in a fixed order.
    The sorted path serialises the duplicates of one index, so callers keep
    padding (many duplicates of one slot) out of ``idx``."""
    with deterministic():
        dst.index_put_((idx,), src, accumulate=True)
    return dst


def round_order(idx: np.ndarray):
    """Host-side order for a fixed-order scatter-add: ``(perm, bounds)`` such
    that round ``r``, ``perm[bounds[r]:bounds[r + 1]]``, holds the r-th entry
    of every target.  Within a round the targets are distinct, and each
    target meets its entries in their original order."""
    idx = np.asarray(idx)
    n = len(idx)
    if n == 0:
        return np.zeros(0, dtype=np.int64), [0]
    order = np.argsort(idx, kind="stable")
    srt = idx[order]
    first = np.concatenate([[True], srt[1:] != srt[:-1]])
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - start
    perm = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[perm], np.arange(int(rank.max()) + 2))
    return perm, [int(b) for b in bounds]


def add_in_rounds_(dst, idx, src, bounds, alpha: float = 1.0):
    """``dst[..., idx] += alpha * src`` for entries in :func:`round_order`:
    each round's targets are distinct, so every ``index_add_`` is exact and
    the sum order per target is the entries' original order, on any device
    and in any run.  ``dst`` is (n,) or a batch (B, n), ``src`` (k,) or
    (B, k): the batch adds each matrix's entries as one matrix alone.
    Complex tensors add on their re/im plane views: the same sums, through
    the real ``index_add_``."""
    dim = dst.dim() - 1
    target = torch.view_as_real(dst) if dst.is_complex() else dst
    if src.is_complex():
        src = torch.view_as_real(src)
    for s, e in zip(bounds[:-1], bounds[1:]):
        target.index_add_(dim, idx[s:e], src.narrow(dim, s, e - s),
                          alpha=alpha)
    return dst


def segmented_accumulate_ref(col_vals, contribs, didx_local):
    """Per-destination-column accumulation.

    col_vals:   (D, C)  current destination-column segments
    contribs:   (D, R)  update contributions (already -l*u)
    didx_local: (D, R)  position of each contribution within its row;
                        positions outside [0, C) are dropped
    returns     (D, C)  ``col_vals`` plus the contributions, summed in
                        ascending r per destination slot
    """
    D, C = col_vals.shape
    out = col_vals.clone()
    dl = didx_local.long()
    keep = (dl >= 0) & (dl < C)
    flat = dl + torch.arange(D, device=dl.device)[:, None] * C
    scatter_add_(out.view(-1), flat[keep], contribs[keep])
    return out


def _level_div(a, b):
    """``a / b`` as the level steps divide: IEEE division for real values,
    :func:`pdiv` on the re/im planes for complex ones (returned as planes)."""
    if a.is_complex():
        return pdiv(torch.view_as_real(a), torch.view_as_real(b))
    return a / b


def perturb_diags(vals, diag_idx, tau, native: bool = False):
    """Static pivot perturbation (SuperLU_DIST-style), in place on the value
    array ``vals``: any diagonal ``vals[diag_idx]`` with ``|d| < tau``
    becomes ``tau * d / |d|``, magnitude tau and phase kept (real values:
    ``sign(d) * tau``; an exact zero becomes ``+tau``).  ``tau`` is a 0-d
    tensor of the values' real dtype.  Complex values follow the
    reference's planar rule (``_perturb_diags_planar_body``): ``|d|`` is
    ``hypot(re, im)``, the phase is ``re / |d|`` and ``im / |d|`` each
    times tau, and an exact zero becomes ``(+tau, 0)``; with ``native``
    (complex values in the native layout) its native rule
    (``_perturb_diags_body``): ``d / |d|`` in complex arithmetic, times
    tau.  Both bump where ``|d| < tau``.  Returns
    ``(vals, n_bumped)`` with the count as a 0-d int32 tensor on the
    device.  The reference's ``_perturb_diags_body`` (its ``diag_idx`` is
    padded; here every index is real).  A batch, (B, n) values with a (B,)
    ``tau``, bumps each matrix against its own threshold and returns (B,)
    counts (the reference's ``perturb_diags_batched``), elementwise as one
    matrix alone."""
    d = vals[..., diag_idx]
    tau = tau[..., None]
    if d.is_complex() and not native:
        re, im = torch.view_as_real(d).unbind(-1)
        mag = torch.hypot(re, im)
        pos = mag > 0
        safe = torch.where(pos, mag, torch.ones_like(mag))
        bumped = torch.complex(
            torch.where(pos, re / safe, torch.ones_like(re)) * tau,
            torch.where(pos, im / safe, torch.zeros_like(im)) * tau)
    else:
        mag = d.abs()
        pos = mag > 0
        bumped = torch.where(pos, d / torch.where(pos, mag, torch.ones_like(mag)),
                             torch.ones_like(d)) * tau
    tiny = mag < tau
    vals[..., diag_idx] = torch.where(tiny, bumped, d)
    return vals, tiny.sum(-1, dtype=torch.int32)


def level_run_ref(vals, run, tau=None, count=None):
    """Plain version of K1 ``level_run``: the run's levels in order, in
    place on ``vals``.  With ``tau`` and ``count`` (static pivoting; tau in
    the values' real dtype) each level first bumps its column diagonals with
    :func:`perturb_diags` and adds the bumps into ``count``, as the robust
    kernel does after each level's grid barrier.  Each level adds its contributions
    ``-((v[lidx] / v[ldiag]) * v[uidx])`` (complex: ``-pmul(pdiv(l, d), u)``)
    into their slots in ascending update order, then normalizes its L
    entries, as the per-level route does; the invariants the run was
    checked against make its bits the kernel's, which normalizes every
    level's L entries after the last.  ``run`` is a
    :class:`~repro_torch.kernels.level_update.LevelRun` on ``vals``'s
    device.  A batch, (B, n) values with (B,) ``tau`` and ``count``, runs
    the single-matrix version on each matrix."""
    if vals.dim() == 2:
        for b in range(vals.shape[0]):
            level_run_ref(vals[b], run, *(() if tau is None
                                          else (tau[b], count[b])))
        return vals
    for lidx, uidx, ldiag, slots, bounds, ni, nd, diag in run.ref_levels():
        if tau is not None:
            count += perturb_diags(vals, diag, tau)[1]
        c = _level_div(vals[lidx], vals[ldiag])
        u = vals[uidx]
        c = -(pmul(c, torch.view_as_real(u)) if u.is_complex() else c * u)
        add_in_rounds_(vals, slots, c, bounds)
        norm = _level_div(vals[ni], vals[nd])
        vals[ni] = torch.view_as_complex(norm) if vals.is_complex() else norm
    return vals


def dense_lu_ref(a):
    """Unpivoted dense LU, in-place layout (L strictly below the diagonal,
    unit diagonal implied; U on and above), unblocked right-looking.  A
    (B, N, N) batch factors each tile alone."""
    if a.dim() == 3:
        return torch.stack([dense_lu_ref(t) for t in a])
    m = a.clone()
    n = m.shape[0]
    for j in range(n - 1):
        m[j + 1:, j] /= m[j, j]
        # an elementwise outer product (no matmul, so no TF32 on the card)
        m[j + 1:, j + 1:] -= m[j + 1:, j:j + 1] * m[j:j + 1, j + 1:]
    return m


def dense_lu_planar_ref(a):
    """Planar twin of :func:`dense_lu_ref`: ``a`` is (2, N, N) re/im planes
    of a complex tile.  The complex multiply is 4 real outer products and a
    sign; the pivot reciprocal is ``conj(p) / (re^2 + im^2)``.  A
    (B, 2, N, N) batch factors each tile alone."""
    if a.dim() == 4:
        return torch.stack([dense_lu_planar_ref(t) for t in a])
    m = a.clone()
    mr, mi = m[0], m[1]
    n = m.shape[-1]
    for j in range(n - 1):
        pr, pi = mr[j, j], mi[j, j]
        inv = 1.0 / (pr * pr + pi * pi)
        cr, ci = mr[j + 1:, j], mi[j + 1:, j]
        qr = (cr * pr + ci * pi) * inv
        qi = (ci * pr - cr * pi) * inv
        mr[j + 1:, j] = qr
        mi[j + 1:, j] = qi
        lr, li = qr[:, None], qi[:, None]
        rr, ri = mr[j:j + 1, j + 1:], mi[j:j + 1, j + 1:]
        mr[j + 1:, j + 1:] -= lr * rr - li * ri
        mi[j + 1:, j + 1:] -= lr * ri + li * rr
    return m


def _widest(t):
    """float64 for a real tile, complex128 for a complex one or for
    (2, N, N) re/im planes."""
    if t.dim() == 3:
        return torch.complex(t[0].double(), t[1].double())
    return t.to(torch.complex128) if t.is_complex() else t.double()


def lu_backward_error(a, lu) -> float:
    """Componentwise backward error of an in-place-layout LU of ``a``:
    ``max |L U - A| / (|L| |U|)``, in float64 or complex128 (0 where both
    are 0).  ``a`` and ``lu`` are real or complex (N, N) tiles or (2, N, N)
    re/im planes.  A correct LU keeps it near N times the value type's
    epsilon, whatever the size of L's entries; a wrong L does not."""
    a, lu = _widest(a), _widest(lu)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    L, U = torch.tril(lu, -1) + eye, torch.triu(lu)
    den = (L.abs() @ U.abs()).clamp_min(torch.finfo(torch.float64).tiny)
    return ((L @ U - a).abs() / den).max().item()


def spmv_ref(row_ids, colidx, vals, x, n_rows):
    """COO SpMV oracle: ``y[row_ids] += vals * x[colidx]``.  A batch,
    (B, nnz) values and (B, n) vectors, scatters into one flat (B * n_rows)
    array, each matrix's entries in their order as one matrix alone."""
    prods = vals * x[..., colidx]
    if prods.dim() == 1:
        y = torch.zeros(n_rows, dtype=prods.dtype, device=prods.device)
        return scatter_add_(y, row_ids, prods)
    B = prods.shape[0]
    flat = (torch.arange(B, device=row_ids.device)[:, None] * n_rows
            + row_ids).reshape(-1)
    y = torch.zeros(B * n_rows, dtype=prods.dtype, device=prods.device)
    return scatter_add_(y, flat, prods.reshape(-1)).view(B, n_rows)
