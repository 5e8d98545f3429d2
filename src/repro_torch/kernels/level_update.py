"""K1: the GLU level update of the narrow SEGMENTED/PANEL levels.

``level_run(vals, run)`` runs a whole run of consecutive such levels in
place on the value array: each level normalizes its L entries and adds the
contributions ``-l·u`` of its updates into its destination column
segments.  ``run`` is a :class:`LevelRun`, the run's packed int32 layout
(built once per plan, ``core/factorize.py``).  A CUDA tensor launches the
hand-written kernel in ``csrc/level_run.cu``: one cooperative launch for
the whole run, one grid barrier a level, per-row counting sorts and sums in
a fixed order (deterministic, and the plain version's bits).  A CPU tensor
runs the plain version ``ref.level_run_ref``.  Any other device raises.
With ``tau`` (in the values' real dtype) and ``count`` it launches the
robust instantiation: static pivoting, each level's column diagonals
bumped at the start of that level (``ref.perturb_diags``'s rule, the
phase kept for complex values) and the bumps added into ``count``.  A
(B, n) value array is a batch of matrices on one run, the counterpart of
the JAX package's batched level steps: one launch, a batch axis of the
same kernel.

``segmented_accumulate(col_vals, contribs, didx_local)`` is the TPU
kernel's own function, ``col_vals (D, C) + scatter(contribs (D, R) at
didx_local (D, R))``, kept as the plain single-level accumulation of the
per-level route (CPU tensors only).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .ref import level_run_ref, round_order, segmented_accumulate_ref

__all__ = ["LevelRun", "check_run_invariants", "level_run",
           "segmented_accumulate", "random_level_run", "SLOTS"]

SLOTS = 1024   # kSlots in csrc/level_run.cu: slots of one work item

_TYPES = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
          torch.complex128: "c128"}
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_INT32_MAX = np.iinfo(np.int32).max


def segmented_accumulate(col_vals: torch.Tensor, contribs: torch.Tensor,
                         didx_local: torch.Tensor) -> torch.Tensor:
    """Returns a new (D, C) tensor; the inputs are not modified.  CPU
    tensors only: on the card a level's accumulation runs inside
    :func:`level_run`."""
    dev = col_vals.device
    if dev.type == "cpu":
        return segmented_accumulate_ref(col_vals, contribs, didx_local)
    if dev.type == "cuda":
        raise NotImplementedError(
            "segmented_accumulate has no kernel of its own on the card: the "
            "level step runs inside K1 level_run (one launch per run of "
            "levels)")
    raise ValueError(f"segmented_accumulate takes cpu tensors (cuda or cpu "
                     f"value arrays run through level_run), not {dev}")


def check_run_invariants(levels, rows, upd, norm, diag=None) -> None:
    """Check, on the host, the facts that make one grid barrier a level
    safe for a run's layout (see :class:`LevelRun` for the arrays), and
    raise ``ValueError`` naming the first that fails:

    * (I1) the destination segments of different rows of a level are
      disjoint;
    * (I2) no slot that a level writes is read in that level as an operand
      (``lidx``, ``uidx``, ``ldiag``) or by its normalization
      (``norm_idx``, ``norm_diag``);
    * (I3) the slots a level's normalization reads and writes are not
      written by a later level of the run, its normalized L entries are
      not read by one, and the run normalizes each L entry once and no
      diagonal it divides by: the kernel normalizes every level's L
      entries at once, after the run's last level.

    ``diag`` is ``(diag_ptr (L + 1,), diag_idx (P,))``, each level's column
    diagonals (the slots static pivoting bumps at the level's start); they
    count as slots the level reads, for I2 and I3.
    """
    L = len(levels)
    col_start, col_len = rows[:, 0].astype(np.int64), rows[:, 1].astype(np.int64)
    row_lev = np.repeat(np.arange(L), levels[:, 3] - levels[:, 2])
    # I1: sorted by (level, start), each segment ends before the next starts
    order = np.lexsort((col_start, row_lev))
    s, e, lv = col_start[order], (col_start + col_len)[order], row_lev[order]
    clash = (lv[1:] == lv[:-1]) & (s[1:] < e[:-1])
    if clash.any():
        k = int(lv[1:][clash][0])
        raise ValueError(f"run layout breaks I1: two rows of level {k} have "
                         "overlapping destination segments")
    n_upd = rows[:, 3] - rows[:, 2]
    upd_row = np.repeat(np.arange(len(rows)), n_upd)
    upd_lev = row_lev[upd_row]
    written = col_start[upd_row] + upd[:, 3]
    norm_lev = np.repeat(np.arange(L), levels[:, 1] - levels[:, 0])
    d_ptr, d_idx = _diag_arrays(diag, L)
    d_lev = np.repeat(np.arange(L), np.diff(d_ptr))
    size = int(max(written.max(initial=0), upd[:, :3].max(initial=0),
                   norm.max(initial=0), d_idx.max(initial=0))) + 1
    # I2: per level, mark what it writes and look at what it reads
    mark = np.zeros(size, dtype=bool)
    u_ptr = np.searchsorted(upd_lev, np.arange(L + 1))
    n_ptr = levels[:, :2]
    for k in range(L):
        w = written[u_ptr[k]:u_ptr[k + 1]]
        mark[w] = True
        reads = (upd[u_ptr[k]:u_ptr[k + 1], :3].ravel(),
                 norm[n_ptr[k, 0]:n_ptr[k, 1]].ravel(),
                 d_idx[d_ptr[k]:d_ptr[k + 1]])
        if any(mark[r].any() for r in reads):
            raise ValueError(f"run layout breaks I2: level {k} reads a slot "
                             "that it writes")
        mark[w] = False
    # I3: the level that normalizes each L entry, and the last level whose
    # normalization reads each diagonal
    nlev = np.full(size, L, dtype=np.int64)
    nlev[norm[:, 0]] = norm_lev
    dlev = np.full(size, -1, dtype=np.int64)
    np.maximum.at(dlev, norm[:, 1], norm_lev)
    np.maximum.at(dlev, d_idx, d_lev)
    read_lev = np.concatenate([np.repeat(upd_lev, 3), norm_lev, norm_lev])
    read_slot = np.concatenate([upd[:, :3].ravel(), norm[:, 1], norm[:, 0]])
    ni = norm[:, 0]
    twice = len(np.unique(ni)) != len(ni) or bool(np.isin(norm[:, 1], ni).any())
    late_read = nlev[read_slot] < read_lev
    late_write = (nlev[written] < upd_lev) | (dlev[written] >= 0) & \
        (dlev[written] < upd_lev)
    if twice:
        raise ValueError("run layout breaks I3: an L entry is normalized "
                         "twice, or normalized and divided by")
    if late_read.any() or late_write.any():
        k = int(np.concatenate([read_lev[late_read], upd_lev[late_write]]).min())
        raise ValueError(f"run layout breaks I3: level {k} reads or writes a "
                         "slot that an earlier level of the run normalizes")


def _diag_arrays(diag, n_levels: int):
    """``(diag_ptr, diag_idx)`` as int64 arrays; ``None`` is no diagonals."""
    if diag is None:
        return np.zeros(n_levels + 1, dtype=np.int64), np.zeros(0, np.int64)
    ptr, idx = (np.asarray(a, dtype=np.int64).ravel() for a in diag)
    if len(ptr) != n_levels + 1 or ptr[0] != 0 or ptr[-1] != len(idx) \
            or (np.diff(ptr) < 0).any():
        raise ValueError("run layout diagonal ranges do not tile its "
                         "diagonal array")
    return ptr, idx


def _check_structure(levels, rows, upd, norm, n_vals: int) -> None:
    """The layout's ranges tile its arrays in order, every level has rows
    and every row updates, and every index lies inside the value array and
    every position inside its segment: what keeps the kernel's reads and
    writes in bounds."""
    def tiles(start, stop, total, least):
        return (len(start) > 0 and start[0] == 0 and stop[-1] == total
                and np.array_equal(start[1:], stop[:-1])
                and bool((stop - start >= least).all()))

    if not (tiles(levels[:, 0], levels[:, 1], len(norm), 0)
            and tiles(levels[:, 2], levels[:, 3], len(rows), 1)
            and tiles(rows[:, 2], rows[:, 3], len(upd), 1)):
        raise ValueError("run layout ranges do not tile its arrays, or a "
                         "level has no rows or a row no updates")
    col_len = np.repeat(rows[:, 1], rows[:, 3] - rows[:, 2])
    if (upd[:, 3] >= col_len).any() or upd[:, :3].max() >= n_vals \
            or (rows[:, 0] + rows[:, 1]).max() > n_vals \
            or (len(norm) and norm.max() >= n_vals):
        raise ValueError("run layout index outside its segment or the value "
                         "array")


class LevelRun:
    """The packed int32 layout of one run of consecutive SEGMENTED/PANEL
    levels, with no padding, on one device.

    levels (L, 6): norm_start, norm_end, row_start, row_end, item_start,
                   item_end of each level (the constructor fills in the
                   item ranges)
    items  (I, 2): row, first slot of each work item (a row and a block of
                   up to ``SLOTS`` of its slots), built by the constructor
    rows   (D, 4): col_start, col_len, upd_start, upd_end; the row's
                   destination segment is ``vals[col_start : col_start +
                   col_len]``
    upd    (U, 4): lidx, uidx, ldiag, dpos of each update, in the plan's
                   order within its row (the order its slot sums in);
                   ``ldiag`` normalizes the L operand, ``dpos`` is the
                   position inside the segment
    norm   (P, 2): norm_idx, norm_diag
    diag_ptr (L + 1,), diag (Q,): each level's column diagonals,
                   ``diag[diag_ptr[k] : diag_ptr[k + 1]]`` for level k,
                   from the ``diag`` argument ``(diag_ptr, diag)`` (none
                   when it is omitted); only the robust (static-pivot)
                   instantiation reads them

    The constructor checks the structure (ranges, bounds), that every
    index fits in int32, and :func:`check_run_invariants`; it raises
    ``ValueError`` on a layout the kernel cannot run.  ``n_vals`` is the
    least length of a value array the run indexes.
    """

    def __init__(self, levels, rows, upd, norm, n_vals: int, device,
                 diag=None):
        arrays = [np.asarray(a) for a in (levels, rows, upd, norm)]
        for a, w in zip(arrays, (6, 4, 4, 2)):
            if a.ndim != 2 or a.shape[1] != w:
                raise ValueError(f"run layout array of shape {a.shape}, "
                                 f"expected (n, {w})")
            if a.size and (a.min() < 0 or a.max() > _INT32_MAX):
                raise ValueError("run layout index outside [0, 2**31)")
        levels, rows, upd, norm = (a.astype(np.int64) for a in arrays)
        if n_vals > _INT32_MAX:
            raise ValueError(f"{n_vals} values do not fit int32 indices")
        diag_ptr, diag_idx = _diag_arrays(diag, len(levels))
        _check_structure(levels, rows, upd, norm, n_vals)
        if diag_idx.size and (diag_idx.min() < 0 or diag_idx.max() >= n_vals):
            raise ValueError("run layout diagonal outside the value array")
        check_run_invariants(levels, rows, upd, norm, (diag_ptr, diag_idx))
        # work items: each row in blocks of SLOTS slots
        nblk = -(-rows[:, 1] // SLOTS)
        first = np.repeat(np.cumsum(nblk) - nblk, nblk)
        item_row = np.repeat(np.arange(len(rows)), nblk)
        items = np.stack([item_row, (np.arange(len(item_row)) - first) * SLOTS],
                         axis=1)
        item_ptr = np.concatenate([[0], np.cumsum(nblk)])
        levels = levels.copy()
        levels[:, 4], levels[:, 5] = item_ptr[levels[:, 2]], item_ptr[levels[:, 3]]
        self.n_vals = int(n_vals)
        self.n_levels = len(levels)
        self.n_updates = len(upd)
        self.max_items = int((levels[:, 5] - levels[:, 4]).max(initial=0))
        # the most work indices of one pass over a matrix (a level's items,
        # the run's normalizations, its diagonals): times B within int32
        self.max_work = max(self.max_items, len(norm), len(diag_idx), 1)
        self.host = dict(levels=levels, items=items, rows=rows, upd=upd,
                         norm=norm, diag_ptr=diag_ptr, diag=diag_idx)
        self.tensors = {k: torch.as_tensor(v, dtype=torch.int32,
                                           device=device).contiguous()
                        for k, v in self.host.items()}
        self.device = self.tensors["levels"].device   # with its index
        self.ptrs = tuple(self.tensors[k].data_ptr()
                          for k in ("levels", "items", "rows", "upd", "norm"))
        self.diag_ptrs = tuple(self.tensors[k].data_ptr()
                               for k in ("diag_ptr", "diag"))
        self._ref = None

    def written_slots(self) -> np.ndarray:
        """Each update's destination slot in the value array (host)."""
        rows, upd = self.host["rows"], self.host["upd"]
        row = np.repeat(np.arange(len(rows)), rows[:, 3] - rows[:, 2])
        return rows[row, 0] + upd[:, 3]

    def ref_levels(self):
        """Per level, the plain version's index tensors on the run's
        device: the updates' lidx, uidx, ldiag and slots in
        :func:`round_order` of their slots, the round bounds, the level's
        norm_idx and norm_diag, and its column diagonals (built at the
        first call)."""
        if self._ref is None:
            h = self.host
            slots = self.written_slots()
            out = []
            for k, (n0, n1, r0, r1, _, _) in enumerate(h["levels"]):
                u0, u1 = h["rows"][r0, 2], h["rows"][r1 - 1, 3]
                perm, bounds = round_order(slots[u0:u1])
                up = h["upd"][u0:u1][perm]
                d0, d1 = h["diag_ptr"][k], h["diag_ptr"][k + 1]
                t = [torch.as_tensor(a, dtype=torch.int64, device=self.device)
                     for a in (up[:, 0], up[:, 1], up[:, 2], slots[u0:u1][perm],
                               h["norm"][n0:n1, 0], h["norm"][n0:n1, 1],
                               h["diag"][d0:d1])]
                out.append((*t[:4], bounds, *t[4:]))
            self._ref = out
        return self._ref


_fns: dict = {}


def _entry(dtype, robust: bool, batched: bool):
    """The library's C entry for ``dtype``, looked up once."""
    key = (dtype, robust, batched)
    fn = _fns.get(key)
    if fn is None:
        if dtype not in _TYPES:
            raise TypeError(f"level_run takes float32, float64, complex64 or "
                            f"complex128 values, got {dtype}")
        name = ("glu_level_run" + ("_robust" if robust else "")
                + ("_batched" if batched else "") + "_" + _TYPES[dtype])
        fn = _fns[key] = getattr(_build.load_library(), name)
    return fn


def level_run(vals: torch.Tensor, run: LevelRun, tau=None,
              count=None) -> torch.Tensor:
    """Run every level of ``run`` in place on the contiguous value array
    ``vals``; returns ``vals``.  ``vals`` is one (n,) array, or a batch
    (B, n) of arrays that share the run (the JAX package's
    ``level_update_batched_body`` and ``level_update_planar_batched_body``):
    one launch for the whole batch, each matrix's bits those of a launch
    on it alone.  With ``tau`` (the static-pivot threshold in the values'
    real dtype: 0-d, or (B,) for a batch) and ``count`` (int32, 0-d or (B,))
    each level first bumps its column diagonals below ``tau`` and adds the
    number it bumped into ``count``, per matrix."""
    dev = vals.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"level_run runs on cuda or cpu, not {dev}")
    if run.device != dev:
        raise ValueError(f"the values lie on {dev}, the run on {run.device}")
    robust = tau is not None
    if robust != (count is not None):
        raise ValueError("level_run takes tau and count together")
    if vals.dim() not in (1, 2):
        raise ValueError(f"level_run takes (n,) or (B, n) values, got shape "
                         f"{tuple(vals.shape)}")
    batched = vals.dim() == 2
    if robust:
        shape = vals.shape[:1] if batched else ()
        if tau.shape != shape or count.shape != shape:
            raise ValueError(f"level_run needs tau and count of shape "
                             f"{tuple(shape)}, got {tuple(tau.shape)} and "
                             f"{tuple(count.shape)}")
    if dev.type == "cpu":
        return level_run_ref(vals, run, tau, count)
    fn = _entry(vals.dtype, robust, batched)
    if not vals.is_contiguous() or vals.shape[-1] < run.n_vals \
            or vals.shape[-1] > _INT32_MAX:
        raise ValueError(f"level_run needs a contiguous value array of at "
                         f"least {run.n_vals} values a matrix")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return level_run(vals, run, tau, count)
    batch = (vals.shape[0], vals.shape[1]) if batched else ()
    if batched and vals.shape[0] * run.max_work > _INT32_MAX:
        raise ValueError(f"a batch of {vals.shape[0]} on this run needs "
                         f"work indices beyond int32")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if robust:
        if tau.dtype != _REAL.get(vals.dtype, vals.dtype) \
                or tau.device != dev \
                or count.dtype != torch.int32 or count.device != dev \
                or not (tau.is_contiguous() and count.is_contiguous()):
            raise ValueError("level_run needs tau in the values' real dtype "
                             "and count as int32, contiguous, on their "
                             "device")
        rc = fn(vals.data_ptr(), *run.ptrs, *run.diag_ptrs, tau.data_ptr(),
                count.data_ptr(), run.n_levels, run.max_items, *batch, stream)
    else:
        rc = fn(vals.data_ptr(), *run.ptrs, run.n_levels, run.max_items,
                *batch, stream)
    _build.check(rc, "level_run")
    _build.count_launch(level_run)
    return vals


level_run.launches = 0
level_run.captured = 0


def random_level_run(rng: np.random.Generator, shapes, dtype, device,
                     duplicates: bool = False):
    """A synthetic run for holding the kernel against its plain version:
    one level per ``(D, R, C)`` of ``shapes``, D rows of R updates into
    segments of C slots, positions drawn at random (``duplicates``: all on
    the segment's first slot).  The value array holds a region of U
    operands for the first level, then each level's L entries and
    diagonals (read and normalized by that level only, and the level's
    column diagonals for static pivoting), then every level's segments;
    level k > 0 takes its U operands from level k - 1's segments, a real
    dependency across the barrier.  Values are drawn from [-1, 1],
    diagonals from [1, 2].  Returns ``(run, vals)``."""
    n_u0 = 4 * shapes[0][0]
    base, regions = n_u0, []
    for D, _, _ in shapes:                 # 4 L entries and 1 diagonal a row
        regions.append((base, 4 * D, base + 4 * D))
        base += 5 * D
    diag = np.concatenate([np.arange(d0, d0 + n_l // 4)
                           for _, n_l, d0 in regions])
    seg0 = []
    for D, _, C in shapes:
        seg0.append(base)
        base += D * C
    levels, rows, upd, norm = [], [], [], []
    n_rows = n_upd = n_norm = 0
    for k, (D, R, C) in enumerate(shapes):
        l0, n_l, d0 = regions[k]
        lsel = rng.integers(0, n_l, size=D * R)
        if k:
            pD, _, pC = shapes[k - 1]
            uidx = seg0[k - 1] + rng.integers(0, pD * pC, size=D * R)
        else:
            uidx = rng.integers(0, n_u0, size=D * R)
        dpos = (np.zeros(D * R, dtype=np.int64) if duplicates
                else rng.integers(0, C, size=D * R))
        upd.append(np.stack([l0 + lsel, uidx, d0 + lsel % D, dpos], axis=1))
        r = np.arange(D)
        rows.append(np.stack([seg0[k] + r * C, np.full(D, C),
                              n_upd + r * R, n_upd + (r + 1) * R], axis=1))
        norm.append(np.stack([l0 + np.arange(n_l), d0 + np.arange(n_l) % D],
                             axis=1))
        levels.append((n_norm, n_norm + n_l, n_rows, n_rows + D, 0, 0))
        n_rows, n_upd, n_norm = n_rows + D, n_upd + D * R, n_norm + n_l
    diag_ptr = np.concatenate([[0], np.cumsum([D for D, _, _ in shapes])])
    run = LevelRun(np.array(levels), np.concatenate(rows), np.concatenate(upd),
                   np.concatenate(norm), base, device, diag=(diag_ptr, diag))
    vals = rng.uniform(-1.0, 1.0, size=(2, base))
    vals[:, diag] = rng.uniform(1.0, 2.0, size=(2, len(diag)))
    vals = vals[0] + 1j * vals[1] if torch.empty(0, dtype=dtype).is_complex() \
        else vals[0]
    return run, torch.as_tensor(vals).to(device=device, dtype=dtype)
