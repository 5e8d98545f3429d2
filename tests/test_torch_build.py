"""PyTorch port, kernel build: the ctypes signatures in ``_build`` against
the ``extern "C"`` entries of ``kernels/csrc/*.cu``.

ctypes passes an argument without a declared type as a 32-bit int, so an
entry whose signature lists too few arguments, or an int where the source
takes a pointer, cuts pointers silently on the card.  These tests read the
sources only: they need no compiler and no card.
"""
import re

import pytest

from repro_torch.kernels import _build

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _entries():
    """{name: [argument declarations]} of every extern "C" entry."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, args in _ENTRY.findall(src.read_text()):
            decls = [" ".join(a.split()) for a in args.split(",") if a.strip()]
            assert name not in out, f"{name} defined twice"
            out[name] = decls
    return out


def _kind(decl: str):
    """The ctypes type a C declaration needs."""
    if "*" in decl:
        return _build._P
    if re.match(r"(const\s+)?int\s+\w+$", decl):
        return _build._I
    raise AssertionError(f"no ctypes mapping for {decl!r}")


def test_every_source_entry_is_bound_and_nothing_else():
    assert set(_entries()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_source(name):
    decls = _entries()[name]
    argtypes = _build._SIGNATURES[name]
    assert len(argtypes) == len(decls), (name, decls, argtypes)
    assert [_kind(d) for d in decls] == argtypes, (name, decls)


def test_dense_lu_entries_take_input_and_output():
    # K2 and K3 read `a` and write a new tensor in one launch
    for name in ("glu_dense_lu_f32", "glu_dense_lu_f64",
                 "glu_dense_lu_planar_f32", "glu_dense_lu_planar_f64"):
        decls = _entries()[name]
        assert decls[0].startswith("const void*") and decls[1].startswith("void*")


def test_level_run_entries_take_values_in_place():
    # K1 updates the value array in place and reads five layout arrays
    for name in ("glu_level_run_f32", "glu_level_run_f64",
                 "glu_level_run_c64", "glu_level_run_c128"):
        decls = _entries()[name]
        assert decls[0] == "void* vals", (name, decls)
        assert all(d.startswith("const void*") for d in decls[1:6]), decls
