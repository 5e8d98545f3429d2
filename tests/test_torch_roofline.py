"""PyTorch port, the roofline analysis and report against the JAX
package's: the three terms at the H100's constants (989 TFLOP/s bf16,
3.35 TB/s HBM3, 450 GB/s NVLink one way: H100 constants, not measured),
the record keys, ``model_flops_for`` of all 33 (arch x shape) cells, and
the report's tables and worst cells as text on the same records."""
import json

import pytest

import repro.configs as jconfigs
import repro.roofline.analysis as janalysis
import repro.roofline.report as jreport
from repro_torch.configs import SHAPES, get_config, list_archs, shape_cells
from repro_torch.roofline import analysis, report
from repro_torch.roofline import Roofline, analyze, model_flops_for

CELLS = [(a, s) for a in list_archs() for s in shape_cells(a)]


def _roof(**kw):
    base = dict(arch="x", shape="train_4k", mesh="16x16", chips=256, hlo_flops=0.0,
                hlo_bytes=0.0, collective_bytes=0.0, collective_detail={},
                model_flops=0.0)
    base.update(kw)
    return base


def test_h100_constants_and_terms():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (989e12, 3.35e12, 450e9)
    r = Roofline(**_roof(hlo_flops=989e12, hlo_bytes=3.35e12, collective_bytes=450e9,
                         model_flops=989e12 * 256)).finalize()
    assert abs(r.compute_s - 1.0) < 1e-12
    assert abs(r.memory_s - 1.0) < 1e-12
    assert abs(r.collective_s - 1.0) < 1e-12
    assert abs(r.useful_fraction - 1.0) < 1e-12
    assert abs(r.roofline_fraction - 1.0) < 1e-12
    r = Roofline(**_roof(hlo_flops=989e12, hlo_bytes=2 * 3.35e12, collective_bytes=450e9,
                         model_flops=989e12 * 128)).finalize()
    assert r.dominant == "memory" and abs(r.bound_s - 2.0) < 1e-12
    assert abs(r.useful_fraction - 0.5) < 1e-12 and abs(r.roofline_fraction - 0.25) < 1e-12
    empty = Roofline(**_roof()).finalize()
    assert empty.useful_fraction == 0.0 and empty.roofline_fraction == 0.0


def test_record_keys_equal_reference():
    kw = _roof(hlo_flops=1e12, hlo_bytes=1e9, collective_bytes=3e8,
               collective_detail={"all-reduce": 3e8}, model_flops=2e14)
    got = Roofline(**kw).finalize().to_dict()
    want = janalysis.Roofline(**kw).finalize().to_dict()
    assert list(got) == list(want)
    # the same arithmetic at other constants: the ratios of the terms
    assert got["compute_s"] / want["compute_s"] == pytest.approx(197e12 / 989e12)
    assert got["memory_s"] / want["memory_s"] == pytest.approx(819e9 / 3.35e12)
    assert got["collective_s"] / want["collective_s"] == pytest.approx(50e9 / 450e9)
    r = analyze("a", "decode_32k", "16x16", 256, {"flops": 2e12, "bytes accessed": 4e9},
                {"all-gather": 5e8, "all-reduce": 1e8, "counts": {"all-gather": 3}}, 1e13)
    assert r.collective_bytes == 6e8
    assert r.collective_detail["counts"] == {"all-gather": 3}
    assert set(r.collective_detail) == set(analysis.COLLECTIVES) | {"counts"}
    assert (r.hlo_flops, r.hlo_bytes) == (2e12, 4e9)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(arch, shape):
    got = model_flops_for(get_config(arch), SHAPES[shape])
    want = janalysis.model_flops_for(jconfigs.get_config(arch), jconfigs.SHAPES[shape])
    assert got == want and got > 0
    assert model_flops_for(get_config(arch), SHAPES[shape], n_active=10) == \
        janalysis.model_flops_for(jconfigs.get_config(arch), jconfigs.SHAPES[shape],
                                  n_active=10)


def _records():
    recs = []
    for i, (arch, shape) in enumerate(CELLS[:9]):
        for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
            roof = Roofline(**_roof(arch=arch, shape=shape, mesh=mesh, chips=chips,
                                    hlo_flops=1e12 * (i + 1), hlo_bytes=3e10 / (i + 1),
                                    collective_bytes=1e8 * i,
                                    model_flops=2e14 * (i % 4 + 1))).finalize()
            recs.append({"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
                         "kind": SHAPES[shape].kind, "tag": "probe" if i == 3 else "",
                         "ok": True, "memory": {
                             "argument_bytes_per_device": 10**9 * (i + 1),
                             "temp_bytes_per_device": 10**8 * (9 - i),
                             "alias_bytes": 10**9 * chips * (i % 2)},
                         "roofline": roof.to_dict()})
    return recs


def test_report_text_equal_reference(tmp_path, capsys):
    recs = _records()
    for mesh in ("16x16", "2x16x16"):
        assert report.table(recs, mesh) == jreport.table(recs, mesh)
        assert report.table(recs, mesh, tags=("", "probe")) == \
            jreport.table(recs, mesh, tags=("", "probe"))
        assert report.worst_cells(recs, mesh, k=4) == jreport.worst_cells(recs, mesh, k=4)
    assert len(report.table(recs).splitlines()) == 2 + 8
    for i, r in enumerate(recs + [{"ok": False, "arch": "broken"}]):
        (tmp_path / f"{i:03d}.json").write_text(json.dumps(r))
    assert report.load(tmp_path) == jreport.load(tmp_path) == recs
    import sys

    argv = sys.argv
    sys.argv = ["report", str(tmp_path)]
    try:
        report.main()
        got = capsys.readouterr().out
        jreport.main()
        want = capsys.readouterr().out
    finally:
        sys.argv = argv
    assert got == want and "## mesh 16x16 (9 cells)" in got
