"""``repro_torch.launch.report`` against ``repro.launch.report``: the same
three tables from one set of dry-run records, byte for byte, except the
card's constants: the fits column reads "fits 80GB" from
``fits_80gb_hbm`` (the reference's "fits 16GB" from ``fits_16gb_hbm``),
and the roofline heading names the H100 in place of the TPU v5e."""

import json
import sys

import pytest

from repro.launch import report as JR
from repro_torch.launch import report as R


def _records():
    """Records of every status and mesh, in no sorted order, as both
    dry-runs write them."""
    def ok(arch, shape, mesh, peak, fits, scale):
        wire = {"all-gather": 1.5e9 * scale, "all-reduce": 2.25e8 * scale,
                "reduce-scatter": 7.5e8 * scale, "all-to-all": 3e7 * scale,
                "collective-permute": 0.0}
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "n_devices": 256 if mesh == "single" else 512,
                "status": "ok", "compile_s": 12.34 * scale,
                "peak_bytes_per_dev": peak, "fits": fits,
                "roofline": {"compute_s": 0.0123 * scale,
                             "memory_s": 2.5 * scale,
                             "collective_s": 0.000456 * scale,
                             "dominant": "memory",
                             "model_flops": 1.234e18 * scale,
                             "useful_flops_ratio": 0.987 * scale,
                             "wire_by_kind": wire}}
    return [ok("olmoe-1b-7b", "train_4k", "single", 12.5e9, True, 1.0),
            ok("dlrm", "train_65k", "multi", 3.2e9, True, 0.5),
            {"arch": "dbrx-132b", "shape": "prefill_32k", "mesh": "single",
             "status": "error", "error": "ValueError: x"},
            ok("dbrx-132b", "train_4k", "single", 95.1e9, False, 3.0),
            ok("h2o-danube-1.8b", "decode_32k", "multi", 1.1e9, True, 0.1),
            {k: v for k, v in ok("qwen2.5-14b", "train_4k", "single", 1e9,
                                 True, 2.0).items() if k != "roofline"}]


def _as(records, key):
    return [{(key if k == "fits" else k): v for k, v in r.items()}
            for r in records]


def test_dryrun_table_is_the_reference_with_the_cards_memory():
    recs = _records()
    want = JR.dryrun_table(_as(recs, "fits_16gb_hbm"))
    got = R.dryrun_table(_as(recs, "fits_80gb_hbm"))
    assert got == want.replace("| fits 16GB |", "| fits 80GB |")
    assert "| fits 80GB |" in got and "ERROR" in got and "| NO |" in got


@pytest.mark.parametrize("table", ["roofline_table", "wire_breakdown"])
def test_roofline_tables_are_the_references(table):
    recs = _records()
    want = getattr(JR, table)(_as(recs, "fits_16gb_hbm"))
    got = getattr(R, table)(_as(recs, "fits_80gb_hbm"))
    assert got == want
    assert "olmoe-1b-7b" in got and "dlrm" not in got     # single pod only


def test_main_prints_the_three_tables(tmp_path, monkeypatch, capsys):
    recs = _records()
    outs = {}
    for mod, key in ((JR, "fits_16gb_hbm"), (R, "fits_80gb_hbm")):
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps(_as(recs, key)))
        monkeypatch.setattr(sys, "argv", ["report", str(path)])
        mod.main()
        outs[key] = capsys.readouterr().out
    want = (outs["fits_16gb_hbm"]
            .replace("| fits 16GB |", "| fits 80GB |")
            .replace("TPU v5e constants", "H100 SXM constants"))
    assert outs["fits_80gb_hbm"] == want
    assert "### Dry-run (5/6 combos ok)" in want
