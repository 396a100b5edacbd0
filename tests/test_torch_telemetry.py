"""The port's telemetry sinks (``repro_torch.telemetry.sinks``/``report``)
against ``repro.telemetry``: the Chrome trace and JSONL schemas are the
reference's, a trace written by either package loads with the other's
``load_trace`` into the same records, ``trace_to`` and the report CLI
behave alike, and the calibration CLI's ``--trace`` writes a trace both
packages read."""

import json

import pytest

from repro import telemetry as jtele
from repro.telemetry.report import main as j_report_main
from repro_torch import telemetry as tele
from repro_torch.telemetry.report import main as report_main


@pytest.fixture()
def both():
    """Both packages' telemetry enabled with clean registries; the
    disabled default is restored (and cleared) afterwards."""
    for t in (tele, jtele):
        t.reset()
        t.enable()
    yield
    for t in (tele, jtele):
        t.reset()
        t.disable()


def _record_sample(t):
    with t.span("parent", kind="demo") as sp:
        with t.span("child"):
            pass
        sp.set(rows=3)
    t.count("t10.calls", 3)
    t.gauge("t10.level", 0.5)


def _shape(trace: dict) -> dict:
    """A loaded trace without its clock: names, parent links by name,
    attributes, counters, gauges, drops."""
    by_id = {s["id"]: s["name"] for s in trace["spans"]}
    spans = sorted(
        (s["name"], by_id.get(s["parent"]),
         json.dumps({k: v for k, v in s["args"].items()
                     if k not in ("span_id", "parent_id")}, sort_keys=True))
        for s in trace["spans"])
    return {"spans": spans, "counters": trace["counters"],
            "gauges": trace["gauges"],
            "dropped": trace["meta"].get("dropped_events", 0)}


def test_chrome_trace_schema(both, tmp_path):
    """``test_telemetry.py::test_chrome_trace_schema``, with the port's
    payload keyed exactly as the reference's."""
    _record_sample(tele)
    _record_sample(jtele)
    path = tele.write_chrome_trace(str(tmp_path / "trace.json"))
    jpath = jtele.write_chrome_trace(str(tmp_path / "ref.json"))
    with open(path) as f:
        payload = json.load(f)
    with open(jpath) as f:
        ref = json.load(f)
    events = payload["traceEvents"]
    assert [e["name"] for e in events] == ["parent", "child"]
    for e, r in zip(events, ref["traceEvents"]):
        assert sorted(e) == sorted(r)
        assert sorted(e["args"]) == sorted(r["args"])
        assert e["ph"] == "X" and e["cat"] == r["cat"] == "repro"
        assert isinstance(e["ts"], (int, float))
        assert isinstance(e["dur"], (int, float))
    child = next(e for e in events if e["name"] == "child")
    parent = next(e for e in events if e["name"] == "parent")
    assert child["args"]["parent_id"] == parent["args"]["span_id"]
    assert parent["args"]["rows"] == 3
    other = payload["otherData"]
    assert sorted(other) == sorted(ref["otherData"])
    assert other["producer"] == "repro_torch.telemetry"
    assert other["counters"] == ref["otherData"]["counters"] == \
        {"t10.calls": 3}
    assert other["gauges"]["t10.level"] == 0.5
    assert other["dropped_events"] == 0


def test_jsonl_roundtrip_and_load_trace(both, tmp_path):
    _record_sample(tele)
    jl = tele.write_jsonl(str(tmp_path / "trace.jsonl"))
    ch = tele.write_chrome_trace(str(tmp_path / "trace.json"))
    parsed = tele.read_jsonl(jl)
    assert parsed["meta"]["schema"] == 1
    assert [s["name"] for s in parsed["spans"]] == ["child", "parent"]
    child, parent = parsed["spans"]
    assert child["parent"] == parent["id"]
    assert parsed["counters"] == {"t10.calls": 3}
    assert parsed["gauges"] == {"t10.level": 0.5}
    for path in (jl, ch):
        trace = tele.load_trace(path)
        assert {s["name"] for s in trace["spans"]} == {"parent", "child"}
        assert trace["counters"]["t10.calls"] == 3


@pytest.mark.parametrize("fmt", ["jsonl", "json"])
def test_traces_load_across_packages(both, tmp_path, fmt):
    """A trace written by either package loads with the other's
    ``load_trace`` into the records its own loader gives."""
    _record_sample(tele)
    _record_sample(jtele)
    writer = {"jsonl": "write_jsonl", "json": "write_chrome_trace"}[fmt]
    mine = getattr(tele, writer)(str(tmp_path / f"port.{fmt}"))
    ref = getattr(jtele, writer)(str(tmp_path / f"ref.{fmt}"))
    assert _shape(jtele.load_trace(mine)) == _shape(tele.load_trace(mine))
    assert _shape(tele.load_trace(ref)) == _shape(jtele.load_trace(ref))
    assert _shape(tele.load_trace(mine)) == _shape(tele.load_trace(ref))
    assert jtele.load_trace(mine) == tele.load_trace(mine)
    assert tele.load_trace(ref) == jtele.load_trace(ref)


def test_summarize_matches_the_reference(both, tmp_path):
    _record_sample(tele)
    path = tele.write_jsonl(str(tmp_path / "trace.jsonl"))
    trace = tele.load_trace(path)
    assert tele.summarize(trace, top=5) == jtele.summarize(trace, top=5)
    dropped = {"meta": {"dropped_events": 7}, "spans": [], "counters": {},
               "gauges": {}}
    assert "7 span(s) dropped" in tele.summarize(dropped)
    assert tele.summarize(dropped) == jtele.summarize(dropped)


def test_trace_to_none_is_transparent():
    assert not tele.is_enabled()
    with tele.trace_to(None) as tracer:
        assert tracer is None and not tele.is_enabled()


def test_trace_to_exports_and_restores_state(tmp_path, capsys):
    assert not tele.is_enabled()
    out = str(tmp_path / "run.jsonl")
    with tele.trace_to(out):
        assert tele.is_enabled()
        with tele.span("body"):
            pass
    assert not tele.is_enabled()                # restored the default
    assert "[telemetry] wrote 1 span(s)" in capsys.readouterr().out
    assert [s["name"] for s in tele.read_jsonl(out)["spans"]] == ["body"]
    assert [s["name"] for s in jtele.read_jsonl(out)["spans"]] == ["body"]
    tele.reset()


def test_report_cli_matches_the_reference(both, tmp_path, capsys):
    _record_sample(tele)
    path = tele.write_jsonl(str(tmp_path / "trace.jsonl"))
    assert report_main([path, "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert "parent" in out and "t10.calls" in out and "gauges:" in out
    assert j_report_main([path, "--top", "5"]) == 0
    assert capsys.readouterr().out == out


def test_write_without_tracer_raises(tmp_path):
    assert not tele.is_enabled()
    with pytest.raises(RuntimeError, match="not enabled"):
        tele.write_chrome_trace(str(tmp_path / "x.json"))
    with pytest.raises(RuntimeError, match="not enabled"):
        tele.write_jsonl(str(tmp_path / "x.jsonl"))


def test_calibrate_cli_writes_a_trace(tmp_path, capsys):
    """``python -m repro_torch.profiling.calibrate --device cpu --smoke
    --trace t.jsonl``: the sweep's span lands in a trace that the port's
    report CLI summarizes and the reference's ``load_trace`` reads."""
    from repro_torch.profiling.calibrate import main
    trace = str(tmp_path / "t.jsonl")
    assert main(["--device", "cpu", "--smoke", "--out",
                 str(tmp_path / "c.npz"), "--trace", trace]) == 0
    assert "[telemetry] wrote" in capsys.readouterr().out
    assert not tele.is_enabled()
    assert report_main([trace]) == 0
    assert "calibrate.sweep" in capsys.readouterr().out
    spans = jtele.load_trace(trace)["spans"]
    assert [s["name"] for s in spans] == ["calibrate.sweep"]
    assert spans[0]["args"]["shapes"] > 0
    tele.reset()
