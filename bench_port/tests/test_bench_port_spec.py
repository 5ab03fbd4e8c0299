"""The harness finds every configuration, mix and metric by name, and a
later change adds one as new files plus entries: shown here with a dummy
configuration, mix and metric that are added, run and removed."""
import json
import re

import pytest

from bench_port.harness import cell, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_parts(w):
    c = spec.Cell(BENCH, w["name"])
    for package in ("datagen", "queries", "reference"):
        assert c.module(package) is not None
    assert int(c.traffic["warm_passes"]) >= 1
    assert c.metrics("end_to_end") and c.metrics("per_layer")
    assert {m["name"] for m in c.metrics("end_to_end")} >= {"setup_s"}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    assert callable(spec.metric_reader(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in m["workloads"]:
        assert w in {x["name"] for x in BENCH["workloads"]}


def test_benchmark_json_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer")
               for m in BENCH[k])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(cfg)
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.Cell(BENCH, "no-such.cell")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_metric")


def test_a_new_config_mix_and_metric_are_files_and_entries(monkeypatch):
    """Add a configuration, a mix and a per-layer metric as new files and
    entries, run the new cell on the CPU, and remove them again."""
    files = {
        spec.BENCH_DIR / "configs" / "zz-dummy.json": json.dumps(dict(
            json.loads((spec.BENCH_DIR / "configs" / "tpch-sf10.json").read_text()),
            name="zz-dummy", scale=0.01)),
        spec.BENCH_DIR / "traffic" / "zz-dummy-mix.json": json.dumps(
            {"warm_passes": 0}),
        spec.BENCH_DIR / "metrics" / "zz_dummy_queries.py":
            "def read(run):\n    return float(len(run.completed))\n",
    }
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "zz-dummy", "source": "https://example.org",
                             "file": "bench_port/configs/zz-dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "zz-dummy.zz-dummy-mix", "config": "zz-dummy",
                               "traffic": "zz-dummy-mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "zz_dummy_queries", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "test", "moves": "queries_per_s",
                               "workloads": ["zz-dummy.zz-dummy-mix"]})
    try:
        for path, text in files.items():
            path.write_text(text)
        monkeypatch.setattr(spec, "load_benchmark", lambda root=spec.ROOT: bench)
        res = cell.run("zz-dummy.zz-dummy-mix", 5, 0.5, True, device="cpu")
        assert res["correct"]
        assert res["metrics"]["zz_dummy_queries"]["value"] == res["attempted"] > 0
        assert "zz_dummy_queries" not in {m["name"] for m in BENCH["per_layer"]}
    finally:
        for path in files:
            path.unlink(missing_ok=True)
