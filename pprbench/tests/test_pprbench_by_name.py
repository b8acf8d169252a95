"""Driven by data: a configuration, a traffic mix, a per-layer metric and
a cell added to a copy of the benchmark are found by name, with no edit
to any file that is there."""

import hashlib
import json
import shutil

import pprbench_cases
from pprbench_cases import ROOT


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted((root / "pprbench").rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "pprbench", tmp_path / "pprbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digest(tmp_path)
    bench = tmp_path / "pprbench"
    conf = json.loads((bench / "configs" / "g500-s22-fora-plus.json")
                      .read_text())
    conf.update(name="er-like", graph=dict(conf["graph"], a=0.25, b=0.25,
                                           c=0.25))
    (bench / "configs" / "er-like.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "top50-batch512.json")
                         .read_text())
    traffic.update(k=10)
    (bench / "traffic" / "top10-batch512.json").write_text(json.dumps(traffic))
    (bench / "cells" / "er-top10.json").write_text(
        json.dumps({"err_mean": 0.5}))
    (bench / "metrics" / "answered.batch.py").write_text(
        "def read(run):\n    return run.answered\n")
    (bench / "metrics" / "nothing_to_read.py").write_text(
        "def read(run):\n    return None\n")
    manifest["configs"].append({
        "name": "er-like", "source": "a uniform Kronecker graph",
        "file": "pprbench/configs/er-like.json", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({
        "name": "er-top10", "config": "er-like", "traffic": "top10-batch512",
        "chips": 1, "why": "a test"})
    manifest["per_layer"] += [
        {"name": "answered.batch", "unit": "queries", "better": "higher",
         "source": "program_counter", "layer": "pool driver",
         "moves": "topk_qps", "workloads": ["er-top10"]},
        {"name": "nothing_to_read", "unit": "s", "better": "lower",
         "source": "host_clock", "layer": "pool driver",
         "moves": "topk_qps", "workloads": ["er-top10"]}]
    manifest["end_to_end"][1]["workloads"].append("er-top10")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    spec = pprbench_cases.tiny_spec("er-top10", scale=9, root=tmp_path)
    assert spec.config["graph"]["a"] == 0.25 and spec.traffic["k"] == 10
    res = pprbench_cases.run(spec, seconds=0.3, trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["answered.batch"]["value"] > 0
    assert "nothing_to_read" not in res["metrics"]   # left out, never 0
    res = pprbench_cases.run(spec, seconds=0.3, trace=False)
    assert set(res["metrics"]) == {"setup_s", "topk_qps", "precision_at_k"}
    assert {k: v for k, v in digest(tmp_path).items() if k in before} \
        == before


def test_metrics_follow_the_manifest():
    from pprbench import harness
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e, per = harness.metric_entries(m, "raw-top50-batch512")
    assert {x["name"] for x in e2e} == {"setup_s", "topk_qps",
                                        "precision_at_k"}
    assert "walk_roofline.batch" in {x["name"] for x in per}
    assert "build_s" not in {x["name"] for x in per}
    e2e, per = harness.metric_entries(m, "plus-top100-batch512")
    assert "build_s" in {x["name"] for x in per}
    assert "walk_roofline.batch" not in {x["name"] for x in per}
    for x in m["per_layer"]:
        assert (ROOT / "pprbench" / "metrics" / f"{x['name']}.py").is_file()
    for w in m["workloads"]:
        assert (ROOT / "pprbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
        assert (ROOT / "pprbench" / "cells" / f"{w['name']}.json").is_file()
