"""The import guard: nothing the benchmark loads is JAX or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), the reference loads nothing of the program, and a run
without a card, or in a directory that holds only the benchmark, prints
no result and exits non-zero."""

import ast
import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from pprbench_cases import ROOT

BENCH = ROOT / "pprbench"
FOREIGN = {"jax", "jaxlib", "flax", "fora_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(where):
    return [p for p in where.rglob("*.py") if "tests" not in p.parts]


def test_no_module_of_the_benchmark_imports_jax():
    for p in sources(BENCH):
        bad = top_level_imports(p) & FOREIGN
        assert not bad, f"{p.relative_to(ROOT)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for p in sources(BENCH / "reference"):
        names = top_level_imports(p)
        assert not names & (FOREIGN | {"fora_tpu_torch", "pprbench"}), p
        text = p.read_text()
        assert "fora_tpu_torch" not in text.replace(
            "fora_tpu_torch/eval", ""), p


def test_the_name_check_compares_whole_names():
    from pprbench import harness
    before = set(sys.modules)
    assert "fora_tpu_torch" not in harness.FOREIGN
    sys.modules["fora_tpu_torch_probe_only"] = object()
    try:
        assert harness.foreign_modules() == sorted(
            {m.split(".")[0] for m in before if m.split(".")[0] in FOREIGN
             and sys.modules.get(m) is not None})
    finally:
        del sys.modules["fora_tpu_torch_probe_only"]


RUN = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # an import of jax now fails
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(2)
    import pprbench_cases
    for w in ("plus-top50-batch512", "raw-top50-batch512"):
        res = pprbench_cases.run(pprbench_cases.tiny_spec(w),
                                 seconds=0.3, trace=True)
        assert res["correct"], (w, res["checks"])
    from pprbench import harness
    print("FOREIGN", harness.foreign_modules())
""")


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN, str(BENCH / "tests")],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("FOREIGN")]
    assert line == ["FOREIGN []"], out.stdout[-2000:]


def run_py(cwd):
    return subprocess.run(
        [sys.executable, "pprbench/run.py", "--workload",
         "plus-top50-batch512", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == "", out.stdout
    assert "CUDA device" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "pprbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    with pytest.raises(ValueError):
        json.loads(out.stdout.strip().splitlines()[-1]
                   if out.stdout.strip() else "")
