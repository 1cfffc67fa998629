"""BENCHMARK.json and the result line keep the benchmark's contract; the
harness is driven by data; a run loads neither JAX nor the JAX package."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import tiny  # noqa: E402
from portbench.harness.guard import forbidden_modules  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source"}


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    cells = {w["name"]: w for w in BENCH["workloads"]}
    confs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and w["config"] in confs and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        lim = json.loads((ROOT / "portbench" / "limits" / f"{w['name']}.json").read_text())
        for v in lim["limits"].values():
            assert v["lower"] < v["limit"] < v["upper"] and 3 * v["lower"] <= v["upper"]
    assert {c for c in confs} == {w["config"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert all(c in e2e[m["moves"]].get("workloads", cells) for c in m["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        mine = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_only_the_tests_are_named_test_files():
    for path in (ROOT / "portbench").rglob("test_*.py"):
        assert path.parent.name == "tests" and path.name.startswith("test_portbench_")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.make_tree(tmp_path_factory.mktemp("bench"))


def test_the_result_line_has_the_contract_keys(tree):
    from portbench.harness.runner import run_cell
    for trace in (False, True):
        res = run_cell(tree, "tiny-dense.tiny_prefill", 2**31 + 5, 0.2, trace, device="cpu")["result"]
        assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(res)[-1] == "checks" and res["correct"] is True
        assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        want = ({"prefill_mfu"} if trace else {"prompt_tokens_per_s", "ttft_ms_p95", "setup_s"})
        assert set(res["metrics"]) == want
        for m in res["metrics"].values():
            assert set(m) == {"value", "unit"}
        if trace:
            assert {"busy_s", "window_s"} <= set(res["device"])
            assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        json.dumps(res)


def _tree_hashes(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_mix_a_metric_and_a_cell_are_new_files_and_entries(tree, tmp_path):
    """A dummy mix and a dummy per-layer metric, added to a copy as new
    files and new BENCHMARK.json entries, run with no file edited."""
    before = _tree_hashes(ROOT)
    dst = tiny.make_tree(tmp_path / "t")
    pkg = dst / "portbench"
    (pkg / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"kind": "prefill", "prompt_lengths": [8, 24], "tokens_per_batch": 48}))
    (pkg / "metrics" / "dummy_batches.py").write_text(
        "def read(rec):\n    return float(len(rec.window['batches']))\n")
    (pkg / "limits" / "tiny-mamba.dummy_mix.json").write_text(json.dumps(
        {"sample_lengths": [24], "limits": {"max_logit_gap": {"limit": tiny.TINY_LIMIT}}}))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-mamba.dummy_mix", "config": "tiny-mamba",
                               "traffic": "dummy_mix", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny-mamba.dummy_mix")
    bench["per_layer"].append({"name": "dummy_batches", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "setup_s",
                               "workloads": ["tiny-mamba.dummy_mix"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    from portbench.harness.runner import run_cell
    res = run_cell(dst, "tiny-mamba.dummy_mix", 9, 0.2, True, device="cpu")["result"]
    assert res["correct"] and res["metrics"]["dummy_batches"]["value"] >= 2
    res = run_cell(dst, "tiny-mamba.dummy_mix", 9, 0.2, False, device="cpu")["result"]
    assert {"prompt_tokens_per_s", "setup_s"} <= set(res["metrics"])
    copied = _tree_hashes(dst)
    assert all(copied[k] == v for k, v in before.items() if not k.startswith("portbench/tests/"))


GUARD_RUN = r"""
import sys, json
sys.path[0] = {root!r}
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args else None)
from portbench.harness.runner import run_cell
from portbench.harness.guard import forbidden_modules
run_cell({tree!r}, "tiny-mamba.tiny_decode", 11, 0.2, True, device="cpu")
bench = {root!r} + "/benchmarks/"
print(json.dumps({{"forbidden": forbidden_modules(),
                  "benchmarks": [p for p in opened if p.startswith(bench)]}}))
"""


def test_a_run_loads_no_jax_and_opens_nothing_of_the_root_benchmarks(tree):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", GUARD_RUN.format(root=str(ROOT), tree=str(tree))],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tree)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "benchmarks": []}
    # the names are compared whole: the port's own name is no match
    assert forbidden_modules({"repro_torch", "repro_torch.serve", "jaxtyping"}) == []
    assert forbidden_modules({"repro.models", "jax.numpy", "flax"}) == ["flax", "jax", "repro"]


def test_run_exits_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "qwen2-1.5b.long_prefill",
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.path[0] = '.'\n"
            "from portbench.harness.runner import run_cell\n"
            "run_cell('.', 'qwen2-1.5b.long_prefill', 1, 0.1, False, device='cpu')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "repro_torch" in out.stderr
