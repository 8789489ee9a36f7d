"""``BENCHMARK.json`` keeps to the contract's shapes and characters, every
name it uses is a file the harness finds, and a configuration, a mix and a
per-layer metric are added as new files with no edit to any existing one."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024 and len(BENCH["command"]) <= 32


def test_entries_have_the_contracts_keys_and_characters():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cfg = harness.load_json("configs", w["config"])
        traffic = harness.load_json("traffic", w["traffic"])
        harness.load_loop(traffic["loop"])
        assert harness.load_json("limits", w["name"])
        e2e, per = harness.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
        for m in per:
            assert callable(harness.load_reader(m["name"]))
        assert cfg["source"] and "reduced" in cfg


def test_additions_are_new_files(tmp_path):
    """A dummy configuration, mix, loop-free metric and cell added as files:
    the harness lists and loads them, and every existing file is unchanged."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p.relative_to(bench_dir): p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "configs" / "dummy_cfg.json").write_text(json.dumps({"backbone": "resnet50", "source": "x",
                                                                       "reduced": []}))
    (bench_dir / "traffic" / "dummy_mix.json").write_text(json.dumps({"loop": "offline_stream", "size": [8, 8]}))
    (bench_dir / "layer_metrics" / "dummy_metric.offline.py").write_text("def read(trace):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg", "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_metric.offline", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "kernels", "moves": "serve_img_per_s"})
    assert harness.load_json("configs", "dummy_cfg", bench_dir)["backbone"] == "resnet50"
    assert harness.load_json("traffic", "dummy_mix", bench_dir)["loop"] == "offline_stream"
    assert harness.load_reader("dummy_metric.offline", bench_dir)(None) == 42.0
    e2e, per = harness.cell_metrics(bench, "dummy.cell")
    assert {m["name"] for m in e2e} == {"setup_s"}  # the cell lists no end-to-end metric of its own yet
    _, per_crowd = harness.cell_metrics(bench, "r50_512.serve.crowd")
    assert "dummy_metric.offline" in {m["name"] for m in per_crowd}  # no workloads key: every such cell
    after = {p.relative_to(bench_dir): p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_jax_side_module_is_loaded():
    """The whole top-level name is compared: the port's name begins with the
    JAX package's."""
    code = ("import sys; sys.modules.setdefault('maskrcnn_tf2_tpu_torch_x', sys); "
            "from benchmark import harness; import benchmark.run, benchmark.serving, benchmark.trace; "
            "import benchmark.loops.offline_stream, benchmark.control; "
            "import maskrcnn_tf2_tpu_torch.predictor, maskrcnn_tf2_tpu_torch.export.quantize; "
            "print(harness.forbidden_loaded()); sys.modules['maskrcnn_tf2_tpu.x'] = sys; "
            "print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                         check=True).stdout.split("\n")
    assert out[0] == "[]" and out[1] == "['maskrcnn_tf2_tpu']"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.model, benchmark.reference.ops; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('maskrcnn_tf2_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", BENCH["workloads"][0]["name"],
                           "--seed", "1", "--seconds", "1"], cwd=harness.ROOT, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""
