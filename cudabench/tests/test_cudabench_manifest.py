"""The manifest and every file it names parse and keep the contract's
limits; a new configuration and cell are added by files alone."""

import importlib.util
import json
import math
import re
import shutil
import time

import pytest

from cudabench import harness
from cudabench.tests.tiny import ROOT, TinyManifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


@pytest.fixture(scope="module")
def manifest():
    return harness.Manifest(ROOT)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths(manifest):
    d = manifest.data
    assert set(d) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(d["paths"]) <= 16
    for p in d["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(d["command"]) <= 32
    assert all(_line(w) for w in d["command"])
    assert (ROOT / d["command"][1]).is_file()
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51


def test_check_time_fits_with_24_cells(manifest):
    rs = manifest.data["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(manifest):
    configs = manifest.data["configs"]
    assert 1 <= len(configs) <= 24
    used = {w["config"] for w in manifest.data["workloads"]}
    files = set()
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(manifest.data["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        body = manifest.config(c["name"])
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert (manifest.bench / "reference"
                / f"model_{body['model']['name']}.py").is_file()


def test_workloads(manifest):
    cells = manifest.data["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in cells}
    assert len(pairs) == len(cells)
    assert len({w["name"] for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        t = manifest.traffic(w["traffic"])
        assert t["step"] in ("adversarial", "supervised")
        e2e = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in e2e and t["rate_metric"] in e2e and len(e2e) >= 2
        assert manifest.per_layer(w["name"])
        limits = manifest.limits(w["name"])
        assert limits and all(v > 0 for v in limits.values())


def test_metrics(manifest):
    d = manifest.data
    names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(d["end_to_end"]) <= 16
    assert 1 <= len(d["per_layer"]) <= 128
    cells = {w["name"] for w in d["workloads"]}
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    setup = next(m for m in d["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    e2e = {m["name"] for m in d["end_to_end"]}
    layers = {}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"]
                                  for x in manifest.end_to_end(cell)}
        layers.setdefault(m["layer"], []).append(m["name"])
        path = manifest.bench / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
        if m["name"].split(".")[-2:-1] == ["roofline_share"] or "mfu" in \
                m["name"]:
            assert m["unit"] == "%"
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_rooflines(manifest):
    rows = manifest.rooflines()
    assert rows
    for r in rows:
        assert set(r) == {"pattern", "work", "counter"}
        assert re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", r["pattern"])
        assert _line(r["work"])


def test_files_are_named_from_name_characters(manifest):
    for p in manifest.bench.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_a_new_config_and_cell_are_files_alone(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix and its
    limits as new files and entries, and run the new cell on the CPU."""
    shutil.copytree(ROOT / "cudabench", tmp_path / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "cudabench"
    cfg = json.loads((bench / "configs" / "unet16_cardiac2d.json")
                     .read_text())
    cfg.update(name="unet8_test", reduced=[])
    cfg["model"]["args"]["feature_scale"] = 8
    (bench / "configs" / "unet8_test.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "workloads" / "sup_b128.json").read_text())
    traffic["batch"] = 2
    (bench / "workloads" / "sup_b2_test.json").write_text(json.dumps(traffic))
    (bench / "limits" / "unet8_test.sup_b2_test.json").write_text(
        json.dumps({"loss_sup1": 2e-6, "grad1": 1e-3}))
    data["configs"].append({"name": "unet8_test", "source": "test",
                            "file": "cudabench/configs/unet8_test.json",
                            "reduced": [], "why": "test"})
    data["workloads"].append({"name": "unet8_test.sup_b2_test",
                              "config": "unet8_test",
                              "traffic": "sup_b2_test", "chips": 1,
                              "why": "test"})
    for m in data["end_to_end"] + data["per_layer"]:
        if "unet16_cardiac2d.sup_b128" in m.get("workloads", []):
            m["workloads"].append("unet8_test.sup_b2_test")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    class Small(TinyManifest):
        pass

    m = Small(tmp_path)
    assert m.config("unet8_test")["model"]["args"]["feature_scale"] == 8
    result = harness.run_cell(m, "unet8_test.sup_b2_test", 2 ** 31 + 7, 0.2,
                              False, "cpu", time.time(), log=lambda s: None)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"train_img_s", "peak_mem_gib",
                                      "setup_s"}
    assert list(result)[-1] == "check"
    assert all(math.isfinite(v["value"]) for v in result["metrics"].values())
