"""The registry finds each piece by its name, refuses names and units
outside the contract, and takes a new cell from new files alone."""
import json
import shutil

import pytest

from portbench.registry import ROOT, Registry, check_name, check_unit


def test_every_cell_resolves_to_its_files():
    reg = Registry()
    for w in reg.spec["workloads"]:
        cfg = reg.config(w["config"])
        assert cfg["name"] == w["config"]
        traffic = reg.traffic(w["traffic"])
        assert callable(reg.driver(traffic.get("driver", cfg["driver"])).run)
        assert reg.end_to_end(w["name"]), w["name"]
        assert reg.per_layer(w["name"]), w["name"]


def test_each_reader_names_the_layer_unit_and_metric_of_the_benchmark():
    reg = Registry()
    for m in reg.spec["per_layer"]:
        mod = reg.metric_reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
            m["layer"], m["unit"], m["moves"]), m["name"]
        for w in m["workloads"]:
            assert m["moves"] in [e["name"] for e in reg.end_to_end(w)]


def test_config_files_are_the_benchmark_entries():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"]
        assert set(doc["reduced"]) == set(c["reduced"])


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "-lead",
                                 "µs", "x" * 65, "tab\there"])
def test_names_outside_the_contract_are_refused(bad):
    with pytest.raises(ValueError):
        check_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per s", "x" * 17, "µs"])
def test_units_outside_the_contract_are_refused(bad):
    with pytest.raises(ValueError):
        check_unit(bad)


@pytest.mark.parametrize("good", ["tokens/s", "%", "launches/step", "ms"])
def test_units_inside_the_contract_pass(good):
    assert check_unit(good) == good


def test_a_bad_name_in_benchmark_json_is_refused(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"][0]["traffic"] = "has space"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError):
        Registry(path)


def test_a_new_cell_needs_only_new_files_and_an_entry(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((base / "traffic" / "lpips_on.json").read_text())
    traffic["overrides"]["model.densification_interval"] = 50
    (base / "traffic" / "lpips_on_dense.json").write_text(json.dumps(traffic))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(
        name="hand_lpips_dense", config="hand_720p",
        traffic="lpips_on_dense", chips=1, why="a denser densify cadence"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "hand_lpips" in m.get("workloads", []):
            m["workloads"].append("hand_lpips_dense")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    reg = Registry(path, base)
    w = reg.workload("hand_lpips_dense")
    assert reg.traffic(w["traffic"])["overrides"][
        "model.densification_interval"] == 50
    assert reg.config(w["config"])["driver"] == "hand_train"
    assert {m["name"] for m in reg.per_layer("hand_lpips_dense")} == {
        m["name"] for m in reg.per_layer("hand_lpips")}
    assert "train_step_ms" in [m["name"] for m in reg.end_to_end(
        "hand_lpips_dense")]
