"""A run's result line, and what the harness refuses."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run as run_mod
from portbench.registry import ROOT, Registry
from portbench.tests.conftest import tiny

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,trace", [("hand_lpips", False),
                                            ("composite_gt_eval", True)])
def test_the_line_has_the_contract_keys(workload, trace):
    reg = Registry()
    line = run_mod.run_cell(reg, workload, 2**31 + 7, 0.5, trace,
                            device="cpu", scale=tiny(workload))
    keys = list(line)
    assert keys[:5] == CONTRACT
    assert keys[-1] == "compared"
    assert set(keys) <= set(CONTRACT) | {"breakdown", "compared"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = reg.per_layer(workload) if trace else reg.end_to_end(workload)
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert set(line["metrics"]) == names
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hand_lpips",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from portbench import run as r;"
        "from portbench.registry import Registry;"
        "from portbench.tests.conftest import tiny;"
        "[r.run_cell(Registry(), w, 3, 0.2, False, device='cpu',"
        " scale=tiny(w)) for w in ('hand_lpips', 'composite_gt_eval')];"
        "tops = {m.split('.')[0] for m in sys.modules};"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'manus_tpu', "
        "'bench', 'manus_tpu_torch'}), r.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "['manus_tpu_torch'] []"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run_mod.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("manus_tpu_torch.fake", "benchmark_fake", "jaxlike"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "manus_tpu.fake", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run_mod.forbidden_modules() == ["jax", "manus_tpu"]
