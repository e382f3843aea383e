"""The result line carries the contract's keys, the compared numbers last;
the entry point refuses to run without a card; the harness loads no JAX."""

import json
import subprocess
import sys

import pytest
import torch

from slotbench import run
from slotbench.tests.helpers import small_run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_keys(trace):
    res = small_run("mode4.drive_cars4", trace=trace, frames=4)
    res.pop("numbers")
    assert set(res) <= KEYS and list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    bench = run.load_benchmark()
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in run.cell_metrics(bench, kind, "mode4.drive_cars4")}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    json.dumps(res)


def test_entry_point_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "mode0.drive", "--seed", str(2 ** 31 + 3), "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_harness_loads_no_jax():
    code = ("import sys, slotbench.run, slotbench.check, slotbench.calibrate, slotbench.tracer,"
            " slotbench.capture, slotbench.hooks;"
            "from slotbench import run;"
            "[run.metric_module(m['name']) for m in run.load_benchmark()['per_layer']];"
            "from slotbench.traffic import scene;"
            "[scene.generator(scene.load_mix(w['traffic'])['generator'])"
            " for w in run.load_benchmark()['workloads']];"
            "import pointslot_torch.slam.system;"
            "print(run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.card
def test_cell_on_the_card_is_correct(card):
    """A short window of each cell at full size on the card."""
    bench = run.load_benchmark()
    for cell in bench["workloads"]:
        res = run.run_cell(bench, cell["name"], 2 ** 31 + 17, 5.0, False)
        assert res["correct"], res["checks"]
