"""Every configuration, traffic mix, stream generator, per-layer metric and
limit file that BENCHMARK.json names loads by name from a file of its own."""

import json

import pytest

from pointslot_torch.config import load_yaml
from slotbench import check, run
from slotbench.traffic import scene as sc

BENCH = run.load_benchmark()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_loads(config):
    path = run.ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("slotbench/configs/")
    cfg = load_yaml(str(path))
    assert cfg.camera.width == 1242 and cfg.camera.height == 375
    assert cfg.orb.n_features == 1000 and cfg.orb.n_levels == 8
    assert config["name"].endswith(f"mode{cfg.slot_mode}")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_mix_and_limits(cell):
    mix = sc.load_mix(cell["traffic"])
    assert mix["warmup_frames"] > 0
    assert callable(sc.generator(mix["generator"]).make_stream)
    limits = check.load_limits(cell["name"])
    assert limits and set(limits) <= set(check.NUMBERS)
    assert cell["chips"] == 1


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_loads(metric):
    mod = run.metric_module(metric["name"])
    assert callable(mod.install) and callable(mod.read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_the_contract_minimum():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(BENCH, "end_to_end", cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(BENCH, "per_layer", cell["name"])


def test_benchmark_file_is_small_and_has_the_contract_keys():
    text = (run.ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) < 64 * 1024
    assert set(json.loads(text)) == {"command", "paths", "run_seconds", "configs", "workloads",
                                     "end_to_end", "per_layer"}
