"""BENCHMARK.json's cells, configurations, traffic, limits and metrics
are found by name, and keep to the contract's names and units."""
import re

import pytest

from portbench.tests import tiny  # noqa: F401
from portbench import check, spec

WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|"
                   r"proj|head|expand|per_tok)", re.I)


def test_every_name_and_unit_keeps_to_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        spec.check_name(n)
    for m in b["end_to_end"] + b["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_cells_configurations_traffic_and_limits_are_found_by_name():
    b = spec.benchmark()
    for w in b["workloads"]:
        assert spec.cell(w["name"], b) is w
        config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
        assert config["name"] == w["config"]
        assert traffic["name"] == w["traffic"]
        assert set(spec.limits(w["name"])) == set(check.NUMBERS)
    with pytest.raises(KeyError):
        spec.cell("no-such-cell", b)


def test_each_traffic_names_parts_found_by_name():
    b = spec.benchmark()
    for w in b["workloads"]:
        traffic = spec.traffic(w["traffic"])
        parts = spec.parts(traffic)
        assert callable(parts["task"].objective)
        assert callable(parts["wire"].receive) and \
            callable(parts["wire"].held)
        assert callable(parts["optim"].first_gradient)
        assert callable(spec.part("data", traffic["data"]["kind"]).make)
        assert callable(spec.part("clients", traffic["task"]).bundle)
    for bad in ("no-such", "a.b", "../x"):
        with pytest.raises(ValueError):
            spec.part("data", bad)


def test_per_layer_metrics_have_readers_and_move_an_end_to_end_metric():
    b = spec.benchmark()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["name"][: -len("_roofline")] in \
                spec.kernels_with_costs()
    with pytest.raises(KeyError):
        spec.metric_reader("no_such_metric")


def test_configuration_files_state_their_cut_and_cut_no_width():
    for c in spec.benchmark()["configs"]:
        config = spec.config(c["name"])
        assert config["reduced"] == c["reduced"]
        for key in ("source", "assumed", "deployment", "reference"):
            assert config[key]
        for key in c["reduced"]:
            assert key in config["source_config"]
            assert config[key] != config["source_config"][key]
            assert not WIDTH.search(key), key


def test_the_program_runs_what_the_configuration_file_says():
    from portbench import fleet

    for c in spec.benchmark()["configs"]:
        config = spec.config(c["name"])
        cfg = fleet.model_config(config)
        ref = check.reference_module(config["reference"])
        assert fleet.param_shapes(cfg) == ref.leaves(config)
    bad = dict(spec.config("mamba2-370m"), d_model=2048)
    with pytest.raises(ValueError):
        fleet.model_config(bad)
