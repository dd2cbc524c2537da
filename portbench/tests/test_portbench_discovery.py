"""Configurations, mixes, metric readers and limits are found by name."""

import importlib

import pytest
import torch

from portbench import inputs, judge, program, run
from portbench.reference import common as C


@pytest.fixture(scope="module")
def bench():
    return run.manifest()


def test_configs_mixes_drivers_and_limits_load_by_name(bench):
    for w in bench["workloads"]:
        cfg = inputs.config(w["config"])
        tr = inputs.traffic(w["traffic"])
        fam = C.family(cfg["family"])
        assert callable(fam.alpha) and callable(fam.colour)
        kind = importlib.import_module(f"portbench.scenes."
                                       f"{cfg['scene']['kind']}")
        assert callable(kind.grids)
        driver = importlib.import_module(f"portbench.drivers.{tr['kind']}")
        assert callable(driver.run)
        assert set(tr) <= driver.KEYS
        assert set(judge.limits(w["name"]))


def test_program_parts_are_found_by_name(bench):
    """The program's family module, configuration object and launch
    counters come by name; every counter a render mix expects exists."""
    found = program.counters()
    assert {"cuda_sweep.sweep", "cuda_box.sweep_box",
            "cuda_sr.rdb_apply"} <= set(found)
    for w in bench["workloads"]:
        cfg = inputs.config(w["config"])
        tr = inputs.traffic(w["traffic"])
        assert program.model_module(cfg).__name__.endswith(cfg["family"])
        assert tuple(program.model_config(cfg).world_size) == \
            C.world_size(cfg["family"], cfg["model"])
        assert set(tr.get("launches_per_frame", {})) <= set(found)


@pytest.mark.parametrize("kind", ["render", "train"])
def test_a_key_a_driver_does_not_read_is_refused(kind):
    """A mix key that no driver reads (such as a client count) is refused,
    not ignored."""
    driver = importlib.import_module(f"portbench.drivers.{kind}")
    ctx = run.Context("x", {}, {"kind": kind, "clients": 8}, 1, 1.0, False,
                      torch.device("cpu"), False)
    with pytest.raises(ValueError, match="clients"):
        driver.run(ctx)


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, group):
    for m in bench[group]:
        assert callable(run.reader(m["name"])), m["name"]


def test_readers_return_nothing_without_their_data(bench):
    empty = {"setup_s": 1.0, "config": inputs.config("fern_lg")}
    for m in bench["per_layer"]:
        assert run.reader(m["name"])(empty) is None, m["name"]


def test_metrics_of_a_cell(bench):
    names = [m["name"] for m in run.metrics_of(bench, "fern_lg.render_4k",
                                               False)]
    assert set(names) == {"fps", "frame_p95_ms", "setup_s"}
    names = [m["name"] for m in run.metrics_of(bench, "fern_lg.pretrain",
                                               True)]
    assert "train_mfu" in names and "rdb_roofline.render" not in names


def test_unknown_names_are_refused(bench):
    with pytest.raises(SystemExit):
        run.cell_of(bench, "no.such_cell")
    with pytest.raises(FileNotFoundError):
        inputs.config("no_such_config")


def test_seeded_paths_share_their_poses():
    tr = inputs.traffic("render_4k")["path"]
    a, b = inputs.path(tr, 1), inputs.path(tr, 3_000_000_017)
    key = lambda ps: sorted(p.tobytes() for p in ps)  # noqa: E731
    assert key(a) == key(b)
    assert inputs.path(tr, 5)[0].tobytes() == inputs.path(tr, 5)[0].tobytes()
