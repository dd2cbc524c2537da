"""Toy sizes of the benchmark's configurations for CPU tests: the same
configurations with their grids, frames, views, batches and decoder depth
cut so that a run takes seconds on the CPU."""

import copy
import functools

import pytest

from portbench import inputs

TINY = {
    "fern_lg": {"model": {"num_voxels": 90 * 100 * 64, "mpi_depth": 64},
                "camera": {"H": 72, "W": 96, "focal": 78.0},
                "decoder": {"num_block": 1}, "data": {"train_views": 2},
                "train": {"N_rand": 128}},
    "chair_syn": {"model": {"num_voxels": 64 ** 3, "num_voxels_base": 64 ** 3},
                  "camera": {"H": 96, "W": 96, "focal": 133.0},
                  "decoder": {"num_block": 1}, "data": {"train_views": 3},
                  "train": {"N_rand": 256}},
}
SEED = 3_000_000_017


def shrunk(read, name: str) -> dict:
    """The configuration ``read(name)`` at its toy sizes."""
    c = copy.deepcopy(read(name))
    for k, v in TINY[name].items():
        c[k].update(v)
    return c


@pytest.fixture
def tiny(monkeypatch):
    """``inputs.config`` returns the toy sizes while the test runs."""
    monkeypatch.setattr(inputs, "config",
                        functools.partial(shrunk, inputs.config))
