"""Port parity: the config loader and its eight configs, the LLFF dataset
loader, the statistics collector and the scalar writer of
fourk_nerf_torch vs the JAX package. Configs load to equal dicts; the
loader gives equal arrays (bitwise: both are the same numpy code)."""

import os
import types

import numpy as np
import pytest
import torch

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.data import load_data as jload_data
from fourk_nerf_tpu.utils import stats as jstats
from fourk_nerf_torch import config as tconfig
from fourk_nerf_torch.data import load_data as tload_data
from fourk_nerf_torch.utils import logging as tlogging, stats as tstats

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = sorted(
    os.path.relpath(os.path.join(d, f),
                    os.path.join(ROOT, "fourk_nerf_tpu", "configs"))
    for d, _, fs in os.walk(os.path.join(ROOT, "fourk_nerf_tpu", "configs"))
    for f in fs if f.endswith(".py"))


def _plain(cfg):
    d = cfg.to_dict()
    d.pop("_config_path")
    return d


def test_the_port_has_every_config():
    assert len(CONFIGS) == 8
    for rel in CONFIGS:
        assert os.path.isfile(os.path.join(ROOT, "fourk_nerf_torch",
                                           "configs", rel)), rel


@pytest.mark.parametrize("rel", CONFIGS)
def test_config_loads_to_the_jax_dict(rel):
    j = jconfig.load_config(os.path.join(ROOT, "fourk_nerf_tpu", "configs",
                                         rel))
    t = tconfig.load_config(os.path.join(ROOT, "fourk_nerf_torch", "configs",
                                         rel))
    assert _plain(t) == _plain(j)
    assert t.fine_train.N_rand == t["fine_train"]["N_rand"]


def test_dump_config_round_trip(tmp_path):
    cfg = tconfig.load_config(os.path.join(
        ROOT, "fourk_nerf_torch", "configs", "llff", "fern_lg_pretrain.py"))
    path = str(tmp_path / "cfg" / "config.py")
    tconfig.dump_config(cfg, path)
    assert _plain(tconfig.load_config(path)) == _plain(cfg)


def _write_llff_scene(base, n=5, h=12, w=16, seed=0):
    """A tiny LLFF scene on disk: images/ at 4x and images_4/, and
    poses_bounds.npy in the LLFF storage convention."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(seed)
    for sub, s in (("images", 4), ("images_4", 1)):
        os.makedirs(os.path.join(base, sub))
        for i in range(n):
            img = rng.integers(0, 256, (h * s, w * s, 3), dtype=np.uint8)
            imageio.imwrite(os.path.join(base, sub, f"im_{i:03d}.png"), img)
    rows = []
    for i in range(n):
        c2w = np.eye(4)[:3]
        c2w[:, 3] = (0.05 * i, -0.02 * i, 1.0 + 0.01 * i)
        stored = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2], c2w[:, 3]], 1)
        hwf = np.array([[4 * h], [4 * w], [60.0]])
        rows.append(np.concatenate([np.concatenate([stored, hwf], 1)
                                    .reshape(-1), [1.5, 12.0 + i]]))
    np.save(os.path.join(base, "poses_bounds.npy"), np.stack(rows))


def _data_cfg(path, base, **kw):
    cfg = path.load_config(os.path.join(
        ROOT, path.__name__.split(".")[0], "configs", "llff",
        "fern_lg_pretrain.py"))
    cfg.data.datadir = base
    cfg.data.llffhold = 2
    for k, v in kw.items():
        cfg.data[k] = v
    return cfg.data


@pytest.mark.parametrize("ndc", [True, False])
def test_llff_loader_matches_jax(tmp_path, ndc):
    base = str(tmp_path / "scene")
    _write_llff_scene(base)
    j = jload_data(_data_cfg(jconfig, base, ndc=ndc))
    t = tload_data(_data_cfg(tconfig, base, ndc=ndc))
    assert set(t) == set(j)
    for k in j:
        if isinstance(j[k], np.ndarray):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        else:
            assert np.all(np.asarray(t[k]) == np.asarray(j[k])), k
    assert t["images"].shape == (5, 12, 16, 3)
    assert list(t["i_test"]) == [0, 2, 4] and list(t["i_train"]) == [1, 3]


def test_collector_matches_jax_and_keeps_device_sums():
    rng = np.random.default_rng(0)
    jc, tc = jstats.Collector(), tstats.Collector()
    for _ in range(4):
        x = rng.normal(size=7).astype(np.float32)
        jc.report("a", jstats.moments(x))
        m = tstats.moments(torch.as_tensor(x))
        assert isinstance(m, torch.Tensor) and m.shape == (3,)
        tc.report("a", m)
    jc.report_scalar("lr", 0.5)
    tc.report_scalar("lr", 0.5)
    for name in ("a", "lr"):
        js, ts = jc.as_dict()[name], tc.as_dict()[name]
        np.testing.assert_allclose(
            (ts.num, ts.total, ts.total_sq, ts.mean, ts.std),
            (js.num, js.total, js.total_sq, js.mean, js.std), rtol=1e-6)
    assert tc.mean("missing", 1.5) == 1.5
    tc.reset()
    assert tc.as_dict() == {}


def test_scalar_writer_and_provenance(tmp_path):
    w = tlogging.ScalarWriter(str(tmp_path / "tb"))
    w.scalar("train/loss", 0.25, 3)
    w.close()
    with open(tmp_path / "tb" / "scalars.tsv") as f:
        fields = f.read().strip().split("\t")
    assert fields[1:] == ["3", "train/loss", "0.25"]
    cfg = tconfig.load_config(os.path.join(
        ROOT, "fourk_nerf_torch", "configs", "llff", "llff_default_lg.py"))
    tlogging.dump_provenance(cfg, types.SimpleNamespace(seed=1, device="cpu"),
                             str(tmp_path / "run"))
    with open(tmp_path / "run" / "args.txt") as f:
        assert f.read() == "device = cpu\nseed = 1\n"
    assert os.path.isfile(tmp_path / "run" / "config.py")


def test_misc_helpers_match_jax():
    from fourk_nerf_tpu.utils import misc as jmisc
    from fourk_nerf_torch.utils import misc as tmisc

    x = torch.zeros(2, 3)
    tmisc.assert_shape(x, [2, None])
    for bad in ([3, None], [2]):
        with pytest.raises(AssertionError):
            tmisc.assert_shape(x, bad)
    a = tmisc.infinite_sampler(5, np.random.default_rng(0), rank=1,
                               num_replicas=2)
    b = jmisc.infinite_sampler(5, np.random.default_rng(0), rank=1,
                               num_replicas=2)
    assert [next(a) for _ in range(9)] == [next(b) for _ in range(9)]
