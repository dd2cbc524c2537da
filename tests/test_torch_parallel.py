"""``parallel/`` on ``torch.distributed`` against the JAX package: one
2-process ``gloo`` world on the CPU (``torch_parallel_worker.py``, spawned
once for the module, with a timeout of its own) runs every check and
saves what it found; each test reads its part. The world joins through
``maybe_initialize_distributed`` from the ``torchrun`` environment.

Checked: the 2x1 and 1x2 meshes; a DirectMPIGO forward with the rays
split over ``data`` and with the grids split along X over ``grid`` (the
readers gather them whole, and the gradient reaches the shards) against
the JAX ``dmpigo.forward``; ``all_reduce_dict``; the replica check passing
and naming the leaf a rank perturbed; ``tile_process_sharded`` against
``tile_process`` (bitwise) and the JAX ``tile_process``;
``render_frame_box(tile_mesh=...)`` through the plain version against the
one-rank frame (1e-6: the rgbnet matmul rounds by its rows);
``--multihost`` without a rendezvous raising.

Tolerances: forwards 1e-5 of the JAX forward (as
``test_torch_dmpigo_train.py``), the sharded gradient 1e-6 of the
unsharded one's largest entry, the tiled decode 1e-4 of the JAX one (as
``test_torch_tile.py``)."""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import dmpigo as jd, sr_esrnet as jsr
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import dmpigo as td
from fourk_nerf_torch.tools import tiny_scene

from test_torch_dmpigo_train import CFG_KW, _rays
from test_torch_sr import numpy_params

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
TIMEOUT = 240  # seconds for the whole world; a hung rendezvous fails


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _scene() -> dict:
    """Everything the ranks compute on, drawn here with numpy."""
    rng = np.random.default_rng(0)
    jcfg = jd.make_config(**CFG_KW)
    p, b = jd.init(jcfg, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: rng.normal(0, 0.7, a.shape).astype(
        np.float32), p)
    p["density"] = rng.normal(-1, 2, p["density"].shape).astype(np.float32)
    b = {"act_shift": np.asarray(b["act_shift"]),
         "mask_cache": rng.uniform(size=jcfg.mask_cache_world_size) < 0.8}
    sftnet = numpy_params(jsr.SFTNet(n_in_colors=3, scale=2, num_feat=8,
                                     num_block=1, num_grow_ch=4, num_cond=1),
                          rng, jnp.zeros((1, 8, 8, 3)),
                          jnp.zeros((1, 8, 8, 1)))
    dvgo_kw = dict(xyz_min=[-1.5] * 3, xyz_max=[1.5] * 3,
                   num_voxels=16 ** 3, num_voxels_base=16 ** 3,
                   alpha_init=1e-2, rgbnet_dim=6, rgbnet_width=16,
                   fast_color_thres=1e-4)
    from fourk_nerf_torch.models import dvgo
    bc = dvgo.make_config(**dvgo_kw)
    bp, _ = dvgo.init(bc, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    X, Y, Z = bc.world_size
    f = tiny_scene.blender_focal(19)
    K = np.array([[f, 0, 9.5], [0, f, 8.5], [0, 0, 1]], np.float32)
    return {
        "dmpigo_kw": CFG_KW, "dmpigo_params": p, "dmpigo_buffers": b,
        "rays": [np.ascontiguousarray(a) for a in _rays()],
        "sftnet": jax.tree.map(np.asarray, sftnet),
        "sr_input": (rng.uniform(size=(1, 21, 18, 3)).astype(np.float32),
                     rng.uniform(size=(1, 21, 18, 1)).astype(np.float32)),
        "dvgo_kw": dvgo_kw,
        "dvgo_params": {
            "density": rng.normal(-2, 3, (X, Y, Z, 1)).astype(np.float32),
            "k0": rng.normal(0, 1, (X, Y, Z, bc.k0_dim)).astype(np.float32),
            "rgbnet": {k: v.numpy() for k, v in bp["rgbnet"].items()}},
        "dvgo_buffers": {"mask_cache": rng.uniform(size=(X, Y, Z)) < 0.7},
        "box_camera": (K, tiny_scene.bounded_poses(3)[1][:3, :4]),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world once; the scene and each rank's results."""
    out = tmp_path_factory.mktemp("parallel")
    scene = _scene()
    torch.save(scene, out / "scene.pt")
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(WORLD),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         str(out)], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return scene, ranks


def _jax_forward(scene):
    jcfg = jd.make_config(**scene["dmpigo_kw"])
    out = jax.jit(lambda p, b, *rays: jd.forward(
        jcfg, p, b, *rays, stepsize=1.0, bg=0.5, ndc_planes=True))(
        jax.tree.map(jnp.asarray, scene["dmpigo_params"]),
        jax.tree.map(jnp.asarray, scene["dmpigo_buffers"]),
        *(jnp.asarray(a) for a in scene["rays"]))
    return {k: np.asarray(out[k]) for k in ("rgb_marched", "alphainv_last")}


@pytest.mark.parametrize("which", [0, 1])
def test_mesh_shapes(world, which):
    _, ranks = world
    for r in ranks:
        assert r["mesh_shapes"][which] == ((2, 1), (1, 2))[which]
        assert tuple(r["mesh_names"][which]) == ("data", "grid")
    assert [r["master"] for r in ranks] == [True, False]


@pytest.mark.parametrize("mode", ["dp", "grid"])
def test_dmpigo_forward_matches_jax(world, mode):
    scene, ranks = world
    want = _jax_forward(scene)
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(r[mode][k].numpy(), v, rtol=0,
                                       atol=1e-5, err_msg=k)
    if mode == "grid":  # 16 x-planes split over 2 ranks
        assert [r["grid_local_x"] for r in ranks] == [8, 8]


def test_grid_sharded_gradient_reaches_the_shards(world):
    scene, ranks = world
    cfg = td.make_config(**scene["dmpigo_kw"])
    p, b = weights.dmpigo_from_numpy(scene["dmpigo_params"],
                                     scene["dmpigo_buffers"], device="cpu")
    leaves = [p["density"].requires_grad_(True), p["k0"].requires_grad_(True)]
    out = td.forward(cfg, p, b, *(torch.as_tensor(a) for a in scene["rays"]),
                     stepsize=1.0, bg=0.5, ndc_planes=True)
    want = torch.autograd.grad(out["rgb_marched"].sum(), leaves)
    for r in ranks:
        for g, w in zip(r["grid_grads"], want):
            assert float(w.abs().max()) > 0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-6 * float(w.abs().max()))


def test_all_reduce_dict(world):
    _, ranks = world
    for r in ranks:
        got = r["all_reduce"]
        assert float(got["loss"]) == 1.5
        assert float(got["vec"]) == 0.75
        assert float(got["nested"]["host"]) == 3.0


@pytest.mark.parametrize("which,leaf", [(0, "/plain"), (1, "/net/w")])
def test_replica_check_names_the_perturbed_leaf(world, which, leaf):
    _, ranks = world
    for r in ranks:  # every rank raises, for the same leaf
        assert r["replica_errors"][which] == f"replica mismatch at {leaf}"


def test_tile_process_sharded_matches_tile_process_and_jax(world):
    scene, ranks = world
    for r in ranks:
        assert torch.equal(r["tile_sharded"], r["tile_plain"])
    img, cond = scene["sr_input"]
    model = jsr.SFTNet(n_in_colors=3, scale=2, num_feat=8, num_block=1,
                       num_grow_ch=4, num_cond=1)
    fwd = jax.jit(lambda pp, x, c: model.apply({"params": pp}, x, c))
    want = np.asarray(jsr.tile_process(
        fwd, jax.tree.map(jnp.asarray, scene["sftnet"]), jnp.asarray(img),
        jnp.asarray(cond), 8, tile_pad=2, scale=2))
    got = ranks[0]["tile_sharded"].numpy()
    assert got.shape == want.shape == (1, 42, 36, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def test_render_frame_box_over_the_mesh(world):
    """Each rank sweeps half the rays: the plain version's rgbnet matmul
    rounds by the rows it is given, so the frame is held to 1e-6 here (on
    the card, chip_smoke holds the kernel's to the one-rank frame
    bitwise)."""
    _, ranks = world
    for r in ranks:
        for k, v in r["box_plain"].items():
            np.testing.assert_allclose(r["box_sharded"][k].numpy(),
                                       v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    assert float((1 - ranks[0]["box_plain"]["alphainv_last"]).max()) > 0.1


@pytest.mark.parametrize("module", ["run", "run_sr"])
def test_multihost_without_a_rendezvous_raises(tmp_path, monkeypatch,
                                               module):
    import importlib
    from fourk_nerf_torch import config as tconfig
    mod = importlib.import_module(f"fourk_nerf_torch.{module}")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    cfg = tconfig.load_config(os.path.join(
        HERE, "..", "fourk_nerf_torch", "configs", "llff",
        "fern_lg_pretrain.py"))
    cfg.basedir = str(tmp_path)
    args = mod.config_parser().parse_args(
        ["--config", "c.py", "--device", "cpu", "--multihost"])
    with pytest.raises(RuntimeError, match="torchrun"):
        mod.run(args, cfg, {})
    assert not torch.distributed.is_initialized()
    assert not any(tmp_path.iterdir())
