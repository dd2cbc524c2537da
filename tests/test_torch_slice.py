"""The port's slice as a whole: a tiny scene -> encoder render -> SFTNet
decode through fourk_nerf_torch.pipeline (on the CPU, the kernels' plain
versions) vs the JAX chain (plane sweep -> sftnet_apply_pallas in interpret
mode), with weights carried over by fourk_nerf_torch.weights. Plus the
port's rules: no JAX and nothing of fourk_nerf_tpu in the package or in
chip_smoke.py, and no silent CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import sr_esrnet as jsr
from fourk_nerf_tpu.ops import pallas_sweep, plane_sweep as jps
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import dmpigo as td
from fourk_nerf_torch.ops import cuda_sweep
from fourk_nerf_torch.pipeline import FramePipeline
from test_plane_sweep import _cam, _scene
from test_torch_sr import numpy_params, sftnet_pallas
from test_torch_sweep import port_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fourk_nerf_torch")


@pytest.mark.parametrize("use_bf16", [False, True])
def test_slice_matches_jax_chain(use_bf16):
    """float32: the XLA plane sweep -> Pallas SFTNet; bf16 (the main path's
    precision): the Pallas sweep with use_bf16 -> Pallas SFTNet."""
    cfg, params, buffers = _scene()
    H, W = 24, 32
    K, c2w = _cam(H, W)
    model = jsr.SFTNet(n_in_colors=3, scale=4, num_feat=64, num_block=1,
                       num_grow_ch=32, num_cond=1)
    sp = numpy_params(model, np.random.default_rng(1), jnp.zeros((1, 8, 8, 3)),
                      jnp.zeros((1, 8, 8, 1)))

    render = pallas_sweep.render_frame_pallas if use_bf16 else jps.render_frame
    kw = dict(interpret=True) if use_bf16 else {}
    enc = render(cfg, params, buffers, H, W, K, c2w, stepsize=1.0, bg=1.0,
                 tile=8, patch=24, use_bf16=use_bf16, **kw)
    ref = np.asarray(sftnet_pallas(sp, enc["rgb_feature"][None],
                                   enc["depth"][None, ..., None]))

    tcfg, tp, tb = port_scene(cfg, params, buffers)
    pipe = FramePipeline(tcfg, tp, tb, weights.sftnet_from_flax(sp, "cpu"),
                         use_bf16=use_bf16, device="cpu")
    sr, tenc = pipe(H, W, K, c2w)
    np.testing.assert_allclose(tenc["rgb_feature"].numpy(),
                               np.asarray(enc["rgb_feature"]), atol=2e-4)
    np.testing.assert_allclose(tenc["depth"].numpy(), np.asarray(enc["depth"]),
                               atol=2e-4)
    assert sr.shape == ref.shape == (1, 4 * H, 4 * W, 3)
    assert bool(torch.isfinite(sr).all())
    assert float(np.abs(sr.numpy() - ref).max()) < 0.05


def test_import_leaves_jax_out():
    code = ("import sys, pkgutil, importlib, fourk_nerf_torch\n"
            "for m in pkgutil.walk_packages(fourk_nerf_torch.__path__, "
            "'fourk_nerf_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'fourk_nerf_tpu')]\n"
            "print(len(bad), bad[:5])\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_do_not_name_the_jax_package():
    srcs = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        srcs += [os.path.join(root, f) for f in files
                 if f.endswith((".py", ".cu", ".cuh"))]
    assert len(srcs) > 10
    for path in srcs:
        with open(path) as f:
            text = f.read()
        for line in text.splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not s.split()[1].split(".")[0] in (
                    "jax", "jaxlib", "flax", "fourk_nerf_tpu"), (path, s)
        if path.startswith(PKG):
            assert "fourk_nerf_tpu" not in text, path


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    cfg = td.make_config(xyz_min=[-1, -1, -1], xyz_max=[1, 1, 1],
                         num_voxels=8 * 8 * 4, mpi_depth=4, rgbnet_dim=3,
                         rgbnet_width=16)
    K, c2w = _cam(8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        td.init(cfg)
    params, buffers = td.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_sweep.render_frame_cuda(cfg, params, buffers, 8, 8, K, c2w,
                                     stepsize=1.0, bg=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        FramePipeline(cfg, params, buffers,
                      weights.sftnet_init(num_block=1, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        weights.sftnet_init(num_block=1)


def test_kernel_sources_are_present():
    from fourk_nerf_torch.ops import _build
    for name in _build.KERNELS:
        path = os.path.join(_build.CSRC, f"{name}.cu")
        with open(path) as f:
            text = f.read()
        assert f'extern "C" int {name}_launch' in text
        assert "sm_90a" in " ".join(_build.FLAGS)
