"""The port's CUDA kernels vs their plain versions, on the card.

CUDA kernels have no interpret mode, so these run only where a GPU is
present and skip elsewhere. On the machine with the card (which has no JAX,
so the JAX suite's conftest is left out) run
``python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py``.
chip_smoke.py holds the same kernels against their plain versions at the
main path's shapes; these cover the other shapes and options."""

import numpy as np
import pytest
import torch

from fourk_nerf_torch import weights
from fourk_nerf_torch.models import dmpigo
from fourk_nerf_torch.ops import cuda_sr, cuda_sweep, plane_sweep

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("use_bf16,width,depth,act", [
    (False, 32, 3, "lkrelu"),   # padded to the 64-wide kernel
    (True, 32, 3, "lkrelu"),
    (False, 100, 4, "gauss"),   # the 128-wide kernel, two hidden layers
    (True, 100, 4, "gauss"),    # the same with the bf16 MLP
    (False, 64, 2, "relu"),     # no hidden layer
])
def test_sweep_kernel_matches_plain(cuda, use_bf16, width, depth, act):
    """A mask at another resolution than the grid, viewdir and spatial PE."""
    cfg = dmpigo.make_config(
        xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
        num_voxels=32 * 32 * 16, mpi_depth=16, fast_color_thres=1.0 / 80,
        rgbnet_dim=6, rgbnet_width=width, rgbnet_depth=depth, viewbase_pe=4,
        spatial_pe=2, act_type=act)
    params, buffers = dmpigo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    rng = np.random.default_rng(0)
    params["density"] = torch.as_tensor(
        rng.normal(-1, 2, params["density"].shape).astype(np.float32), device=cuda)
    params["k0"] = torch.as_tensor(
        rng.normal(0, 1, params["k0"].shape).astype(np.float32), device=cuda)
    buffers["mask_cache"] = torch.as_tensor(rng.uniform(size=(9, 11, 8)) < 0.7,
                                            device=cuda)
    K = np.array([[40.0, 0, 20], [0, 40.0, 16], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 1.0
    kw = dict(stepsize=1.0, bg=0.5, use_bf16=use_bf16, device=cuda)
    n0 = cuda_sweep.sweep.launches
    got = cuda_sweep.render_frame_cuda(cfg, params, buffers, 32, 40, K, c2w, **kw)
    assert cuda_sweep.sweep.launches == n0 + 1
    ref = plane_sweep.render_frame(cfg, params, buffers, 32, 40, K, c2w, **kw)
    torch.cuda.synchronize()
    for k in ("rgb_marched", "depth", "alphainv_last"):
        err = (got[k] - ref[k]).abs()
        assert float((err > 2e-4).float().mean()) < 0.02, k
        assert float(err.max()) < 0.05, k


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("h,w", [(37, 55), (5, 9), (8, 16)])
def test_rdb_kernel_matches_plain(cuda, tail, h, w):
    """Frames that do not divide the 8x16 tile, smaller than it, and one
    exact tile: SAME zero padding at every frame edge."""
    model = weights.sftnet_init(num_block=1, seed=2, device=cuda)
    rng = np.random.default_rng(1)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                   device=cuda).to(torch.bfloat16)
    x, c, xin = t(h, w, 64), t(h, w, 32), t(h, w, 64)
    wts = cuda_sr.pack_rdb_weights(model.body0.rdb3,
                                   model.body0.sft0 if tail else None)
    got = cuda_sr.rdb_apply(x, c, wts, xin=xin if tail else None)
    ref = cuda_sr.rdb_plain(x, c, wts, xin=xin if tail else None)
    torch.cuda.synchronize()
    assert float((got.float() - ref.float()).abs().max()) <= 0.05
