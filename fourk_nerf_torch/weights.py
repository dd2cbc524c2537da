"""Parameters into the port: numpy trees of the JAX package's layout, the
SFTNet flax tree, and the trained-content anchor asset.

The dmpigo ``params``/``buffers`` dicts keep their layout (grids
``[X,Y,Z,C]``, rgbnet ``{w0,b0,...}`` with ``w [Cin,W]``) and only become
tensors. The SFTNet flax tree (``conv_first``, ``cond0..3``,
``body{i}/rdb{j}/conv{k}``, ``.../sft0/scale0``, ...; kernels HWIO) maps
by name onto :class:`~fourk_nerf_torch.models.sr_esrnet.SFTNet` (OIHW).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import dmpigo, sr_esrnet
from fourk_nerf_torch.ops import grid_sample

ANCHOR_ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "assets", "med_sr_grids_f16.npz")


def to_torch(tree, device="cpu"):
    """Nested dict of arrays -> the same dict of tensors on ``device``
    (bool stays bool, floats become float32)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    dtype = torch.bool if arr.dtype == bool else torch.float32
    return torch.tensor(arr, dtype=dtype, device=device)


def dmpigo_from_numpy(params, buffers, device=None):
    """JAX-layout dmpigo ``params``/``buffers`` (numpy-convertible) ->
    tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return to_torch(params, dev), to_torch(buffers, dev)


def sftnet_from_flax(tree: dict, device=None) -> sr_esrnet.SFTNet:
    """Build an :class:`SFTNet` from a flax ``params`` tree, inferring its
    shape (input colours, condition channels, blocks, scale)."""
    dev = resolve_device(device)
    num_block = sum(1 for k in tree if k.startswith("body"))
    scale = 4 if "conv_up2" in tree else 2 if "conv_up1" in tree else 1
    model = sr_esrnet.SFTNet(
        n_in_colors=int(np.shape(tree["conv_first"]["kernel"])[2]),
        scale=scale,
        num_feat=int(np.shape(tree["conv_first"]["kernel"])[3]),
        num_block=num_block,
        num_grow_ch=int(np.shape(tree["body0"]["rdb1"]["conv1"]["kernel"])[3])
        if num_block else 32,
        num_cond=int(np.shape(tree["cond0"]["kernel"])[2]))
    with torch.no_grad():
        for path, mod in model.named_modules():
            if not isinstance(mod, sr_esrnet.Conv):
                continue
            node = tree
            for part in path.split("."):
                node = node[part]
            k = torch.tensor(np.asarray(node["kernel"], np.float32))
            mod.weight.copy_(k.permute(3, 2, 0, 1))
            mod.bias.copy_(torch.tensor(np.asarray(node["bias"], np.float32)))
    return model.to(dev).eval()


def sftnet_init(*, num_block: int = 5, seed: int = 0,
                device=None) -> sr_esrnet.SFTNet:
    """A randomly initialised SFTNet drawn from a seeded
    ``torch.Generator``: dense-block convs kaiming-normal (fan_in, relu
    gain) scaled by 0.1, as the JAX module initialises them; every other
    conv normal with std 1/sqrt(fan_in), the scale of flax's default; all
    biases uniform in +-0.1, so that a check of the kernels sees them."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = sr_esrnet.SFTNet(num_block=num_block)
    with torch.no_grad():
        for path, mod in model.named_modules():
            if not isinstance(mod, sr_esrnet.Conv):
                continue
            w = mod.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            dense = ".rdb" in path and path.rsplit(".", 1)[-1].startswith("conv")
            std = 0.1 * (2.0 / fan_in) ** 0.5 if dense else fan_in ** -0.5
            w.copy_(torch.randn(w.shape, generator=g) * std)
            mod.bias.copy_((torch.rand(mod.bias.shape, generator=g) * 2 - 1)
                           * 0.1)
    return model.to(dev).eval()


def fern_config(**kw) -> dmpigo.Config:
    """The LLFF fern encoder geometry of the 4K frame: a 384x384x256 voxel
    budget over [-1.5,1.5]x[-1.67,1.67]x[-1,1] (world size 363x405x256),
    256 planes, fast_color_thres 1/256/5."""
    return dmpigo.make_config(
        xyz_min=[-1.5, -1.67, -1.0], xyz_max=[1.5, 1.67, 1.0],
        num_voxels=384 * 384 * 256, mpi_depth=256,
        fast_color_thres=1.0 / 256 / 5, **kw)


def load_anchor(path: str = ANCHOR_ASSET, device=None):
    """The trained-content anchor: an encoder checkpoint's grids
    (``density``, ``k0`` float16 at a coarse resolution) and rgbnet,
    trilinearly upsampled onto the fern geometry of :func:`fern_config`,
    with the occupancy mask re-derived from the upsampled density.
    Returns (cfg, params, buffers)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        arrs = {k: np.asarray(z[k]) for k in z.files}
    rgbnet = {k[len("rgbnet_"):]: torch.as_tensor(v, dtype=torch.float32,
                                                  device=dev)
              for k, v in arrs.items() if k.startswith("rgbnet_")}
    cfg = fern_config(
        rgbnet_dim=int(arrs["k0"].shape[-1]), rgbnet_depth=len(rgbnet) // 2,
        rgbnet_width=int(rgbnet["w1"].shape[0]),
        viewbase_pe=int(arrs["viewbase_pe"]),
        spatial_pe=int(arrs["spatial_pe"]))
    _, buffers = dmpigo.init(cfg, device=dev)

    def up(g):
        return grid_sample.resize_trilinear_chunked(
            torch.as_tensor(g.astype(np.float32), device=dev), cfg.world_size)

    params = {"density": up(arrs["density"]), "k0": up(arrs["k0"]),
              "rgbnet": rgbnet}
    buffers = dmpigo.update_occupancy_cache(cfg, params, buffers)
    return cfg, params, buffers
