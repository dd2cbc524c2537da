"""Parameters into the port: numpy trees of the JAX package's layout, the
SFTNet, RRDBNetBPS, discriminator and VGG19 flax trees, and the
trained-content anchor asset.

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
from fourk_nerf_torch.models import dmpigo, sr_esrnet, sr_unetdisc
from fourk_nerf_torch.ops import grid_sample

ANCHOR_ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "assets", "med_sr_grids_f16.npz")


def to_torch(tree, device=None):
    """Nested dict of arrays -> the same dict of tensors on ``device``
    (default ``cuda``; bool stays bool, floats become float32)."""
    device = resolve_device(device)
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


def opt_state_from_numpy(state, device=None) -> dict:
    """A MaskedAdam state in the JAX package's ``init_state`` layout
    (``exp_avg`` and ``exp_avg_sq`` trees of arrays, an int32 ``step``)
    -> the port's: tensors on ``device`` (default ``cuda``), the step a
    host int."""
    dev = resolve_device(device)
    return {"exp_avg": to_torch(state["exp_avg"], dev),
            "exp_avg_sq": to_torch(state["exp_avg_sq"], dev),
            "step": int(np.asarray(state["step"]))}


def dvgo_from_numpy(params, buffers, device=None):
    """JAX-layout dvgo ``params`` (``density``, ``k0``, optional
    ``rgbnet``) and ``buffers`` (``mask_cache``) -> tensors on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    return to_torch(params, dev), to_torch(buffers, dev)


def dcvgo_from_numpy(params, buffers, device=None):
    """JAX-layout dcvgo ``params`` (``density``, ``k0``, optional
    ``rgbnet``) and ``buffers`` (``mask_cache`` over the contracted cube)
    -> tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return to_torch(params, dev), to_torch(buffers, dev)


def dvqgo_from_numpy(params, buffers, device=None):
    """JAX-layout dvqgo ``params`` (``density``, ``k0_vq/project``,
    ``rgbnet``) and ``buffers`` (``act_shift``, ``mask_cache``,
    ``vq_state``) -> tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return to_torch(params, dev), to_torch(buffers, dev)


def dbvgo_from_numpy(params, buffers, device=None):
    """JAX-layout dbvgo ``params`` (the ``fg`` and ``bg`` fields) and
    ``buffers`` (``mask_cache_fg``, ``mask_cache_bg``) -> tensors on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return to_torch(params, dev), to_torch(buffers, dev)


def _as_float(x) -> torch.Tensor:
    """An array or tensor as a float32 tensor on its own device."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.tensor(np.asarray(x, np.float32))


def load_flax_convs(model, tree: dict):
    """Copy a flax tree (arrays or tensors) into ``model`` by name: every
    :class:`Conv` takes ``kernel`` (HWIO -> OIHW) and ``bias`` of the node
    at its path."""
    with torch.no_grad():
        for path, mod in model.named_modules():
            if not isinstance(mod, sr_esrnet.Conv):
                continue
            node = tree
            for part in path.split("."):
                node = node[part]
            mod.weight.copy_(_as_float(node["kernel"]).permute(3, 2, 0, 1))
            mod.bias.copy_(_as_float(node["bias"]))
    return model


def sftnet_from_flax(tree: dict, device=None) -> sr_esrnet.SFTNet:
    """Build an :class:`SFTNet` from a flax ``params`` tree (arrays or
    tensors), inferring its shape (input colours, condition channels,
    blocks, scale)."""
    dev = resolve_device(device)
    num_block = sum(1 for k in tree if k.startswith("body"))
    scale = 4 if "conv_up2" in tree else 2 if "conv_up1" in tree else 1

    def dim(node, i):
        return int(tuple(node["kernel"].shape)[i])

    model = sr_esrnet.SFTNet(
        n_in_colors=dim(tree["conv_first"], 2), scale=scale,
        num_feat=dim(tree["conv_first"], 3), num_block=num_block,
        num_grow_ch=dim(tree["body0"]["rdb1"]["conv1"], 3)
        if num_block else 32,
        num_cond=dim(tree["cond0"], 2))
    return load_flax_convs(model, tree).to(dev).eval()


def sftnet_params(model) -> dict:
    """The module's parameters as a tree of the flax names
    (``{"body0": {"rdb1": {"conv1": {"kernel", "bias"}}}, ...}``), each
    leaf the module's own tensor (kernels OIHW): the generator's group of
    the joint trainer's MaskedAdam, which updates them in place."""
    tree: dict = {}
    for path, mod in model.named_modules():
        if not isinstance(mod, sr_esrnet.Conv):
            continue
        node = tree
        for part in path.split("."):
            node = node.setdefault(part, {})
        node["kernel"], node["bias"] = mod.weight, mod.bias
    return tree


def flax_kernels(tree):
    """A tree of the flax names with its conv ``kernel`` leaves taken from
    the module's OIHW layout to flax's HWIO (new tensors; the other
    tensors, dense kernels ``[in, out]`` among them, detached)."""
    if not isinstance(tree, dict):
        return tree.detach() if isinstance(tree, torch.Tensor) else tree
    return {k: v.detach().permute(2, 3, 1, 0).contiguous()
            if k == "kernel" and v.dim() == 4 else flax_kernels(v)
            for k, v in tree.items()}


def torch_kernels(tree, device=None):
    """The inverse of :func:`flax_kernels`: arrays or tensors of flax's
    layout as float32 tensors on ``device`` (default ``cuda``), conv
    kernels OIHW."""
    if isinstance(tree, dict):
        out = {k: torch_kernels(v, device) for k, v in tree.items()}
        for k, v in out.items():
            if k == "kernel" and v.dim() == 4:
                out[k] = v.permute(3, 2, 0, 1).contiguous()
        return out
    return _as_float(tree).to(resolve_device(device))


def sftnet_to_flax(model) -> dict:
    """The inverse of :func:`sftnet_from_flax`: the module's weights as a
    flax ``params`` tree of numpy arrays (kernels HWIO)."""
    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return t.cpu().numpy()

    return np_tree(flax_kernels(sftnet_params(model)))


def sr_opt_state_from_numpy(state, device=None) -> dict:
    """The generator's or the discriminator's MaskedAdam state in the JAX
    package's layout (``init_state({"srnet": params})`` or ``{"d": ...}``:
    moments with HWIO conv kernels, an int32 ``step``) -> the port's
    (tensors on ``device``, conv kernels OIHW, the step a host int)."""
    return {"exp_avg": torch_kernels(state["exp_avg"], device),
            "exp_avg_sq": torch_kernels(state["exp_avg_sq"], device),
            "step": int(np.asarray(state["step"]))}


def opt_state_to_flax(state: dict) -> dict:
    """The inverse of :func:`sr_opt_state_from_numpy` for the generator's
    or the discriminator's state: conv kernels of the moments HWIO (new
    tensors), the step a host int."""
    return {"exp_avg": flax_kernels(state["exp_avg"]),
            "exp_avg_sq": flax_kernels(state["exp_avg_sq"]),
            "step": state["step"]}


def joint_opt_state_from_numpy(states: dict, device=None) -> dict:
    """The joint trainer's optimizer states in the JAX layout (the
    encoder's ``enc``, the generator's ``sr``) -> the port's."""
    return {"enc": opt_state_from_numpy(states["enc"], device),
            "sr": sr_opt_state_from_numpy(states["sr"], device)}


# ---------------------------------------------------------------------------
# the discriminators and the VGG19 tower
# ---------------------------------------------------------------------------

def disc_from_flax(params: dict, spectral: dict | None = None, *,
                   device=None):
    """Build a discriminator from the JAX package's ``params`` and
    ``spectral`` trees (arrays or tensors; conv kernels HWIO): the plain
    ``Unet``, or, with a ``feat`` subtree, ``Unet_pose`` (a dense
    ``mapping``) or ``Unet_viewdir`` (a 1x1 conv ``mapping``); widths
    from the kernels. ``spectral`` None
    leaves every ``u`` zero."""
    dev = resolve_device(device)
    kind = "Unet" if "feat" not in params else (
        "Unet_pose" if np.ndim(params["mapping"]["kernel"]) == 2
        else "Unet_viewdir")
    trunk = params.get("feat", params)
    num_feat = int(tuple(trunk["conv0"]["kernel"].shape)[3])
    fc_in = (int(tuple(params["epilogue"]["fc"]["kernel"].shape)[0])
             if kind != "Unet" else None)
    model = sr_unetdisc.build(kind, num_feat, fc_in=fc_in).to(dev)
    load_disc_flax(model, params, spectral)
    return model


@torch.no_grad()
def load_disc_flax(model, params: dict, spectral: dict | None = None):
    """Copy the JAX package's discriminator trees into ``model`` in place:
    every parameter from the leaf of ``params`` at its path (conv kernels
    HWIO -> OIHW), every ``u`` from ``spectral`` where given. Returns
    ``model``."""
    dev = next(model.parameters()).device
    tp = torch_kernels(params, dev)
    for path, p in model.named_parameters():
        p.copy_(_at_path(tp, path))
    if spectral:
        ts = torch_kernels(spectral, dev)
        for path, b in model.named_buffers():
            b.copy_(_at_path(ts, path))
    return model


def disc_to_flax(model) -> tuple[dict, dict]:
    """The inverse of :func:`disc_from_flax`: (``params``, ``spectral``)
    as numpy trees of the JAX layout (conv kernels HWIO)."""
    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return t.detach().cpu().numpy()

    return (np_tree(flax_kernels(sr_unetdisc.disc_params(model))),
            np_tree(sr_unetdisc.disc_spectral(model)))


def vgg19_from_flax(tree: dict, device=None) -> dict:
    """The JAX package's VGG19 params (``{conv_name: {"kernel": HWIO,
    "bias"}}``) -> the port's (kernels OIHW, float32 tensors on
    ``device``, default ``cuda``)."""
    return torch_kernels(tree, device)


def _at_path(tree, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def rrdbnet_bps_from_flax(tree: dict, device=None) -> sr_esrnet.RRDBNetBPS:
    """Build an :class:`RRDBNetBPS` from a flax ``params`` tree (numpy
    arrays, kernels HWIO), inferring its shape (colours, blocks, scale)."""
    dev = resolve_device(device)
    num_block = sum(1 for k in tree if k.startswith("body"))
    model = sr_esrnet.RRDBNetBPS(
        n_colors=int(np.shape(tree["conv_first"]["kernel"])[2]),
        scale=4 if "conv_up2" in tree else 2,
        num_feat=int(np.shape(tree["conv_first"]["kernel"])[3]),
        num_block=num_block,
        num_grow_ch=int(np.shape(tree["body0"]["rdb1"]["conv1"]["kernel"])[3])
        if num_block else 32)
    return load_flax_convs(model, tree).to(dev).eval()


def sftnet_init(*, num_block: int = 5, scale: int = 4, seed: int = 0,
                device=None) -> sr_esrnet.SFTNet:
    """A randomly initialised SFTNet drawn from a seeded
    ``torch.Generator``: dense-block convs kaiming-normal (fan_in, relu
    gain) scaled by 0.1, as the JAX module initialises them; every other
    conv normal with std 1/sqrt(fan_in), the scale of flax's default; all
    biases uniform in +-0.1, so that a check of the kernels sees them."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = sr_esrnet.SFTNet(num_block=num_block, scale=scale)
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
