"""Self-describing checkpoints in the JAX package's npz format, and the
reference's torch encoder checkpoints.

A checkpoint is one ``.npz``: ``params/<path>``, ``buffers/<path>`` and
``opt/<path>`` arrays (tree paths joined by ``/``) plus a JSON ``__meta__``
blob that holds ``model_kwargs``, ``global_step`` and the caller's extra
keys. A file the JAX package writes loads here, and the reverse: the
layouts are the same (grids ``[X,Y,Z,C]``, rgbnet ``w`` as ``[Cin, W]``,
the optimizer's step an int32 scalar).

:class:`AsyncSaver` writes in the background: it snapshots the tensors on
the device (``clone()``) before the caller's next step updates them in
place, then pulls and writes them on one worker thread. A second save
waits for the first, so at most one snapshot is held.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import threading

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.ops import grid_sample, render


def tree_to_flat_dict(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tree_to_flat_dict(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def flat_dict_to_tree(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _write_npz(path: str, flat: dict) -> None:
    flat = {k: _to_numpy(v) for k, v in flat.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)  # a run killed mid-write leaves the old file


class AsyncSaver:
    """One worker thread that writes checkpoints while training goes on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: list = []  # [(path, Future)]
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-save")

    def submit(self, path: str, flat: dict) -> None:
        """Snapshot ``flat`` on its device and queue the write. Waits for
        the save before it first (at most one snapshot in flight)."""
        self.wait_for_pending_saves()
        snap = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                for k, v in flat.items()}
        with self._lock:
            self._pending.append((path, self._pool.submit(_write_npz, path,
                                                          snap)))

    def wait_for_pending_saves(self) -> None:
        """Wait for every queued save, then raise the first failure."""
        with self._lock:
            pending, self._pending = self._pending, []
        errors = []
        for path, fut in pending:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 -- re-raised below
                errors.append((path, e))
        if errors:
            path, e = errors[0]
            raise RuntimeError(f"checkpoint save to {path} failed "
                               f"({len(errors)} of {len(pending)} saves "
                               "failed)") from e

    def close(self) -> None:
        try:
            self.wait_for_pending_saves()
        finally:
            self._pool.shutdown(wait=True)


def save_checkpoint(path: str, model_kwargs: dict, params: dict,
                    buffers: dict, opt_state: dict | None = None,
                    global_step: int = 0, extra_meta: dict | None = None,
                    saver: AsyncSaver | None = None) -> None:
    """Write a checkpoint; with ``saver`` in the background."""
    flat = {f"params/{k}": v for k, v in tree_to_flat_dict(params).items()}
    flat.update({f"buffers/{k}": v
                 for k, v in tree_to_flat_dict(buffers).items()})
    if opt_state is not None:
        flat.update({f"opt/{k}": _int32_steps(k, v) for k, v in
                     tree_to_flat_dict(opt_state).items()})
    meta = {"model_kwargs": model_kwargs, "global_step": int(global_step)}
    if extra_meta:
        meta.update(extra_meta)
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8)
    if saver is None:
        _write_npz(path, flat)
    else:
        saver.submit(path, flat)


def _is_step(path: str) -> bool:
    return path == "step" or path.endswith("/step")


def _int32_steps(path: str, v):
    """An optimizer tree's ``step`` leaf (a host int here) as the JAX
    package's int32 scalar; any other leaf as it is."""
    if _is_step(path) and not isinstance(v, torch.Tensor):
        return np.asarray(int(v), dtype=np.int32)
    return v


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """Floats as float32, bools and integers in their own type."""
    a = np.asarray(a)
    dtype = torch.float32 if np.issubdtype(a.dtype, np.floating) else None
    return torch.as_tensor(a, dtype=dtype, device=device)


def load_checkpoint(path: str, device=None):
    """(model_kwargs, params, buffers, opt_state or None, global_step, meta),
    the arrays as tensors on ``device`` (default ``cuda``): floats float32,
    masks bool, integers integer. Every optimizer ``step`` becomes a host
    int: the top-level one of an encoder checkpoint, and the one of each
    optimizer of a joint checkpoint (``opt/{enc,sr,d}/step``)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode())
    groups: dict = {"params": {}, "buffers": {}, "opt": {}}
    for k, v in flat.items():
        head, rest = k.split("/", 1)
        groups[head][rest] = v
    params, buffers = (
        flat_dict_to_tree({k: _tensor(v, dev) for k, v in g.items()})
        for g in (groups["params"], groups["buffers"]))
    opt_state = None
    if groups["opt"]:
        opt_state = flat_dict_to_tree(
            {k: int(v) if _is_step(k) else _tensor(v, dev)
             for k, v in groups["opt"].items()})
        if "exp_avg" in opt_state:
            opt_state.setdefault("step", 0)
    return (meta["model_kwargs"], params, buffers, opt_state,
            meta.get("global_step", 0), meta)


def _torch_load(path):
    """``torch.load`` with the safe unpickler, numpy scalars allowed (the
    reference's checkpoints hold some); the unsafe one only after a loud
    warning, for files the user trusts."""
    try:
        import numpy.core.multiarray as _ma
        allowed = [_ma._reconstruct, np.ndarray, np.dtype,
                   np.dtypes.Float32DType, np.dtypes.Float64DType,
                   np.dtypes.Int64DType]
    except (ImportError, AttributeError):  # numpy without these names
        allowed = []
    try:
        with torch.serialization.safe_globals(allowed):
            return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 -- pickle errors vary
        print(f"checkpoints: WARNING safe load failed ({type(e).__name__}); "
              f"falling back to weights_only=False for {path} -- only do "
              "this with checkpoints you trust")
        return torch.load(path, map_location="cpu", weights_only=False)


def reference_sr_state_dict(path: str) -> dict:
    """The generator's state dict in a reference (basicsr) checkpoint: its
    ``params_ema``, else its ``params``, else the file's own dict."""
    sd = _torch_load(path)
    for key in ("params_ema", "params"):
        if isinstance(sd, dict) and key in sd:
            return sd[key]
    return sd


def _grid_to_channel_last(t) -> np.ndarray:
    """``[1, C, X, Y, Z] -> [X, Y, Z, C]``."""
    arr = np.asarray(t.detach().numpy() if hasattr(t, "detach") else t,
                     dtype=np.float32)
    if arr.ndim != 5 or arr.shape[0] != 1:
        raise ValueError(f"expected a [1, C, X, Y, Z] grid, got {arr.shape}")
    return np.moveaxis(arr[0], 0, -1)


def import_torch_encoder_checkpoint(path: str):
    """A reference encoder ``.tar`` (frozoul/4K-NeRF run.py:616-633) as
    (model_kwargs, params, buffers, global_step), numpy arrays in the
    package's layout: ``density.grid`` / ``k0.grid`` channel-last, the
    ``rgbnet`` Linear weights transposed to ``[Cin, W]``, the per-plane
    ``act_shift`` of DirectMPIGO and ``mask_cache.mask``."""
    ckpt = _torch_load(path)
    kwargs = dict(ckpt["model_kwargs"])
    for k in ("xyz_min", "xyz_max"):
        kwargs[k] = np.asarray(kwargs[k]).tolist()
    sd = ckpt["model_state_dict"]
    params: dict = {"density": _grid_to_channel_last(sd["density.grid"])}
    buffers: dict = {}
    if "k0.grid" in sd:
        params["k0"] = _grid_to_channel_last(sd["k0.grid"])
    # the Linear layers of the (possibly nested) rgbnet Sequential in order
    wkeys = sorted(
        (k for k in sd if k.startswith("rgbnet.") and k.endswith(".weight")),
        key=lambda k: [int(p) for p in k.split(".")[1:-1]])
    mlp = {}
    for li, wk in enumerate(wkeys):
        bk = wk[: -len("weight")] + "bias"
        mlp[f"w{li}"] = np.asarray(sd[wk].numpy(), dtype=np.float32).T
        mlp[f"b{li}"] = np.asarray(sd[bk].numpy(), dtype=np.float32)
    if mlp:
        params["rgbnet"] = mlp
    if "act_shift.grid" in sd:  # [1,1,1,1,D] -> [1,1,D,1]
        buffers["act_shift"] = _grid_to_channel_last(sd["act_shift.grid"])
    if "mask_cache.mask" in sd:
        buffers["mask_cache"] = np.asarray(sd["mask_cache.mask"].numpy(),
                                           dtype=bool)
    return kwargs, params, buffers, int(ckpt.get("global_step", 0))


def _coarse_mask(density, act_shift, ratio, thres: float):
    """``alpha >= thres`` of the 3x3x3 max-pooled density ``[X, Y, Z]``
    (frozoul/4K-NeRF lib/grid.py:277-284)."""
    dens = grid_sample.max_pool3d_same(density)
    return render.raw2alpha(dens, act_shift, ratio) >= thres


@torch.no_grad()
def mask_from_coarse_checkpoint(path: str, mask_cache_thres: float,
                                device=None):
    """The free-space mask of a coarse DirectVoxGO ``.npz`` checkpoint:
    its density max-pooled 3x3x3, then alpha (the scalar act_shift of its
    ``alpha_init``) at or above ``mask_cache_thres``. Returns (mask
    ``[X, Y, Z]`` bool on ``device``, default ``cuda``; xyz_min; xyz_max),
    the box as float64 numpy."""
    kwargs, params, _, _, _, _ = load_checkpoint(path, device=device)
    act_shift = float(np.log(1.0 / (1.0 - kwargs["alpha_init"]) - 1.0))
    mask = _coarse_mask(params["density"][..., 0], act_shift,
                        kwargs["voxel_size_ratio"], mask_cache_thres)
    return mask, np.asarray(kwargs["xyz_min"]), np.asarray(kwargs["xyz_max"])


@torch.no_grad()
def mask_from_coarse_torch_checkpoint(path: str, mask_cache_thres: float,
                                      device=None):
    """:func:`mask_from_coarse_checkpoint` of a reference coarse ``.tar``
    (its ``density.grid [1, 1, X, Y, Z]`` and ``act_shift``)."""
    st = _torch_load(path)
    dev = resolve_device(device)
    sd, kwargs = st["model_state_dict"], st["model_kwargs"]
    density = sd["density.grid"].to(device=dev, dtype=torch.float32)[0, 0]
    act_shift = sd["act_shift"].to(device=dev, dtype=torch.float32)
    mask = _coarse_mask(density, act_shift.reshape(()),
                        kwargs["voxel_size_ratio"], mask_cache_thres)
    return (mask, np.asarray(kwargs["xyz_min"]),
            np.asarray(kwargs["xyz_max"]))
