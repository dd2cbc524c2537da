"""The encoder's grid update on the card (``csrc/grid_update.cu``): the TV
gradient added into a grid's gradient, and MaskedAdam, each one in-place
pass over a dense float32 grid in which an entry whose gradient is zero
costs the read of that gradient alone (in sparse TV and masked Adam).

:func:`tv_add_grad_` is ``grad += render.total_variation_grad(grid, ...)``
and :func:`masked_adam_` is the arithmetic of ``optim._update_leaf``, both
bitwise (a skipped ``-0.0`` gradient aside, which the plain sparse TV turns
into ``+0.0``). They take CUDA tensors only: their callers
(``common.grid_tv_add_``, ``optim._update_leaf``) run the plain versions for
CPU tensors. Each counts its launches in ``<function>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from fourk_nerf_torch.ops import _build

_TV_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
                + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
_ADAM_ARGTYPES = ([ctypes.c_void_p] * 5
                  + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int]
                  + [ctypes.c_void_p] * 2)


def _check(what: str, **tensors) -> torch.device:
    """The tensors' common CUDA device; raises unless every one is a
    contiguous float32 tensor on it."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: {name} must be on the CUDA device of "
                             f"the others (the plain version is for the "
                             f"CPU), got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"tensor, got {t.dtype}, strides {t.stride()}")
    return dev


def _launch(name: str, argtypes, *args) -> None:
    lib = _build.load("grid_update")
    fn = getattr(lib, f"grid_update_{name}")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _build.check(lib, "grid_update_error_string", fn(*args),
                 f"grid_update {name} kernel")


def tv_add_grad_(grid, grad, wx: float, wy: float, wz: float,
                 dense: bool):
    """``grad += TV gradient of grid`` in place on ``[X, Y, Z, C]`` tensors,
    by ``render.total_variation_grad``'s rule (``wx`` weighs Z, ``wz`` X);
    without ``dense`` only where ``grad`` is non-zero. Returns ``grad``."""
    dev = _check("tv_add_grad_", grid=grid, grad=grad)
    if grid.dim() != 4 or grad.shape != grid.shape:
        raise ValueError(f"tv_add_grad_: grid and grad must be one [X, Y, Z, "
                         f"C] shape, got {tuple(grid.shape)} and "
                         f"{tuple(grad.shape)}")
    X, Y, Z, C = grid.shape
    _launch("tv", _TV_ARGTYPES, grid.data_ptr(), grad.data_ptr(), X, Y, Z, C,
            wz / 6.0, wy / 6.0, wx / 6.0, int(dense),
            torch.cuda.current_stream(dev).cuda_stream)
    tv_add_grad_.launches += 1
    return grad


tv_add_grad_.launches = 0


def masked_adam_(p, g, m, v, step_size: float, masked: bool, plr=None,
                 touched=None) -> None:
    """One MaskedAdam step of ``p`` and its moments ``m``, ``v`` in place,
    ``optim._update_leaf``'s: ``g`` is the gradient in ``p``'s element
    order (any layout of its numel), ``plr`` an element-wise lr scale of the
    same order, ``masked`` leaves the entries whose gradient is zero alone.
    ``touched``, a one-element int64 CUDA tensor, gains the count of entries
    updated."""
    g = g.reshape(-1).contiguous()
    tensors = dict(p=p, g=g, m=m, v=v)
    if plr is not None:
        tensors["plr"] = plr = plr.reshape(-1).contiguous()
    dev = _check("masked_adam_", **tensors)
    n = p.numel()
    if any(t.numel() != n for t in tensors.values()):
        raise ValueError("masked_adam_: p, g, m, v (and plr) must have one "
                         "numel")
    if touched is not None and (touched.dtype != torch.int64
                                or touched.device != dev
                                or touched.numel() != 1):
        raise ValueError("masked_adam_: touched must be one int64 entry on "
                         "the params' device")
    _launch("adam", _ADAM_ARGTYPES, p.data_ptr(), g.data_ptr(), m.data_ptr(),
            v.data_ptr(), None if plr is None else plr.data_ptr(), n,
            step_size, int(masked),
            None if touched is None else touched.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    masked_adam_.launches += 1


masked_adam_.launches = 0
