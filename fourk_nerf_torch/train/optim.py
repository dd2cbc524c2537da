"""MaskedAdam, the reference's sparse-voxel Adam, updating in place.

The same update as the JAX package's ``train/optim.py`` and the reference's
three CUDA kernels (frozoul/4K-NeRF lib/cuda/adam_upd_kernel.cu:8-58):

- Adam with ``step_size = lr * sqrt(1 - b2^t) / (1 - b1^t)`` and ``eps``
  added outside the square root, the bias correction in float32;
- masked: entries whose gradient is 0 are left alone, moments included
  (the ``skip_zero_grad`` groups, lib/masked_adam.py:64-67);
- per-voxel lr: the update scaled element-wise (lib/masked_adam.py:35-37).

Param groups are the top-level keys of the params dict, matched against the
config's ``lrate_<key>`` entries; a group without an lr is frozen. The
caller decays the lrs (:func:`group_lr`) and resets the state at every
progressive-scaling boundary, as the reference does (run.py:465-476).

:func:`apply_updates` writes the params and the moments in place under
``torch.no_grad()``, so no second copy of a grid or of its moments exists
while it runs (the JAX package gets the same from buffer donation): a leaf
on the card in one pass of ``ops/cuda_grid.masked_adam_``, which reads only
the gradient of an entry it skips, a leaf on the CPU in chunks of
``_CHUNK`` elements. The step count is a host integer: the update reads
nothing back from the device.
"""

from __future__ import annotations

import numpy as np
import torch

from fourk_nerf_torch.ops import cuda_grid
from fourk_nerf_torch.utils import trace

BETA1, BETA2, EPS = 0.9, 0.99, 1e-8  # lib/masked_adam.py:19
_CHUNK = 1 << 24  # elements per in-place slice: 64 MB of float32


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def init_state(params: dict) -> dict:
    """Zero moments shaped like ``params`` and step 0."""
    return {"exp_avg": _zeros_like_tree(params),
            "exp_avg_sq": _zeros_like_tree(params), "step": 0}


def _bias_correction(step: int) -> float:
    """``sqrt(1 - b2^t) / (1 - b1^t)`` in float32, as the JAX update."""
    t = np.float32(step)
    one = np.float32(1.0)
    return float(np.sqrt(one - np.float32(BETA2) ** t)
                 / (one - np.float32(BETA1) ** t))


def _update_leaf(p, g, m, v, step_size: float, masked: bool, plr=None):
    """The update of one leaf in place: on the card one pass of
    ``cuda_grid.masked_adam_``, on the CPU :func:`masked_adam_plain`. While
    tracing is on, a masked leaf adds its numel to the counter
    ``update.entries`` and the entries it updated (those with a non-zero
    gradient) to ``update.touched``."""
    gf = g.reshape(-1)  # a conv's weight gradient may come in another layout
    plrf = None if plr is None else plr.reshape(-1)
    counted = masked and trace.on()
    if counted:
        trace.count("update.entries", p.numel())
    if p.is_cuda:
        touched = (torch.zeros((), dtype=torch.int64, device=p.device)
                   if counted else None)
        cuda_grid.masked_adam_(p, gf, m, v, step_size, masked, plrf, touched)
        if counted:
            trace.count("update.touched", touched)
        return
    if counted:
        trace.count("update.touched", int((gf != 0).sum()))
    masked_adam_plain(p.view(-1), gf, m.view(-1), v.view(-1), step_size,
                      masked, plrf)


def masked_adam_plain(pf, gf, mf, vf, step_size: float, masked: bool,
                      plrf=None) -> None:
    """The plain MaskedAdam step of flat tensors in place, in chunks of
    ``_CHUNK`` elements: the kernel's reference, on any device."""
    for s in range(0, pf.numel(), _CHUNK):
        sl = slice(s, s + _CHUNK)
        gc, mc, vc = gf[sl], mf[sl], vf[sl]
        m_new = BETA1 * mc + (1.0 - BETA1) * gc
        v_new = BETA2 * vc + (1.0 - BETA2) * gc * gc
        delta = step_size * m_new / (v_new.sqrt() + EPS)
        if plrf is not None:
            delta = delta * plrf[sl]
        if masked:
            nz = gc != 0
            delta.masked_fill_(~nz, 0.0)
            m_new = torch.where(nz, m_new, mc)
            v_new = torch.where(nz, v_new, vc)
        pf[sl].sub_(delta)
        mc.copy_(m_new)
        vc.copy_(v_new)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _as_layout(g, p):
    """``g`` in the shape and the strides of ``p``: a foreach op takes its
    multi-tensor path only where its lists' tensors share strides, and a
    conv's weight gradient may come channels-last, or with other strides
    on its size-1 axes."""
    g = g.reshape(p.shape)
    if g.stride() == p.stride():
        return g
    if g.is_contiguous() and p.is_contiguous():
        return g.as_strided(p.shape, p.stride())
    return torch.empty_like(p).copy_(g)


def _update_tree(p, g, m, v, step_size) -> None:
    """The plain (unmasked) update of every leaf of a group tree at once,
    by ``torch._foreach_*`` ops: a few launches for the whole tree instead
    of a dozen a leaf (the generator has ~460 leaves). The arithmetic, and
    its order, is :func:`_update_leaf`'s. ``step_size``: a float, or a
    float32 0-d tensor on the leaves' device."""
    paths = [path for path, _ in _leaves(p)]
    ps, gs, ms, vs = ([_at(t, path) for path in paths] for t in (p, g, m, v))
    gs = [_as_layout(x, y) for x, y in zip(gs, ps)]
    torch._foreach_mul_(ms, BETA1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - BETA1))
    g2 = torch._foreach_mul(gs, 1.0 - BETA2)
    torch._foreach_mul_(g2, gs)
    torch._foreach_mul_(vs, BETA2)
    torch._foreach_add_(vs, g2)
    den = torch._foreach_sqrt(vs)
    torch._foreach_add_(den, EPS)
    delta = torch._foreach_mul(ms, step_size)
    torch._foreach_div_(delta, den)
    torch._foreach_sub_(ps, delta)


class GraphedTreeUpdate:
    """:func:`_update_tree` of one group tree captured in a CUDA graph and
    replayed with the step size in a device scalar. Op by op, each foreach
    op allocates an output for every leaf on the host, some 20 ms a step
    for the generator's ~460 leaves; replayed, the update is two host
    calls. The graph reads and writes the tensors it was captured on, so
    it is captured again whenever a leaf of the params, the gradients or
    the moments is another tensor than at the last call (a CUDA-graphed
    backward returns the same gradient tensors at every step)."""

    def __init__(self):
        self.graph = self.key = self.step_size = None

    def __call__(self, p, g, m, v, step_size: float) -> None:
        key = tuple(t.data_ptr() for tree in (p, g, m, v)
                    for _, t in _leaves(tree))
        if key != self.key:
            leaf = next(t for _, t in _leaves(p))
            self.graph = None
            self.step_size = torch.zeros((), dtype=torch.float32,
                                         device=leaf.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                _update_tree(p, g, m, v, self.step_size)
            self.graph, self.key = graph, key
        self.step_size.fill_(step_size)
        self.graph.replay()


def _update_window(p, g, m, v, step_size: float, origin) -> None:
    """The masked update of the window of ``p`` (and of its moments) at
    ``origin`` (leading-axis starts) that ``g`` covers, in place."""
    sl = tuple(slice(o, o + n) for o, n in zip(origin, g.shape))
    pw, mw, vw = p[sl], m[sl], v[sl]
    m_new = BETA1 * mw + (1.0 - BETA1) * g
    v_new = BETA2 * vw + (1.0 - BETA2) * g * g
    delta = step_size * m_new / (v_new.sqrt() + EPS)
    nz = g != 0
    pw.sub_(delta.masked_fill_(~nz, 0.0))
    mw.copy_(torch.where(nz, m_new, mw))
    vw.copy_(torch.where(nz, v_new, vw))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, lrs: dict,
                  skip_zero_grad=frozenset(), per_lr: dict | None = None,
                  windows: dict | None = None,
                  tree_update=_update_tree) -> None:
    """One MaskedAdam step over a two-level params dict, in place.

    ``grads`` has the layout of ``params`` for the groups it holds; ``lrs``
    maps a group to its (decayed) lr, and a group absent from it is
    frozen; ``skip_zero_grad`` names the masked groups; ``per_lr`` maps a
    group to an element-wise lr scale of its shape. ``windows`` maps a
    group to the origin (leading-axis starts, host ints) of the window
    that its gradient covers: only that window of the param and of its
    moments is read and written. The gradient is zero outside the window
    and the group is masked, so this is the full masked update.
    ``tree_update`` updates an unmasked group tree (a
    :class:`GraphedTreeUpdate` replays it on the card)."""
    state["step"] = step = state["step"] + 1
    bc = _bias_correction(step)
    for name, p in params.items():
        g, lr = grads.get(name), lrs.get(name)
        if g is None or lr is None:
            continue
        step_size = float(np.float32(lr) * np.float32(bc))
        masked = name in skip_zero_grad
        plr = per_lr.get(name) if per_lr else None
        if windows and name in windows:
            if plr is not None or not masked:
                raise ValueError(f"the windowed update of {name} needs a "
                                 "masked group without a per-voxel lr")
            _update_window(p, g, state["exp_avg"][name],
                           state["exp_avg_sq"][name], step_size,
                           windows[name])
            continue
        if isinstance(p, dict) and not masked and plr is None:
            tree_update(p, g, state["exp_avg"][name],
                        state["exp_avg_sq"][name], step_size)
            continue
        for path, leaf in _leaves(p):
            plr_leaf = (plr if plr is not None and not path
                        and tuple(plr.shape) == tuple(leaf.shape) else None)
            _update_leaf(leaf, _at(g, path),
                         _at(state["exp_avg"][name], path),
                         _at(state["exp_avg_sq"][name], path),
                         step_size, masked, plr_leaf)


def state_compatible(loaded, fresh) -> bool:
    """True when a checkpointed state has the tree structure and the leaf
    shapes of a fresh one (grid shapes change across pg_scale, so a stale
    state is rejected, not used)."""
    if isinstance(fresh, dict):
        return (isinstance(loaded, dict) and set(loaded) == set(fresh)
                and all(state_compatible(loaded[k], fresh[k]) for k in fresh))
    return getattr(loaded, "shape", None) == getattr(fresh, "shape", None)


def restore_state(loaded, fresh, *, label: str = "optimizer"):
    """``(state, restored)``: the checkpointed state where it fits the
    fresh one (the reference's ``optimizer.load_state_dict`` on resume,
    lib/utils.py:53-59), else the fresh state."""
    if loaded is None:
        return fresh, False
    if not state_compatible(loaded, fresh):
        print(f"restore_state: checkpointed {label} state incompatible with "
              "current shapes; reinitializing")
        return fresh, False
    return loaded, True


def group_lr(lr0: float, steps_since_reset, lrate_decay: float):
    """lr after ``steps_since_reset`` optimizer steps (run.py:560-563)."""
    decay_factor = 0.1 ** (1.0 / (lrate_decay * 1000.0))
    return lr0 * decay_factor ** steps_since_reset


def build_group_lrs(cfg_train, params: dict) -> dict:
    """Base lr of each param group from the ``lrate_<name>`` entries
    (lib/utils.py:26-47); a group whose lr is not positive is frozen."""
    lrs = {}
    for k in cfg_train.keys():
        if not k.startswith("lrate_"):
            continue
        name = k[len("lrate_"):]
        if name not in params:
            # DirectQVGO keeps its codebook projection under k0_vq, driven
            # by lrate_k0 (the reference's VQGrid is model.k0)
            if name == "k0" and "k0_vq" in params:
                name = "k0_vq"
            else:
                continue
        lr = cfg_train[k]
        if lr and lr > 0:
            lrs[name] = float(lr)
    return lrs
