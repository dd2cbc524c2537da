#!/usr/bin/env python3
"""Time builds of the plane-sweep kernel against each other on the 4K frame,
with ``--box`` builds of the box-sweep kernel on the fly-through frame, or
with ``--uptail`` builds of the fused upsample tail on the 4K decode.

Each argument names one build, ``LABEL=SOURCE.cu`` or
``LABEL=SOURCE.cu@WRAPPER.py``: the source is compiled with the port's
nvcc flags (``ops/_build.py``; its own directory first on the include path,
then ``fourk_nerf_torch/csrc``), and launched through the ``sweep`` function
of the wrapper module (by default ``ops/cuda_sweep.py``, whose C interface
the tree's ``csrc/sweep.cu`` has); a bare ``LABEL`` is the tree's kernel.
Every build is held against the plain version (``plane_sweep.sweep_plain``)
on the synthetic and the trained-anchor 4K frames of ``chip_smoke.py``
(1008x756 rays, the fern geometry, in the frame driver's tile order, or
row-major with ``--row-major``; the bf16 grid of the main path, or the
float32 grid with ``--f32``), then timed in turns, A B ... B A, by
CUDA events (mean of 3 launches after a warm-up; of 20 with ``--box``,
whose kernel takes about a millisecond), so that every build gets
two readings in one process on one card. The ptxas register and spill lines
of each build are printed.

``--box`` does the same for ``csrc/box.cu`` (wrapper ``ops/cuda_box.py``),
held against ``box_sweep.sweep_box_plain`` on frame 0 of
``chip_smoke.py``'s fly-through (the 160^3 bounded scene, pose
``box_pose(0.1)``, 800x800 rays in tile order or row-major with
``--row-major``; bf16 grid, or float32 with ``--f32``), called as
``sweep_box(packed, consts, vde, mlp, **kwargs)`` with the scene's
``PackedBox``.

``--uptail`` does the same for ``csrc/uptail.cu`` (wrapper
``ops/cuda_sr.py``, called as ``uptail_apply(up1, weights)``) on the real
``[1, 1512, 2016, 64]`` ``conv_up1`` output of ``chip_smoke.py``'s
synthetic 4K frame (the frame's encoder, then ``sftnet_trunk_cuda`` with
the dilated upchain, SFTNet seed 1), held against ``cuda_sr.uptail_plain``
to 0.03 (``chip_smoke.UPTAIL_TOL``); a build that disagrees stops the run,
unless ``--split`` is given (for throwaway builds that skip part of the
work to split the time; their error is printed). Timed by the mean of 5
launches a reading. Run on a machine with the card, from the repository
root, for example:

    python3 -m fourk_nerf_torch.tools.sweep_variants tree \\
        slow=build/variants/slow.cu
    python3 -m fourk_nerf_torch.tools.sweep_variants --box tree \\
        parent=build/variants/parent/box.cu@build/variants/parent/cuda_box.py
    python3 -m fourk_nerf_torch.tools.sweep_variants --uptail tree \
        parent=build/variants/parent/uptail.cu@build/variants/parent/cuda_sr.py

The last line is a JSON object {scene: {label: [ms, ms]}}.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from fourk_nerf_torch import weights
from fourk_nerf_torch.ops import _build, box_sweep, cuda_box, cuda_sr, \
    cuda_sweep, plane_sweep

ROOT = os.path.dirname(os.path.dirname(_build.CSRC))


def _wrapper(path: str | None, default):
    if path is None:
        return default
    spec = importlib.util.spec_from_file_location(
        f"sweep_wrapper_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def build(specs, out_dir: str, name: str) -> dict:
    """{label: CDLL}, one nvcc per source, all started together."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc, procs, libs = _build.nvcc_path(), {}, {}
    t0 = time.perf_counter()
    for label, src, _ in specs:
        out = os.path.join(out_dir, f"lib{name}_{label}.so")
        cmd = [nvcc, *_build.FLAGS, "-I", _build.CSRC, "-o", out, src]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        out)
    for label, (proc, out) in procs.items():
        text = proc.communicate()[0]
        print(f"{label}: built in {time.perf_counter() - t0:.1f} s", flush=True)
        for line in text.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                print("   ", line.strip()[:160])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{text}")
        libs[label] = ctypes.CDLL(out)
    return libs


def sweep_scenes(dev, f32: bool, row_major: bool):
    """(scene, call(wrapper), reference maps, maps of an output) of the 4K
    frames."""
    import chip_smoke as cs
    H, W = cs.H, cs.W
    for scene, make in (("synthetic", lambda: cs.fern_synthetic(dev)),
                        ("anchor", lambda: weights.load_anchor(device=dev))):
        cfg, params, buffers = make()
        K, c2w = cs.camera(H, W, 815.0)
        g = cuda_sweep.pack_grids_kernel(params, buffers, use_bf16=not f32)
        if row_major:
            a, b, vde = plane_sweep.prepare_frame(cfg, H, W, K, c2w, device=dev)
        else:
            a, b, vde, _ = cuda_sweep.prepare_frame(cfg, H, W, K, c2w,
                                                    device=dev)
        mlp = plane_sweep.mlp_layers(params["rgbnet"])
        X, Y, _ = cfg.world_size
        kw = dict(Xl=X, Yl=Y, mask_ch=g.mask_ch, k0_dim=cfg.k0_dim,
                  interval=float(cfg.voxel_size_ratio),
                  fast_thres=float(cfg.fast_color_thres),
                  spatial_pe=cfg.spatial_pe, act_type=cfg.act_type)
        del params, buffers
        maps = lambda out: plane_sweep.assemble(*out, H, W, 1.0)
        ref = maps(plane_sweep.sweep_plain(g.packed, g.act_shift, a, b, vde,
                                           mlp, **kw))
        yield (scene, lambda wrap: wrap.sweep(g.packed, g.act_shift, a, b,
                                              vde, mlp, **kw),
               _sweep_check(ref, maps))


def box_scenes(dev, f32: bool, row_major: bool):
    """The same for frame 0 of the bounded-scene fly-through."""
    import chip_smoke as cs
    hw = cs.BOX_HW
    cfg, params, buffers = cs.box_synthetic(dev)
    K, c2w = cs.box_camera(hw), cs.box_pose(0.1)
    packed = cuda_box.pack_box_kernel(cfg, params, buffers, use_bf16=not f32)
    frame = box_sweep.prepare_frame_box(cfg, hw, hw, K, c2w, stepsize=0.5,
                                        near=0.2, device=dev)
    kw = box_sweep.sweep_kwargs(cfg, frame, packed, 0.5)
    consts, vde = frame.consts, frame.vde
    if not row_major:
        order, _ = cuda_sweep.ray_order(hw, hw, dev)
        consts, vde = consts[order], vde[order].contiguous()
    mlp = plane_sweep.mlp_layers(params["rgbnet"])
    maps = lambda out: box_sweep.assemble(*out, hw, hw, 1.0)
    ref = maps(box_sweep.sweep_box_plain(packed.voxels, consts, vde, mlp,
                                         **kw))
    scene = f"fly-through frame 0 (axis {frame.axis}, flip {frame.flip})"
    yield (scene, lambda wrap: wrap.sweep_box(packed, consts, vde, mlp, **kw),
           _sweep_check(ref, maps))


def _sweep_check(ref, maps):
    import chip_smoke as cs

    def check(out):
        mx, frac = cs.sweep_errors(maps(out), ref, tie=cs.SWEEP_TOL["tie"])
        return (f"vs plain max abs {mx:.3e}, pixels above "
                f"{cs.SWEEP_TOL['tie']:.0e} {frac:.4%}")
    return check


def uptail_scenes(dev, split: bool):
    """The 4K decode's conv_up1 output and the fused tail's weights."""
    import chip_smoke as cs
    from fourk_nerf_torch.pipeline import FramePipeline
    sr_model = weights.sftnet_init(num_block=5, seed=1, device=dev)
    pipe = FramePipeline(*cs.fern_synthetic(dev), sr_model, device=dev)
    enc = pipe.encode(cs.H, cs.W, *cs.camera(cs.H, cs.W, 815.0))
    up1 = cuda_sr.sftnet_trunk_cuda(pipe.sr, enc["rgb_feature"][None],
                                    enc["depth"][None, ..., None],
                                    upchain="dilated")
    wts = cuda_sr.pack_uptail_weights(sr_model)
    del pipe, enc
    ref = cuda_sr.uptail_plain(up1, wts)

    def check(out):
        err = float((out - ref).abs().max())
        ok = err <= cs.UPTAIL_TOL and bool(torch.isfinite(out).all())
        if not (ok or split):
            raise AssertionError(f"uptail build disagrees with the plain "
                                 f"version: max abs {err:.3e}")
        return f"vs plain max abs {err:.3e}{'' if ok else ' (DISAGREES)'}"
    yield (f"4K decode tail {tuple(up1.shape)}",
           lambda wrap: wrap.uptail_apply(up1, wts), check)


def main(argv) -> int:
    import chip_smoke as cs
    flags = {a for a in argv if a.startswith("--")}
    row_major, f32, box, uptail = ("--row-major" in flags, "--f32" in flags,
                                   "--box" in flags, "--uptail" in flags)
    name = "uptail" if uptail else "box" if box else "sweep"
    default = cuda_sr if uptail else cuda_box if box else cuda_sweep
    specs = []
    for arg in (a for a in argv if a not in flags):
        label, _, rest = arg.partition("=")
        src, _, wrap = (rest or os.path.join(_build.CSRC, f"{name}.cu")) \
            .partition("@")
        specs.append((label, os.path.abspath(src),
                      _wrapper(os.path.abspath(wrap) if wrap else None,
                               default)))
    if not specs or not torch.cuda.is_available():
        print("usage: [--box | --uptail [--split]] [--row-major] [--f32] "
              "LABEL[=SOURCE.cu[@WRAPPER.py]] ..., on a machine with a CUDA "
              "device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(specs, os.path.join(ROOT, "build", "sweep_variants"), name)
    dev = torch.device("cuda")
    if uptail:
        scenes = uptail_scenes(dev, "--split" in flags)
    elif box:
        scenes = box_scenes(dev, f32, row_major)
    else:
        scenes = sweep_scenes(dev, f32, row_major)
    reps = 5 if uptail else 20 if box else 3
    results: dict = {}
    for scene, call_with, check in scenes:
        def call(label, wrap):
            _build._loaded[name] = libs[label]
            return call_with(wrap)

        for label, _, wrap in specs:
            got = call(label, wrap)
            torch.cuda.synchronize()
            print(f"{scene} {label}: {check(got)}", flush=True)
        del check, got
        for label, _, wrap in specs + specs[::-1]:
            ms = cs.cuda_ms(lambda: call(label, wrap), reps)
            results.setdefault(scene, {}).setdefault(label, []).append(ms)
            print(f"{scene} {label}: {ms:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    _build._loaded.pop(name, None)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
