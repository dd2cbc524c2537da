#!/usr/bin/env python3
"""Time builds of the plane-sweep kernel against each other on the 4K frame,
or, with ``--box``, builds of the box-sweep kernel on the fly-through frame.

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
``PackedBox``. Run on a machine with the card, from the repository root,
for example:

    python3 -m fourk_nerf_torch.tools.sweep_variants tree \\
        slow=build/variants/slow.cu
    python3 -m fourk_nerf_torch.tools.sweep_variants --box tree \\
        parent=build/variants/parent/box.cu@build/variants/parent/cuda_box.py

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
from fourk_nerf_torch.ops import _build, box_sweep, cuda_box, cuda_sweep, \
    plane_sweep

ROOT = os.path.dirname(os.path.dirname(_build.CSRC))


def _wrapper(path: str | None, default):
    if path is None:
        return default
    spec = importlib.util.spec_from_file_location(
        f"sweep_wrapper_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
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
                                              vde, mlp, **kw), ref, maps)


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
           ref, maps)


def main(argv) -> int:
    import chip_smoke as cs
    flags = {a for a in argv if a.startswith("--")}
    row_major, f32, box = ("--row-major" in flags, "--f32" in flags,
                           "--box" in flags)
    name = "box" if box else "sweep"
    default = cuda_box if box else cuda_sweep
    specs = []
    for arg in (a for a in argv if a not in flags):
        label, _, rest = arg.partition("=")
        src, _, wrap = (rest or os.path.join(_build.CSRC, f"{name}.cu")) \
            .partition("@")
        specs.append((label, os.path.abspath(src),
                      _wrapper(os.path.abspath(wrap) if wrap else None,
                               default)))
    if not specs or not torch.cuda.is_available():
        print("usage: [--box] [--row-major] [--f32] "
              "LABEL[=SOURCE.cu[@WRAPPER.py]] ..., on a machine with a CUDA "
              "device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(specs, os.path.join(ROOT, "build", "sweep_variants"), name)
    dev = torch.device("cuda")
    scenes = box_scenes(dev, f32, row_major) if box \
        else sweep_scenes(dev, f32, row_major)
    results: dict = {}
    for scene, call_with, ref, maps in scenes:
        def call(label, wrap):
            _build._loaded[name] = libs[label]
            return call_with(wrap)

        for label, _, wrap in specs:
            got = maps(call(label, wrap))
            torch.cuda.synchronize()
            mx, frac = cs.sweep_errors(got, ref, tie=cs.SWEEP_TOL["tie"])
            print(f"{scene} {label}: vs plain max abs {mx:.3e}, pixels above "
                  f"{cs.SWEEP_TOL['tie']:.0e} {frac:.4%}", flush=True)
        del ref, got
        for label, _, wrap in specs + specs[::-1]:
            ms = cs.cuda_ms(lambda: call(label, wrap), 20 if box else 3)
            results.setdefault(scene, {}).setdefault(label, []).append(ms)
            print(f"{scene} {label}: {ms:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    _build._loaded.pop(name, None)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
