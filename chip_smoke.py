#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fourk_nerf_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the eight CUDA libraries from ``fourk_nerf_torch/csrc`` (one
     nvcc per source, in parallel) and print the build time and ptxas
     summary, with the sweep and box kernels' registers by instantiation;
  2. sweep kernel vs its plain version on a small scene (viewdir PE 4,
     spatial PE 2, mask at grid resolution), float32 and bf16 paths;
  3. dense-block kernel vs its plain version, plain and tail mode, on a
     100x150 frame that does not divide the 8x16 tile;
  4. the 4K frame at full width, synthetic scene (the fern geometry of
     the JAX package's bench: 363x405x256 grid, 9-ch k0, rgbnet 3x64,
     density N(-2,2), 50% random mask, numpy seed 0) -> 1008x756 render ->
     SFTNet (64 feat, 5 RRDBs, grow 32, seeded) -> 4032x3024: launch counts,
     finiteness, kernel vs plain on the main path's inputs, timings (the
     dense block beside its five convs as cuDNN calls, ``conv_chain_ms``);
  5. the same frame on the trained-content anchor
     ``tools/assets/med_sr_grids_f16.npz`` upsampled onto that geometry;
  6. box kernel vs its plain version on a small bounded scene, float32
     and bf16 paths, three poses (sweep axis and sign);
  7. whole-RRDB kernel vs its plain version on the 100x150 frame, and vs
     three dense-block launches;
  8. the bounded-scene fly-through at full width: a 160^3 DirectVoxGO scene
     (12-ch k0, rgbnet 3x128 on 39 inputs, blob fill 0.15, numpy seed 0),
     three 800x800 poses through ``pipeline.render_video`` with a scale-1
     SFTNet (64 feat, 5 RRDBs) and ``fuse_rrdb=True``: launch counts,
     finiteness, both kernels vs plain on the path's inputs, the samples
     in range, in occupied blocks (what the box kernel's empty-space
     skipping leaves) and with a non-zero weight, timings; the frames also
     timed with ``fuse_rrdb=False`` (``render_video``'s default: 15
     dense-block launches a frame, counted);
  9. fused upsample tail (uptail) kernel vs its plain version at 45x70 (an
     odd size), 48x64, 1x1 and the sizes under, at and one pixel past one
     16x28 output tile in each direction;
 10. the 4K decode with the fused tail at full width: the trunk of the
     synthetic frame (15 dense-block launches) -> one uptail launch ->
     clamp; kernel vs plain on the real ``conv_up1`` output, the frame vs
     the dilated decode, the launch beside the library tail it replaces
     and its bound;
 11. ``upchain="materialized"`` vs ``"dilated"`` on the 4K frame, and a
     ``tile_process`` decode of a 252x189 crop at tile size 96 against a
     per-tile loop with the same padding and crop;
 12. the floor probes and the construct probes
     (``fourk_nerf_torch/tools/probe_floor.py`` / ``probe_ops.py``), every
     check enforced, their timings printed;
 13. encoder training at full width: the trained anchor renders 10 views
     at 1008x756 through ``render_viewpoints`` (the sweep kernel), their
     contrast stretched, 8 to train and 2 held out; ``fourk_nerf_torch/configs/llff/
     fern_lg_pretrain.py`` trains on them for 60 steps through all five
     grid sizes (``TRAIN_OVERRIDES``) with an ``i_val`` render, a periodic
     and a final checkpoint; checks: the loss falls, everything finite,
     the sweep launches, the grid update's launches (two TV and two
     MaskedAdam a step: density and k0), the final checkpoint reloads and
     renders the held out views bitwise as before, a 10-step run of the tiny CPU-test scene
     gives the same losses on the card and on the CPU; timings: the step at
     each grid size, the full-width step split into its parts beside their
     byte bounds; on one full-width step's gradients the grid update
     kernels (``ops/cuda_grid.py``: sparse and dense TV, masked Adam on the
     TV-added gradient) against their plain versions bit for bit (a skipped
     zero gradient's sign aside), the touched count, and each kernel beside
     its plain version and its bound (the gradient read, the touched
     entries' bytes); peak memory, a profiled step, the checkpoint's save and
     load; one ``{"training": ...}`` JSON line; the scene's views are also
     rendered at 4032x3024 for phase 14, and the final checkpoint is kept
     for it;
 14. joint encoder + SR training at full width: the scored held-out views
     of phase 13's checkpoint (its mask at the third grid size) through
     the float32 sweep kernel (the mask resampled onto the grid) and
     through the native-resolution lookup, compared (no pixel may differ
     by more than 2e-4, the PSNR by more than 0.01 dB);
     ``fourk_nerf_torch/configs/llff/fern_lg_joint_l1.py`` from that
     checkpoint (``--ftdv_path``) for 40 steps on the ten views with their
     4K ground truth (``JOINT_OVERRIDES``: no pg_scale fires, TV off as in
     the published run) with an ``i_val`` evaluation, a periodic and a
     final joint checkpoint; checks: the SR L1 falls, the step takes the
     full-grid sweep with the NATIVE mask; then ``run_sr --render_only
     --render_test --render_video`` from the final checkpoint serves one
     4K frame (the sweep kernel, 15 dense-block launches, counted) held to
     the plain chain, its video write logged and skipped where imageio is
     not installed; timings: the full-width joint step split into its
     parts beside their bounds, a profiled step, ``evaluate_sr``'s parts,
     the checkpoint's save and load; one ``{"joint": ...}`` JSON line;
 15. joint GAN + perceptual training at full width:
     ``fourk_nerf_torch/configs/llff/fern_lg_joint_l1_gan.py`` from phase
     13's checkpoint for 40 steps (phase 14's cut, and
     ``allow_random_vgg``: the perceptual and style terms on the fixed-seed
     random VGG19 tower, logged as the one deviation from the published
     objective; 64x64 patches, 256x256 truth, the published SFTNet and the
     ``Unet`` discriminator at 64 features, float32); checks: the SR L1
     falls, the discriminator's losses stay finite, every spectral-norm
     vector moved, the final joint file holds ``__disc__``,
     ``__disc_state__`` and ``opt/d`` and round-trips through
     ``load_joint``; then ``run_sr --render_only --render_test
     --render_video`` serves one 4K frame from it as in phase 14; timings:
     the full-width GAN step, the L1 step and the GAN step in turn on
     the same state (5 pairs), the GAN step's parts (patch render,
     SFTNet, VGG perceptual + style, the generator's discriminator call,
     the discriminator's step, the three MaskedAdams) beside their bounds
     (bytes, and torch's flop counter at the FP32 peak), a profiled step,
     peak memory; then ``fern_lg_joint_1x_l1_gan.py`` (the scale-1 SFTNet,
     the discriminator on the 64x64 LR truth) for 10 steps, its step
     time; one ``{"joint_gan": ...}`` JSON line;
 16. the bounded-scene path at full width: phase 8's scene (160^3,
     rgbnet 3x128) rendered on white through the box kernel from 24
     poses of the Blender sphere (``tiny_scene.bounded_poses``) at
     800x800 and the Blender field of view, as the Blender loader's
     ``data_dict`` (20 train, 2 val, 2 test); ``configs/syn/
     syn_default.py`` as published (coarse 1024000 voxels with the
     per-voxel lr, fine 160^3 with ``in_maskcache``, N_rand 8192, step
     0.5) cut to 100 coarse and 100 fine steps, the fine grid doubling at
     20, 40, 60, 80 (``BOUNDED_OVERRIDES``), an ``i_val`` render of each
     stage through the box kernel; checks: both losses fall, the i_val
     renders take the box kernel, the box kernel vs its plain version on
     the coarse model (no rgbnet) and the fine model; then
     ``run --export_coarse_only`` and ``run --render_only --render_test``
     (the box kernel, the held-out PSNR above a white frame's); timings:
     the coarse step and the fine step at 160^3 by parts beside their
     bounds (the larger of bytes and FP32 operations), ``voxel_count_views``, a profiled fine step, peak
     memory; then ``configs/syn/chair_joint_1x_l1_gan.py`` from the fine
     checkpoint (``--ftdv_path``) and the coarse one (``--ftdvcoa_path``)
     for 40 steps at 64x64 patches (``allow_random_vgg``, phase 15's one
     deviation), the SR L1 falling; its step timed beside its bound; then
     ``run_sr --render_only --render_test --render_video`` serves one
     800x800 frame through ``serve_joint`` (the box kernel, 15 dense-block
     launches, the decode's kernel chain vs its plain chain); one
     ``{"bounded": ...}`` JSON line;
 17. the unbounded-inward path at full width: phase 8's scene (160^3,
     rgbnet 3x128) rendered on black through the box kernel from 24
     poses around the Blender sphere at 800x800, plus each pixel's
     background share times an environment colour of its direction
     (``tiny_scene.environment``: the far exterior the contracted shell
     learns), as the NeRF++ loader's ``data_dict`` (20 train, 2 val, 2
     test, interleaved; ``near`` 0, ``near_clip`` and ``far`` from the
     cameras' spread); ``configs/syn/syn_default.py`` with
     ``tiny_scene.UNBOUNDED_OVERRIDES`` at syn_default's own widths
     (DirectContractedVoxGO, 160^3 voxels (a 159^3 grid, 532 samples a
     ray), rgbnet 3x128 on 12 features, N_rand 8192, step 0.5, the
     near-clip and distortion losses) cut to phase 16's 100 steps, the
     grid doubling at 20, 40, 60, 80 (``UNBOUNDED_CUT``), an ``i_val``
     render through the chunked forward; checks: the loss falls, the
     final grid and sample count; then ``run --render_only
     --render_test`` (the held-out PSNR above that of the constant frame
     of the training views' mean colour);
     a 30-step run of the tiny unbounded CPU-test scene gives the same
     losses on the card and on the CPU; timings: the step at 159^3 by
     parts (forward + backward, MaskedAdam) beside their bounds (the
     larger of bytes and FP32 operations), the spacing filter's loop
     alone on the host clock, a profiled step, peak memory; one
     ``{"unbounded": ...}`` JSON line;
 18. the secondary models at full width: (a) DirectQVGO
     (``mode_type`` adain_vq, 4096 codes) on phase 13's views, the fern
     pretrain config at 384x384x256 from step 0 (``VQ_OVERRIDES``: 60
     steps, no pg_scale, the one deviation), an ``i_val`` render, a
     periodic and a final checkpoint; checks: the loss falls, the EMA
     codebook learns, ``run --render_only`` renders the held-out views
     from the final checkpoint bitwise as the trained model did (the
     chunked forward, no sweep launch), a 10-step run of the tiny CPU-test
     scene gives the same losses on the card and on the CPU, every VQ
     index flip a near-tie; timings: the step by parts (forward +
     backward, the distances and argmin alone, the EMA, TV, MaskedAdam)
     beside their bounds, a profiled step; (b) TensoRF grids (ranks 16 /
     48) in DirectMPIGO through phase 13's five grid sizes and in
     DirectVoxGO (syn_default, 100 dense coarse and 20 fine steps on
     phase 16's views); checks: the losses fall, every pg_scale step
     resizes the factors, the ``i_val`` renders take the chunked forward,
     the checkpoints round-trip; timings: each full-width step by parts
     beside their bounds; (c) DirectBiVoxGO at 160^3 a field, an
     8192-ray batch of phase 16's views forward and backward: finite, the
     constant background weighted by the product of the two fields'
     transmittances, timed beside its bound; the tiny DirectBiVoxGO and
     TensoRF DirectMPIGO / DirectVoxGO of ``tools/device_parity.py`` on
     the card against the CPU (the background samples within 4 ulps,
     outputs 1e-4, gradients 1e-4 of each leaf's largest entry); (d) the StyleGAN-heritage ops
     on the card against CPU copies of their inputs (the FIR ops and
     ``bias_act`` on ``[4, 256, 128, 128]``, ``hash_encode`` at its
     defaults on 2^20 points with equal indices, ``topp_masking`` on
     ``[8192, 256]``); one ``{"secondary": ...}`` JSON line;
 19. the last modules at full width: (a) ``fern_lg_pretrain.py`` with
     ``dim_rend`` 8 (the rend layer; the one deviation) on phase 13's views
     and cut; checks: the loss falls, the rend layer bitwise unchanged
     (frozen: no ``lrate_rend_layer``), the ``i_val`` and held-out renders
     chunked with no sweep launch, ``run --render_only`` renders the
     held-out views bitwise as the trained model did, ``FramePipeline``
     and ``run_sr`` refuse the model, a 10-step run of the tiny CPU-test
     scene with ``dim_rend`` 8 gives the same losses on the card and on
     the CPU; (b) ``syn_default.py`` with ``ray_sampler='patch_box'`` in
     both stages on phase 16's views and cut, the coarse stage 400 steps
     (``PATCH_BOX_OVERRIDES``):
     the plans and windows each stage logs (renewed at every pg_scale
     step), the steps by route, the loss falls, the held-out PSNR beside
     phase 16's and above a white frame, the slab forward against the
     gather forward on one patch at the final params (loss 1e-5 relative,
     gradients 5e-5), the fine step by parts (forward + backward,
     MaskedAdam) beside their bounds and beside phase 16's gather step,
     peak memory, a 10-step tiny ``patch_box`` run on both devices; (c)
     ``parallel/`` in a world of one rank on NCCL: the 1x1 mesh,
     ``all_reduce_dict``, ``tile_process_sharded`` of phase 11's crop on
     the dense-block kernel (counted) bitwise equal to ``tile_process``,
     ``box_sweep.render_frame_box(tile_mesh=...)`` of a phase 8 pose
     (one box launch) bitwise equal to the one-rank frame, the grids
     split along X and whole again, the replica check, then ``run.run``
     with ``--multihost`` on the tiny scene in a process of its own (the
     card's machine has no image reader, so the scene goes in memory, as
     phase 13's ``run --render_only`` does); one ``{"completion": ...}``
     JSON line and the phase's seconds;
 20. one JSON line with the eight kernels' summary, then the result line.

The script imports nothing of JAX. It exits with code 2, printing no
result, when no CUDA device is present or the ``fourk_nerf_torch``
package is not beside it.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 756, 1008          # LLFF fern LR frame
SCALE = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12         # H100 SXM, non-tensor
BF16_FLOPS = 989e12        # H100 SXM, dense tensor core
SWEEP_TOL = dict(tie=2e-4, tie_frac=0.02, max=0.05)
RDB_TOL = 0.05             # max abs, as the JAX package's dense-block test
BOX_HW = 800               # the bounded-scene frame (synthetic-NeRF size)
BOX_FRAMES = 3
SR_TOL = 0.1               # max abs of the full decode, kernel vs plain
UPTAIL_TOL = 0.03          # max abs, as the JAX package's uptail test
TRAIN_VIEWS = 10           # phase 13: views of the anchor, every 5th held out
#: phase 13: what is set over the published fern_lg_pretrain config (the
#: run directory goes under build/ and is deleted at the phase's end)
TRAIN_OVERRIDES = {
    "fine_train": {"N_iters": 60, "pg_scale": [8, 16, 24, 32],
                   "tv_dense_before": 50},
    "args": {"i_print": 10, "i_val": 60, "i_weights": 31},
}
TINY_TOL = 1e-4            # phase 13: tiny run, per-step loss, cuda vs cpu
JOINT_STEPS = 40           # phase 14: joint steps after the pretrain's last
#: phase 14: what is set over the published fern_lg_joint_l1 config (N_iters
#: is the pretrain's last step + JOINT_STEPS; the run directory goes under
#: build/ and is deleted at the phase's end)
JOINT_OVERRIDES = {
    "fine_train": {"pg_scale": TRAIN_OVERRIDES["fine_train"]["pg_scale"],
                   "tv_before": 20},
    "args": {"i_print": 10, "i_val": 40, "i_weights": 30},
}
GAN_STEPS = 40             # phase 15: GAN joint steps after the pretrain's
GAN_1X_STEPS = 10          # last; then the scale-1 config's
ALTERNATE_PAIRS = 5        # phase 15: L1 and GAN steps timed in turn
#: phase 15: phase 14's cut, and the one deviation from the published
#: objective: no pretrained VGG19 weights exist here, so the perceptual and
#: style terms run on the fixed-seed random tower
GAN_OVERRIDES = {
    "fine_train": {**JOINT_OVERRIDES["fine_train"],
                   "allow_random_vgg": True},
    "args": JOINT_OVERRIDES["args"],
}

BOUNDED_HW = 800           # phase 16: the Blender frame
BOUNDED_VIEWS = 24         # phase 16: 20 train, 2 val, 2 test
BOUNDED_TEACHER_G = 160    # phase 16: phase 8's scene, the teacher
BOUNDED_JOINT_STEPS = 40   # phase 16: chair joint steps after the pretrain
#: phase 16: what is set over the published configs/syn/syn_default.py (the
#: run directory goes under build/ and is deleted at the phase's end): 100
#: coarse and 100 fine steps, the fine grid doubling every 20; and one
#: deviation, the coarse alpha_init 1e-4 for the published 1e-6: at 1e-6
#: the density's gradients sit under MaskedAdam's eps (1e-8), and the coarse
#: loss stays flat for a few hundred of its 5000 steps
BOUNDED_OVERRIDES = {
    "coarse_model_and_render": {"alpha_init": 1e-4},
    "coarse_train": {"N_iters": 100},
    "fine_train": {"N_iters": 100, "pg_scale": [20, 40, 60, 80]},
    "args": {"i_print": 10, "i_val": 100, "i_weights": 50},
}
#: phase 16: over configs/syn/chair_joint_1x_l1_gan.py (N_iters is the
#: pretrain's last step + BOUNDED_JOINT_STEPS): phase 15's one deviation
BOUNDED_JOINT_OVERRIDES = {
    "fine_train": {"allow_random_vgg": True},
    "args": {"i_print": 10, "i_val": 40, "i_weights": 30},
}


UNBOUNDED_HW = 800         # phase 17: the frame
UNBOUNDED_VIEWS = 24       # phase 17: 20 train, 2 val, 2 test, interleaved
#: phase 17: set over configs/syn/syn_default.py after
#: tiny_scene.UNBOUNDED_OVERRIDES (the run directory goes under build/ and
#: is deleted at the phase's end): phase 16's cut, 100 steps with the grid
#: doubling every 20
UNBOUNDED_CUT = {
    "fine_train": {"N_iters": 100, "pg_scale": [20, 40, 60, 80]},
    "args": {"i_print": 10, "i_val": 100, "i_weights": 0},
}


FERN_CFG = os.path.join("fourk_nerf_torch", "configs", "llff",
                        "fern_lg_pretrain.py")
SYN_CFG = os.path.join("fourk_nerf_torch", "configs", "syn", "syn_default.py")
#: phase 18 (a): DirectQVGO over the fern pretrain config, phase 13's cut
#: at full width from step 0: no pg_scale, the one deviation (below)
VQ_OVERRIDES = {
    "fine_model_and_render": {"mode_type": "adain_vq"},
    "fine_train": {"N_iters": 60, "pg_scale": [], "tv_dense_before": 50},
    "args": {"i_print": 10, "i_val": 60, "i_weights": 31},
}
VQ_DEVIATION = ("fine_train.pg_scale=[] (published [2000, 4000, 6000, "
                "8000]): the JAX package's DirectQVGO has no "
                "scale_volume_grid, so its loop fails at the first pg_scale "
                "step, and the port refuses a pg_scale for it up front")
VQ_TIE_REL = 1e-5          # phase 18 (a): a VQ index flip cuda vs cpu must
                           # be a near-tie: the two distances this close
#: phase 18 (b): TensoRF grids at the VM ranks of TensoRF's published
#: configs/lego.txt (n_lamb_sigma 16, n_lamb_sh 48)
TENSORF_GRIDS = {"density_type": "TensoRFGrid", "k0_type": "TensoRFGrid",
                 "density_config": {"n_comp": 16},
                 "k0_config": {"n_comp": 48}}
#: phase 18 (b): syn_default with the fine grids TensoRF: phase 16's coarse
#: cut (100 dense steps) and 20 fine steps through five grid sizes
TENSORF_BOUNDED = {
    "coarse_model_and_render": BOUNDED_OVERRIDES["coarse_model_and_render"],
    "coarse_train": BOUNDED_OVERRIDES["coarse_train"],
    "fine_model_and_render": TENSORF_GRIDS,
    "fine_train": {"N_iters": 20, "pg_scale": [4, 8, 12, 16]},
    "args": {"i_print": 5, "i_val": 20, "i_weights": 0},
}
DBVGO_G = 160              # phase 18 (c): voxels a side of each field
DBVGO_RAYS = 8192          # phase 18 (c): rays a batch
STYLEGAN_SHAPE = (4, 256, 128, 128)  # phase 18 (d): the FIR ops' input
HASH_POINTS = 1 << 20      # phase 18 (d): hash_encode points
TOPP_SHAPE = (8192, 256)   # phase 18 (d): topp_masking weights
DIM_REND = 8               # phase 19 (a): the rend layer's input channels
#: phase 19 (a): the fern pretrain with the rend layer, phase 13's cut
DIM_REND_OVERRIDES = {
    "fine_model_and_render": {"dim_rend": DIM_REND},
    "fine_train": TRAIN_OVERRIDES["fine_train"],
    "args": TRAIN_OVERRIDES["args"],
}
DIM_REND_DEVIATION = ("fine_model_and_render.dim_rend=8 (published 3): no "
                      "published config sets it above 3")
#: phase 19 (b): syn_default with the slab sweep's patches in both stages,
#: phase 16's cut but 400 coarse steps: an 88x88 patch of an 800x800 view
#: reaches a voxel of the object in a few of 100 steps, where 8192 random
#: rays reach it in every one, and 100 coarse patch steps left every alpha
#: under bbox_thres on an H100 (PERF.md, phase 19)
PATCH_BOX_COARSE_STEPS = 400
PATCH_BOX_OVERRIDES = {
    **BOUNDED_OVERRIDES,
    "coarse_train": {**BOUNDED_OVERRIDES["coarse_train"],
                     "N_iters": PATCH_BOX_COARSE_STEPS,
                     "ray_sampler": "patch_box"},
    "fine_train": {**BOUNDED_OVERRIDES["fine_train"],
                   "ray_sampler": "patch_box"},
}
BOUNDED_DEVIATION = ("coarse_model_and_render.alpha_init=1e-4 (published "
                     "1e-6): 100 coarse steps of 5000, as phase 16's")


def log(*a):
    print(*a, flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    import torch
    fn()
    sync()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    sync()
    return e0.elapsed_time(e1) / reps


def sweep_errors(got: dict, ref: dict, *, tie: float):
    """Per-pixel max error over rgb_marched, depth and alphainv_last; the
    share of pixels above ``tie`` counts nearest-mask tie flips."""
    import torch
    err = torch.zeros(got["depth"].shape, device=got["depth"].device)
    for k in ("rgb_marched", "depth", "alphainv_last"):
        d = (got[k] - ref[k]).abs()
        err = torch.maximum(err, d.amax(-1) if d.dim() == 3 else d)
    return float(err.max()), float((err > tie).float().mean())


def check_sweep(name: str, got: dict, ref: dict):
    """Hold a sweep kernel's maps (plane sweep or box sweep) against the
    plain version's: under 2% of the pixels above 2e-4, none above 0.05."""
    mx, frac = sweep_errors(got, ref, tie=SWEEP_TOL["tie"])
    log(f"  {name}: max abs {mx:.3e}, pixels above {SWEEP_TOL['tie']:.0e}"
        f" (tie flips) {frac:.4%}")
    if not (frac < SWEEP_TOL["tie_frac"] and mx < SWEEP_TOL["max"]):
        raise AssertionError(f"sweep kernel disagrees with plain ({name})")
    return mx


def rdb_macs_per_px() -> int:
    """MACs of one dense block per pixel: five 3x3 convs, SFT0 on 64
    channels and SFT1 on 32 (each a scale and a shift branch of 32x32 then
    32xC)."""
    from fourk_nerf_torch.ops import cuda_sr
    return (9 * sum(ci * co for ci, co in zip(cuda_sr._CIN, cuda_sr._COUT))
            + 2 * (32 * 32 + 32 * 64) + 2 * (32 * 32 + 32 * 32))


def conv_chain_ms(body, w) -> float:
    """The dense block's five 3x3 convs alone as cuDNN bf16 ``F.conv2d``
    calls (channels_last, bias fused, no SFT, no concat) on the block's
    input ``body [H,W,64]``: ms per chain by CUDA events. A yardstick for
    the conv share of the dense-block kernel, not one call of its
    function."""
    import torch
    import torch.nn.functional as F
    from fourk_nerf_torch.ops import cuda_sr
    bf, cl = torch.bfloat16, torch.channels_last
    ks = [cuda_sr._unpack_conv(w, s).to(bf).contiguous(memory_format=cl)
          for s in range(5)]
    bs = [w.bias[s, :cuda_sr._COUT[s]].to(bf) for s in range(5)]
    srcs = [body.permute(2, 0, 1)[None].contiguous(memory_format=cl)]
    for s in range(4):  # the inputs each conv reads, built untimed
        y = F.leaky_relu(F.conv2d(srcs[-1], ks[s], bs[s], padding=1), 0.2)
        srcs.append(torch.cat([srcs[-1], y], 1).contiguous(memory_format=cl))

    def chain():
        for s in range(5):
            F.conv2d(srcs[s], ks[s], bs[s], padding=1)

    return cuda_ms(chain, 5)


def ptxas_registers(text: str, kernel: str) -> dict:
    """{instantiation: registers} of ``kernel`` from nvcc's ptxas log, the
    template arguments read off the mangled name (``bf16,16,64``)."""
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = line.split("'")[1] if "'" in line else ""
            name = None
            if f"{kernel}I" in m:
                args = m.split(f"{kernel}I", 1)[1].split("EEv", 1)[0]
                for code, typ in (("13__nv_bfloat16", "bf16"), ("f", "float")):
                    if args.startswith(code):
                        args = typ + "," + args[len(code):]
                name = args.replace("Li", "").replace("E", ",").strip(",")
        elif name and "registers" in line:
            out[name] = int(line.split("Used")[1].split()[0])
            name = None
    return out


def phase_build() -> dict:
    """Build every library; returns the sweep and box kernels' registers
    by instantiation, ``{"sweep": {...}, "box": {...}}``."""
    from fourk_nerf_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[1] build: {time.perf_counter() - t0:.1f} s total")
    for name, (sec, text) in logs.items():
        log(f"  {name}.cu: {sec:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"    {line.strip()}")
    regs = {k: ptxas_registers(logs[k][1], f"{k}_kernel")
            for k in ("sweep", "box")}
    for k, r in regs.items():
        log(f"  {k}_kernel registers by <grid type, channels a tap, MLP "
            f"width>: {r}")
    return regs


def small_scene(dev, seed=5):
    import torch
    from fourk_nerf_torch.models import dmpigo
    D = 32
    cfg = dmpigo.make_config(
        xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
        num_voxels=64 * 64 * D, mpi_depth=D, fast_color_thres=1.0 / D / 5,
        rgbnet_dim=9, rgbnet_width=64, viewbase_pe=4, spatial_pe=2)
    params, buffers = dmpigo.init(
        cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    params["density"] = t(rng.normal(-1, 2, params["density"].shape)
                          .astype(np.float32))
    params["k0"] = t(rng.normal(0, 1, params["k0"].shape).astype(np.float32))
    buffers["mask_cache"] = t(rng.uniform(size=cfg.world_size) < 0.7)
    return cfg, params, buffers


def camera(h, w, f):
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 1.0
    return K, c2w[:3, :4]


def phase_sweep_small(dev):
    from fourk_nerf_torch.ops import cuda_sweep, plane_sweep
    cfg, params, buffers = small_scene(dev)
    h, w = 96, 128
    K, c2w = camera(h, w, 120.0)
    log("[2] sweep kernel vs plain, small scene (viewbase_pe 4, spatial_pe 2,"
        f" grid {cfg.world_size}, {h}x{w})")
    kw = dict(stepsize=1.0, bg=0.25, device=dev)
    ref32 = plane_sweep.render_frame(cfg, params, buffers, h, w, K, c2w,
                                     use_bf16=False, **kw)
    ref16 = plane_sweep.render_frame(cfg, params, buffers, h, w, K, c2w,
                                     use_bf16=True, **kw)
    got32 = cuda_sweep.render_frame_cuda(cfg, params, buffers, h, w, K, c2w,
                                         use_bf16=False, **kw)
    got16 = cuda_sweep.render_frame_cuda(cfg, params, buffers, h, w, K, c2w,
                                         use_bf16=True, **kw)
    sync()
    check_sweep("f32 grid vs plain f32", got32, ref32)
    check_sweep("bf16 path vs plain bf16 path", got16, ref16)
    # the bf16 path (grid, x weights and MLP rounded to bf16, as the JAX
    # kernel's use_bf16) vs the float32 reference: rounding at 2^-9
    # relative moves alphas and features a little; the mean error must
    # stay well under one 8-bit colour level
    d = (got16["rgb_marched"] - ref32["rgb_marched"]).abs()
    mean, mx = float(d.mean()), float(d.max())
    log(f"  bf16 path vs plain f32: rgb max abs {mx:.3e}, mean {mean:.3e}")
    if not (mean < 2e-3 and mx < 0.1):
        raise AssertionError("bf16 sweep too far from the f32 plain")


def phase_rdb_small(dev, sr_model):
    import torch
    from fourk_nerf_torch.ops import cuda_sr
    h, w = 100, 150
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev).to(
        torch.bfloat16).contiguous()
    x, c, xin = (t(rng.normal(size=(h, w, n))) for n in (64, 32, 64))
    body = sr_model.body0
    log(f"[3] dense-block kernel vs plain, {h}x{w} (tile 8x16 does not "
        "divide it)")
    worst = 0.0
    for mode, wts, xi in (
            ("plain", cuda_sr.pack_rdb_weights(body.rdb1), None),
            ("tail", cuda_sr.pack_rdb_weights(body.rdb3, body.sft0), xin)):
        got = cuda_sr.rdb_apply(x, c, wts, xin=xi)
        ref = cuda_sr.rdb_plain(x, c, wts, xin=xi)
        sync()
        err = float((got.float() - ref.float()).abs().max())
        worst = max(worst, err)
        log(f"  {mode}: max abs {err:.3e} (|ref| max "
            f"{float(ref.float().abs().max()):.2f})")
        if not err <= RDB_TOL:
            raise AssertionError(f"dense-block kernel disagrees ({mode})")
    return worst


def fern_synthetic(dev):
    import torch
    from fourk_nerf_torch import weights
    from fourk_nerf_torch.models import dmpigo
    cfg = weights.fern_config(rgbnet_dim=9, rgbnet_depth=3, rgbnet_width=64)
    params, buffers = dmpigo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    params["density"] = torch.as_tensor(
        rng.normal(-2.0, 2.0, params["density"].shape).astype(np.float32),
        device=dev)
    buffers["mask_cache"] = torch.as_tensor(
        rng.uniform(size=cfg.mask_cache_world_size) < 0.5, device=dev)
    return cfg, params, buffers


def run_frame(label, cfg, params, buffers, sr_model, dev, sweep_regs):
    """Phases 4/5: one frame through the pipeline with the launch counts,
    checks against the plain versions, then timings. ``sweep_regs``: the
    sweep kernel's registers by instantiation (phase 1). Returns a dict of
    the measured numbers."""
    import torch
    from fourk_nerf_torch.ops import cuda_sr, cuda_sweep, plane_sweep
    from fourk_nerf_torch.pipeline import FramePipeline

    K, c2w = camera(H, W, 815.0)
    pipe = FramePipeline(cfg, params, buffers, sr_model, device=dev)
    sync()

    # the main path, counted
    cuda_sweep.sweep.launches = 0
    cuda_sr.rdb_apply.launches = 0
    sr, enc = pipe(H, W, K, c2w)
    sync()
    launches = {"sweep": cuda_sweep.sweep.launches,
                "rdb": cuda_sr.rdb_apply.launches}
    log(f"  main-path launches: {launches}")
    if launches != {"sweep": 1, "rdb": 3 * sr_model.num_block}:
        raise AssertionError(f"unexpected launch counts {launches}")
    if tuple(sr.shape) != (1, H * SCALE, W * SCALE, 3):
        raise AssertionError(f"SR shape {tuple(sr.shape)}")
    for k in ("rgb_feature", "depth", "alphainv_last"):
        if not bool(torch.isfinite(enc[k]).all()):
            raise AssertionError(f"non-finite encoder {k}")
    if not bool(torch.isfinite(sr).all()):
        raise AssertionError("non-finite SR output")
    log(f"  shapes: rgb_feature {tuple(enc['rgb_feature'].shape)}, "
        f"sr {tuple(sr.shape)}; all finite; rgb_feature mean "
        f"{float(enc['rgb_feature'].mean()):.4f}, alphainv_last mean "
        f"{float(enc['alphainv_last'].mean()):.4f}")

    # encoder: kernel vs plain on the main path's inputs, the rays in the
    # driver's tile order (the plain sweep runs in ray chunks of 2^18)
    X, Y, _ = cfg.world_size
    a, b, vde, inv = cuda_sweep.prepare_frame(cfg, H, W, K, c2w, device=dev)
    mlp = plane_sweep.mlp_layers(params["rgbnet"])
    kw = dict(Xl=X, Yl=Y, mask_ch=pipe.packed.mask_ch, k0_dim=cfg.k0_dim,
              interval=float(cfg.voxel_size_ratio),
              fast_thres=float(cfg.fast_color_thres),
              spatial_pe=cfg.spatial_pe, act_type=cfg.act_type)
    g = pipe.packed
    stats: dict = {}
    t0 = time.perf_counter()
    ref = plane_sweep.sweep_plain(g.packed, g.act_shift, a, b, vde, mlp,
                                  stats=stats, **kw)
    sync()
    plain_sweep_ms = (time.perf_counter() - t0) * 1e3
    ref = plane_sweep.assemble(*(t[inv] for t in ref), H, W, 1.0)
    sweep_err = check_sweep("encoder kernel vs plain (bf16 path)", enc, ref)
    log(f"  samples in bounds and live {stats['samples']}, with non-zero "
        f"weight (MLP evaluated) {stats['mlp_samples']}")

    sweep_ms = cuda_ms(lambda: cuda_sweep.sweep(g.packed, g.act_shift, a, b,
                                                vde, mlp, **kw), 3)
    # bound: the grid's live channels (density, k0, mask; not the padding)
    # read once, rays in, maps out; the MLP of the samples with a non-zero
    # weight at the peak of its type (bf16 tensor cores on the bf16 path,
    # the JAX kernel's MLP type there)
    cin0 = mlp[0][0].shape[0]
    width = mlp[0][0].shape[1]
    mlp_flop = 2 * (cin0 * width + (len(mlp) - 2) * width * width + width * 3)
    Z, Xp, Yp, _ = g.packed.shape
    sweep_bytes = (Z * Xp * Yp * (g.mask_ch + 1) * g.packed.element_size()
                   + (a.numel() + b.numel() + vde.numel()) * 4 + H * W * 5 * 4)
    t_bytes = sweep_bytes / HBM_BYTES_PER_S * 1e3
    bf16 = g.packed.dtype == torch.bfloat16
    t_ops = stats["mlp_samples"] * mlp_flop \
        / (BF16_FLOPS if bf16 else FP32_FLOPS) * 1e3
    sweep_bound = max(t_bytes, t_ops)
    cl = 8 if max(g.mask_ch, cfg.k0_dim) < 8 else 16  # channels read a tap
    regs = sweep_regs.get(f"{'bf16' if bf16 else 'float'},{cl},"
                          f"{64 if width <= 64 else 128}")
    log(f"  sweep kernel {sweep_ms:.3f} ms, plain {plain_sweep_ms:.1f} ms, "
        f"bound {sweep_bound:.3f} ms (bytes {t_bytes:.4f} ms, "
        f"{'bf16' if bf16 else 'fp32'} MLP ops {t_ops:.4f} ms); "
        f"sweep_kernel {regs} registers")

    # decoder: kernel vs plain at the main path's dense-block input
    prep = pipe.sr
    feat = enc["rgb_feature"][None]
    depth = enc["depth"][None, ..., None]
    _, _, body, ch = cuda_sr.sftnet_head(prep, feat, depth)
    rdb_err = 0.0
    for j, xi in ((0, None), (2, body)):
        got = cuda_sr.rdb_apply(body, ch, prep.packs[j], xin=xi)
        want = cuda_sr.rdb_plain(body, ch, prep.packs[j], xin=xi)
        rdb_err = max(rdb_err, float((got.float() - want.float()).abs().max()))
    log(f"  dense block kernel vs plain at {H}x{W}: max abs {rdb_err:.3e}")
    if not rdb_err <= RDB_TOL:
        raise AssertionError("dense-block kernel disagrees on the main path")
    rdb_ms = cuda_ms(lambda: cuda_sr.rdb_apply(body, ch, prep.packs[0]), 5)
    rdb_tail_ms = cuda_ms(
        lambda: cuda_sr.rdb_apply(body, ch, prep.packs[2], xin=body), 5)
    rdb_plain_ms = cuda_ms(lambda: cuda_sr.rdb_plain(body, ch, prep.packs[0]), 2)
    chain_ms = conv_chain_ms(body, prep.packs[0])
    mac_px = rdb_macs_per_px()
    rdb_ops = 2 * mac_px * H * W / BF16_FLOPS * 1e3
    rdb_bytes = (H * W * (64 + 32 + 64) * 2
                 + prep.packs[0].conv.numel() * 2) / HBM_BYTES_PER_S * 1e3
    rdb_bound = max(rdb_ops, rdb_bytes)
    log(f"  dense block kernel {rdb_ms:.3f} ms (tail {rdb_tail_ms:.3f} ms), "
        f"plain {rdb_plain_ms:.1f} ms, bound {rdb_bound:.3f} ms "
        f"({mac_px} MAC/px at the bf16 peak; bytes {rdb_bytes:.4f} ms); "
        f"its five convs as cuDNN bf16 calls {chain_ms:.3f} ms")

    sr_ref = cuda_sr.sftnet_apply_plain(prep, feat, depth, upchain="dilated")
    sync()
    d = (sr - sr_ref).abs()
    sr_err, sr_mean = float(d.max()), float(d.mean())
    log(f"  SR kernel chain vs plain chain: max abs {sr_err:.3e}, mean "
        f"{sr_mean:.3e} (|ref| max {float(sr_ref.abs().max()):.3f})")
    if not sr_err <= SR_TOL:
        raise AssertionError("SR output disagrees with the plain chain")
    del sr_ref, d, ref

    # timings: one warm-up frame, then the median of five
    pipe(H, W, K, c2w)
    sync()
    enc_t, sr_t, tot_t = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        e = pipe.encode(H, W, K, c2w)
        sync()
        t1 = time.perf_counter()
        pipe.decode(e)
        sync()
        t2 = time.perf_counter()
        enc_t.append((t1 - t0) * 1e3)
        sr_t.append((t2 - t1) * 1e3)
        tot_t.append((t2 - t0) * 1e3)
    out = {"enc_ms": statistics.median(enc_t), "sr_ms": statistics.median(sr_t),
           "fps": 1e3 / statistics.median(tot_t)}
    log(f"  {label}: " + json.dumps({k: round(v, 3) for k, v in out.items()}))
    profile_frame(pipe, H, W, K, c2w)
    out.update(rgb_feature=enc["rgb_feature"], depth=enc["depth"],
               launches=launches, sweep_err=sweep_err, sweep_ms=sweep_ms,
               plain_sweep_ms=plain_sweep_ms, sweep_bound=sweep_bound,
               sweep_bound_by="bytes" if t_bytes >= t_ops else "operations",
               sweep_registers=regs,
               rdb_err=rdb_err, rdb_ms=rdb_ms, rdb_plain_ms=rdb_plain_ms,
               rdb_bound=rdb_bound, conv_chain_ms=chain_ms,
               rdb_bound_by="operations" if rdb_ops >= rdb_bytes else "bytes")
    return out


def profile_call(fn, what: str = "frame", top: int = 8) -> dict:
    """``fn()`` once under torch.profiler: device time by kernel (the top
    ``top``) and the device's idle share of the call's wall time. Only
    device-side kernel rows are summed (operator rows repeat their
    kernels' time, and a ``record_function`` range's device row spans
    the kernels inside it). Returns ``wall_ms``, ``device_ms``, ``idle_share`` and
    ``top`` ([name, ms, calls], ...), or {} when no device time was
    recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        log("  profiler: no device time recorded")
        return {}
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms > wall_ms:
        raise AssertionError(f"device kernel time {busy_ms:.1f} ms exceeds "
                             f"the {what}'s wall time {wall_ms:.1f} ms: the "
                             "kernel rows are counted twice")
    log(f"  profiler: {what} wall {wall_ms:.1f} ms (profiled), device kernels "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for us, key, n in rows[:top]:
        log(f"    {us / 1e3:9.2f} ms  x{n:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top": [[key[:90], us / 1e3, n] for us, key, n in rows[:top]]}


def profile_frame(pipe, H, W, K, c2w):
    """One frame under torch.profiler (:func:`profile_call`)."""
    profile_call(lambda: pipe(H, W, K, c2w))


def box_pose(ang: float):
    """The orbit pose of the JAX package's bounded-scene bench: elevation
    0.5 rad, azimuth ``ang``, the camera 4 units out looking at the origin
    (-z forward)."""
    ax, ay = 0.5, ang
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    R = (Ry @ Rx).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[:3, :3] = R
    c2w[:3, 3] = R @ np.array([0, 0, 4.0], np.float32)
    return c2w


def box_camera(hw: int):
    f = 0.9 * hw
    return np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1]], np.float32)


def box_synthetic(dev, G: int = 160, fill: float = 0.15, *, direct=True,
                  width: int = 128):
    """The bounded scene of the JAX package's ``tools/perf/bench_box.py``
    from numpy seed 0: a G^3 grid over [-1.2, 1.2]^3, 12-ch k0, rgbnet
    3 x ``width`` (``rgbnet_direct`` as the published default config has
    it), a central blob of volume share ``fill`` with density N(15, 5)
    inside and -6 outside, the mask equal to the blob."""
    import torch
    from fourk_nerf_torch.models import dvgo
    cfg = dvgo.make_config(
        xyz_min=[-1.2, -1.2, -1.2], xyz_max=[1.2, 1.2, 1.2],
        num_voxels=G ** 3, num_voxels_base=G ** 3, alpha_init=1e-6,
        rgbnet_dim=12, rgbnet_width=width, rgbnet_depth=3, viewbase_pe=4,
        rgbnet_direct=direct, fast_color_thres=1e-4)
    params, buffers = dvgo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    X, Y, Z = cfg.world_size
    gx, gy, gz = np.meshgrid(np.linspace(-1, 1, X), np.linspace(-1, 1, Y),
                             np.linspace(-1, 1, Z), indexing="ij")
    blob = gx ** 2 + gy ** 2 + gz ** 2 \
        < (3.0 * fill / (4.0 * np.pi) * 8.0) ** (2 / 3)
    dens = np.where(blob, rng.normal(15.0, 5.0, blob.shape), -6.0)
    params["density"] = torch.as_tensor(dens[..., None].astype(np.float32),
                                        device=dev)
    params["k0"] = torch.as_tensor(
        rng.normal(0, 1, tuple(params["k0"].shape)).astype(np.float32),
        device=dev)
    buffers["mask_cache"] = torch.as_tensor(blob, device=dev)
    return cfg, params, buffers


BOX_RENDER = dict(stepsize=0.5, near=0.2, far=1e9, bg=1.0)


def phase_box_small(dev):
    from fourk_nerf_torch.ops import box_sweep, cuda_box
    cfg, params, buffers = box_synthetic(dev, G=32, fill=0.3, direct=False,
                                         width=64)
    h, w = 96, 128
    K = box_camera(w)
    K[1, 2] = h / 2
    log("[6] box kernel vs plain, small bounded scene (grid "
        f"{cfg.world_size}, residual rgbnet 3x64, {h}x{w})")
    worst = 0.0
    # azimuths that sweep along +z, -x and -z of the grid
    for ang in (0.1, 0.5 * np.pi, np.pi + 0.2):
        c2w = box_pose(ang)
        for use_bf16 in (False, True):
            kw = dict(stepsize=0.5, near=0.2, bg=0.25, use_bf16=use_bf16,
                      device=dev)
            ref = box_sweep.render_frame_box(cfg, params, buffers, h, w, K,
                                             c2w, **kw)
            got = cuda_box.render_frame_box_cuda(cfg, params, buffers, h, w,
                                                 K, c2w, **kw)
            sync()
            frame = box_sweep.prepare_frame_box(
                cfg, h, w, K, c2w, stepsize=0.5, near=0.2, device=dev)
            worst = max(worst, check_sweep(
                f"azimuth {ang:.2f} (axis {frame.axis}, flip {frame.flip}) "
                f"{'bf16' if use_bf16 else 'f32'}", got, ref))
            if not float((ref["rgb_marched"] - 0.25).abs().max()) > 0.05:
                raise AssertionError("the small bounded scene is not seen")
    return worst


def phase_rrdb_small(dev, sr_model):
    import torch
    from fourk_nerf_torch.ops import cuda_sr
    h, w = 100, 150
    rng = np.random.default_rng(4)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev).to(
        torch.bfloat16).contiguous()
    x, c = (t(rng.normal(size=(h, w, n))) for n in (64, 32))
    wts = cuda_sr.pack_rrdb_weights(sr_model.body0)
    log(f"[7] whole-RRDB kernel vs plain, {h}x{w} (divides neither the 8x16 "
        "tile nor the 36x60 region)")
    got = cuda_sr.rrdb_apply(x, c, wts)
    ref = cuda_sr.rrdb_plain(x, c, wts)
    cur = cuda_sr.rdb_apply(x, c, wts.block(0))
    cur = cuda_sr.rdb_apply(cur, c, wts.block(1))
    three = cuda_sr.rdb_apply(cur, c, wts.block(2), xin=x)
    sync()
    err = float((got.float() - ref.float()).abs().max())
    err3 = float((got.float() - three.float()).abs().max())
    log(f"  vs rrdb_plain: max abs {err:.3e}; vs three dense-block launches "
        f"(bf16 between blocks): {err3:.3e} (|ref| max "
        f"{float(ref.float().abs().max()):.2f})")
    if not (err <= RDB_TOL and err3 <= RDB_TOL):
        raise AssertionError("whole-RRDB kernel disagrees")
    return err


def occupied_samples(consts, occ, dims, block: int = 16):
    """(samples in range, samples whose floor cell lies in a block that
    ``occ``, a ``cuda_box.block_occupancy`` map at edge ``block``, marks)
    over every ``k <= kmax`` of the rays ``consts [R, 8]``, without early
    termination: what the box kernel's march tests and what it reads
    voxels for. Positions round as in the plain version."""
    import torch
    Z, U, V = dims
    u0, du, v0, dv, z0, dz, kmax = consts[:, :7].unbind(1)
    n_in = torch.zeros((), dtype=torch.long, device=consts.device)
    n_occ = torch.zeros_like(n_in)
    BU, BV = occ.shape[1], occ.shape[2]
    flat = occ.reshape(-1).bool()
    for k in range(int(kmax.max()) + 1 if kmax.numel() else 0):
        idx = (kmax >= k).nonzero().squeeze(1)
        u = u0[idx] + du[idx] * float(k)
        v = v0[idx] + dv[idx] * float(k)
        z = z0[idx] + dz[idx] * float(k)
        ok = ((u >= 0) & (u <= U - 1) & (v >= 0) & (v <= V - 1)
              & (z >= 0) & (z <= Z - 1))
        j = torch.floor(z).clamp(0, Z - 2).long() // block
        iu = torch.floor(u).clamp(0, U - 1).long() // block
        iv = torch.floor(v).clamp(0, V - 1).long() // block
        n_in += ok.sum()
        n_occ += (ok & flat[(j * BU + iu) * BV + iv]).sum()
    return int(n_in), int(n_occ)


def run_flythrough(dev, box_regs):
    """Phase 8: the bounded-scene fly-through through ``render_video`` with
    the launch counts, checks against the plain versions, then timings.
    ``box_regs``: the box kernel's registers by instantiation (phase 1)."""
    import torch
    from fourk_nerf_torch import weights
    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.ops import box_sweep, cuda_box, cuda_sr, cuda_sweep
    from fourk_nerf_torch.ops.plane_sweep import mlp_layers
    from fourk_nerf_torch.pipeline import FramePipeline, render_video
    from fourk_nerf_torch.train.trainer import DataFlags

    hw = BOX_HW
    cfg, params, buffers = box_synthetic(dev)
    sr_model = weights.sftnet_init(num_block=5, scale=1, seed=2, device=dev)
    prep = cuda_sr.prepare_sftnet(sr_model)
    K = box_camera(hw)
    poses = [box_pose(0.1 + 0.2 * i) for i in range(BOX_FRAMES)]
    log(f"  scene: grid {cfg.world_size}, occupancy "
        f"{float(buffers['mask_cache'].float().mean()):.3f}, rgbnet input "
        f"{cfg.dim0}, K {cfg.n_samples(0.5)} samples per ray at most")
    sync()

    # the main path, counted
    counters = {"box": cuda_box.sweep_box, "rrdb": cuda_sr.rrdb_apply,
                "rdb": cuda_sr.rdb_apply, "sweep": cuda_sweep.sweep}
    for fn in counters.values():
        fn.launches = 0
    out = render_video(dvgo, cfg, params, buffers, prep, poses, (hw, hw), K,
                       data=DataFlags(), render_kwargs=BOX_RENDER,
                       fuse_rrdb=True, device=dev)
    sync()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"  main-path launches over {BOX_FRAMES} frames: {launches}")
    want = {"box": BOX_FRAMES, "rrdb": BOX_FRAMES * sr_model.num_block,
            "rdb": 0, "sweep": 0}
    if launches != want:
        raise AssertionError(f"unexpected launch counts {launches}")
    frames, enc = out["frames"], out["encoder"]
    if tuple(frames.shape) != (BOX_FRAMES, hw, hw, 3) or enc["path"] != "box":
        raise AssertionError(f"frames {tuple(frames.shape)} via {enc['path']}")
    for k in ("rgb_features", "depths", "bgmaps"):
        if not bool(torch.isfinite(enc[k]).all()):
            raise AssertionError(f"non-finite encoder {k}")
    if not bool(torch.isfinite(frames).all()) or float(frames.min()) < 0 \
            or float(frames.max()) > 1:
        raise AssertionError("SR frames not finite in [0, 1]")
    covered = float((enc["bgmaps"] < 0.5).float().mean())
    log(f"  frames {tuple(frames.shape)}, all finite in [0,1]; share of "
        f"pixels the blob covers {covered:.3f}; encoder "
        f"{[round(t * 1e3, 1) for t in enc['frame_times']]} ms, decoder "
        f"{[round(t * 1e3, 1) for t in out['sr_times']]} ms (first frame "
        "includes warm-up)")
    if not 0.02 < covered < 0.95:
        raise AssertionError("the blob is not in view")

    # box kernel vs plain at the path's inputs (frame 0, the bf16 path)
    pipe = FramePipeline(cfg, params, buffers, prep, fuse_rrdb=True,
                         device=dev, **{k: BOX_RENDER[k]
                                        for k in ("stepsize", "near", "bg")})
    c2w = poses[0]
    frame = box_sweep.prepare_frame_box(cfg, hw, hw, K, c2w, stepsize=0.5,
                                        near=0.2, device=dev)
    mlp = mlp_layers(params["rgbnet"])
    kw = box_sweep.sweep_kwargs(cfg, frame, pipe.packed, 0.5)
    vox = pipe.packed.voxels
    stats: dict = {}
    t0 = time.perf_counter()
    ref = box_sweep.sweep_box_plain(vox, frame.consts, frame.vde, mlp,
                                    stats=stats, **kw)
    sync()
    box_plain_ms = (time.perf_counter() - t0) * 1e3
    ref = box_sweep.assemble(*ref, hw, hw, BOX_RENDER["bg"])
    got = {"rgb_marched": enc["rgbs"][0], "depth": enc["depths"][0],
           "alphainv_last": enc["bgmaps"][0]}
    box_err = check_sweep("box kernel vs plain (bf16 path, frame 0)", got, ref)
    # the kernel's inputs as the driver hands them: rays in tile order, the
    # scene's block map of this sweep direction
    occ = cuda_box.box_occupancy(pipe.packed, kw["dims"], kw["strides"])
    n_in, n_occ = occupied_samples(frame.consts, occ, kw["dims"],
                                   cuda_box.OCC_BLOCK)
    log(f"  sweep axis {frame.axis}, flip {frame.flip}; samples in range "
        f"{stats['samples']} ({n_in} up to kmax without early termination, "
        f"{n_occ} of them in occupied {cuda_box.OCC_BLOCK}^3 blocks, "
        f"{float(occ.float().mean()):.3f} of the blocks), with non-zero "
        f"weight (MLP evaluated) {stats['mlp_samples']}")
    order, _ = cuda_sweep.ray_order(hw, hw, dev)
    consts, vde = frame.consts[order], frame.vde[order].contiguous()
    box_ms = cuda_ms(lambda: cuda_box.sweep_box(pipe.packed, consts, vde,
                                                mlp, **kw), 5)
    width = mlp[0][0].shape[1]
    mlp_flop = 2 * (cfg.dim0 * width + (len(mlp) - 2) * width * width
                    + width * 3)
    box_bytes = (vox.shape[0] * (pipe.packed.mask_ch + 1) * vox.element_size()
                 + (frame.consts.numel() + frame.vde.numel()) * 4
                 + hw * hw * 5 * 4)
    t_bytes = box_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = stats["mlp_samples"] * mlp_flop / BF16_FLOPS * 1e3
    box_bound = max(t_bytes, t_ops)
    regs = box_regs.get(f"bf16,16,{64 if width <= 64 else 128}")
    log(f"  box kernel {box_ms:.3f} ms, plain {box_plain_ms:.1f} ms, bound "
        f"{box_bound:.4f} ms (bytes {t_bytes:.4f} ms, bf16 MLP ops "
        f"{t_ops:.4f} ms); box_kernel {regs} registers")

    # the encoder's steps at frame 0, each on the host clock and synced:
    # the frame's rays, their gather into tile order, the launch, the
    # gather back into row order with assembly; beside them the rgbnet's
    # packing, which the scene's cache makes once
    def host_ms(fn, reps=5):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) * 1e3 / reps

    rgb, dep, ail = cuda_box.sweep_box(pipe.packed, consts, vde, mlp, **kw)
    inverse = cuda_sweep.ray_order(hw, hw, dev)[1]
    enc_split = {
        "frame": host_ms(lambda: pipe.encode(hw, hw, K, c2w)),
        "prepare": host_ms(lambda: box_sweep.prepare_frame_box(
            cfg, hw, hw, K, c2w, stepsize=0.5, near=0.2, device=dev)),
        "tile_gather": host_ms(lambda: (frame.consts[order], frame.vde[
            order].contiguous(), cuda_sweep.ray_order(hw, hw, dev))),
        "launch": host_ms(lambda: cuda_box.sweep_box(pipe.packed, consts,
                                                     vde, mlp, **kw)),
        "restore": host_ms(lambda: box_sweep.assemble(
            rgb[inverse], dep[inverse], ail[inverse], hw, hw,
            BOX_RENDER["bg"])),
        "rgbnet_pack_once": host_ms(
            lambda: cuda_sweep.pack_mlp_fragments(mlp, cfg.dim0))}
    log("  encoder steps at frame 0, ms (host clock): " + json.dumps(
        {k: round(v, 3) for k, v in enc_split.items()}))

    # rrdb kernel vs plain at the path's first RRDB input
    feat = enc["rgb_features"][0][None]
    depth = enc["depths"][0][None, ..., None]
    _, _, body, ch = cuda_sr.sftnet_head(prep, feat, depth)
    w0 = prep.rrdb_packs[0]
    got = cuda_sr.rrdb_apply(body, ch, w0)
    want_ = cuda_sr.rrdb_plain(body, ch, w0)
    sync()
    rrdb_err = float((got.float() - want_.float()).abs().max())
    log(f"  rrdb kernel vs plain at {hw}x{hw}: max abs {rrdb_err:.3e}")
    if not rrdb_err <= RDB_TOL:
        raise AssertionError("whole-RRDB kernel disagrees on the main path")
    del got, want_
    rrdb_ms = cuda_ms(lambda: cuda_sr.rrdb_apply(body, ch, w0), 3)

    def three_rdb():
        cur = cuda_sr.rdb_apply(body, ch, prep.packs[0])
        cur = cuda_sr.rdb_apply(cur, ch, prep.packs[1])
        return cuda_sr.rdb_apply(cur, ch, prep.packs[2], xin=body)

    three_ms = cuda_ms(three_rdb, 3)
    rrdb_plain_ms = cuda_ms(lambda: cuda_sr.rrdb_plain(body, ch, w0), 2)
    mac_px = 3 * rdb_macs_per_px() + 2 * (32 * 32 + 32 * 64)
    rrdb_ops = 2 * mac_px * hw * hw / BF16_FLOPS * 1e3
    rrdb_bytes = (hw * hw * (64 + 32 + 64) * 2 + w0.conv.numel() * 2
                  + (w0.bias.numel() + w0.sftb.numel()) * 4
                  + w0.sftk.numel() * 2
                  ) / HBM_BYTES_PER_S * 1e3
    rrdb_bound = max(rrdb_ops, rrdb_bytes)
    log(f"  rrdb kernel {rrdb_ms:.3f} ms, three dense-block launches "
        f"{three_ms:.3f} ms, plain {rrdb_plain_ms:.1f} ms, bound "
        f"{rrdb_bound:.4f} ms ({mac_px} MAC/px at the bf16 peak; bytes "
        f"{rrdb_bytes:.4f} ms)")

    # the decode: kernel chain vs plain chain on frame 0
    sr_ref = cuda_sr.sftnet_apply_plain(prep, feat, depth, fuse_rrdb=True,
                                        upchain="dilated")
    sync()
    d = (frames[0] - sr_ref[0].clamp(0, 1)).abs()
    sr_err, sr_mean = float(d.max()), float(d.mean())
    log(f"  SR kernel chain vs plain chain (fuse_rrdb): max abs {sr_err:.3e},"
        f" mean {sr_mean:.3e}")
    if not sr_err <= SR_TOL:
        raise AssertionError("fused SR output disagrees with the plain chain")
    del sr_ref, d

    # timings: one warm-up frame, then the poses in turn, five frames; with
    # fuse_rrdb and with three dense-block launches an RRDB (render_video's
    # default), whose path is counted first
    def frames_timed(p):
        p(hw, hw, K, poses[0])
        sync()
        enc_t, sr_t, tot_t = [], [], []
        for i in range(5):
            t0 = time.perf_counter()
            e = p.encode(hw, hw, K, poses[i % BOX_FRAMES])
            sync()
            t1 = time.perf_counter()
            p.decode(e)
            sync()
            t2 = time.perf_counter()
            enc_t.append((t1 - t0) * 1e3)
            sr_t.append((t2 - t1) * 1e3)
            tot_t.append((t2 - t0) * 1e3)
        return {"enc_ms": statistics.median(enc_t),
                "sr_ms": statistics.median(sr_t),
                "fps": 1e3 / statistics.median(tot_t)}

    res = frames_timed(pipe)
    log("  fly-through, fuse_rrdb: " + json.dumps(
        {k: round(v, 3) for k, v in res.items()}))
    pipe3 = FramePipeline(cfg, params, buffers, prep, fuse_rrdb=False,
                          device=dev, **{k: BOX_RENDER[k]
                                         for k in ("stepsize", "near", "bg")})
    for fn in counters.values():
        fn.launches = 0
    pipe3(hw, hw, K, poses[0])
    sync()
    n3 = {k: fn.launches for k, fn in counters.items()}
    if n3 != {"box": 1, "rrdb": 0, "rdb": 3 * sr_model.num_block, "sweep": 0}:
        raise AssertionError(f"unexpected launch counts {n3} (fuse_rrdb off)")
    res3 = frames_timed(pipe3)
    log(f"  fly-through, fuse_rrdb=False (launches a frame {n3}): "
        + json.dumps({k: round(v, 3) for k, v in res3.items()}))
    del pipe3
    profile_frame(pipe, hw, hw, K, poses[0])
    res.update(unfused=res3, launches=launches, box_err=box_err, box_ms=box_ms,
               encoder_steps=enc_split,
               box_plain_ms=box_plain_ms, box_bound=box_bound,
               box_bound_by="bytes" if t_bytes >= t_ops else "operations",
               box_registers=box_regs, box_samples=dict(
                   in_range=stats["samples"], in_range_to_kmax=n_in,
                   in_occupied_blocks=n_occ, mlp=stats["mlp_samples"]),
               rrdb_err=rrdb_err, rrdb_ms=rrdb_ms, rrdb_plain_ms=rrdb_plain_ms,
               rrdb_bound=rrdb_bound, three_rdb_ms=three_ms,
               rrdb_bound_by="operations" if rrdb_ops >= rrdb_bytes
               else "bytes")
    return res


def phase_uptail_small(dev, sr_model):
    import torch
    from fourk_nerf_torch.ops import cuda_sr
    wts = cuda_sr.pack_uptail_weights(sr_model)
    log("[9] uptail kernel vs plain (16x28 output tiles: 8x14 of the 2x "
        "map)")
    worst = 0.0
    # an odd size, an even one, one pixel, under, at and one pixel past a
    # tile in each direction and in both
    for h2, w2 in ((45, 70), (48, 64), (1, 1), (7, 13), (8, 14), (9, 14),
                   (8, 15), (9, 15)):
        x = torch.as_tensor(np.random.default_rng(7).normal(
            size=(1, h2, w2, 64)).astype(np.float32), device=dev)
        got = cuda_sr.uptail_apply(x, wts)
        ref = cuda_sr.uptail_plain(x, wts)
        sync()
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        log(f"  {h2}x{w2} -> {tuple(got.shape)}: max abs {err:.3e} (|ref| max "
            f"{float(ref.abs().max()):.2f})")
        if not (err <= UPTAIL_TOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"uptail kernel disagrees at {h2}x{w2}")
    return worst


def run_fused_tail(dev, sr_model, syn):
    """Phases 10-11: the 4K decode of the synthetic frame's encoder output
    with the fused tail, counted, checked and timed; then the materialized
    upchain and the tiled decode."""
    import torch
    from fourk_nerf_torch.models import sr_esrnet
    from fourk_nerf_torch.ops import cuda_sr

    feat = syn["rgb_feature"][None]
    depth = syn["depth"][None, ..., None]
    prep = cuda_sr.prepare_sftnet(sr_model)
    wts = cuda_sr.pack_uptail_weights(sr_model)
    sync()

    # the slice's path, counted
    cuda_sr.rdb_apply.launches = 0
    cuda_sr.uptail_apply.launches = 0
    up1 = cuda_sr.sftnet_trunk_cuda(prep, feat, depth, upchain="dilated")
    rgb = cuda_sr.uptail_apply(up1, wts)
    frame = rgb.clamp(0.0, 1.0)
    sync()
    launches = {"rdb": cuda_sr.rdb_apply.launches,
                "uptail": cuda_sr.uptail_apply.launches}
    log(f"  main-path launches: {launches}")
    if launches != {"rdb": 3 * sr_model.num_block, "uptail": 1}:
        raise AssertionError(f"unexpected launch counts {launches}")
    H2, W2 = up1.shape[1:3]
    if tuple(frame.shape) != (1, H * SCALE, W * SCALE, 3) \
            or (H2, W2) != (2 * H, 2 * W) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"fused-tail frame {tuple(frame.shape)}")
    log(f"  conv_up1 output {tuple(up1.shape)} {up1.dtype} -> frame "
        f"{tuple(frame.shape)}, all finite, mean {float(frame.mean()):.4f}")

    # (a) kernel vs plain on the real conv_up1 output
    t0 = time.perf_counter()
    ref = cuda_sr.uptail_plain(up1, wts)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((rgb - ref).abs().max())
    log(f"  uptail kernel vs plain at {H2}x{W2}: max abs {err:.3e} (|ref| max "
        f"{float(ref.abs().max()):.3f})")
    if not err <= UPTAIL_TOL:
        raise AssertionError("uptail kernel disagrees on the main path")
    del ref
    # (b) the frame vs the dilated decode of the same input
    dil = cuda_sr.sftnet_tail(prep, up1, upchain="dilated")
    sync()
    d = (rgb - dil).abs()
    fr_err, fr_mean = float(d.max()), float(d.mean())
    log(f"  fused-tail decode vs dilated decode: max abs {fr_err:.3e}, mean "
        f"{fr_mean:.3e} (the fused tail rounds its RGB to bf16)")
    if not fr_err <= SR_TOL:
        raise AssertionError("fused-tail frame disagrees with the dilated "
                             "decode")
    del d

    # timings, in turns: library tail, kernel, kernel, library tail
    lib1 = cuda_ms(lambda: cuda_sr.sftnet_tail(prep, up1, upchain="dilated"), 5)
    ms1 = cuda_ms(lambda: cuda_sr.uptail_apply(up1, wts), 5)
    ms2 = cuda_ms(lambda: cuda_sr.uptail_apply(up1, wts), 5)
    lib2 = cuda_ms(lambda: cuda_sr.sftnet_tail(prep, up1, upchain="dilated"), 5)
    ms, lib_ms = (ms1 + ms2) / 2, (lib1 + lib2) / 2
    # bound from the shapes: per pixel of the 2x map, four phase outputs of a
    # 2x2 conv 64->64, four output pixels of a 3x3 conv 64->64 and of a 3x3
    # conv 64->3; x and the weights read once, the RGB written once
    mac_px = 4 * 4 * 64 * 64 + 4 * 9 * 64 * 64 + 4 * 9 * 64 * 3
    t_ops = 2 * mac_px * H2 * W2 / BF16_FLOPS * 1e3
    n_in = up1.numel() * up1.element_size() + sum(
        t.numel() * t.element_size()
        for t in (wts.kup, wts.khr, wts.klast, wts.bias))
    n_out = rgb.numel() * rgb.element_size()
    t_bytes = (n_in + n_out) / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    # rates: the bound's operations, and the MACs the kernel issues with its
    # tiles' halo and padding, over the kernel's time
    issued = cuda_sr.uptail_issued_macs(H2, W2)
    tflops = 2 * mac_px * H2 * W2 / ms / 1e9
    tflops_issued = 2 * issued / ms / 1e9
    log(f"  uptail kernel {ms:.3f} ms ({ms1:.3f}, {ms2:.3f}), library tail "
        f"(transposed conv_up2 + conv_hr + float32 conv_last) {lib_ms:.3f} ms "
        f"({lib1:.3f}, {lib2:.3f}), plain {plain_ms:.1f} ms, bound "
        f"{bound:.3f} ms ({mac_px} MAC per 2x pixel x {H2 * W2} pixels = "
        f"{2 * mac_px * H2 * W2 / 1e12:.3f} TFLOP at the bf16 peak; bytes "
        f"{n_in / 1e6:.0f} MB in + {n_out / 1e6:.0f} MB out, {t_bytes:.3f} ms)")
    log(f"  uptail kernel rate {tflops:.1f} TFLOP/s on the bound's operations,"
        f" {tflops_issued:.1f} TFLOP/s on the {issued} MAC it issues "
        f"({issued / (mac_px * H2 * W2):.3f}x: halo and padding)")
    # the decode end to end, host clock around a synchronise, median of 3
    def decode_ms(fn):
        fn()
        sync()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    fused_ms = decode_ms(lambda: cuda_sr.uptail_apply(
        cuda_sr.sftnet_trunk_cuda(prep, feat, depth, upchain="dilated"), wts))
    dil_ms = decode_ms(lambda: cuda_sr.sftnet_apply_cuda(
        prep, feat, depth, upchain="dilated"))
    log(f"  decode with the fused tail {fused_ms:.3f} ms, dilated decode "
        f"{dil_ms:.3f} ms")
    res = dict(launches=launches, uptail_err=err, uptail_ms=ms,
               uptail_plain_ms=plain_ms, uptail_bound=bound,
               uptail_bound_by="operations" if t_ops >= t_bytes else "bytes",
               uptail_library_ms=lib_ms, frame_err=fr_err,
               uptail_tflops=tflops, uptail_tflops_issued=tflops_issued)
    del rgb, frame, up1
    torch.cuda.empty_cache()

    log("[11] materialized vs dilated upchain on the 4K frame; tiled decode")
    mat = cuda_sr.sftnet_apply_cuda(prep, feat, depth, upchain="materialized")
    d = (mat - dil).abs()
    sync()
    up_err, up_mean = float(d.max()), float(d.mean())
    log(f"  upchain materialized vs dilated: max abs {up_err:.3e}, mean "
        f"{up_mean:.3e}")
    if not (up_err <= SR_TOL and bool(torch.isfinite(mat).all())):
        raise AssertionError("the two upchains disagree")
    del mat, dil, d
    torch.cuda.empty_cache()

    # tile_process on a crop vs a per-tile loop with the same pad and crop
    ch, cw, ts, tp = 189, 252, 96, 10
    img, cond = feat[:, :ch, :cw], depth[:, :ch, :cw]
    with torch.no_grad():
        tiled = sr_esrnet.tile_process(sr_model, img, cond, tile_size=ts,
                                       tile_pad=tp, scale=SCALE)
    ny, nx = -(-ch // ts), -(-cw // ts)
    pad = (tp, nx * ts + tp - cw, tp, ny * ts + tp - ch)  # W then H
    img_p, cond_p = (torch.nn.functional.pad(
        a.permute(0, 3, 1, 2), pad, mode="replicate").permute(0, 2, 3, 1)
        for a in (img, cond))
    oracle = torch.zeros((ch * SCALE, cw * SCALE, 3), device=dev)
    full = ts + 2 * tp
    for y in range(ny):
        for x in range(nx):
            sy, sx = y * ts, x * ts
            with torch.no_grad():
                sr = sr_model(img_p[:, sy:sy + full, sx:sx + full],
                              cond_p[:, sy:sy + full, sx:sx + full])[0]
            core = sr[tp * SCALE:(tp + ts) * SCALE, tp * SCALE:(tp + ts) * SCALE]
            oy, ox = sy * SCALE, sx * SCALE
            h = min(ts * SCALE, ch * SCALE - oy)
            w = min(ts * SCALE, cw * SCALE - ox)
            oracle[oy:oy + h, ox:ox + w] = core[:h, :w]
    sync()
    t_err = float((tiled[0] - oracle).abs().max())
    log(f"  tile_process {cw}x{ch} at tile {ts} ({ny * nx} tiles) -> "
        f"{tuple(tiled.shape)}: max abs vs the per-tile loop {t_err:.3e}")
    if not (tuple(tiled.shape) == (1, ch * SCALE, cw * SCALE, 3)
            and t_err <= 1e-5):
        raise AssertionError("tile_process disagrees with the per-tile loop")
    return res


class Recorder:
    """A scalar writer that keeps the rows (the trainer's ``writer``)."""

    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def values(self, tag):
        return [v for t, v, _ in self.rows if t == tag]


def train_teacher_views(dev, hr: bool = False):
    """The scene of phase 13: the trained anchor rendered at 1008x756 from
    ``TRAIN_VIEWS`` poses a few hundredths apart (the sweep kernel, bf16
    path), its contrast stretched, as the LLFF loader's ``data_dict`` with
    every 5th view held out and ``i_val`` the first of those. With ``hr``
    the same poses are also rendered at 4032x3024 (``K`` scaled by 4),
    stretched by the low-resolution views' mean and std, as ``srgt``
    (NCHW, as the LLFF loader gives it) with the poses' ``w2c``."""
    from fourk_nerf_torch import weights
    from fourk_nerf_torch.models import dmpigo
    from fourk_nerf_torch.train import trainer
    cfg, params, buffers = weights.load_anchor(device=dev)
    K, c2w0 = camera(H, W, 815.0)
    poses = np.stack([c2w0 + np.array([[0, 0, 0, 0.02 * (i % 5 - 2)],
                                       [0, 0, 0, 0.03 * (i // 5 - 0.5)],
                                       [0, 0, 0, 0]], np.float32)
                      for i in range(TRAIN_VIEWS)]).astype(np.float32)
    n = TRAIN_VIEWS
    res = trainer.render_viewpoints(
        dmpigo, cfg, params, buffers, poses, np.array([[H, W]] * n),
        np.stack([K] * n), data=trainer.DataFlags(ndc=True),
        render_kwargs={"stepsize": 1.0, "bg": 0.0}, verbose=False,
        device=dev)
    images = res["rgbs"].float().cpu().numpy()
    del res
    srgt = None
    if hr:
        K4 = K.copy()
        K4[:2, :3] *= SCALE
        res = trainer.render_viewpoints(
            dmpigo, cfg, params, buffers, poses,
            np.array([[H * SCALE, W * SCALE]] * n), np.stack([K4] * n),
            data=trainer.DataFlags(ndc=True),
            render_kwargs={"stepsize": 1.0, "bg": 0.0}, verbose=False,
            device=dev)
        srgt = res["rgbs"].float().permute(0, 3, 1, 2).cpu().numpy()
        del res
    del cfg, params, buffers
    # the anchor's frames are near-uniform grey (mean 0.50, std ~0.02), and
    # the MSE of an untrained model is then smaller than the published
    # distortion term: stretch them to a std of 0.2 around their mean so
    # that 60 steps show in the loss
    mean, std = images.mean(), images.std()

    def stretch(x):
        return np.clip(0.5 + (x - mean) * (0.2 / std), 0.0,
                       1.0).astype(np.float32)

    images = stretch(images)
    i_test = np.arange(n)[::5]
    i_val = [int(i_test[0])]
    i_train = np.array([i for i in range(n)
                        if i not in i_test and i not in i_val])
    data = dict(hwf=[H, W, 815.0], HW=np.array([[H, W]] * n),
                Ks=np.stack([K] * n).astype(np.float64), near=0.0, far=1.0,
                near_clip=None, i_train=i_train, i_val=i_val, i_test=i_test,
                poses=poses, render_poses=poses.copy(), images=images,
                irregular_shape=False)
    if hr:
        from fourk_nerf_torch.data import llff
        data.update(srgt=stretch(srgt), w2c=llff.w2c_gen(poses))
    return data


def event_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` calls of ``fn`` (after one warm-up) of the ms
    between CUDA events around each call."""
    import torch
    fn()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def check_grid_update(st, params, opt, grads, lrs, n_rand: int) -> dict:
    """Phase 13: the grid update kernels (``ops/cuda_grid.py``) on one
    full-width step's gradients of the density and k0 grids, against their
    plain versions on copies: TV added sparse and dense against ``grad +
    render.total_variation_grad``, then MaskedAdam of the sparse TV-added
    gradient against ``optim.masked_adam_plain`` from the run's moments.
    Both bit for bit, except that the plain sparse TV turns a skipped -0.0
    gradient into +0.0; the kernel's ``touched`` count equals the non-zero
    gradients. Each kernel is timed (CUDA events, median of 5) beside its
    plain version and its byte bound: the gradient read, and the touched
    entries' grid read and gradient write (TV), or their param and moments
    read and written (Adam). Returns the record."""
    import torch
    from fourk_nerf_torch.ops import cuda_grid, render
    from fourk_nerf_torch.train import optim

    def bits(t):
        return t.view(torch.int32)

    m = st.model_mod
    weights = {"density": st.weight_tv_density, "k0": st.weight_tv_k0}
    bc = optim._bias_correction(opt["step"] + 1)
    out = {"grids": {}, "ms": {}, "plain_ms": {}}
    bound = {"tv_sparse": 0, "tv_dense": 0, "adam": 0}
    for k in ("density", "k0"):
        grid, g = params[k], grads[k]
        w = m.tv_weights(st.model_cfg, weights[k], n_rand)
        n = g.numel()
        zero = g == 0
        res = {"shape": list(g.shape), "nonzero": n - int(zero.sum())}
        for dense in (False, True):
            tag = "tv_dense" if dense else "tv_sparse"
            got = g.clone()
            cuda_grid.tv_add_grad_(grid, got, *w, dense)
            want = g + render.total_variation_grad(grid, *w,
                                                   None if dense else g)
            same = (bits(got) == bits(want)) | (zero & (got == 0)
                                                & (want == 0))
            res[f"{tag}_differ"] = int((~same).sum())
            res[f"{tag}_max_abs_err"] = float((got - want).abs().max())
            if dense:
                del got
            else:
                g_tv = got
            del want
            scratch = g.clone()
            out["ms"][f"{k}.{tag}"] = event_ms(
                lambda: cuda_grid.tv_add_grad_(grid, scratch, *w, dense))
            scratch.copy_(g)
            out["plain_ms"][f"{k}.{tag}"] = event_ms(
                lambda: scratch.add_(render.total_variation_grad(
                    grid, *w, None if dense else scratch)))
            del scratch
        touched = n - int((g_tv == 0).sum())
        res["touched"] = touched
        bound["tv_sparse"] += 4 * n + 8 * res["nonzero"]
        bound["tv_dense"] += 12 * n
        bound["adam"] += 4 * n + 24 * touched

        step_size = float(np.float32(lrs[k]) * np.float32(bc))
        kern = [t.clone() for t in (grid, opt["exp_avg"][k],
                                     opt["exp_avg_sq"][k])]
        plain = [t.clone() for t in kern]
        count = torch.zeros((), dtype=torch.int64, device=grid.device)
        cuda_grid.masked_adam_(kern[0], g_tv, kern[1], kern[2], step_size,
                               True, touched=count)
        optim.masked_adam_plain(*(t.view(-1) for t in
                                  (plain[0], g_tv, plain[1], plain[2])),
                                step_size, True)
        res["adam_differ"] = sum(int((bits(a) != bits(b)).sum())
                                 for a, b in zip(kern, plain))
        res["adam_max_abs_err"] = max(float((a - b).abs().max())
                                      for a, b in zip(kern, plain))
        res["adam_touched"] = int(count)
        out["ms"][f"{k}.adam"] = event_ms(lambda: cuda_grid.masked_adam_(
            kern[0], g_tv, kern[1], kern[2], step_size, True))
        out["plain_ms"][f"{k}.adam"] = event_ms(
            lambda: optim.masked_adam_plain(*(t.view(-1) for t in (
                plain[0], g_tv, plain[1], plain[2])), step_size, True))
        del kern, plain, g_tv
        torch.cuda.empty_cache()
        out["grids"][k] = res
        log(f"  grid update, {k} {tuple(g.shape)}: {res['nonzero']} "
            f"non-zero gradients, {touched} after TV (touched count "
            f"{res['adam_touched']}); entries that differ from the plain "
            f"versions: TV sparse {res['tv_sparse_differ']}, dense "
            f"{res['tv_dense_differ']}, Adam {res['adam_differ']}; ms "
            + ", ".join(f"{t} {out['ms'][f'{k}.{t}']:.3f} (plain "
                        f"{out['plain_ms'][f'{k}.{t}']:.2f})"
                        for t in ("tv_sparse", "tv_dense", "adam")))
        if res["tv_sparse_differ"] or res["tv_dense_differ"] \
                or res["adam_differ"] or res["adam_touched"] != touched:
            raise AssertionError(f"grid update kernels vs plain, {k}: {res}")
    # the step's two stages: sparse TV, then masked Adam, over both grids
    stages = ("tv_sparse", "adam")
    out["bound_bytes"] = bound
    out["bound_ms"] = {t: b / HBM_BYTES_PER_S * 1e3 for t, b in bound.items()}
    out["step_ms"] = sum(out["ms"][f"{k}.{t}"] for k in out["grids"]
                         for t in stages)
    out["step_plain_ms"] = sum(out["plain_ms"][f"{k}.{t}"]
                               for k in out["grids"] for t in stages)
    out["step_bound_ms"] = sum(out["bound_ms"][t] for t in stages)
    out["max_abs_err"] = max(r[f"{t}_max_abs_err"] for r in
                             out["grids"].values()
                             for t in ("tv_sparse", "tv_dense", "adam"))
    log(f"  grid update, a step's sparse TV + masked Adam over both grids: "
        f"{out['step_ms']:.3f} ms, plain {out['step_plain_ms']:.2f} ms, "
        f"bound {out['step_bound_ms']:.3f} ms")
    return out


def run_training(dev):
    """Phase 13 (see the module docstring). Returns the ``training``
    record."""
    import shutil
    import types

    import torch
    from fourk_nerf_torch import config as config_mod
    from fourk_nerf_torch.models import dmpigo
    from fourk_nerf_torch.ops import cuda_grid, cuda_sweep, grid_sample
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import checkpoints, optim, trainer

    cfg_path = os.path.join("fourk_nerf_torch", "configs", "llff",
                            "fern_lg_pretrain.py")
    basedir = os.path.join(HERE, "build", "phase13_train")
    shutil.rmtree(basedir, ignore_errors=True)
    rec: dict = {"config": cfg_path, "overrides": TRAIN_OVERRIDES}
    t_phase = time.perf_counter()

    # --- the scene (and its 4K views for phase 14) ---------------------------
    cuda_sweep.sweep.launches = 0
    data = train_teacher_views(dev, hr=True)
    sync()
    launches = {"teacher": cuda_sweep.sweep.launches}
    if launches["teacher"] != 2 * TRAIN_VIEWS:
        raise AssertionError(f"teacher views: {launches['teacher']} sweep "
                             f"launches for {TRAIN_VIEWS} views at two sizes")
    log(f"  teacher: {TRAIN_VIEWS} views of {W}x{H} through the sweep "
        f"kernel; train {data['i_train'].tolist()}, test "
        f"{data['i_test'].tolist()}, val {data['i_val']}")

    # --- the run -------------------------------------------------------------
    cfg = config_mod.load_config(os.path.join(HERE, cfg_path))
    cfg.basedir, cfg.expname = basedir, "fern_pretrain"
    for k, v in TRAIN_OVERRIDES["fine_train"].items():
        cfg.fine_train[k] = v
    args = types.SimpleNamespace(seed=777, no_reload=True,
                                 no_reload_optimizer=False, ft_path="",
                                 **TRAIN_OVERRIDES["args"])
    writer = Recorder()
    torch.cuda.reset_peak_memory_stats()
    cuda_sweep.sweep.launches = 0
    cuda_grid.tv_add_grad_.launches = 0
    cuda_grid.masked_adam_.launches = 0
    t0 = time.perf_counter()
    _, mcfg, params, buffers = trainer.train(args, cfg, data, writer=writer,
                                             device=dev)
    sync()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches["i_val"] = cuda_sweep.sweep.launches
    # every step adds TV (tv_after 0, tv_every 1) to density and k0, and
    # both are masked groups; the rgbnet's update is no kernel of its own
    grid_launches = {"tv": cuda_grid.tv_add_grad_.launches,
                     "adam": cuda_grid.masked_adam_.launches}
    n_steps = cfg.fine_train.N_iters
    rec["grid_update_launches"] = grid_launches
    log(f"  grid update launches over {n_steps} steps: {grid_launches}")
    if grid_launches != {"tv": 2 * n_steps, "adam": 2 * n_steps}:
        raise AssertionError(f"grid update: {grid_launches} launches, not "
                             f"2 + 2 a step over {n_steps} steps")
    losses = writer.values("train/loss")
    rec.update(world_size=list(mcfg.world_size),
               mask_cache_world_size=list(mcfg.mask_cache_world_size),
               train_s=train_s, losses=losses,
               train_psnr=writer.values("train/psnr"),
               val_psnr=writer.values("val/psnr"),
               max_memory_allocated_bytes=peak)
    log(f"  trained {cfg.fine_train.N_iters} steps in {train_s:.1f} s (host "
        f"clock, eval render and saves included): world size "
        f"{mcfg.world_size}, mask {mcfg.mask_cache_world_size}; loss at "
        f"each print {['%.6g' % x for x in losses]}, psnr "
        f"{['%.2f' % x for x in rec['train_psnr']]}; val psnr "
        f"{rec['val_psnr']}; peak memory {peak / 2**30:.2f} GiB")
    if launches["i_val"] != 1:
        raise AssertionError(f"i_val: {launches['i_val']} sweep launches")
    if len(losses) != cfg.fine_train.N_iters // args.i_print \
            or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for k, v in checkpoints.tree_to_flat_dict(params).items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite parameter {k}")
    full = int(np.prod(mcfg.world_size))
    if not full > 0.9 * cfg.fine_model_and_render.num_voxels:
        raise AssertionError(f"the run ended at {mcfg.world_size}, not the "
                             "full voxel budget")

    # --- held-out views, and the same from the final checkpoint --------------
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "stepsize": 1.0}
    gt = [data["images"][i] for i in data["i_test"]]

    def render_test(p, b, c):
        return trainer.render_viewpoints(
            dmpigo, c, p, b, data["poses"][data["i_test"]],
            data["HW"][data["i_test"]], data["Ks"][data["i_test"]],
            data=trainer.DataFlags(ndc=True), render_kwargs=rk, gt_imgs=gt,
            eval_ssim=False, device=dev)

    cuda_sweep.sweep.launches = 0
    res = render_test(params, buffers, mcfg)
    sync()
    launches["i_test"] = cuda_sweep.sweep.launches
    last = os.path.join(basedir, "fern_pretrain", "fine_last.npz")
    del params, buffers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kw, p2, b2, opt, step, _ = checkpoints.load_checkpoint(last, device=dev)
    sync()
    load_s = time.perf_counter() - t0
    c2 = dmpigo.make_config(**kw)
    cuda_sweep.sweep.launches = 0
    res2 = render_test(p2, b2, c2)
    sync()
    launches["reloaded_i_test"] = cuda_sweep.sweep.launches
    rec.update(test_psnr=res["psnrs"], sweep_launches=launches)
    log(f"  held-out views: psnr {res['psnrs']}; sweep launches {launches}")
    if launches["i_test"] != 2 or launches["reloaded_i_test"] != 2:
        raise AssertionError(f"held-out renders: {launches}")
    if c2 != mcfg or step != cfg.fine_train.N_iters or opt is None \
            or not all(torch.equal(a, b) for a, b in
                       zip(res["rgbs"], res2["rgbs"])):
        raise AssertionError("the final checkpoint does not render the "
                             "held-out views as the trained model did")

    # --- timings at full width (after the run, nothing timed inside it) -----
    cfg_train = cfg.fine_train
    rk_train = {**rk, "rand_bkgd": True, "ndc_planes": True}
    flat, _ = trainer.gather_training_rays(cfg, cfg_train, data, dev)
    sample = trainer.make_batch_sampler("flatten", flat, cfg_train.N_rand,
                                        777)
    lrs = {k: optim.group_lr(v, 10, cfg_train.lrate_decay) for k, v in
           optim.build_group_lrs(cfg_train, p2).items()}
    skip = frozenset(cfg_train.skip_zero_grad_fields)
    n_rand = cfg_train.N_rand
    noise = trainer.bkgd_noise(777, 1, n_rand, dev)
    counter = [0]

    def batch():
        counter[0] += 1
        return trainer.gather_batch(flat, *sample(counter[0]))

    def step_ms(c, p, b, o, tv_dense=True):
        st = trainer.TrainStep(dmpigo, c, cfg_train, render_kwargs=rk_train,
                               skip_zero_grad=skip)
        return event_ms(lambda: st(p, b, o, batch(), lrs, None, noise,
                                   apply_tv=True, tv_dense=tv_dense))

    # the step at each grid size of the run (the trained grids resampled)
    sizes = [int(cfg.fine_model_and_render.num_voxels / 2 ** n)
             for n in range(len(cfg_train.pg_scale), -1, -1)]
    per_size = []
    for nv in sizes[:-1]:
        c = dmpigo.make_config(**{**kw, "num_voxels": nv})
        p = {**p2, **{k: grid_sample.resize_trilinear_chunked(
            p2[k], c.world_size).contiguous() for k in ("density", "k0")}}
        o = optim.init_state(p)
        per_size.append([list(c.world_size), step_ms(c, p, b2, o)])
        del p, o
        torch.cuda.empty_cache()
    full_dense = step_ms(c2, p2, b2, opt)
    full_sparse = step_ms(c2, p2, b2, opt, tv_dense=False)
    per_size.append([list(c2.world_size), full_dense])
    log("  step ms (CUDA events, median of 5) by world size: "
        + ", ".join(f"{tuple(ws)} {ms:.2f}" for ws, ms in per_size)
        + f"; full width with sparse TV {full_sparse:.2f}")

    # the full-width step's parts, each beside its byte bound
    st = trainer.TrainStep(dmpigo, c2, cfg_train, render_kwargs=rk_train,
                           skip_zero_grad=skip)
    bt = batch()
    _, _, grads = st.loss_and_grads(p2, b2, bt, lrs.keys(), noise)
    grid_update = check_grid_update(st, p2, opt, grads, lrs, n_rand)
    rec["grid_update"] = grid_update
    # each TV mode on its own copy of the gradients (dense TV fills in the
    # zeros that sparse TV and masked Adam skip); Adam on the sparse one,
    # as the step runs them
    g_dense = {k: grads[k].clone() for k in ("density", "k0")}
    split = {
        "gather": event_ms(batch),
        "fwd_bwd": event_ms(lambda: st.loss_and_grads(p2, b2, bt, lrs.keys(),
                                                      noise)),
        "tv_dense": event_ms(lambda: st.add_tv(p2, g_dense, n_rand, True)),
        "tv_sparse": event_ms(lambda: st.add_tv(p2, grads, n_rand, False)),
        "adam": event_ms(lambda: optim.apply_updates(
            p2, grads, opt, lrs, skip_zero_grad=skip)),
    }
    del g_dense
    grid_bytes = tree_bytes({k: p2[k] for k in ("density", "k0")})
    param_bytes = tree_bytes(p2)
    K = c2.n_samples(1.0)
    C = 1 + c2.k0_dim
    taps = n_rand * K * 4 * C * 4  # 4 bilinear corners a sample
    bound_bytes = {
        "gather": 2 * n_rand * 12 * 4 + n_rand * 8,
        # the taps read forward and scattered backward; the dense
        # gradients written once
        "fwd_bwd": 2 * taps + param_bytes,
        # the grid and its gradient read, the gradient written
        "tv_dense": 3 * grid_bytes,
        # the gradient read; the touched entries' grid read, gradient
        # written (check_grid_update)
        "tv_sparse": grid_update["bound_bytes"]["tv_sparse"],
        # the grids' masked update (check_grid_update); the rgbnet's p, g,
        # m, v read and p, m, v written: 28 B a float32 parameter
        "adam": grid_update["bound_bytes"]["adam"]
        + 7 * (param_bytes - grid_bytes),
    }
    bound_ms = {k: v / HBM_BYTES_PER_S * 1e3 for k, v in bound_bytes.items()}
    rec.update(step_ms_by_world_size=per_size, step_ms_full_sparse_tv=full_sparse,
               split_ms=split, split_bound_ms=bound_ms,
               split_bound_bytes=bound_bytes, params=param_bytes // 4)
    log(f"  full-width step split ({param_bytes // 4} parameters): "
        + ", ".join(f"{k} {v:.4g} ms (bound {bound_ms[k]:.4g})"
                    for k, v in split.items()))
    del grads
    prof = profile_call(lambda: st(p2, b2, opt, batch(), lrs, None, noise,
                                   apply_tv=True, tv_dense=True),
                        "training step", top=10)
    rec["profile"] = prof

    # --- the checkpoint's save and load --------------------------------------
    t0 = time.perf_counter()
    checkpoints.save_checkpoint(last, kw, p2, b2, opt, step)
    save_s = time.perf_counter() - t0
    rec["checkpoint"] = {"bytes": os.path.getsize(last), "save_s": save_s,
                         "load_s": load_s}
    log(f"  checkpoint {os.path.getsize(last) / 2**30:.2f} GiB: save "
        f"{save_s:.2f} s, load {load_s:.2f} s (host clock)")
    del p2, b2, opt, flat
    torch.cuda.empty_cache()

    # --- the tiny CPU-test scene on the card and on the CPU ------------------
    tiny = {}
    for name in ("cuda", "cpu"):
        tcfg = tiny_scene.apply_overrides(
            config_mod.load_config(os.path.join(HERE, cfg_path)), basedir,
            f"tiny_{name}")
        w = Recorder()
        targs = types.SimpleNamespace(seed=0, no_reload=True,
                                      no_reload_optimizer=False, ft_path="",
                                      i_print=1, i_val=0, i_weights=0)
        trainer.train(targs, tcfg, tiny_scene.scene(), writer=w,
                      device=torch.device(name))
        tiny[name] = np.array(w.values("train/loss"))
    rel = float(np.max(np.abs(tiny["cuda"] - tiny["cpu"]) / tiny["cpu"]))
    rec["tiny_loss_max_rel_diff"] = rel
    log(f"  tiny scene, {len(tiny['cpu'])} steps: per-step loss cuda vs cpu "
        f"max rel {rel:.3e} (limit {TINY_TOL:.0e})")
    if len(tiny["cpu"]) != 10 or not rel <= TINY_TOL:
        raise AssertionError("the tiny run differs between cuda and cpu")
    # phase 14 starts from the final checkpoint; the rest goes now
    for name in os.listdir(basedir):
        if name != "fern_pretrain":
            shutil.rmtree(os.path.join(basedir, name))
    for name in os.listdir(os.path.join(basedir, "fern_pretrain")):
        path = os.path.join(basedir, "fern_pretrain", name)
        if name != "fine_last.npz":
            (shutil.rmtree if os.path.isdir(path) else os.remove)(path)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 13: {rec['phase_s']:.1f} s")
    return rec, {"data": data, "basedir": basedir, "ckpt": last}


def flops_of(fn) -> int:
    """Floating-point operations of one call of ``fn`` as PyTorch's flop
    counter counts them (every convolution and matmul, forward and
    backward: two a multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


class SkippedWrites:
    """Stands in for ``imageio.v2`` in ``run_sr`` where imageio is not
    installed: each write is logged and skipped."""

    @staticmethod
    def mimwrite(path, frames, **kw):
        log(f"  video write skipped (no imageio): {os.path.basename(path)}, "
            f"{len(frames)} frames")

    @staticmethod
    def imwrite(path, img, **kw):
        log(f"  image write skipped (no imageio): {os.path.basename(path)}")


def serve_joint(dev, cfg_path, basedir, expname, last, data, *,
                render="sweep", frame_hw=(H * SCALE, W * SCALE)):
    """``run_sr --render_only --render_test --render_video --eval_lpips_vgg``
    from the joint file ``last``: the held-out views scored and one frame
    of ``frame_hw`` served (its video write logged and skipped where imageio
    is not installed); checks the launches (the ``render`` kernel, ``sweep``
    or ``box``, for each scored view and the frame, 15 dense-block launches)
    and holds the frame's decode, kernel chain vs plain chain, within
    ``SR_TOL``. Returns (``evaluate_sr``'s seconds, the serve record, the
    launches)."""
    import torch
    from fourk_nerf_torch import config as config_mod, run_sr
    from fourk_nerf_torch.ops import cuda_box, cuda_sr, cuda_sweep

    kernel = {"sweep": cuda_sweep.sweep, "box": cuda_box.sweep_box}[render]
    one = dict(data, render_poses=data["poses"][data["i_test"][:1]])
    rargs = run_sr.config_parser().parse_args(
        ["--config", os.path.join(HERE, cfg_path), "--render_only",
         "--render_test", "--render_video", "--eval_lpips_vgg", "--ft_path",
         last, "--device", dev.type])
    cfg_r = config_mod.load_config(os.path.join(HERE, cfg_path))
    cfg_r.basedir, cfg_r.expname = basedir, expname
    real_imageio = run_sr._imageio
    try:
        import imageio.v2  # noqa: F401
    except ImportError:
        run_sr._imageio = SkippedWrites
    kernel.launches = 0
    cuda_sr.rdb_apply.launches = 0
    try:
        res = run_sr.run(rargs, cfg_r, one)
    finally:
        run_sr._imageio = real_imageio
    sync()
    launches = {render: kernel.launches, "rdb": cuda_sr.rdb_apply.launches}
    video, test = res["video"], res["test"]
    enc_s = video["encoder"]["frame_times"][0]
    sr_s = video["sr_times"][0]
    log(f"  evaluate_sr of the {len(data['i_test'])} held-out views: seconds "
        f"{test['seconds']} (host clock)")
    serve = {"launches": launches, "encoder_s": enc_s, "decoder_s": sr_s,
             "frame_s": enc_s + sr_s, "psnr_sr_test": test["psnr_sr"],
             "ssim_sr_test": test["ssim_sr"], "psnr_lr_test": test["psnr_lr"],
             "encoder_path": video["encoder"]["path"]}
    log(f"  served {frame_hw[0]}x{frame_hw[1]} frame through the "
        f"{serve['encoder_path']} path (first call, host clock): encoder "
        f"{enc_s * 1e3:.1f} ms, decoder {sr_s * 1e3:.1f} ms, frame "
        f"{(enc_s + sr_s) * 1e3:.1f} ms; launches {launches}; "
        f"--render_test held-out views: PSNR_SR {test['psnr_sr']:.3f}, "
        f"SSIM {test['ssim_sr']:.4f}, LR PSNR {test['psnr_lr']}")
    n_test = len(data["i_test"])
    if launches != {render: 1 + n_test, "rdb": 15}:
        raise AssertionError(f"serving launches {launches}")
    frame = video["frames"][0]
    if tuple(frame.shape) != (*frame_hw, 3) \
            or not bool(torch.isfinite(frame).all()):
        raise AssertionError(f"the served frame {tuple(frame.shape)} is not "
                             f"a finite {frame_hw} frame")
    prep = cuda_sr.prepare_sftnet(res["model"][4])
    feat = video["encoder"]["rgb_features"][0][None]
    depth = video["encoder"]["depths"][0][None, ..., None]
    got = cuda_sr.sftnet_apply_cuda(prep, feat, depth, upchain="dilated")
    want = cuda_sr.sftnet_apply_plain(prep, feat, depth, upchain="dilated")
    sync()
    err = float((got - want).abs().max())
    serve["decode_vs_plain_max_abs"] = err
    log(f"  trained decoder, kernel chain vs plain chain: max abs {err:.3e} "
        f"(limit {SR_TOL})")
    if not err <= SR_TOL:
        raise AssertionError("the trained decoder's kernel chain disagrees "
                             "with its plain chain")
    seconds = test["seconds"]
    del res, video, test, prep, got, want
    torch.cuda.empty_cache()
    return seconds, serve, launches


def joint_step_setup(dev, cfg, data, mcfg, params, buffers, sr_model,
                     scale, *, perceptual=None, d_model=None):
    """The full-width joint step of a trained run, for timing: its
    ``SRTrainStep`` (with ``perceptual`` and ``d_model`` where given), the
    path it takes, a ``batch()`` drawing the sampler's patches in turn (the
    truth at ``scale`` from ``data["srgt"]``, the view's ``w2c``), the lrs at step 100 of the
    decay, new optimizer states and a background noise."""
    import types

    import torch
    from fourk_nerf_torch.models import dmpigo
    from fourk_nerf_torch.models.sr_unetdisc import disc_params
    from fourk_nerf_torch.ops import plane_sweep
    from fourk_nerf_torch.train import optim, sr_trainer, trainer

    ct = cfg.fine_train
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "rand_bkgd": True,
          "stepsize": 1.0, "ndc_planes": True}
    flat, _ = trainer.gather_training_rays(
        cfg, sr_trainer._force_image_sampler(ct), data, dev)
    a_all, b_all = (t.cpu().numpy() for t in plane_sweep.affine_coeffs(
        flat["rays_o"], flat["rays_d"],
        torch.tensor(mcfg.xyz_min, device=dev),
        torch.tensor(mcfg.xyz_max, device=dev),
        torch.tensor(mcfg.world_size[:2], dtype=torch.float32, device=dev),
        mcfg.world_size[2]))
    patch, V = int(ct.N_patch), flat["rgb"].shape[0]
    sampler = sr_trainer.make_patch_sampler(V, H, W, patch, 777)
    sp = sr_trainer.sweep_patch_size_for(mcfg, a_all, b_all, sampler.rows,
                                         sampler.cols, patch)
    gw = sr_trainer.sweep_window_size_for(mcfg, a_all, b_all, sampler.rows,
                                          sampler.cols, patch, sp)
    hr_all = torch.as_tensor(np.ascontiguousarray(np.moveaxis(
        data["srgt"][data["i_train"]], 1, -1)), device=dev)
    w2c_all = torch.as_tensor(np.asarray(data["w2c"])[data["i_train"]],
                              dtype=torch.float32, device=dev)
    skip = frozenset(ct.skip_zero_grad_fields)
    st = sr_trainer.SRTrainStep(
        dmpigo, mcfg, ct, cfg.fine_model_and_render, render_kwargs=rk,
        skip_zero_grad=skip, sr_model=sr_model, n_views=V, patch=patch,
        sr_ratio=scale, sweep_patch=sp, grid_window=gw,
        perceptual=perceptual, d_model=d_model)
    path = st.path(params, buffers, apply_tv=False)
    mode = "CHANNEL" if tuple(buffers["mask_cache"].shape) == tuple(
        mcfg.world_size) else "NATIVE"
    log(f"  the step renders through the {path} path, mask in {mode} mode "
        f"({tuple(buffers['mask_cache'].shape)} on a {mcfg.world_size} "
        f"grid), slice {sp}, grid window {gw}")
    counter = [0]

    def batch():
        counter[0] += 1
        v, r, c = sampler(counter[0])

        def sl(t):
            return t[v, r:r + patch, c:c + patch].reshape(-1, 3)
        return (sl(flat["rays_o"]), sl(flat["rays_d"]), sl(flat["viewdirs"]),
                sl(flat["rgb"]), hr_all[v, r * scale:(r + patch) * scale,
                                        c * scale:(c + patch) * scale]
                .reshape(-1, 3), w2c_all[v])

    lr_sr = optim.group_lr(ct.lrate_srnet, 100, ct.lrate_decay)
    lrs = {"enc": {k: optim.group_lr(v, 100, ct.lrate_decay) for k, v in
                   optim.build_group_lrs(ct, params).items()},
           "srnet": lr_sr, "d": lr_sr}
    return types.SimpleNamespace(
        st=st, path=path, mode=mode, sp=sp, gw=gw, batch=batch, lrs=lrs,
        skip=skip, patch=patch, enc_opt=optim.init_state(params),
        sr_opt=optim.init_state({"srnet": st.sr_params}),
        d_opt=optim.init_state({"d": disc_params(d_model)})
        if d_model is not None else None,
        noise=trainer.bkgd_noise(777, 1, patch * patch, dev))


def run_joint(dev, pre):
    """Phase 14 (see the module docstring). ``pre``: phase 13's scene and
    final checkpoint. Returns the ``joint`` record and the launch counts of
    the path."""
    import shutil
    import types

    import torch
    from fourk_nerf_torch import config as config_mod
    from fourk_nerf_torch.models import dmpigo
    from fourk_nerf_torch.ops import cuda_sweep, plane_sweep
    from fourk_nerf_torch.train import checkpoints, optim, sr_trainer, trainer

    t_phase = time.perf_counter()
    data, pre_ckpt = pre["data"], pre["ckpt"]
    basedir = os.path.join(HERE, "build", "phase14_joint")
    shutil.rmtree(basedir, ignore_errors=True)
    cfg_path = os.path.join("fourk_nerf_torch", "configs", "llff",
                            "fern_lg_joint_l1.py")
    rec: dict = {"config": cfg_path, "ftdv_path": os.path.relpath(pre_ckpt,
                                                                   HERE)}
    launches: dict = {}

    # --- scored renders with a mask of another resolution (Queue C 1) --------
    kw, p0, b0, _, start, _ = checkpoints.load_checkpoint(pre_ckpt,
                                                          device=dev)
    c0 = dmpigo.make_config(**kw)
    rec["mask"] = [list(c0.world_size), list(b0["mask_cache"].shape)]
    packed = cuda_sweep.pack_grids_kernel(p0, b0, use_bf16=False)
    kern, nat, t_kern, t_nat = [], [], [], []
    for i in data["i_test"]:
        K = np.asarray(data["Ks"][i], np.float32)
        c2w = np.asarray(data["poses"][i], np.float32)
        t0 = time.perf_counter()
        kern.append(cuda_sweep.render_frame_cuda(
            c0, p0, b0, H, W, K, c2w, stepsize=1.0, bg=0.0, device=dev,
            packed=packed)["rgb_marched"])
        sync()
        t1 = time.perf_counter()
        nat.append(plane_sweep.render_frame_native(
            c0, p0, b0, H, W, K, c2w, stepsize=1.0, bg=0.0,
            device=dev)["rgb_marched"])
        sync()
        t_kern.append((t1 - t0) * 1e3)
        t_nat.append((time.perf_counter() - t1) * 1e3)
    gts = [data["images"][i] for i in data["i_test"]]
    diff = max(float((a - b).abs().max()) for a, b in zip(kern, nat))
    n_px = sum(int(((a - b).abs() > 2e-4).any(-1).sum())
               for a, b in zip(kern, nat))
    from fourk_nerf_torch.utils import metrics
    psnr_k = float(np.mean([metrics.psnr(a.cpu().numpy(), g)
                            for a, g in zip(kern, gts)]))
    psnr_n = float(np.mean([metrics.psnr(a.cpu().numpy(), g)
                            for a, g in zip(nat, gts)]))
    rec["scored_mask"] = {"max_abs_diff": diff, "pixels_over_2e-4": n_px,
                          "psnr_resampled": psnr_k, "psnr_native": psnr_n,
                          "ms_kernel": t_kern, "ms_native": t_nat}
    log(f"  scored held-out views, grid {c0.world_size}, mask "
        f"{tuple(b0['mask_cache'].shape)}: the float32 sweep kernel on the "
        f"resampled mask vs the native lookup: max abs {diff:.3e}, "
        f"{n_px} pixels over 2e-4; psnr {psnr_k:.4f} vs {psnr_n:.4f} dB; "
        f"ms per view (host clock) kernel {[round(t, 1) for t in t_kern]}, "
        f"native {[round(t, 1) for t in t_nat]}")
    if n_px > 0 or abs(psnr_k - psnr_n) > 0.01:
        raise AssertionError("the scored render on the resampled mask "
                             "disagrees with the native lookup (limits: no "
                             "pixel over 2e-4, PSNR within 0.01 dB)")
    del p0, b0, packed, kern, nat
    torch.cuda.empty_cache()

    # --- the joint run -------------------------------------------------------
    cfg = config_mod.load_config(os.path.join(HERE, cfg_path))
    cfg.basedir, cfg.expname = basedir, "fern_joint"
    for k, v in JOINT_OVERRIDES["fine_train"].items():
        cfg.fine_train[k] = v
    cfg.fine_train.N_iters = start + JOINT_STEPS
    args = types.SimpleNamespace(
        seed=777, no_reload=False, no_reload_optimizer=False, ft_path="",
        ftdv_path=pre_ckpt, ftsr_path="", test_tile=0,
        **JOINT_OVERRIDES["args"])
    writer = Recorder()
    torch.cuda.reset_peak_memory_stats()
    cuda_sweep.sweep.launches = 0
    t0 = time.perf_counter()
    _, mcfg, params, buffers, sr_model = sr_trainer.train_sr(
        args, cfg, data, writer=writer, device=dev)
    sync()
    train_s = time.perf_counter() - t0
    launches["i_val"] = cuda_sweep.sweep.launches
    peak = torch.cuda.max_memory_allocated()
    l1 = writer.values("train/loss_l1")
    rec.update(start=start, steps=JOINT_STEPS, train_s=train_s,
               loss_l1=l1, loss_photo=writer.values("train/loss_photo"),
               psnr_sr=writer.values("train/psnr_sr"),
               val_psnr_sr=writer.values("val/psnr_sr"),
               val_lpips_proxy=writer.values("val/lpips_sr_proxy"),
               max_memory_allocated_bytes=peak)
    log(f"  joint steps {start + 1}..{start + JOINT_STEPS} in {train_s:.1f} s "
        f"(host clock, eval and saves included); loss_l1 at each print "
        f"{['%.6g' % x for x in l1]}, loss_photo "
        f"{['%.6g' % x for x in rec['loss_photo']]}, psnr_sr "
        f"{['%.2f' % x for x in rec['psnr_sr']]}; val psnr_sr "
        f"{rec['val_psnr_sr']}, lpips proxy {rec['val_lpips_proxy']}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    if len(l1) != JOINT_STEPS // args.i_print or not all(np.isfinite(l1)) \
            or not l1[-1] < l1[0]:
        raise AssertionError(f"the SR L1 did not fall: {l1}")
    for k, v in checkpoints.tree_to_flat_dict(params).items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite parameter {k}")

    # --- the joint checkpoint's load, then serve the trained decoder through
    # run_sr --render_only --render_test --render_video ---------------------
    last = os.path.join(basedir, "fern_joint", "fine_last.npz")
    t0 = time.perf_counter()
    loaded = sr_trainer.load_joint(last, True, device=dev)
    sync()
    load_s = time.perf_counter() - t0
    rec["checkpoint"] = {"bytes": os.path.getsize(last), "load_s": load_s}
    del loaded
    torch.cuda.empty_cache()
    rec["evaluate_sr_s"], rec["serve"], launches["serve"] = serve_joint(
        dev, cfg_path, basedir, "fern_joint", last, data)
    # --- the full-width joint step, by parts (after the run) -----------------
    js = joint_step_setup(dev, cfg, data, mcfg, params, buffers, sr_model,
                          SCALE)
    st, batch, lrs, skip, patch = js.st, js.batch, js.lrs, js.skip, js.patch
    enc_opt, sr_opt, noise = js.enc_opt, js.sr_opt, js.noise
    path, mode = js.path, js.mode
    rec["step_path"] = {"path": path, "mask_mode": mode, "slice": js.sp,
                        "grid_window": js.gw}
    if (path, mode) != ("sweep", "NATIVE"):
        raise AssertionError("the fern joint step should take the full-grid "
                             "sweep with the NATIVE mask")
    bt = batch()
    full = event_ms(lambda: st(params, buffers, enc_opt, sr_opt, batch(),
                               lrs, noise, apply_tv=False, tv_dense=False))
    *_, eg, sg, win, _ = st.loss_and_grads(params, buffers, bt,
                                           lrs["enc"].keys(), noise)
    live = {k: trainer._detached_leaves(params[k]) for k in lrs["enc"]}

    def sweep_fb():
        out = st.render({**params, **live}, buffers, *bt[:3], path="sweep",
                        bg_noise=noise)
        leaves = trainer._flatten(live, [])
        torch.autograd.grad((out["rgb_feature"].sum() + out["weights"].sum()
                             + out["raw_rgb"].sum()), leaves,
                            allow_unused=True)

    out = st.render(params, buffers, *bt[:3], path="sweep")
    x = out["rgb_feature"].detach().reshape(1, patch, patch, 3)
    cond = out["depth"].detach().reshape(1, patch, patch, 1)
    hr = bt[4].reshape(1, patch * SCALE, patch * SCALE, 3)
    sr_leaves = trainer._flatten(st.sr_params, [])

    def sft_fb():
        loss = (sr_model(x, cond) - hr).abs().mean()
        torch.autograd.grad(loss, sr_leaves)

    from fourk_nerf_torch.device import fp32_precision
    with fp32_precision():
        split = {
            "gather": event_ms(batch),
            "fwd_bwd": event_ms(lambda: st.loss_and_grads(
                params, buffers, bt, lrs["enc"].keys(), noise)),
            "sweep_fwd_bwd": event_ms(sweep_fb),
            "sftnet_fwd_bwd": event_ms(sft_fb),
            "enc_adam": event_ms(lambda: optim.apply_updates(
                params, eg, enc_opt, lrs["enc"], skip_zero_grad=skip)),
            "sr_adam": event_ms(lambda: optim.apply_updates(
                {"srnet": st.sr_params}, {"srnet": sg}, sr_opt,
                {"srnet": lrs["srnet"]})),
        }
        sft_flops = flops_of(sft_fb)
    R, Z = patch * patch, mcfg.world_size[2]
    C = 1 + mcfg.k0_dim
    param_bytes = tree_bytes(params)
    sr_bytes = tree_bytes(st.sr_params)
    taps = R * Z * 4 * C * 4
    bound_bytes = {
        "gather": 2 * (R * 4 * 12 + R * SCALE * SCALE * 12),
        "sweep_fwd_bwd": 2 * taps + param_bytes,
        "enc_adam": 7 * param_bytes, "sr_adam": 7 * sr_bytes}
    bound_ms = {k: v / HBM_BYTES_PER_S * 1e3 for k, v in bound_bytes.items()}
    # the generator's forward and backward as timed (the weight gradients
    # and the input gradients they need), float32, at the FP32 peak
    bound_ms["sftnet_fwd_bwd"] = sft_flops / FP32_FLOPS * 1e3
    bound_ms["fwd_bwd"] = bound_ms["sweep_fwd_bwd"] \
        + bound_ms["sftnet_fwd_bwd"]
    rec.update(step_ms=full, split_ms=split, split_bound_ms=bound_ms,
               split_bound_bytes=bound_bytes, sftnet_fwd_bwd_flops=sft_flops,
               params=param_bytes // 4, sr_params=sr_bytes // 4)
    log(f"  full-width joint step {full:.2f} ms (CUDA events, median of 5); "
        f"parts ({param_bytes // 4} encoder, {sr_bytes // 4} generator "
        "parameters): " + ", ".join(
            f"{k} {v:.4g} ms (bound {bound_ms[k]:.4g})"
            for k, v in split.items())
        + f"; bounds: bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, the "
        f"SFTNet's {sft_flops / 1e9:.1f} GFLOP float32 at the FP32 peak "
        f"{FP32_FLOPS / 1e12:.0f} TFLOP/s")
    rec["profile"] = profile_call(
        lambda: st(params, buffers, enc_opt, sr_opt, batch(), lrs, noise,
                   apply_tv=False, tv_dense=False), "joint step", top=10)
    del eg, sg, live, js
    torch.cuda.empty_cache()

    # --- the joint checkpoint's save (params and both optimizers) -----------
    path = os.path.join(basedir, "fern_joint", "timed_save.npz")
    t0 = time.perf_counter()
    sr_trainer.save_joint(path, dmpigo, mcfg, params, buffers, sr_model,
                          start + JOINT_STEPS,
                          opt_states={"enc": enc_opt, "sr": sr_opt})
    rec["checkpoint"]["save_s"] = save_s = time.perf_counter() - t0
    log(f"  joint checkpoint {os.path.getsize(last) / 2**30:.2f} GiB (params "
        f"and both optimizers): save {save_s:.2f} s, load {load_s:.2f} s "
        "(host clock)")
    del params, buffers, enc_opt, sr_opt, sr_model
    torch.cuda.empty_cache()
    shutil.rmtree(basedir)  # phase 15 starts from phase 13's checkpoint
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 14: {rec['phase_s']:.1f} s")
    return rec, launches


def run_joint_gan(dev, pre):
    """Phase 15 (see the module docstring). ``pre``: phase 13's scene and
    final checkpoint, deleted at the end. Returns the ``joint_gan`` record
    and the launch counts of the path."""
    import copy
    import shutil
    import types

    import torch
    from fourk_nerf_torch import config as config_mod, weights
    from fourk_nerf_torch.device import fp32_precision
    from fourk_nerf_torch.models import sr_unetdisc
    from fourk_nerf_torch.ops import cuda_sweep
    from fourk_nerf_torch.train import checkpoints, optim, sr_losses, \
        sr_trainer, trainer

    t_phase = time.perf_counter()
    data, pre_ckpt = pre["data"], pre["ckpt"]
    basedir = os.path.join(HERE, "build", "phase15_gan")
    shutil.rmtree(basedir, ignore_errors=True)
    cfg_path = os.path.join("fourk_nerf_torch", "configs", "llff",
                            "fern_lg_joint_l1_gan.py")
    with np.load(pre_ckpt) as z:
        start = int(json.loads(bytes(z["__meta__"]).decode())["global_step"])
    rec: dict = {"config": cfg_path,
                 "ftdv_path": os.path.relpath(pre_ckpt, HERE),
                 "deviation": "fine_train.allow_random_vgg=True: the "
                 "perceptual and style terms on the fixed-seed random VGG19 "
                 "tower (no pretrained weights here)"}
    launches: dict = {}

    def train(path, expname, steps, dataset):
        cfg = config_mod.load_config(os.path.join(HERE, path))
        cfg.basedir, cfg.expname = basedir, expname
        for k, v in GAN_OVERRIDES["fine_train"].items():
            cfg.fine_train[k] = v
        cfg.fine_train.N_iters = start + steps
        args = types.SimpleNamespace(
            seed=777, no_reload=False, no_reload_optimizer=False, ft_path="",
            ftdv_path=pre_ckpt, ftsr_path="", test_tile=0,
            **GAN_OVERRIDES["args"])
        writer = Recorder()
        t0 = time.perf_counter()
        model = sr_trainer.train_sr(args, cfg, dataset, writer=writer,
                                    device=dev)
        sync()
        return cfg, args, model, writer, time.perf_counter() - t0

    log(f"  deviation from the published objective: {rec['deviation']}")
    torch.cuda.reset_peak_memory_stats()
    cuda_sweep.sweep.launches = 0
    cfg, args, (_, mcfg, params, buffers, sr_model), writer, train_s = train(
        cfg_path, "fern_gan", GAN_STEPS, data)
    launches["i_val"] = cuda_sweep.sweep.launches
    peak = torch.cuda.max_memory_allocated()
    vals = {k: writer.values(f"train/{k}") for k in (
        "loss_l1", "loss_photo", "loss_pcp", "loss_style", "loss_g",
        "loss_d_real", "loss_d_fake", "psnr_sr")}
    vals.update(val_psnr_sr=writer.values("val/psnr_sr"),
                val_lpips_proxy=writer.values("val/lpips_sr_proxy"))
    rec.update(start=start, steps=GAN_STEPS, train_s=train_s,
               max_memory_allocated_bytes=peak, **vals)
    log(f"  GAN joint steps {start + 1}..{start + GAN_STEPS} in "
        f"{train_s:.1f} s (host clock, eval and saves included); at each "
        "print " + "; ".join(f"{k} {['%.6g' % x for x in v]}"
                             for k, v in vals.items())
        + f"; peak memory {peak / 2**30:.2f} GiB")
    l1 = vals["loss_l1"]
    if len(l1) != GAN_STEPS // args.i_print or not all(np.isfinite(l1)) \
            or not l1[-1] < l1[0]:
        raise AssertionError(f"the SR L1 did not fall: {l1}")
    for k in ("loss_d_real", "loss_d_fake", "loss_g", "loss_pcp",
              "loss_style"):
        if len(vals[k]) != len(l1) or not all(np.isfinite(vals[k])):
            raise AssertionError(f"{k} is not finite at every print: "
                                 f"{vals[k]}")

    # --- the final joint file: the discriminator, its vectors and Adam ------
    last = os.path.join(basedir, "fern_gan", "fine_last.npz")
    with np.load(last) as z:
        names = set(z.files)
    for prefix in ("params/__disc__/", "params/__disc_state__/",
                   "opt/d/exp_avg/", "opt/d/exp_avg_sq/"):
        if not any(k.startswith(prefix) for k in names):
            raise AssertionError(f"the final joint file lacks {prefix}")
    if "opt/d/step" not in names:
        raise AssertionError("the final joint file lacks opt/d/step")
    t0 = time.perf_counter()
    *_, d_params, d_state, opt, step, _ = sr_trainer.load_joint(
        last, True, device=dev)
    sync()
    rec["checkpoint"] = {"bytes": os.path.getsize(last),
                         "load_s": time.perf_counter() - t0}
    d_model = weights.disc_from_flax(d_params, d_state, device=dev)
    p_np, s_np = weights.disc_to_flax(d_model)
    with np.load(last) as z:
        for tree, head in ((p_np, "__disc__"), (s_np, "__disc_state__")):
            for k, v in checkpoints.tree_to_flat_dict(tree).items():
                if not np.array_equal(v, z[f"params/{head}/{k}"]):
                    raise AssertionError(f"load_joint round trip: {head}/{k}")
    if step != start + GAN_STEPS or opt["d"]["step"] != GAN_STEPS:
        raise AssertionError(f"the file's steps: {step}, d {opt['d']['step']}")
    d0 = sr_trainer.build_discriminator(cfg.fine_model_and_render,
                                        int(cfg.fine_train.N_patch) * SCALE,
                                        args.seed, dev)
    moved = {k: float((u - u0).norm()) for (k, u), u0 in zip(
        checkpoints.tree_to_flat_dict(
            sr_unetdisc.disc_spectral(d_model)).items(),
        checkpoints.tree_to_flat_dict(
            sr_unetdisc.disc_spectral(d0)).values())}
    rec["u_moved"] = moved
    log(f"  final joint file {os.path.getsize(last) / 2**30:.2f} GiB: "
        f"__disc__, __disc_state__ and opt/d (step {opt['d']['step']}) "
        "round-trip through load_joint; |u - u_init| by conv: "
        + ", ".join(f"{k.split('/')[0]} {v:.3g}" for k, v in moved.items()))
    if len(moved) != 8 or not all(v > 1e-6 for v in moved.values()):
        raise AssertionError(f"a spectral-norm vector did not move: {moved}")
    del d0, opt, d_params, d_state
    rec["evaluate_sr_s"], rec["serve"], launches["serve"] = serve_joint(
        dev, cfg_path, basedir, "fern_gan", last, data)

    # --- the full-width GAN step, by parts (after the run) -------------------
    perceptual = sr_trainer.build_perceptual(cfg.fine_train, device=dev)
    js = joint_step_setup(dev, cfg, data, mcfg, params, buffers, sr_model,
                          SCALE, perceptual=perceptual, d_model=d_model)
    st, lrs, noise, patch = js.st, js.lrs, js.noise, js.patch
    if js.path != "sweep":
        raise AssertionError("the fern GAN step should take the full-grid "
                             "sweep, as phase 14's")
    bt = js.batch()

    def full_step():
        st(params, buffers, js.enc_opt, js.sr_opt, js.batch(), lrs, noise,
           apply_tv=False, tv_dense=False, d_opt=js.d_opt)

    full = event_ms(full_step)
    # the same step without the GAN and perceptual terms (the L1 step) on
    # the same state, timed in turn with the GAN step: the two whole
    # steps' difference within pairs, each step one call
    cfg_l1 = copy.deepcopy(cfg)
    cfg_l1.fine_train.weight_gan = 0.0
    js_l1 = joint_step_setup(dev, cfg_l1, data, mcfg, params, buffers,
                             sr_model, SCALE)

    def l1_step():
        js_l1.st(params, buffers, js_l1.enc_opt, js_l1.sr_opt,
                 js_l1.batch(), js_l1.lrs, js_l1.noise, apply_tv=False,
                 tv_dense=False)

    l1_step()
    pairs = [[event_ms(l1_step, 1), event_ms(full_step, 1)]
             for _ in range(ALTERNATE_PAIRS)]
    del js_l1
    diff = [g - l for l, g in pairs]
    rec["alternate"] = {"l1_gan_ms": pairs, "gan_minus_l1_ms": diff,
                        "median_gan_minus_l1_ms": statistics.median(diff)}
    log(f"  L1 and GAN steps in turn ({ALTERNATE_PAIRS} pairs, each step "
        "timed after a warm-up call of its own): " + ", ".join(
            f"{l:.2f}/{g:.2f}" for l, g in pairs)
        + f" ms; GAN - L1 median {statistics.median(diff):.2f} ms")
    *_, eg, sg, win, (rgb_sr, rgb_hr) = st.loss_and_grads(
        params, buffers, bt, lrs["enc"].keys(), noise)
    _, _, dg = st.d_loss_and_grads(rgb_sr, rgb_hr, st.d_condition(bt))
    live = {k: trainer._detached_leaves(params[k]) for k in lrs["enc"]}

    def render_fb():
        out = st.render({**params, **live}, buffers, *bt[:3], path="sweep",
                        bg_noise=noise)
        torch.autograd.grad((out["rgb_feature"].sum() + out["weights"].sum()
                             + out["raw_rgb"].sum()),
                            trainer._flatten(live, []), allow_unused=True)

    out = st.render(params, buffers, *bt[:3], path="sweep")
    x = out["rgb_feature"].detach().reshape(1, patch, patch, 3)
    cond = out["depth"].detach().reshape(1, patch, patch, 1)
    sr_leaves = trainer._flatten(st.sr_params, [])
    sr_in = rgb_sr.clone().requires_grad_(True)

    def sft_fb():
        loss = (sr_model(x, cond) - rgb_hr).abs().mean()
        torch.autograd.grad(loss, sr_leaves)

    def vgg_fb():
        pcp, style = perceptual(sr_in, rgb_hr)
        torch.autograd.grad(pcp + style, sr_in)

    cond_d = st.d_condition(bt)

    def gside_fb():
        # a non-leaf module input: the flop counter's module hooks refuse a
        # leaf one under autograd.grad
        fake = sr_unetdisc.apply(d_model, sr_in + 0.0, cond_d, False)
        torch.autograd.grad(sr_losses.gan_loss(
            fake, True, is_disc=False, loss_weight=cfg.fine_train.weight_gan),
            sr_in)

    def dstep_fb():
        st.d_loss_and_grads(rgb_sr, rgb_hr, cond_d)

    adams = {
        "enc_adam": lambda: optim.apply_updates(
            params, eg, js.enc_opt, lrs["enc"], skip_zero_grad=js.skip),
        "sr_adam": lambda: optim.apply_updates(
            {"srnet": st.sr_params}, {"srnet": sg}, js.sr_opt,
            {"srnet": lrs["srnet"]}),
        "d_adam": lambda: optim.apply_updates(
            {"d": st.d_params}, {"d": dg}, js.d_opt, {"d": lrs["d"]})}
    parts = {"patch_render_fwd_bwd": render_fb, "sftnet_fwd_bwd": sft_fb,
             "vgg_pcp_style_fwd_bwd": vgg_fb, "g_side_d_fwd_bwd": gside_fb,
             "d_step_fwd_bwd": dstep_fb}
    with fp32_precision():
        split = {k: event_ms(fn) for k, fn in parts.items()}
        split.update({k: event_ms(fn) for k, fn in adams.items()})
        flops = {k: flops_of(fn) for k, fn in parts.items()
                 if k != "patch_render_fwd_bwd"}
    split["three_adams"] = sum(split[k] for k in adams)
    R, Z = patch * patch, mcfg.world_size[2]
    param_bytes = tree_bytes(params)
    sr_bytes, d_bytes = tree_bytes(st.sr_params), tree_bytes(st.d_params)
    bound_bytes = {"patch_render_fwd_bwd": 2 * R * Z * 4 * (1 + mcfg.k0_dim)
                   * 4 + param_bytes, "enc_adam": 7 * param_bytes,
                   "sr_adam": 7 * sr_bytes, "d_adam": 7 * d_bytes}
    bound_ms = {k: v / HBM_BYTES_PER_S * 1e3 for k, v in bound_bytes.items()}
    bound_ms.update({k: v / FP32_FLOPS * 1e3 for k, v in flops.items()})
    bound_ms["three_adams"] = sum(bound_ms[k] for k in adams)
    bound_ms["step"] = sum(bound_ms[k] for k in parts) \
        + bound_ms["three_adams"]
    rec.update(step_ms=full, split_ms=split, split_bound_ms=bound_ms,
               split_bound_bytes=bound_bytes, split_flops=flops,
               step_path={"path": js.path, "mask_mode": js.mode,
                          "slice": js.sp, "grid_window": js.gw},
               params=param_bytes // 4, sr_params=sr_bytes // 4,
               d_params=d_bytes // 4)
    log(f"  full-width GAN step {full:.2f} ms (CUDA events, median of 5; "
        f"bound {bound_ms['step']:.3g} ms); parts ({param_bytes // 4} "
        f"encoder, {sr_bytes // 4} generator, {d_bytes // 4} discriminator "
        "parameters): " + ", ".join(
            f"{k} {v:.4g} ms (bound {bound_ms[k]:.4g}"
            + (f", {flops[k] / 1e9:.1f} GFLOP" if k in flops else "") + ")"
            for k, v in split.items())
        + f"; bounds: bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, float32 "
        f"operations (torch's flop counter) at {FP32_FLOPS / 1e12:.0f} "
        "TFLOP/s")
    rec["profile"] = profile_call(full_step, "GAN step", top=10)
    del eg, sg, dg, live, js, st, out, x, cond, sr_in, rgb_sr, rgb_hr
    del params, buffers, sr_model, d_model, perceptual
    torch.cuda.empty_cache()

    # --- the scale-1 config: the decoder at LR resolution, D on 64x64 -------
    cfg1_path = os.path.join("fourk_nerf_torch", "configs", "llff",
                             "fern_lg_joint_1x_l1_gan.py")
    data1 = dict(data, srgt=np.ascontiguousarray(np.moveaxis(
        np.asarray(data["images"]), -1, 1)))
    cfg1, _, (_, mcfg1, p1, b1, sr1), w1, train1_s = train(
        cfg1_path, "fern_gan_1x", GAN_1X_STEPS, data1)
    losses1 = {k: w1.values(f"train/{k}") for k in (
        "loss_l1", "loss_pcp", "loss_g", "loss_d_real", "loss_d_fake")}
    if sr1.scale != 1 or not all(v and all(np.isfinite(v))
                                 for v in losses1.values()):
        raise AssertionError(f"the scale-1 GAN run: x{sr1.scale}, "
                             f"{losses1}")
    last1 = os.path.join(basedir, "fern_gan_1x", "fine_last.npz")
    *_, d1p, d1s, _, _, _ = sr_trainer.load_joint(last1, True, device=dev)
    d1 = weights.disc_from_flax(d1p, d1s, device=dev)
    js1 = joint_step_setup(dev, cfg1, data1, mcfg1, p1, b1, sr1, 1,
                           perceptual=sr_trainer.build_perceptual(
                               cfg1.fine_train, device=dev), d_model=d1)
    step1 = event_ms(lambda: js1.st(
        p1, b1, js1.enc_opt, js1.sr_opt, js1.batch(), js1.lrs, js1.noise,
        apply_tv=False, tv_dense=False, d_opt=js1.d_opt))
    rec["scale1"] = {"config": cfg1_path, "steps": GAN_1X_STEPS,
                     "train_s": train1_s, "step_ms": step1, **losses1}
    log(f"  scale-1 GAN config, {GAN_1X_STEPS} steps in {train1_s:.1f} s "
        f"(host clock): step {step1:.2f} ms (CUDA events, median of 5), "
        "losses at the print " + ", ".join(
            f"{k} {['%.6g' % x for x in v]}" for k, v in losses1.items()))
    del p1, b1, sr1, d1, js1, d1p, d1s
    torch.cuda.empty_cache()
    shutil.rmtree(basedir)
    shutil.rmtree(pre["basedir"])
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 15: {rec['phase_s']:.1f} s")
    return rec, launches


def bounded_views(dev):
    """The scene of phase 16: phase 8's bounded scene (``box_synthetic``)
    rendered on white through ``render_viewpoints`` (the box kernel, bf16
    path) from ``BOUNDED_VIEWS`` poses of the Blender sphere
    (``tiny_scene.bounded_poses``) at the Blender field of view, as the
    Blender loader's ``data_dict``: the first 20 views train, then 2 val,
    then 2 test; ``srgt`` the images (the 1x chair config's truth)."""
    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import trainer
    hw, n = BOUNDED_HW, BOUNDED_VIEWS
    cfg, params, buffers = box_synthetic(dev, G=BOUNDED_TEACHER_G)
    f = tiny_scene.blender_focal(hw)
    K = np.array([[f, 0, 0.5 * hw], [0, f, 0.5 * hw], [0, 0, 1]])
    poses = tiny_scene.bounded_poses(n)
    res = trainer.render_viewpoints(
        dvgo, cfg, params, buffers, poses, np.array([[hw, hw]] * n),
        np.stack([K] * n), data=trainer.DataFlags(),
        render_kwargs={**BOX_RENDER}, verbose=False, device=dev)
    images = res["rgbs"].float().clamp(0, 1).cpu().numpy()
    i_split = np.split(np.arange(n), [n - 4, n - 2])
    return dict(hwf=[hw, hw, f], HW=np.array([[hw, hw]] * n),
                Ks=np.stack([K] * n), near=2.0, far=6.0, near_clip=None,
                i_train=i_split[0], i_val=i_split[1], i_test=i_split[2],
                poses=poses, render_poses=poses[i_split[2][:1]],
                images=images, irregular_shape=False, srgt=images, w2c=0)


def valid_samples(mcfg, buffers, rays_o, rays_d, stepsize, near):
    """The samples of the rays that the gather forward reads voxels for:
    inside the box, within the ray's own count and in the mask."""
    import torch
    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.ops import grid_sample
    n = 0
    for s in range(0, rays_o.shape[0], 4096):
        pts, valid, _ = dvgo.sample_ray(mcfg, rays_o[s:s + 4096],
                                        rays_d[s:s + 4096], near=near,
                                        far=1e9, stepsize=stepsize)
        mn = torch.tensor(mcfg.xyz_min, device=pts.device)
        mx = torch.tensor(mcfg.xyz_max, device=pts.device)
        n += int((valid & grid_sample.nearest_mask_lookup(
            buffers["mask_cache"], pts, mn, mx)).sum())
    return n


def bounded_step_parts(dev, cfg_train, mcfg, params, buffers, batch,
                       per_lr, rk):
    """A bounded training step at full width split into the gather
    forward + backward and MaskedAdam, each by CUDA events (median of 5)
    beside its bound, the larger of its bytes and its FP32 operations.
    Bytes: the voxels of this batch's valid samples read (8 corners,
    density and k0) forward and scattered backward, the dense gradients
    written; Adam reading p, g, m, v and writing p, m, v. Operations: the
    rgbnet on the valid samples, forward and backward (6 a multiply-add:
    the product, its input gradient, its weight gradient)."""
    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.train import optim, trainer
    lrs = {k: optim.group_lr(v, 10, cfg_train.lrate_decay) for k, v in
           optim.build_group_lrs(cfg_train, params).items()}
    skip = frozenset(cfg_train.skip_zero_grad_fields)
    st = trainer.TrainStep(dvgo, mcfg, cfg_train, render_kwargs=rk,
                           skip_zero_grad=skip)
    opt = optim.init_state(params)

    def step():
        st(params, buffers, opt, batch, lrs, per_lr, None, apply_tv=False,
           tv_dense=False)

    full = event_ms(step)
    _, _, grads = st.loss_and_grads(params, buffers, batch, lrs.keys())
    split = {"fwd_bwd": event_ms(lambda: st.loss_and_grads(
                 params, buffers, batch, lrs.keys())),
             "adam": event_ms(lambda: optim.apply_updates(
                 params, grads, opt, lrs, skip_zero_grad=skip,
                 per_lr=per_lr))}
    n_valid = valid_samples(mcfg, buffers, batch[0], batch[1],
                            rk["stepsize"], rk["near"])
    param_bytes = tree_bytes(params)
    bound_bytes = {"fwd_bwd": 2 * n_valid * 8 * (1 + mcfg.k0_dim) * 4
                   + param_bytes, "adam": 7 * param_bytes}
    rgbnet_macs = sum(w.shape[0] * w.shape[1] for k, w in
                      params.get("rgbnet", {}).items() if k.startswith("w"))
    bound_flops = {"fwd_bwd": 6 * rgbnet_macs * n_valid, "adam": 0}
    bound_by = {k: "bytes" if bound_bytes[k] / HBM_BYTES_PER_S
                >= bound_flops[k] / FP32_FLOPS else "operations"
                for k in bound_bytes}
    bound = {k: max(bound_bytes[k] / HBM_BYTES_PER_S,
                    bound_flops[k] / FP32_FLOPS) * 1e3 for k in bound_bytes}
    bound["step"] = sum(bound.values())
    return dict(step_ms=full, split_ms=split, split_bound_ms=bound,
                split_bound_bytes=bound_bytes, split_bound_flops=bound_flops,
                split_bound_by=bound_by, valid_samples=n_valid,
                rays=int(batch[0].shape[0]), params=param_bytes // 4), step


def check_box_models(dev, data, models):
    """The box kernel against its plain version on each trained model
    (float32 and bf16 paths) on the first test view; returns the worst
    max abs."""
    from fourk_nerf_torch.ops import box_sweep, cuda_box
    i = int(data["i_test"][0])
    hw = BOUNDED_HW
    worst = 0.0
    for name, (mcfg, params, buffers) in models.items():
        for use_bf16 in (False, True):
            kw = dict(stepsize=0.5, near=2.0, bg=1.0, use_bf16=use_bf16,
                      device=dev)
            c2w = data["poses"][i][:3, :4]
            ref = box_sweep.render_frame_box(mcfg, params, buffers, hw, hw,
                                             data["Ks"][i], c2w, **kw)
            got = cuda_box.render_frame_box_cuda(
                mcfg, params, buffers, hw, hw, data["Ks"][i], c2w, **kw)
            sync()
            worst = max(worst, check_sweep(
                f"{name} model (grid {mcfg.world_size}, rgbnet_dim "
                f"{mcfg.rgbnet_dim}) {'bf16' if use_bf16 else 'f32'}", got,
                ref))
    return worst


def run_bounded(dev):
    """Phase 16 (see the module docstring). Returns the ``bounded`` record
    and the launch counts of its path."""
    import shutil
    import types

    import torch
    from fourk_nerf_torch import config as config_mod, run as run_mod, \
        weights
    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.ops import cuda_box, render
    from fourk_nerf_torch.train import checkpoints, optim, sr_trainer, \
        trainer

    t_phase = time.perf_counter()
    basedir = os.path.join(HERE, "build", "phase16_bounded")
    shutil.rmtree(basedir, ignore_errors=True)
    cfg_path = os.path.join("fourk_nerf_torch", "configs", "syn",
                            "syn_default.py")
    joint_path = os.path.join("fourk_nerf_torch", "configs", "syn",
                              "chair_joint_1x_l1_gan.py")
    rec: dict = {"config": cfg_path, "overrides": BOUNDED_OVERRIDES,
                 "joint_config": joint_path,
                 "joint_overrides": BOUNDED_JOINT_OVERRIDES,
                 "deviations": [
                     "coarse_model_and_render.alpha_init=1e-4 (published "
                     "1e-6): 100 coarse steps of 5000",
                     "the joint run's fine_train.allow_random_vgg=True, as "
                     "phase 15's"]}
    for d in rec["deviations"]:
        log(f"  deviation from the published config: {d}")
    launches: dict = {}

    # --- the scene ------------------------------------------------------------
    cuda_box.sweep_box.launches = 0
    data = bounded_views(dev)
    sync()
    launches["teacher"] = cuda_box.sweep_box.launches
    log(f"  teacher: {BOUNDED_VIEWS} views of {BOUNDED_HW}x{BOUNDED_HW} of "
        f"phase 8's scene ({BOUNDED_TEACHER_G}^3) through the box kernel "
        f"({launches['teacher']} launches); train "
        f"{data['i_train'].tolist()}, val {data['i_val'].tolist()}, test "
        f"{data['i_test'].tolist()}")
    if launches["teacher"] != BOUNDED_VIEWS:
        raise AssertionError(f"teacher views: {launches['teacher']} box "
                             "launches")

    # --- 1. the pretrain, coarse then fine ------------------------------------
    cfg = config_mod.load_config(os.path.join(HERE, cfg_path))
    cfg.basedir, cfg.expname = basedir, "syn_pretrain"
    for section in ("coarse_model_and_render", "coarse_train",
                    "fine_train"):
        for k, v in BOUNDED_OVERRIDES[section].items():
            cfg[section][k] = v
    args = types.SimpleNamespace(seed=777, no_reload=True,
                                 no_reload_optimizer=False, ft_path="",
                                 **BOUNDED_OVERRIDES["args"])
    writer = Recorder()
    torch.cuda.reset_peak_memory_stats()
    cuda_box.sweep_box.launches = 0
    t0 = time.perf_counter()
    _, mcfg, params, buffers = trainer.train(args, cfg, data, writer=writer,
                                             device=dev)
    sync()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches["i_val"] = cuda_box.sweep_box.launches
    rundir = os.path.join(basedir, "syn_pretrain")
    losses = writer.values("train/loss")
    n_c = cfg.coarse_train.N_iters // args.i_print
    rec.update(world_size=list(mcfg.world_size),
               xyz_min=list(mcfg.xyz_min), xyz_max=list(mcfg.xyz_max),
               train_s=train_s, coarse_losses=losses[:n_c],
               fine_losses=losses[n_c:], train_psnr=writer.values(
                   "train/psnr"), val_psnr=writer.values("val/psnr"),
               max_memory_allocated_bytes=peak)
    log(f"  coarse {cfg.coarse_train.N_iters} + fine "
        f"{cfg.fine_train.N_iters} steps in {train_s:.1f} s (host clock, "
        f"view counts, hit tests, eval renders and saves included): fine "
        f"world size {mcfg.world_size} over {mcfg.xyz_min}..{mcfg.xyz_max};"
        f" loss at each print coarse {['%.5g' % x for x in losses[:n_c]]}, "
        f"fine {['%.5g' % x for x in losses[n_c:]]}; val psnr (coarse, "
        f"fine) {rec['val_psnr']}; i_val box launches "
        f"{launches['i_val']}; peak memory {peak / 2**30:.2f} GiB")
    n_val = sum(c.N_iters // args.i_val for c in (cfg.coarse_train,
                                                   cfg.fine_train))
    if launches["i_val"] != n_val * len(data["i_val"]):
        raise AssertionError(f"i_val renders: {launches['i_val']} box "
                             "launches (a model left the box path)")
    # the coarse alphas start small and show late in its 100 steps: its
    # last three prints against its first three
    if not (all(np.isfinite(losses)) and losses[-1] < losses[n_c]
            and np.mean(losses[n_c - 3:n_c]) < np.mean(losses[:3])):
        raise AssertionError(f"a stage's loss did not fall: {losses}")
    if not (int(np.prod(mcfg.world_size))
            > 0.9 * cfg.fine_model_and_render.num_voxels
            and tuple(buffers["mask_cache"].shape) == mcfg.world_size):
        raise AssertionError(f"the fine run ended at {mcfg.world_size}, "
                             f"mask {tuple(buffers['mask_cache'].shape)}")
    for k, v in checkpoints.tree_to_flat_dict(params).items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite parameter {k}")
    coarse_last = os.path.join(rundir, "coarse_last.npz")
    fine_last = os.path.join(rundir, "fine_last.npz")
    ckw, cp, cb, _, _, _ = checkpoints.load_checkpoint(coarse_last,
                                                       device=dev)
    ccfg = dvgo.make_config(**ckw)

    # --- the box kernel vs plain on both models -----------------------------
    rec["box_vs_plain_max_abs"] = check_box_models(
        dev, data, {"coarse": (ccfg, cp, cb), "fine": (mcfg, params,
                                                       buffers)})

    # --- 2. --export_coarse_only; 3. --render_only --render_test ------------
    def cli(argv):
        a = run_mod.config_parser().parse_args(
            ["--config", os.path.join(HERE, cfg_path), "--device", dev.type]
            + argv)
        c = config_mod.load_config(os.path.join(HERE, cfg_path))
        c.basedir, c.expname = basedir, "syn_pretrain"
        return a, c

    export = os.path.join(basedir, "coarse_alpha.npz")
    run_mod.run(*cli(["--export_coarse_only", export]), data)
    with np.load(export) as z:
        alpha = z["alpha"]
    thres = cfg.fine_model_and_render.bbox_thres
    want = render.raw2alpha(cp["density"][..., 0], ccfg.act_shift,
                            ccfg.voxel_size_ratio).cpu().numpy()
    rec["export_coarse"] = {"shape": list(alpha.shape),
                            "max": float(alpha.max()),
                            "share_above_bbox_thres": float(
                                (alpha > thres).mean())}
    log(f"  --export_coarse_only: alpha {alpha.shape}, max "
        f"{alpha.max():.4g}, share above bbox_thres {thres} "
        f"{(alpha > thres).mean():.4f}")
    if not (alpha.shape == want.shape and np.array_equal(alpha, want)
            and alpha.max() > thres):
        raise AssertionError("the exported coarse volume is not the coarse "
                             "model's")
    cuda_box.sweep_box.launches = 0
    res = run_mod.run(*cli(["--render_only", "--render_test"]),
                      data)["test"]
    sync()
    launches["render_only"] = cuda_box.sweep_box.launches
    rec["test_psnr"], rec["test_path"] = res["psnrs"], res["path"]
    log(f"  --render_only --render_test: held-out psnr {res['psnrs']}, the "
        f"{res['path']} path, {launches['render_only']} box launches")
    if res["path"] != "box" or launches["render_only"] != len(
            data["i_test"]):
        raise AssertionError("the held-out views did not take the box "
                             "kernel")
    # the trained model beats a flat white frame on the held-out views
    white = [float(-10 * np.log10(np.mean((1.0 - data["images"][i]) ** 2)))
             for i in data["i_test"]]
    if not np.mean(res["psnrs"]) > np.mean(white) + 1.0:
        raise AssertionError(f"held-out psnr {res['psnrs']} vs white {white}")
    del res

    # --- the coarse step, the fine step at full width -----------------------
    rk = {"near": 2.0, "far": 6.0, "bg": 1.0, "rand_bkgd": False,
          "stepsize": 0.5}
    ct, ft = cfg.coarse_train, cfg.fine_train
    flat_c, lists_c = trainer.gather_training_rays(cfg, ct, data, dev)
    cnt = dvgo.voxel_count_views(ccfg, lists_c["rays_o"], lists_c["rays_d"],
                                 2.0, 0.5)
    t_cnt = event_ms(lambda: dvgo.voxel_count_views(
        ccfg, lists_c["rays_o"], lists_c["rays_d"], 2.0, 0.5), reps=1)
    per_lr = {"density": cnt / cnt.max().clamp_min(1.0)}
    sample = trainer.make_batch_sampler("random", flat_c, ct.N_rand, 777)
    coarse, _ = bounded_step_parts(
        dev, ct, ccfg, cp, cb, trainer.gather_batch(flat_c, *sample(5)),
        per_lr, rk)
    coarse["voxel_count_views_ms"] = t_cnt
    del flat_c, lists_c, cnt, per_lr
    flat_f, _ = trainer.gather_training_rays(
        cfg, ft, data, dev, model=(dvgo, mcfg, buffers), render_kwargs=rk)
    sample = trainer.make_batch_sampler("in_maskcache", flat_f, ft.N_rand,
                                        777)
    fine, fine_step = bounded_step_parts(
        dev, ft, mcfg, params, buffers,
        trainer.gather_batch(flat_f, *sample(5)), None, rk)
    fine["in_maskcache_rays"] = int(flat_f["rgb"].shape[0])
    fine["profile"] = profile_call(fine_step, "fine step", top=10)
    del flat_f
    rec.update(coarse_step=coarse, fine_step=fine)
    for name, r in (("coarse", coarse), ("fine", fine)):
        log(f"  {name} step at {r['rays']} rays, {r['valid_samples']} valid "
            f"samples, {r['params']} parameters: {r['step_ms']:.2f} ms (CUDA "
            f"events, median of 5; bound {r['split_bound_ms']['step']:.3g} "
            "ms); " + ", ".join(f"{k} {v:.4g} ms (bound "
                               f"{r['split_bound_ms'][k]:.4g}, by "
                               f"{r['split_bound_by'][k]})"
                               for k, v in r["split_ms"].items()))
    log(f"  voxel_count_views over {len(data['i_train'])} views of "
        f"{BOUNDED_HW}x{BOUNDED_HW} rays on the coarse grid "
        f"{ccfg.world_size}: {t_cnt:.1f} ms (CUDA events, one call); "
        f"in_maskcache keeps {fine['in_maskcache_rays']} rays")
    del params, buffers, cp, cb
    torch.cuda.empty_cache()

    # --- 4. the chair joint config from fine_last and coarse_last -----------
    with np.load(fine_last) as z:
        start = int(json.loads(bytes(z["__meta__"]).decode())["global_step"])
    jcfg = config_mod.load_config(os.path.join(HERE, joint_path))
    jcfg.basedir, jcfg.expname = basedir, "chair_joint"
    for k, v in BOUNDED_JOINT_OVERRIDES["fine_train"].items():
        jcfg.fine_train[k] = v
    jcfg.fine_train.N_iters = start + BOUNDED_JOINT_STEPS
    jargs = types.SimpleNamespace(
        seed=777, no_reload=False, no_reload_optimizer=False, ft_path="",
        ftdv_path=fine_last, ftdvcoa_path=coarse_last, ftsr_path="",
        test_tile=0, **BOUNDED_JOINT_OVERRIDES["args"])
    jw = Recorder()
    torch.cuda.reset_peak_memory_stats()
    cuda_box.sweep_box.launches = 0
    t0 = time.perf_counter()
    _, jmcfg, jp, jb, sr_model = sr_trainer.train_sr(jargs, jcfg, data,
                                                     writer=jw, device=dev)
    sync()
    joint_s = time.perf_counter() - t0
    launches["joint_i_val"] = cuda_box.sweep_box.launches
    jvals = {k: jw.values(f"train/{k}") for k in (
        "loss_l1", "loss_photo", "loss_pcp", "loss_style", "loss_g",
        "loss_d_real", "loss_d_fake", "psnr_sr")}
    jvals.update(val_psnr_sr=jw.values("val/psnr_sr"))
    rec["joint"] = dict(start=start, steps=BOUNDED_JOINT_STEPS,
                        train_s=joint_s, max_memory_allocated_bytes=
                        torch.cuda.max_memory_allocated(), **jvals)
    log(f"  chair joint steps {start + 1}..{start + BOUNDED_JOINT_STEPS} in "
        f"{joint_s:.1f} s (host clock, eval and saves included), box "
        f"launches of its i_val {launches['joint_i_val']}; at each print "
        + "; ".join(f"{k} {['%.5g' % x for x in v]}"
                    for k, v in jvals.items()))
    l1 = jvals["loss_l1"]
    if not (l1 and all(np.isfinite(l1)) and l1[-1] < l1[0]) or \
            launches["joint_i_val"] != len(data["i_val"]):
        raise AssertionError(f"the joint run: SR L1 {l1}, i_val launches "
                             f"{launches['joint_i_val']}")
    for k in ("loss_d_real", "loss_d_fake", "loss_g", "loss_pcp"):
        if not all(np.isfinite(jvals[k])):
            raise AssertionError(f"{k} is not finite: {jvals[k]}")

    # --- the joint step at full width ------------------------------------------
    jft = jcfg.fine_train
    patch = int(jft.N_patch)
    perceptual = sr_trainer.build_perceptual(jft, device=dev)
    jlast = os.path.join(basedir, "chair_joint", "fine_last.npz")
    *_, d_params, d_state, _, _, _ = sr_trainer.load_joint(jlast, False,
                                                           device=dev)
    d_model = weights.disc_from_flax(d_params, d_state, device=dev)
    st = sr_trainer.SRTrainStep(
        dvgo, jmcfg, jft, jcfg.fine_model_and_render, render_kwargs=rk,
        skip_zero_grad=frozenset(jft.skip_zero_grad_fields),
        sr_model=sr_model, n_views=len(data["i_train"]), patch=patch,
        sr_ratio=1, perceptual=perceptual, d_model=d_model)
    flat_j, _ = trainer.gather_training_rays(
        jcfg, sr_trainer._force_image_sampler(jft), data, dev)
    sampler = sr_trainer.make_patch_sampler(len(data["i_train"]),
                                            BOUNDED_HW, BOUNDED_HW, patch, 7)
    counter = [0]

    def jbatch():
        counter[0] += 1
        v, r, c = sampler(counter[0])
        sl = [flat_j[k][v, r:r + patch, c:c + patch].reshape(-1, 3)
              for k in trainer._RAY_KEYS]
        return (*sl, sl[3], torch.zeros((3, 3), device=dev))

    lr_sr = optim.group_lr(jft.lrate_srnet, 100, jft.lrate_decay)
    jlrs = {"enc": {k: optim.group_lr(v, 100, jft.lrate_decay) for k, v in
                    optim.build_group_lrs(jft, jp).items()},
            "srnet": lr_sr, "d": lr_sr}
    opts = (optim.init_state(jp), optim.init_state({"srnet": st.sr_params}),
            optim.init_state({"d": st.d_params}))

    def joint_step():
        st(jp, jb, opts[0], opts[1], jbatch(), jlrs, apply_tv=False,
           tv_dense=False, d_opt=opts[2])

    n0 = counter[0]
    jstep = event_ms(joint_step)
    # the bound's render bytes: the mean valid samples of the timed draws
    n_valid = 0
    for i in range(n0 + 1, counter[0] + 1):
        v, r, c = sampler(i)
        n_valid += valid_samples(
            jmcfg, jb, flat_j["rays_o"][v, r:r + patch, c:c + patch]
            .reshape(-1, 3), flat_j["rays_d"][v, r:r + patch, c:c + patch]
            .reshape(-1, 3), 0.5, 2.0)
    n_valid //= counter[0] - n0
    bt = jbatch()
    g_flops = flops_of(lambda: st.loss_and_grads(jp, jb, bt,
                                                 jlrs["enc"].keys()))
    *_, (rgb_sr, rgb_hr) = st.loss_and_grads(jp, jb, bt, jlrs["enc"].keys())
    d_flops = flops_of(lambda: st.d_loss_and_grads(rgb_sr, rgb_hr, None))
    adam_bytes = 7 * (tree_bytes(jp) + tree_bytes(st.sr_params)
                      + tree_bytes(st.d_params))
    render_bytes = 2 * n_valid * 8 * (1 + jmcfg.k0_dim) * 4 + tree_bytes(jp)
    jbound = {"render_bytes_ms": render_bytes / HBM_BYTES_PER_S * 1e3,
              "adam_bytes_ms": adam_bytes / HBM_BYTES_PER_S * 1e3,
              "g_d_flops_ms": (g_flops + d_flops) / FP32_FLOPS * 1e3}
    jbound["step"] = sum(jbound.values())
    rec["joint"].update(step_ms=jstep, step_bound_ms=jbound,
                        g_flops=g_flops, d_flops=d_flops,
                        valid_samples=n_valid, patch=patch,
                        step_path=st.path(jp, jb, False))
    log(f"  chair joint step at {patch}x{patch} patches ({n_valid} valid "
        f"samples a patch, the {st.path(jp, jb, False)} path): {jstep:.2f} ms (CUDA "
        f"events, median of 5); bound {jbound['step']:.3g} ms = render "
        f"bytes {jbound['render_bytes_ms']:.3g} + three Adams' bytes "
        f"{jbound['adam_bytes_ms']:.3g} + G and D float32 operations "
        f"({(g_flops + d_flops) / 1e9:.1f} GFLOP, torch's flop counter) "
        f"{jbound['g_d_flops_ms']:.3g}")
    del flat_j, st, opts, rgb_sr, rgb_hr, jp, jb, d_model, perceptual
    torch.cuda.empty_cache()

    # --- 5. run_sr --render_only --render_test --render_video ---------------
    rec["evaluate_sr_s"], rec["serve"], launches["serve"] = serve_joint(
        dev, joint_path, basedir, "chair_joint", jlast, data, render="box",
        frame_hw=(BOUNDED_HW, BOUNDED_HW))
    shutil.rmtree(basedir)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 16: {rec['phase_s']:.1f} s")
    return rec, launches


def unbounded_views(dev):
    """The scene of phase 17: phase 8's bounded scene (``box_synthetic``)
    rendered on black through ``render_viewpoints`` (the box kernel, bf16
    path) from ``UNBOUNDED_VIEWS`` poses 15 degrees apart around the
    Blender sphere, plus each pixel's background share times
    ``tiny_scene.environment`` of its direction, as the NeRF++ loader's
    ``data_dict``: held-out views interleaved
    (``tiny_scene.interleaved_split``), ``near`` 0, ``near_clip`` and
    ``far`` from the training cameras' spread."""
    import torch
    from fourk_nerf_torch.data import inward_nearfar_heuristic
    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.ops import rays as ray_ops
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import trainer
    hw, n = UNBOUNDED_HW, UNBOUNDED_VIEWS
    cfg, params, buffers = box_synthetic(dev, G=BOUNDED_TEACHER_G)
    f = tiny_scene.blender_focal(hw)
    K = np.array([[f, 0, 0.5 * hw], [0, f, 0.5 * hw], [0, 0, 1]])
    poses = tiny_scene.bounded_poses(n)
    res = trainer.render_viewpoints(
        dvgo, cfg, params, buffers, poses, np.array([[hw, hw]] * n),
        np.stack([K] * n), data=trainer.DataFlags(),
        render_kwargs={**BOX_RENDER, "bg": 0.0}, verbose=False, device=dev)
    images = np.empty((n, hw, hw, 3), np.float32)
    for v in range(n):
        _, _, vd = ray_ops.get_rays_of_a_view(
            hw, hw, K, poses[v], ndc=False, inverse_y=False, flip_x=False,
            flip_y=False, device=dev)
        env = torch.as_tensor(tiny_scene.environment(vd.cpu().numpy()),
                              device=dev)
        images[v] = (res["rgbs"][v].float() + res["bgmaps"][v].float()
                     [..., None] * env).clamp(0, 1).cpu().numpy()
    del res
    i_train, i_val, i_test = tiny_scene.interleaved_split(n, 2, 2)
    near_clip, far = inward_nearfar_heuristic(poses[i_train, :3, 3],
                                              ratio=0.02)
    return dict(hwf=[hw, hw, f], HW=np.array([[hw, hw]] * n),
                Ks=np.stack([K] * n), near=0, far=far, near_clip=near_clip,
                i_train=i_train, i_val=i_val, i_test=i_test, poses=poses,
                render_poses=poses[i_test], images=images,
                irregular_shape=False)


def unbounded_step_parts(dev, cfg_train, mcfg, params, buffers, batch, rk,
                         near_thres):
    """A DirectContractedVoxGO training step at full width split into the
    forward + backward and MaskedAdam, each by CUDA events (median of 5),
    and the spacing filter's loop alone (sampling and keep mask) on the
    host clock (median of 5, synchronised), each beside its bound, the
    larger of its bytes and its FP32 operations. Bytes: the voxels of
    this batch's valid samples (kept, in the mask) read (8 corners,
    density and k0) forward and scattered backward, the dense gradients
    written; Adam reading p, g, m, v and writing p, m, v; the filter
    reading the rays and writing the ``[N, K]`` mask. Operations: the
    rgbnet on the valid samples, forward and backward (6 a multiply-add);
    the filter's few operations a sample are left out (bytes bound it)."""
    import torch
    from fourk_nerf_torch.models import dcvgo
    from fourk_nerf_torch.ops import grid_sample
    from fourk_nerf_torch.train import optim, trainer
    lrs = {k: optim.group_lr(v, 10, cfg_train.lrate_decay) for k, v in
           optim.build_group_lrs(cfg_train, params).items()}
    skip = frozenset(cfg_train.skip_zero_grad_fields)
    st = trainer.TrainStep(dcvgo, mcfg, cfg_train, render_kwargs=rk,
                           skip_zero_grad=skip, near_thres=near_thres)
    opt = optim.init_state(params)

    def step():
        st(params, buffers, opt, batch, lrs, None, None, apply_tv=False,
           tv_dense=False)

    full = event_ms(step)
    _, _, grads = st.loss_and_grads(params, buffers, batch, lrs.keys())
    split = {"fwd_bwd": event_ms(lambda: st.loss_and_grads(
                 params, buffers, batch, lrs.keys())),
             "adam": event_ms(lambda: optim.apply_updates(
                 params, grads, opt, lrs, skip_zero_grad=skip))}
    del grads
    stepsize = rk["stepsize"]

    def keep():
        pts, inner, _ = dcvgo.sample_ray(mcfg, batch[0], batch[1],
                                         stepsize=stepsize)
        return pts, dcvgo.keep_mask(mcfg, pts, inner, stepsize)

    keep()
    sync()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        keep()
        sync()
        host.append((time.perf_counter() - t0) * 1e3)
    keep_ms = statistics.median(host)
    pts, kept = keep()
    mn, mx = (torch.tensor(v, device=pts.device) for v in (mcfg.xyz_min,
                                                          mcfg.xyz_max))
    n_valid = int((kept & grid_sample.nearest_mask_lookup(
        buffers["mask_cache"], pts, mn, mx)).sum())
    n_rays, K = (int(v) for v in kept.shape)
    del pts, kept
    param_bytes = tree_bytes(params)
    bound_bytes = {"fwd_bwd": 2 * n_valid * 8 * (1 + mcfg.k0_dim) * 4
                   + param_bytes, "adam": 7 * param_bytes,
                   "keep": n_rays * (6 * 4 + K)}
    rgbnet_macs = sum(w.shape[0] * w.shape[1] for k, w in
                      params.get("rgbnet", {}).items() if k.startswith("w"))
    bound_flops = {"fwd_bwd": 6 * rgbnet_macs * n_valid, "adam": 0,
                   "keep": 0}
    bound_by = {k: "bytes" if bound_bytes[k] / HBM_BYTES_PER_S
                >= bound_flops[k] / FP32_FLOPS else "operations"
                for k in bound_bytes}
    bound = {k: max(bound_bytes[k] / HBM_BYTES_PER_S,
                    bound_flops[k] / FP32_FLOPS) * 1e3 for k in bound_bytes}
    bound["step"] = bound["fwd_bwd"] + bound["adam"]
    return dict(step_ms=full, split_ms=split, keep_host_ms=keep_ms,
                keep_share_of_step=keep_ms / full, split_bound_ms=bound,
                split_bound_bytes=bound_bytes, split_bound_flops=bound_flops,
                split_bound_by=bound_by, valid_samples=n_valid,
                samples=n_rays * K, rays=n_rays, samples_per_ray=K,
                params=param_bytes // 4), step


def run_unbounded(dev):
    """Phase 17 (see the module docstring). Returns the ``unbounded``
    record and the launch counts of its path."""
    import shutil
    import types

    import torch
    from fourk_nerf_torch import config as config_mod, run as run_mod
    from fourk_nerf_torch.models import dcvgo
    from fourk_nerf_torch.ops import cuda_box
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import checkpoints, trainer

    t_phase = time.perf_counter()
    basedir = os.path.join(HERE, "build", "phase17_unbounded")
    shutil.rmtree(basedir, ignore_errors=True)
    cfg_path = os.path.join("fourk_nerf_torch", "configs", "syn",
                            "syn_default.py")
    rec: dict = {"config": cfg_path,
                 "overrides": tiny_scene.UNBOUNDED_OVERRIDES,
                 "cut": UNBOUNDED_CUT}
    launches: dict = {}

    def load_cfg(expname, *overs):
        c = config_mod.load_config(os.path.join(HERE, cfg_path))
        for over in (tiny_scene.UNBOUNDED_OVERRIDES,) + overs:
            tiny_scene.apply_overrides(c, basedir, expname, over)
        return c

    # --- the scene ------------------------------------------------------------
    cuda_box.sweep_box.launches = 0
    data = unbounded_views(dev)
    sync()
    launches["teacher"] = cuda_box.sweep_box.launches
    log(f"  teacher: {UNBOUNDED_VIEWS} views of {UNBOUNDED_HW}x{UNBOUNDED_HW}"
        f" of phase 8's scene ({BOUNDED_TEACHER_G}^3) on black through the "
        f"box kernel ({launches['teacher']} launches) before the environment"
        f"; train {data['i_train'].tolist()}, val {data['i_val'].tolist()}, "
        f"test {data['i_test'].tolist()}; near_clip {data['near_clip']:.4f},"
        f" far {data['far']:.4f}")
    if launches["teacher"] != UNBOUNDED_VIEWS:
        raise AssertionError(f"teacher views: {launches['teacher']} box "
                             "launches")

    # --- 1. the pretrain ------------------------------------------------------
    cfg = load_cfg("unbounded", {"fine_train": UNBOUNDED_CUT["fine_train"]})
    args = types.SimpleNamespace(seed=777, no_reload=True,
                                 no_reload_optimizer=False, ft_path="",
                                 **UNBOUNDED_CUT["args"])
    writer = Recorder()
    torch.cuda.reset_peak_memory_stats()
    cuda_box.sweep_box.launches = 0
    t0 = time.perf_counter()
    model_mod, mcfg, params, buffers = trainer.train(args, cfg, data,
                                                     writer=writer,
                                                     device=dev)
    sync()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches["train"] = cuda_box.sweep_box.launches
    losses = writer.values("train/loss")
    K = mcfg.n_samples(0.5)
    rec.update(world_size=list(mcfg.world_size), samples_per_ray=K,
               scene_center=list(mcfg.scene_center),
               scene_radius=list(mcfg.scene_radius),
               near_clip=float(data["near_clip"]), far=float(data["far"]),
               train_s=train_s, losses=losses,
               train_psnr=writer.values("train/psnr"),
               val_psnr=writer.values("val/psnr"),
               max_memory_allocated_bytes=peak)
    log(f"  {cfg.fine_train.N_iters} steps in {train_s:.1f} s (host clock, "
        f"the i_val render and the save included): grid {mcfg.world_size} "
        f"over the contracted cube, {K} samples a ray, foreground cube "
        f"centre {np.round(mcfg.scene_center, 3).tolist()} radius "
        f"{mcfg.scene_radius[0]:.3f}; loss at each print "
        f"{['%.5g' % x for x in losses]}; val psnr {rec['val_psnr']}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    fm = cfg.fine_model_and_render
    want = dcvgo.make_config(xyz_min=[-1] * 3, xyz_max=[1] * 3,
                             num_voxels=fm.num_voxels,
                             num_voxels_base=fm.num_voxels_base,
                             alpha_init=fm.alpha_init)
    if model_mod is not dcvgo or mcfg.world_size != want.world_size:
        raise AssertionError(f"the run trained {model_mod.__name__} on "
                             f"{mcfg.world_size}, not {want.world_size}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and launches["train"] == 0 and len(rec["val_psnr"]) == 1):
        raise AssertionError(f"losses {losses}, val {rec['val_psnr']}, box "
                             f"launches {launches['train']}")
    for k, v in checkpoints.tree_to_flat_dict(params).items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite parameter {k}")

    # --- the step at full width --------------------------------------------------
    rk = {"near": 0.0, "far": float(data["far"]), "bg": 1.0,
          "rand_bkgd": False, "stepsize": 0.5}
    ft = cfg.fine_train
    flat, _ = trainer.gather_training_rays(cfg, ft, data, dev)
    sample = trainer.make_batch_sampler("flatten", flat, ft.N_rand, 777)
    batch = trainer.gather_batch(flat, *sample(5))
    step_rec, step = unbounded_step_parts(
        dev, ft, mcfg, params, buffers, batch, rk,
        float(data["near_clip"]) / mcfg.scene_radius[0])
    step_rec["profile"] = profile_call(step, "unbounded step", top=10)
    del flat, batch, step
    rec["step"] = step_rec
    r = step_rec
    log(f"  step at {r['rays']} rays x {r['samples_per_ray']} samples "
        f"({r['valid_samples']} valid), {r['params']} parameters: "
        f"{r['step_ms']:.2f} ms (CUDA events, median of 5; bound "
        f"{r['split_bound_ms']['step']:.3g} ms); " + ", ".join(
            f"{k} {v:.4g} ms (bound {r['split_bound_ms'][k]:.4g}, by "
            f"{r['split_bound_by'][k]})" for k, v in r["split_ms"].items())
        + f"; the spacing filter alone {r['keep_host_ms']:.2f} ms (host "
        f"clock, {100 * r['keep_share_of_step']:.1f}% of the step; bound "
        f"{r['split_bound_ms']['keep']:.3g} ms)")
    del params, buffers
    torch.cuda.empty_cache()

    # --- 2. --render_only --render_test -----------------------------------------
    argv = ["--config", os.path.join(HERE, cfg_path), "--device", dev.type,
            "--render_only", "--render_test"]
    cuda_box.sweep_box.launches = 0
    res = run_mod.run(run_mod.config_parser().parse_args(argv),
                      load_cfg("unbounded"), data)["test"]
    sync()
    launches["render_only"] = cuda_box.sweep_box.launches
    # the constant frame: the training views' mean colour
    const = np.mean([data["images"][i].mean((0, 1))
                     for i in data["i_train"]], 0)
    flat_psnr = [float(-10 * np.log10(np.mean((data["images"][i] - const)
                                               ** 2)))
                 for i in data["i_test"]]
    rec.update(test_psnr=res["psnrs"], test_path=res["path"],
               test_frame_s=res["frame_times"], constant_frame_psnr=flat_psnr)
    log(f"  --render_only --render_test: held-out psnr {res['psnrs']} (the "
        f"constant frame {flat_psnr}), the {res['path']} path, "
        f"{[round(t, 3) for t in res['frame_times']]} s a frame (host clock)")
    if res["path"] != "chunked" or launches["render_only"]:
        raise AssertionError("the held-out views left the chunked forward")
    if not np.mean(res["psnrs"]) > np.mean(flat_psnr):
        raise AssertionError(f"held-out psnr {res['psnrs']} vs the "
                             f"constant frame {flat_psnr}")
    del res

    # --- the tiny unbounded CPU-test scene on the card and on the CPU ----------
    tiny = {}
    for name in ("cuda", "cpu"):
        tcfg = load_cfg(f"tiny_{name}", tiny_scene.UNBOUNDED_TINY)
        w = Recorder()
        targs = types.SimpleNamespace(seed=0, no_reload=True,
                                      no_reload_optimizer=False, ft_path="",
                                      i_print=1, i_val=0, i_weights=0)
        trainer.train(targs, tcfg, tiny_scene.unbounded_scene(), writer=w,
                      device=torch.device(name))
        tiny[name] = np.array(w.values("train/loss"))
    rel = float(np.max(np.abs(tiny["cuda"] - tiny["cpu"]) / tiny["cpu"]))
    rec["tiny_loss_max_rel_diff"] = rel
    log(f"  tiny unbounded scene, {len(tiny['cpu'])} steps: per-step loss "
        f"cuda vs cpu max rel {rel:.3e} (limit {TINY_TOL:.0e})")
    if len(tiny["cpu"]) != 30 or not rel <= TINY_TOL:
        raise AssertionError("the tiny unbounded run differs between cuda "
                             "and cpu")
    shutil.rmtree(basedir)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 17: {rec['phase_s']:.1f} s")
    return rec, launches


def bounds_of(bound_bytes: dict, bound_flops: dict) -> tuple:
    """(bound ms, bound by) of each part: the larger of its bytes at the
    card's memory rate and its operations at the FP32 rate."""
    by = {k: "bytes" if bound_bytes[k] / HBM_BYTES_PER_S
          >= bound_flops[k] / FP32_FLOPS else "operations"
          for k in bound_bytes}
    ms = {k: max(bound_bytes[k] / HBM_BYTES_PER_S,
                 bound_flops[k] / FP32_FLOPS) * 1e3 for k in bound_bytes}
    return ms, by


def mlp_macs(mlp: dict) -> int:
    """Multiply-adds a row of an ``{w0, b0, ...}`` MLP."""
    return sum(w.shape[0] * w.shape[1] for k, w in mlp.items()
               if k.startswith("w"))


def load_over(cfg_path, basedir, expname, overrides):
    """A published config with ``overrides`` (section -> key -> value; the
    ``args`` section is skipped) set over it, its run under ``basedir``."""
    from fourk_nerf_torch import config as config_mod
    cfg = config_mod.load_config(os.path.join(HERE, cfg_path))
    cfg.basedir, cfg.expname = basedir, expname
    for section, kv in overrides.items():
        if section != "args":
            for k, v in kv.items():
                cfg[section][k] = v
    return cfg


def run_args(overrides, seed=777):
    import types
    return types.SimpleNamespace(seed=seed, no_reload=True,
                                 no_reload_optimizer=False, ft_path="",
                                 **overrides["args"])


def check_finite(tree, what):
    import torch
    from fourk_nerf_torch.train import checkpoints
    for k, v in checkpoints.tree_to_flat_dict(tree).items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite {k}")


def secondary_vq(dev, data, basedir, launches):
    """Phase 18 (a): DirectQVGO (``mode_type`` adain_vq) on phase 13's
    views at full width. Returns its record."""
    import torch
    from fourk_nerf_torch import run as run_mod
    from fourk_nerf_torch.models import dvqgo
    from fourk_nerf_torch.ops import cuda_sweep, vq
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import checkpoints, optim, trainer

    cfg = load_over(FERN_CFG, basedir, "vq", VQ_OVERRIDES)
    args = run_args(VQ_OVERRIDES)
    rec: dict = {"config": FERN_CFG, "overrides": VQ_OVERRIDES,
                 "deviations": [VQ_DEVIATION]}
    log(f"  (a) deviation from the published config: {VQ_DEVIATION}")
    writer = Recorder()
    torch.cuda.reset_peak_memory_stats()
    cuda_sweep.sweep.launches = 0
    t0 = time.perf_counter()
    model_mod, mcfg, params, buffers = trainer.train(args, cfg, data,
                                                     writer=writer,
                                                     device=dev)
    sync()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches["vq_i_val"] = cuda_sweep.sweep.launches
    losses = writer.values("train/loss")
    state = buffers["vq_state"]
    _, b0 = dvqgo.init(mcfg, generator=torch.Generator().manual_seed(777),
                       device=dev)
    moved = float((state["embed"] - b0["vq_state"]["embed"]).abs().max())
    del b0
    rec.update(world_size=list(mcfg.world_size), n_cluster=mcfg.n_cluster,
               train_s=train_s, losses=losses,
               val_psnr=writer.values("val/psnr"),
               cluster_size_sum=float(state["cluster_size"].sum()),
               codes_used=int((state["cluster_size"] > 1e-3).sum()),
               embed_max_move=moved, max_memory_allocated_bytes=peak)
    log(f"  (a) DirectQVGO: {cfg.fine_train.N_iters} steps in {train_s:.1f} "
        f"s (host clock, the i_val render and saves included): world size "
        f"{mcfg.world_size}, {mcfg.n_cluster} codes; loss at each print "
        f"{['%.5g' % x for x in losses]}; val psnr {rec['val_psnr']}; "
        f"cluster sizes sum {rec['cluster_size_sum']:.4g} over "
        f"{rec['codes_used']} codes, the codebook moved by up to "
        f"{moved:.4g}; sweep launches {launches['vq_i_val']}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    full = cfg.fine_model_and_render.num_voxels
    if model_mod is not dvqgo or not int(np.prod(mcfg.world_size)) > 0.9 * full:
        raise AssertionError(f"the run trained {model_mod.__name__} at "
                             f"{mcfg.world_size}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and len(rec["val_psnr"]) == 1 and launches["vq_i_val"] == 0):
        raise AssertionError(f"losses {losses}, val {rec['val_psnr']}, "
                             f"sweep launches {launches['vq_i_val']}")
    if not (rec["cluster_size_sum"] > 0 and moved > 0):
        raise AssertionError("the EMA codebook did not learn")
    check_finite(params, "DirectQVGO")
    rundir = os.path.join(basedir, "vq")
    if not os.path.isfile(os.path.join(
            rundir, f"fine_{args.i_weights:06d}.npz")):
        raise AssertionError("no periodic checkpoint")

    # --- held-out views, then run --render_only from the final checkpoint ----
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "stepsize": 1.0}
    res = trainer.render_viewpoints(
        dvqgo, mcfg, params, buffers, data["poses"][data["i_test"]],
        data["HW"][data["i_test"]], data["Ks"][data["i_test"]],
        data=trainer.DataFlags(ndc=True), render_kwargs=rk,
        gt_imgs=[data["images"][i] for i in data["i_test"]],
        eval_ssim=False, device=dev)
    argv = ["--config", FERN_CFG, "--device", dev.type, "--render_only",
            "--render_test"]
    cuda_sweep.sweep.launches = 0
    res2 = run_mod.run(run_mod.config_parser().parse_args(argv), cfg,
                       data)["test"]
    sync()
    launches["vq_render_only"] = cuda_sweep.sweep.launches
    rec.update(test_psnr=res["psnrs"], test_path=res2["path"],
               test_frame_s=res2["frame_times"])
    log(f"  (a) held-out psnr {res['psnrs']}; --render_only from fine_last: "
        f"{res2['psnrs']}, the {res2['path']} path, "
        f"{[round(t, 3) for t in res2['frame_times']]} s a frame (host "
        f"clock), sweep launches {launches['vq_render_only']}")
    if res["path"] != "chunked" or res2["path"] != "chunked" \
            or launches["vq_render_only"]:
        raise AssertionError("the held-out views left the chunked forward")
    if not all(torch.equal(a, b) for a, b in zip(res["rgbs"], res2["rgbs"])):
        raise AssertionError("the final checkpoint does not render the "
                             "held-out views as the trained model did")
    del res, res2

    # --- the full-width step by parts ------------------------------------------
    ft = cfg.fine_train
    rk_train = {**rk, "rand_bkgd": True}
    flat, _ = trainer.gather_training_rays(cfg, ft, data, dev)
    sample = trainer.make_batch_sampler("flatten", flat, ft.N_rand, 777)
    bt = trainer.gather_batch(flat, *sample(3))
    del flat
    noise = trainer.bkgd_noise(777, 1, ft.N_rand, dev)
    lrs = {k: optim.group_lr(v, 10, ft.lrate_decay) for k, v in
           optim.build_group_lrs(ft, params).items()}
    skip = frozenset(ft.skip_zero_grad_fields)
    st = trainer.TrainStep(dvqgo, mcfg, ft, render_kwargs=rk_train,
                           skip_zero_grad=skip)
    opt = optim.init_state(params)
    seen = {}
    nearest = vq.nearest_code

    def spy(rows, embed):
        seen["rows"] = rows.detach()
        return nearest(rows, embed)

    vq.nearest_code = spy
    try:
        _, _, grads = st.loss_and_grads(params, buffers, bt, lrs.keys(),
                                        noise)
    finally:
        vq.nearest_code = nearest
    rows, embed = seen.pop("rows"), buffers["vq_state"]["embed"]
    idx = vq.nearest_code(rows, embed)
    split = {
        "fwd_bwd": event_ms(lambda: st.loss_and_grads(
            params, buffers, bt, lrs.keys(), noise)),
        "vq_argmin": event_ms(lambda: vq.nearest_code(rows, embed)),
        "ema": event_ms(lambda: vq.ema_update(buffers["vq_state"], rows,
                                              idx)),
        "tv": event_ms(lambda: st.add_tv(params, grads, ft.N_rand, True)),
        "adam": event_ms(lambda: optim.apply_updates(
            params, grads, opt, lrs, skip_zero_grad=skip)),
    }
    step_ms = event_ms(lambda: st(params, buffers, opt, bt, lrs, None, noise,
                                  apply_tv=True, tv_dense=True))
    P, dim = (int(v) for v in rows.shape)
    n = mcfg.n_cluster
    param_bytes = tree_bytes(params)
    dens_bytes = tree_bytes({"d": params["density"]})
    argmin_flops = 2 * P * n * dim + 3 * P * n
    bound_bytes = {
        # the density's 8 corners read and scattered, the dense gradient
        # written; the rest of the params are small
        "fwd_bwd": 2 * P * 8 * 4 + param_bytes,
        "vq_argmin": P * dim * 4 + dim * n * 4 + P * 8,
        "ema": P * (dim * 4 + 8) + 3 * dim * n * 4 + 2 * n * 4,
        "tv": 3 * dens_bytes,
        "adam": 7 * param_bytes,
    }
    bound_flops = {
        # the rgbnet and the projection forward and backward (6 a
        # multiply-add), and the codebook distances and their argmin
        "fwd_bwd": 6 * P * (mlp_macs(params["rgbnet"])
                            + mlp_macs(params["k0_vq"]["project"]))
        + argmin_flops,
        "vq_argmin": argmin_flops,
        "ema": P * dim + 5 * dim * n,
        "tv": 0, "adam": 0,
    }
    bound, bound_by = bounds_of(bound_bytes, bound_flops)
    bound["step"] = sum(bound[k] for k in ("fwd_bwd", "ema", "tv", "adam"))
    rec["step"] = dict(step_ms=step_ms, split_ms=split, split_bound_ms=bound,
                       split_bound_bytes=bound_bytes,
                       split_bound_flops=bound_flops, split_bound_by=bound_by,
                       rows=P, code_dim=dim, params=param_bytes // 4)
    log(f"  (a) step at {ft.N_rand} rays ({P} rows against {n} codes of "
        f"{dim}): {step_ms:.2f} ms (CUDA events, median of 5; bound "
        f"{bound['step']:.3g}); " + ", ".join(
            f"{k} {v:.4g} ms (bound {bound[k]:.4g}, by {bound_by[k]})"
            for k, v in split.items()))
    rec["step"]["profile"] = profile_call(
        lambda: st(params, buffers, opt, bt, lrs, None, noise, apply_tv=True,
                   tv_dense=True), "DirectQVGO step", top=8)
    del params, buffers, opt, grads, rows, idx, st, bt
    torch.cuda.empty_cache()

    rec.update(vq_tiny_runs(basedir))
    return rec


def vq_tiny_runs(basedir, devices=("cuda", "cpu")) -> dict:
    """Phase 18 (a): the tiny CPU-test scene as DirectQVGO for 10 steps on
    each of ``devices``: the per-step losses within ``TINY_TOL``, every VQ
    index that differs between the two runs a near-tie (its two distances,
    in float64 on the second run's rows, within ``VQ_TIE_REL``)."""
    import torch
    from fourk_nerf_torch.ops import vq
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import trainer

    nearest = vq.nearest_code
    tiny, calls = {}, {}
    over = tiny_scene.OVERRIDES
    tiny_vq = {**over,
               "fine_train": {**over["fine_train"], "pg_scale": []},
               "fine_model_and_render": {**over["fine_model_and_render"],
                                         "mode_type": "adain_vq"}}
    rec = {"tiny_overrides": tiny_vq}
    for name in devices:
        tcfg = load_over(FERN_CFG, basedir, f"tiny_vq_{name}", tiny_vq)
        w, log_calls = Recorder(), []

        def spy_all(rows, embed, log_calls=log_calls):
            got = nearest(rows, embed)
            log_calls.append((rows.detach().cpu(), embed.cpu(), got.cpu()))
            return got

        vq.nearest_code = spy_all
        try:
            trainer.train(run_args({"args": dict(i_print=1, i_val=0,
                                                 i_weights=0)}, seed=0),
                          tcfg, tiny_scene.scene(), writer=w,
                          device=torch.device(name))
        finally:
            vq.nearest_code = nearest
        tiny[name], calls[name] = np.array(w.values("train/loss")), log_calls
    a, b = devices
    rel = float(np.max(np.abs(tiny[a] - tiny[b]) / tiny[b]))
    flips, worst = 0, 0.0
    for (_, _, ia), (rows_c, emb_c, ib) in zip(calls[a], calls[b]):
        diff = torch.nonzero(ia != ib)[:, 0]
        flips += int(diff.numel())
        if diff.numel():
            f = rows_c[diff].double()
            e = emb_c.double()
            d = (f ** 2).sum(1, keepdim=True) - 2 * f @ e \
                + (e ** 2).sum(0, keepdim=True)
            da = d.gather(1, ia[diff][:, None])[:, 0]
            db = d.gather(1, ib[diff][:, None])[:, 0]
            gap = ((da - db).abs() / torch.maximum(da.abs(), db.abs())
                   .clamp_min(1e-30)).max()
            worst = max(worst, float(gap))
    rec.update(tiny_loss_max_rel_diff=rel, tiny_vq_calls=len(calls[b]),
               tiny_vq_rows=int(sum(c[0].shape[0] for c in calls[b])),
               tiny_vq_flips=flips, tiny_vq_flip_max_rel_gap=worst)
    log(f"  (a) tiny scene, {len(tiny[b])} steps: per-step loss {a} vs "
        f"{b} max rel {rel:.3e} (limit {TINY_TOL:.0e}); VQ index flips "
        f"{flips} of {rec['tiny_vq_rows']} rows (each a near-tie: the two "
        f"distances within {worst:.2e} relative, limit {VQ_TIE_REL:.0e})")
    if len(tiny[b]) != 10 or not rel <= TINY_TOL \
            or len(calls[a]) != len(calls[b]) \
            or not worst <= VQ_TIE_REL:
        raise AssertionError("the tiny DirectQVGO run differs between cuda "
                             "and cpu")
    return rec


def tensorf_step_parts(model_mod, mcfg, ft, params, buffers, batch, rk,
                       noise, n_samples: int) -> dict:
    """A TensoRF training step at full width by parts (CUDA events, median
    of 5): forward + backward, the factors' TV, MaskedAdam, each beside
    its bound, the larger of its bytes and its FP32 operations. Bytes: a
    sample reads 4 corners of each of three planes and 2 of each of three
    vectors, of both grids' ranks, forward and again for the scatter
    backward, over ``n_samples`` samples; the dense factor gradients
    written; TV reading the factors, writing and adding their gradient;
    Adam reading p, g, m, v and writing p, m, v. Operations: the rgbnet
    and the k0 fusion product on the samples, forward and backward (6 a
    multiply-add)."""
    from fourk_nerf_torch.train import optim, trainer
    lrs = {k: optim.group_lr(v, 10, ft.lrate_decay) for k, v in
           optim.build_group_lrs(ft, params).items()}
    skip = frozenset(ft.skip_zero_grad_fields)
    st = trainer.TrainStep(model_mod, mcfg, ft, render_kwargs=rk,
                           skip_zero_grad=skip)
    opt = optim.init_state(params)
    apply_tv = ft.weight_tv_density > 0 or ft.weight_tv_k0 > 0

    def step():
        st(params, buffers, opt, batch, lrs, None, noise, apply_tv=apply_tv,
           tv_dense=True)

    full = event_ms(step)
    _, _, grads = st.loss_and_grads(params, buffers, batch, lrs.keys(),
                                    noise)
    split = {"fwd_bwd": event_ms(lambda: st.loss_and_grads(
                 params, buffers, batch, lrs.keys(), noise)),
             "adam": event_ms(lambda: optim.apply_updates(
                 params, grads, opt, lrs, skip_zero_grad=skip))}
    if apply_tv:
        split["tv"] = event_ms(lambda: st.add_tv(params, grads,
                                                 int(batch[0].shape[0]),
                                                 True))
    del grads
    ranks = sum(params[g]["x_vec"].shape[1] for g in ("density", "k0"))
    fac_bytes = tree_bytes({g: params[g] for g in ("density", "k0")})
    param_bytes = tree_bytes(params)
    C = params["k0"]["f_vec"].shape[1]
    fuse = params["k0"]["f_vec"].shape[0] * C
    bound_bytes = {"fwd_bwd": 2 * n_samples * 18 * ranks * 4 + fac_bytes,
                   "adam": 7 * param_bytes, "tv": 3 * fac_bytes}
    bound_flops = {"fwd_bwd": 6 * n_samples * (
        mlp_macs(params.get("rgbnet", {})) + fuse), "adam": 0, "tv": 0}
    if not apply_tv:
        del bound_bytes["tv"], bound_flops["tv"]
    bound, bound_by = bounds_of(bound_bytes, bound_flops)
    bound["step"] = sum(bound.values())
    return dict(step_ms=full, split_ms=split, split_bound_ms=bound,
                split_bound_bytes=bound_bytes, split_bound_flops=bound_flops,
                split_bound_by=bound_by, samples=n_samples,
                rays=int(batch[0].shape[0]), params=param_bytes // 4)


def secondary_tensorf(dev, data, bdata, basedir, launches):
    """Phase 18 (b): TensoRF grids in DirectMPIGO (phase 13's views, all
    five grid sizes) and in DirectVoxGO (phase 16's views, coarse dense
    then fine TensoRF). Returns its record."""
    import torch
    from fourk_nerf_torch.models import dmpigo, dvgo
    from fourk_nerf_torch.ops import cuda_box, cuda_sweep, tensorf
    from fourk_nerf_torch.train import checkpoints, trainer

    rec: dict = {"grids": TENSORF_GRIDS}
    resized = [0]
    resize = tensorf.tensorf_resize

    def counted(*a, **k):
        resized[0] += 1
        return resize(*a, **k)

    # --- DirectMPIGO, fern pretrain, 60 steps through five grid sizes --------
    over = {"fine_model_and_render": TENSORF_GRIDS,
            "fine_train": TRAIN_OVERRIDES["fine_train"],
            "args": TRAIN_OVERRIDES["args"]}
    cfg = load_over(FERN_CFG, basedir, "tensorf_mpi", over)
    args = run_args(over)
    writer = Recorder()
    torch.cuda.reset_peak_memory_stats()
    cuda_sweep.sweep.launches = 0
    tensorf.tensorf_resize = counted
    t0 = time.perf_counter()
    try:
        _, mcfg, params, buffers = trainer.train(args, cfg, data,
                                                 writer=writer, device=dev)
    finally:
        tensorf.tensorf_resize = resize
    sync()
    train_s = time.perf_counter() - t0
    launches["tensorf_mpi_i_val"] = cuda_sweep.sweep.launches
    losses = writer.values("train/loss")
    X, Y, Z = mcfg.world_size
    shapes_ok = all(tuple(params[g]["xy_plane"].shape[:2]) == (X, Y)
                    and tuple(params[g]["xz_plane"].shape[:2]) == (X, Z)
                    and params[g]["z_vec"].shape[0] == Z
                    for g in ("density", "k0"))
    mpi = dict(config=FERN_CFG, overrides=over, world_size=[X, Y, Z],
               train_s=train_s, losses=losses,
               val_psnr=writer.values("val/psnr"), resizes=resized[0],
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    log(f"  (b) DirectMPIGO with TensoRF grids (ranks "
        f"{TENSORF_GRIDS['density_config']['n_comp']} / "
        f"{TENSORF_GRIDS['k0_config']['n_comp']}): "
        f"{cfg.fine_train.N_iters} steps in {train_s:.1f} s (host clock): "
        f"world size {mcfg.world_size}, {resized[0]} factor resizes; loss "
        f"at each print {['%.5g' % x for x in losses]}; val psnr "
        f"{mpi['val_psnr']}; sweep launches "
        f"{launches['tensorf_mpi_i_val']}")
    n_scale = len(cfg.fine_train.pg_scale)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and resized[0] == 2 * n_scale and shapes_ok
            and int(np.prod(mcfg.world_size))
            > 0.9 * cfg.fine_model_and_render.num_voxels
            and len(mpi["val_psnr"]) == 1
            and launches["tensorf_mpi_i_val"] == 0):
        raise AssertionError(f"the TensoRF DirectMPIGO run: {mpi}")
    check_finite(params, "TensoRF DirectMPIGO")
    kw, p2, b2, opt2, step2, _ = checkpoints.load_checkpoint(
        os.path.join(basedir, "tensorf_mpi", "fine_last.npz"), device=dev)
    flat_a = checkpoints.tree_to_flat_dict(params)
    flat_b = checkpoints.tree_to_flat_dict(p2)
    if not (dmpigo.make_config(**kw) == mcfg
            and step2 == cfg.fine_train.N_iters
            and set(flat_a) == set(flat_b)
            and all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)
            and torch.equal(b2["mask_cache"], buffers["mask_cache"])):
        raise AssertionError("the TensoRF checkpoint does not round-trip")
    del p2, b2, opt2
    ft = cfg.fine_train
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "rand_bkgd": True,
          "stepsize": 1.0, "ndc_planes": True}
    flat, _ = trainer.gather_training_rays(cfg, ft, data, dev)
    bt = trainer.gather_batch(flat, *trainer.make_batch_sampler(
        "flatten", flat, ft.N_rand, 777)(3))
    del flat
    noise = trainer.bkgd_noise(777, 1, ft.N_rand, dev)
    mpi["step"] = tensorf_step_parts(dmpigo, mcfg, ft, params, buffers, bt,
                                     rk, noise,
                                     ft.N_rand * mcfg.n_samples(1.0))
    r = mpi["step"]
    log(f"  (b) DirectMPIGO TensoRF step at {r['rays']} rays: "
        f"{r['step_ms']:.2f} ms (bound {r['split_bound_ms']['step']:.3g}); "
        + ", ".join(f"{k} {v:.4g} ms (bound {r['split_bound_ms'][k]:.4g}, "
                    f"by {r['split_bound_by'][k]})"
                    for k, v in r["split_ms"].items()))
    rec["mpi"] = mpi
    del params, buffers, bt
    torch.cuda.empty_cache()

    # --- DirectVoxGO: syn_default, coarse dense, fine TensoRF ----------------
    cfg = load_over(SYN_CFG, basedir, "tensorf_vox", TENSORF_BOUNDED)
    args = run_args(TENSORF_BOUNDED)
    writer = Recorder()
    cuda_box.sweep_box.launches = 0
    resized[0] = 0
    tensorf.tensorf_resize = counted
    t0 = time.perf_counter()
    try:
        _, mcfg, params, buffers = trainer.train(args, cfg, bdata,
                                                 writer=writer, device=dev)
    finally:
        tensorf.tensorf_resize = resize
    sync()
    train_s = time.perf_counter() - t0
    launches["tensorf_vox_i_val"] = cuda_box.sweep_box.launches
    losses = writer.values("train/loss")
    n_c = cfg.coarse_train.N_iters // args.i_print
    n_box = cfg.coarse_train.N_iters // args.i_val * len(bdata["i_val"])
    vox = dict(config=SYN_CFG, overrides=TENSORF_BOUNDED,
               world_size=list(mcfg.world_size), train_s=train_s,
               coarse_losses=losses[:n_c], fine_losses=losses[n_c:],
               val_psnr=writer.values("val/psnr"), resizes=resized[0],
               coarse_i_val_box_launches=n_box)
    log(f"  (b) DirectVoxGO coarse {cfg.coarse_train.N_iters} (dense) + fine"
        f" {cfg.fine_train.N_iters} (TensoRF) steps in {train_s:.1f} s: fine "
        f"world size {mcfg.world_size}, {resized[0]} factor resizes; fine "
        f"loss at each print {['%.5g' % x for x in losses[n_c:]]}; val psnr"
        f" (coarse, fine) {vox['val_psnr']}; box launches "
        f"{launches['tensorf_vox_i_val']} (the coarse i_val renders: "
        f"{n_box})")
    fine = losses[n_c:]
    if not (all(np.isfinite(losses)) and fine[-1] < fine[0]
            and resized[0] == 2 * len(cfg.fine_train.pg_scale)
            and int(np.prod(mcfg.world_size))
            > 0.9 * cfg.fine_model_and_render.num_voxels
            and launches["tensorf_vox_i_val"] == n_box
            and len(vox["val_psnr"]) == n_box // len(bdata["i_val"]) + 1):
        raise AssertionError(f"the TensoRF DirectVoxGO run: {vox}")
    check_finite(params, "TensoRF DirectVoxGO")
    _, p2, _, _, _, _ = checkpoints.load_checkpoint(
        os.path.join(basedir, "tensorf_vox", "fine_last.npz"), device=dev)
    flat_a = checkpoints.tree_to_flat_dict(params)
    flat_b = checkpoints.tree_to_flat_dict(p2)
    if not all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a):
        raise AssertionError("the TensoRF DirectVoxGO checkpoint does not "
                             "round-trip")
    del p2
    ft = cfg.fine_train
    rk = {"near": float(bdata["near"]), "far": float(bdata["far"]),
          "bg": 1.0, "rand_bkgd": False, "stepsize": 0.5}
    flat, _ = trainer.gather_training_rays(
        cfg, type(ft)({**ft, "ray_sampler": "flatten"}), bdata, dev)
    bt = trainer.gather_batch(flat, *trainer.make_batch_sampler(
        "flatten", flat, ft.N_rand, 777)(3))
    del flat
    n_valid = valid_samples(mcfg, buffers, bt[0], bt[1], rk["stepsize"],
                            rk["near"])
    vox["step"] = tensorf_step_parts(dvgo, mcfg, ft, params, buffers, bt, rk,
                                     None, n_valid)
    r = vox["step"]
    log(f"  (b) DirectVoxGO TensoRF step at {r['rays']} rays ({n_valid} "
        f"valid samples): {r['step_ms']:.2f} ms (bound "
        f"{r['split_bound_ms']['step']:.3g}); " + ", ".join(
            f"{k} {v:.4g} ms (bound {r['split_bound_ms'][k]:.4g}, by "
            f"{r['split_bound_by'][k]})" for k, v in r["split_ms"].items()))
    rec["vox"] = vox
    del params, buffers, bt
    torch.cuda.empty_cache()
    return rec


def secondary_dbvgo(dev, bdata):
    """Phase 18 (c): DirectBiVoxGO at 160^3 a field on phase 16's views,
    one 8192-ray batch forward and backward. Returns its record."""
    import torch
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.models import dbvgo
    from fourk_nerf_torch.ops import render
    from fourk_nerf_torch.train import trainer

    G = DBVGO_G
    cfg = dbvgo.make_config(xyz_min=[-1.2] * 3, xyz_max=[1.2] * 3,
                            num_voxels=G ** 3, num_voxels_base=G ** 3,
                            alpha_init=1e-2, rgbnet_dim=12, rgbnet_width=128,
                            viewbase_pe=4, fast_color_thres=1e-4)
    params, buffers = dbvgo.init(
        cfg, generator=torch.Generator().manual_seed(0), device=dev)
    flags = ConfigDict(dict(data=dict(ndc=False, inverse_y=False,
                                      flip_x=False, flip_y=False)))
    flat, _ = trainer.gather_training_rays(
        flags, ConfigDict(dict(ray_sampler="flatten")), bdata, dev)
    ro, rd, vd, target = trainer.gather_batch(
        flat, *trainer.make_batch_sampler("flatten", flat, DBVGO_RAYS,
                                          777)(0))
    del flat
    leaves = [params[f][g] for f in ("fg", "bg") for g in ("density", "k0")]

    def fwd_bwd(bg=1.0):
        for v in leaves:
            v.requires_grad_(True)
        out = dbvgo.forward(cfg, params, buffers, ro, rd, vd, stepsize=0.5,
                            bg=bg)
        loss = ((out["rgb_marched"] - target) ** 2).mean()
        grads = torch.autograd.grad(loss, leaves)
        for v in leaves:
            v.requires_grad_(False)
        return out, loss, grads

    torch.cuda.reset_peak_memory_stats()
    out, loss, grads = fwd_bwd()
    sync()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        out0 = dbvgo.forward(cfg, params, buffers, ro, rd, vd, stepsize=0.5,
                             bg=0.0)
    # the constant background enters through the product of the two
    # fields' transmittances: rgb(bg=1) - rgb(bg=0) is alphainv_last
    out = {k: v.detach() if isinstance(v, torch.Tensor) else v
           for k, v in out.items()}
    comp_err = float((out["rgb_marched"] - out0["rgb_marched"]
                      - out["alphainv_last"][:, None]).abs().max())
    prod_err = float((out["alphainv_last"] - out["alphainv_last_fg"]
                      * out["alphainv_last_bg"]).abs().max())
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    ms = event_ms(fwd_bwd)
    # the samples: the foreground's in the cube, the background's all
    mn = torch.tensor(cfg.xyz_min, device=dev)
    mx = torch.tensor(cfg.xyz_max, device=dev)
    center = torch.tensor(cfg.scene_center, device=dev)
    radius = torch.tensor(cfg.scene_radius, device=dev)
    _, valid, _ = render.sample_pts_on_rays_fixed(
        (ro - center) / radius, rd / rd.norm(dim=-1, keepdim=True), mn, mx,
        0.0, 2 * np.sqrt(3), 0.5 * cfg.voxel_size, cfg.n_samples_fg(0.5))
    n_fg = int(valid.sum())
    n_bg = DBVGO_RAYS * cfg.n_samples_bg(0.5)
    param_bytes = tree_bytes(params)
    macs = mlp_macs(params["fg"]["rgbnet"])
    bound_bytes = {"fwd_bwd": 2 * (n_fg + n_bg) * 8 * (1 + cfg.k0_dim) * 4
                   + param_bytes}
    bound_flops = {"fwd_bwd": 6 * macs * (n_fg + n_bg)}
    bound, bound_by = bounds_of(bound_bytes, bound_flops)
    rec = dict(world_size=list(cfg.world_size), rays=DBVGO_RAYS,
               samples_fg=DBVGO_RAYS * cfg.n_samples_fg(0.5),
               samples_bg=n_bg, valid_fg=n_fg, loss=loss.item(),
               composite_max_abs=comp_err, product_max_abs=prod_err,
               fwd_bwd_ms=ms, bound_ms=bound["fwd_bwd"],
               bound_by=bound_by["fwd_bwd"], bound_bytes=bound_bytes,
               bound_flops=bound_flops, max_memory_allocated_bytes=peak)
    log(f"  (c) DirectBiVoxGO {cfg.world_size} a field, {DBVGO_RAYS} rays "
        f"({rec['samples_fg']} fg samples, {n_fg} in the cube, {n_bg} bg): "
        f"loss {rec['loss']:.5g}, fg-over-bg: rgb(bg=1) - rgb(bg=0) vs "
        f"alphainv_last {comp_err:.2e}, alphainv_last vs the fields' product"
        f" {prod_err:.2e}; forward + backward {ms:.2f} ms (CUDA events, "
        f"median of 5; bound {bound['fwd_bwd']:.3g} ms by "
        f"{bound_by['fwd_bwd']}); peak memory {peak / 2**30:.2f} GiB")
    if not (finite and comp_err <= 1e-5 and prod_err <= 1e-6):
        raise AssertionError(f"DirectBiVoxGO: {rec}")
    rec["cuda_vs_cpu"] = secondary_cuda_vs_cpu(dev)
    return rec


def secondary_cuda_vs_cpu(dev):
    """Phase 18 (c): the tiny DirectBiVoxGO and TensoRF DirectMPIGO /
    DirectVoxGO of ``tools/device_parity.py`` on the card against the CPU,
    as ``tests/test_torch_gpu.py`` holds them: the background samples
    within 4.8e-7 (4 ulps), outputs 1e-4, gradients 1e-4 of each leaf's
    largest entry."""
    import torch
    from fourk_nerf_torch.tools import device_parity
    cpu = torch.device("cpu")
    rec = {"dbvgo_bg_samples_max_abs": device_parity.dbvgo_bg_samples(dev)}
    for name, case in (("dbvgo", device_parity.dbvgo_case()),
                       ("tensorf_dmpigo", device_parity.tensorf_case(
                           "dmpigo")),
                       ("tensorf_dvgo", device_parity.tensorf_case("dvgo"))):
        res = device_parity.compare((cpu, dev), *case)
        rec[name] = {"out_max_abs": max(res["out_diff"].values()),
                     "grad_max_rel": max(res["grad_rel"])}
    log("  (c) cuda vs cpu, the tiny models of tools/device_parity.py: "
        + ", ".join(f"{k} {v}" for k, v in rec.items()))
    if not (rec["dbvgo_bg_samples_max_abs"] <= 4.8e-7 and all(
            v["out_max_abs"] <= 1e-4 and v["grad_max_rel"] <= 1e-4
            for k, v in rec.items() if isinstance(v, dict))):
        raise AssertionError(f"a secondary model moves between the card "
                             f"and the CPU: {rec}")
    return rec


def secondary_stylegan(dev):
    """Phase 18 (d): the StyleGAN-heritage ops on the card against the same
    ops on CPU copies of their inputs. Returns its record."""
    import torch
    from fourk_nerf_torch.ops import stylegan as sg

    rng = np.random.default_rng(0)
    rec: dict = {}
    x_np = rng.normal(size=STYLEGAN_SHAPE).astype(np.float32)
    b_np = rng.normal(size=STYLEGAN_SHAPE[1]).astype(np.float32)
    x, b = (torch.as_tensor(a, device=dev) for a in (x_np, b_np))
    xc, bc = torch.as_tensor(x_np), torch.as_tensor(b_np)
    f, fc = (sg.setup_filter([1, 3, 3, 1], device=d) for d in (dev, "cpu"))
    ops = {
        "upsample2d": lambda x, b, f: sg.upsample2d(x, f),
        "downsample2d": lambda x, b, f: sg.downsample2d(x, f),
        "filtered_lrelu": lambda x, b, f: sg.filtered_lrelu(
            x, f, f, b, padding=3, clamp=256.0),
    }
    for act in ("linear", "relu", "lrelu", "tanh", "sigmoid", "elu", "selu",
                "softplus", "swish"):
        ops[f"bias_act_{act}"] = functools.partial(
            lambda x, b, f, act: sg.bias_act(x, b, act=act), act=act)
    for name, fn in ops.items():
        got = fn(x, b, f)
        want = fn(xc, bc, fc)
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        rec[name] = {"shape": list(got.shape), "max_abs_err": err,
                     "ms": event_ms(lambda fn=fn: fn(x, b, f))}
        if tuple(got.shape) != tuple(want.shape) or not err <= 1e-5 * max(
                scale, 1.0):
            raise AssertionError(f"{name}: card vs cpu {err} (scale {scale})")
    log("  (d) " + ", ".join(f"{k} {v['ms']:.3f} ms (err {v['max_abs_err']:.1e})"
                             for k, v in rec.items()))
    del x, xc
    # the hash grid at its defaults: 16 levels of 2^19 entries, 2 features
    xyz_np = rng.uniform(0, 1, (HASH_POINTS, 3)).astype(np.float32)
    table_c = sg.init_hash_table(generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    xyz, table = torch.as_tensor(xyz_np, device=dev), table_c.to(dev)
    xyzc = torch.as_tensor(xyz_np)
    T = table.shape[1]
    mism = 0
    for lvl in range(16):
        res = int(np.floor(16 * 1.3819129 ** lvl))
        for corner in ((0, 0, 0), (1, 1, 1), (1, 0, 1)):
            c = torch.tensor(corner)
            ia = sg.hash_index(torch.floor(xyz * res).long() + c.to(dev), T)
            ib = sg.hash_index(torch.floor(xyzc * res).long() + c, T)
            mism += int((ia.cpu() != ib).sum())
    enc = sg.hash_encode(xyz, table)
    enc_c = sg.hash_encode(xyzc, table_c)
    err = float((enc.cpu() - enc_c).abs().max())
    rec["hash_encode"] = {"points": HASH_POINTS, "index_mismatches": mism,
                          "max_abs_err": err, "scale": float(enc_c.abs().max()),
                          "ms": event_ms(lambda: sg.hash_encode(xyz, table))}
    log(f"  (d) hash_encode {HASH_POINTS} points: index mismatches {mism}, "
        f"max abs err {err:.1e} (entries up to "
        f"{rec['hash_encode']['scale']:.1e}), "
        f"{rec['hash_encode']['ms']:.2f} ms")
    if mism or not err <= 1e-5 * rec["hash_encode"]["scale"]:
        raise AssertionError("hash_encode differs between the card and the "
                             "cpu")
    del xyz, table, xyzc, table_c, enc, enc_c
    # top-p: a flip is allowed only where a sample sits on the p boundary
    w_np = (rng.uniform(size=TOPP_SHAPE) ** 4).astype(np.float32)
    w, wc = torch.as_tensor(w_np, device=dev), torch.as_tensor(w_np)
    got, want = sg.topp_masking(w, 0.99).cpu(), sg.topp_masking(wc, 0.99)
    flips = torch.nonzero(got != want).tolist()
    margin = 0.0
    for r, c in flips:
        # the weight before the flipped sample, against p of the total
        row = w_np[r].astype(np.float64)
        ahead = row[row > row[c]].sum()
        margin = max(margin, abs(ahead - 0.99 * row.sum()) / row.sum())
    rec["topp_masking"] = {"shape": list(TOPP_SHAPE),
                           "flips": len(flips),
                           "flip_max_margin": margin,
                           "ms": event_ms(lambda: sg.topp_masking(w, 0.99))}
    log(f"  (d) topp_masking {TOPP_SHAPE}: {len(flips)} flips "
        f"(each within {margin:.1e} of the p boundary), "
        f"{rec['topp_masking']['ms']:.3f} ms")
    if not margin <= 1e-5:
        raise AssertionError("topp_masking differs between the card and the "
                             "cpu away from the p boundary")
    return rec


def run_secondary(dev, anchor):
    """Phase 18 (see the module docstring). ``anchor``: phase 13's views.
    Returns the ``secondary`` record and the launch counts of its paths."""
    import shutil

    import torch
    from fourk_nerf_torch.ops import cuda_box

    t_phase = time.perf_counter()
    basedir = os.path.join(HERE, "build", "phase18_secondary")
    shutil.rmtree(basedir, ignore_errors=True)
    launches: dict = {}
    rec: dict = {}
    t0 = time.perf_counter()
    rec["vq"] = secondary_vq(dev, anchor, basedir, launches)
    rec["vq"]["part_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    cuda_box.sweep_box.launches = 0
    bdata = bounded_views(dev)
    sync()
    launches["teacher"] = cuda_box.sweep_box.launches
    if launches["teacher"] != BOUNDED_VIEWS:
        raise AssertionError(f"teacher views: {launches['teacher']} box "
                             "launches")
    t0 = time.perf_counter()
    rec["tensorf"] = secondary_tensorf(dev, anchor, bdata, basedir, launches)
    rec["tensorf"]["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["dbvgo"] = secondary_dbvgo(dev, bdata)
    rec["dbvgo"]["part_s"] = time.perf_counter() - t0
    del bdata
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["stylegan"] = secondary_stylegan(dev)
    rec["stylegan"]["part_s"] = time.perf_counter() - t0
    shutil.rmtree(basedir)
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 18: {rec['phase_s']:.1f} s (parts "
        + ", ".join(f"{k} {rec[k]['part_s']:.1f} s" for k in
                    ("vq", "tensorf", "dbvgo", "stylegan")) + ")")
    return rec, launches


class Tee:
    """Writes to stdout and keeps the lines that hold ``key`` (the
    trainer's plan lines)."""

    def __init__(self, key: str):
        self.key, self.lines, self.out = key, [], sys.stdout

    def write(self, s):
        self.lines += [line for line in s.splitlines() if self.key in line]
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def tiny_tolerance(runs: dict, what: str) -> float:
    """The largest relative difference of the per-step losses of a tiny
    run on the card and on the CPU; fails above ``TINY_TOL``."""
    rel = float(np.max(np.abs(runs["cuda"] - runs["cpu"]) / runs["cpu"]))
    log(f"  {what}: {len(runs['cpu'])} steps, per-step loss cuda vs cpu max "
        f"rel {rel:.3e} (limit {TINY_TOL:.0e})")
    if len(runs["cpu"]) != 10 or not rel <= TINY_TOL:
        raise AssertionError(f"{what} differs between cuda and cpu")
    return rel


def last_dim_rend(dev, anchor, basedir, launches):
    """Phase 19 (a): DirectMPIGO with ``dim_rend`` 8 on phase 13's views at
    full width (see the module docstring). Returns its record."""
    import types

    import torch
    from fourk_nerf_torch import pipeline, run as run_mod, run_sr, weights
    from fourk_nerf_torch.models import dmpigo
    from fourk_nerf_torch.ops import cuda_sweep
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import checkpoints, trainer

    log(f"  (a) deviation from the published config: {DIM_REND_DEVIATION}")
    rec: dict = {"config": FERN_CFG, "overrides": DIM_REND_OVERRIDES,
                 "deviation": DIM_REND_DEVIATION}
    cfg = load_over(FERN_CFG, basedir, "dim_rend", DIM_REND_OVERRIDES)
    drawn = []
    init = dmpigo.init

    def recording_init(*a, **kw):  # the rend layer the run starts from
        params, buffers = init(*a, **kw)
        drawn.append({k: v.clone() for k, v in params["rend_layer"].items()})
        return params, buffers

    writer = Recorder()
    torch.cuda.reset_peak_memory_stats()
    cuda_sweep.sweep.launches = 0
    dmpigo.init = recording_init
    t0 = time.perf_counter()
    try:
        _, mcfg, params, buffers = trainer.train(
            run_args(DIM_REND_OVERRIDES), cfg, anchor, writer=writer,
            device=dev)
    finally:
        dmpigo.init = init
    sync()
    rec["train_s"] = time.perf_counter() - t0
    launches["dim_rend_i_val"] = cuda_sweep.sweep.launches
    losses = writer.values("train/loss")
    frozen = len(drawn) == 1 and all(
        torch.equal(params["rend_layer"][k], v) for k, v in drawn[0].items())
    rec.update(world_size=list(mcfg.world_size), losses=losses,
               val_psnr=writer.values("val/psnr"), rend_layer_frozen=frozen,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    log(f"  (a) dim_rend {mcfg.dim_rend}: {cfg.fine_train.N_iters} steps in "
        f"{rec['train_s']:.1f} s (host clock), world size {mcfg.world_size};"
        f" loss at each print {['%.5g' % x for x in losses]}; val psnr "
        f"{rec['val_psnr']} ({launches['dim_rend_i_val']} sweep launches); "
        f"rend layer unchanged: {frozen}; peak memory "
        f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and frozen
            and launches["dim_rend_i_val"] == 0):
        raise AssertionError(f"the dim_rend run: {rec}")
    check_finite(params, "dim_rend params")

    # held-out views: chunked, counted; then --render_only from the file
    rk = {"near": 0.0, "far": 1.0, "bg": 0.0, "stepsize": 1.0}
    gt = [anchor["images"][i] for i in anchor["i_test"]]
    cuda_sweep.sweep.launches = 0
    t0 = time.perf_counter()
    res = trainer.render_viewpoints(
        dmpigo, mcfg, params, buffers, anchor["poses"][anchor["i_test"]],
        anchor["HW"][anchor["i_test"]], anchor["Ks"][anchor["i_test"]],
        data=trainer.DataFlags(ndc=True), render_kwargs=rk, gt_imgs=gt,
        eval_ssim=False, device=dev)
    sync()
    rec["chunked_frame_s"] = (time.perf_counter() - t0) / len(gt)
    args = run_mod.config_parser().parse_args(
        ["--config", os.path.join(HERE, FERN_CFG), "--device", dev.type,
         "--render_only", "--render_test"])
    again = run_mod.run(args, cfg, anchor)["test"]
    sync()
    launches["dim_rend_test"] = cuda_sweep.sweep.launches
    same = all(torch.equal(a, b) for a, b in zip(res["rgbs"], again["rgbs"]))
    rec.update(test_psnr=res["psnrs"], test_path=res["path"],
               render_only_path=again["path"], render_only_bitwise=same)
    h, w = (int(v) for v in anchor["HW"][0])
    log(f"  (a) held-out psnr {res['psnrs']} through the {res['path']} "
        f"forward ({rec['chunked_frame_s']:.2f} s a {w}x{h} frame, host "
        f"clock); --render_only {again['path']}, bitwise: {same}; sweep "
        f"launches {launches['dim_rend_test']}")
    if not (res["path"] == again["path"] == "chunked" and same
            and launches["dim_rend_test"] == 0):
        raise AssertionError("the dim_rend held-out renders")
    del res, again

    # the 4K frame and the joint trainer refuse the model up front
    refused = {}
    sr = weights.sftnet_init(num_block=1, seed=3, device=dev)
    try:
        pipeline.FramePipeline(mcfg, params, buffers, sr, device=dev)
    except ValueError as e:
        refused["FramePipeline"] = str(e)[:60]
    jcfg = load_over(os.path.join("fourk_nerf_torch", "configs", "llff",
                                  "fern_lg_joint_l1.py"), basedir,
                     "dim_rend_joint", {"fine_model_and_render": {
                         "dim_rend": DIM_REND}})
    try:
        run_sr.run(run_sr.config_parser().parse_args(
            ["--config", "c.py", "--device", dev.type]), jcfg, anchor)
    except ValueError as e:
        refused["run_sr"] = str(e)[:60]
    rec["refused"] = refused
    log(f"  (a) refused up front: {refused}")
    if set(refused) != {"FramePipeline", "run_sr"}:
        raise AssertionError("a dim_rend 8 model was not refused")
    del params, buffers, sr
    torch.cuda.empty_cache()

    # the tiny CPU-test scene on the card and on the CPU
    tiny = {}
    for name in ("cuda", "cpu"):
        tcfg = tiny_scene.apply_overrides(load_over(
            FERN_CFG, basedir, f"tiny_{name}", {}), basedir, f"tiny_{name}")
        tcfg.fine_model_and_render.dim_rend = DIM_REND
        w = Recorder()
        trainer.train(types.SimpleNamespace(
            seed=0, no_reload=True, no_reload_optimizer=False, ft_path="",
            i_print=1, i_val=0, i_weights=0), tcfg, tiny_scene.scene(),
            writer=w, device=torch.device(name))
        tiny[name] = np.array(w.values("train/loss"))
    rec["tiny_loss_max_rel_diff"] = tiny_tolerance(tiny, "(a) tiny dim_rend "
                                                   "run")
    return rec


def tiny_patch_box_cfg(basedir, expname):
    """``syn_default`` cut to the tiny bounded scene for ``patch_box``: no
    coarse stage, 10 fine steps at 28^3 with a pg_scale step at 5, N_rand
    64 (8x8 patches), as ``tests/test_torch_box_train.py`` runs it."""
    from fourk_nerf_torch.tools import tiny_scene
    over = {k: v for k, v in tiny_scene.BOUNDED_OVERRIDES.items()
            if k.endswith("model_and_render")}
    cfg = load_over(SYN_CFG, basedir, expname, over)
    cfg.fine_model_and_render.update(num_voxels=28 ** 3,
                                     num_voxels_base=28 ** 3)
    cfg.coarse_train.N_iters = 0
    cfg.fine_train.update(N_iters=10, N_rand=64, pg_scale=[5],
                          ray_sampler="patch_box")
    return cfg


def last_patch_box(dev, basedir, launches, bounded):
    """Phase 19 (b): ``patch_box`` in both stages of ``syn_default`` on
    phase 16's views at full width (see the module docstring).
    ``bounded``: phase 16's record, beside which the numbers go. Returns
    its record."""
    import contextlib
    import types

    import torch
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.ops import box_sweep, cuda_box
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import losses as losses_mod, optim, trainer

    rec: dict = {"config": SYN_CFG, "overrides": PATCH_BOX_OVERRIDES,
                 "deviation": BOUNDED_DEVIATION}
    cuda_box.sweep_box.launches = 0
    data = bounded_views(dev)
    sync()
    launches["patch_box_teacher"] = cuda_box.sweep_box.launches
    cfg = load_over(SYN_CFG, basedir, "patch_box", PATCH_BOX_OVERRIDES)
    args = run_args(PATCH_BOX_OVERRIDES)
    writer, tee = Recorder(), Tee("patch_box")
    torch.cuda.reset_peak_memory_stats()
    cuda_box.sweep_box.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        _, mcfg, params, buffers = trainer.train(args, cfg, data,
                                                 writer=writer, device=dev)
    sync()
    rec["train_s"] = time.perf_counter() - t0
    launches["patch_box_i_val"] = cuda_box.sweep_box.launches
    losses = writer.values("train/loss")
    n_c = cfg.coarse_train.N_iters // args.i_print
    plans = [line.split("): ", 1)[1] for line in tee.lines
             if "slab-sweep ON" in line or "-> gather" in line]
    routes = [line.split("): ", 1)[1] for line in tee.lines
              if "patch_box steps" in line]
    rec.update(coarse_losses=losses[:n_c], fine_losses=losses[n_c:],
               plans=plans, routes=routes,
               val_psnr=writer.values("val/psnr"),
               world_size=list(mcfg.world_size),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    log(f"  (b) coarse {cfg.coarse_train.N_iters} + fine "
        f"{cfg.fine_train.N_iters} patch_box steps in {rec['train_s']:.1f} s "
        f"(host clock, plans, eval renders and saves included): fine world "
        f"size {mcfg.world_size}; steps by route {rec['routes']}; loss at "
        f"each print coarse {['%.5g' % x for x in losses[:n_c]]}, fine "
        f"{['%.5g' % x for x in losses[n_c:]]}; val psnr {rec['val_psnr']} "
        f"({launches['patch_box_i_val']} box launches); peak memory "
        f"{rec['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    for line in plans:
        log(f"  (b) plan: {line}")
    n_plans = 1 + len(cfg.coarse_train.pg_scale) + 1 + len(
        cfg.fine_train.pg_scale)
    # a print averages 10 patches of another content each, most of them
    # background: the coarse stage's second half of prints against its
    # first (40 prints), and the val renders, which see whole views, rise
    halves = [float(np.mean(x[:len(x) // 2])), float(np.mean(
        x[len(x) // 2:]))] if (x := losses[:n_c]) else []
    rec["coarse_loss_halves"] = halves
    val = rec["val_psnr"]
    n_val = sum(c.N_iters // args.i_val for c in (cfg.coarse_train,
                                                   cfg.fine_train))
    slab = [int(r.split("steps: ")[1].split(" slab")[0]) for r in routes]
    if not (len(plans) == n_plans and all(np.isfinite(losses))
            and halves[1] < halves[0] and val[-1] > val[0] + 1.0
            and len(slab) == 2 and min(slab) > 0
            and launches["patch_box_i_val"] == n_val * len(data["i_val"])):
        raise AssertionError(f"the patch_box run: {rec}")
    check_finite(params, "patch_box params")

    # the held-out views through the box kernel, beside phase 16's
    rk = {"near": 2.0, "far": 6.0, "bg": 1.0, "stepsize": 0.5}
    gt = [data["images"][i] for i in data["i_test"]]
    cuda_box.sweep_box.launches = 0
    res = trainer.render_viewpoints(
        dvgo, mcfg, params, buffers, data["poses"][data["i_test"]],
        data["HW"][data["i_test"]], data["Ks"][data["i_test"]],
        data=trainer.DataFlags(), render_kwargs=rk, gt_imgs=gt,
        eval_ssim=False, device=dev)
    sync()
    launches["patch_box_test"] = cuda_box.sweep_box.launches
    white = [float(-10 * np.log10(np.mean((1.0 - g) ** 2))) for g in gt]
    rec.update(test_psnr=res["psnrs"], white_psnr=white,
               phase16_test_psnr=bounded.get("test_psnr"))
    log(f"  (b) held-out psnr {res['psnrs']} (phase 16, gathers: "
        f"{bounded.get('test_psnr')}; a white frame {white}); "
        f"{launches['patch_box_test']} box launches")
    if not (res["path"] == "box" and np.mean(res["psnrs"]) > np.mean(white)
            + 1.0):
        raise AssertionError("the patch_box model's held-out views")
    del res

    # one patch at the final params: the slab forward against the gather
    ft = cfg.fine_train
    flat, _ = trainer.gather_training_rays(cfg, ft, data, dev)
    sample = trainer.make_batch_sampler("patch_box", flat, ft.N_rand, 777)
    kind, sel = sample(3)
    batch = trainer.gather_batch(flat, kind, sel, sample.patch)
    # this patch's own plan and window: at the final grid the stage's
    # window over every patch may pass the cap (the gather route)
    axis, flip, S = box_sweep.box_train_plan(
        mcfg, flat["rays_o"][sel[0]], flat["rays_d"][sel[0]], stepsize=0.5,
        near=2.0)
    Pu, Pv = box_sweep.box_window_size_for(
        mcfg, *batch[:3], stepsize=0.5, near=2.0, axis=axis, flip=flip,
        cap=max(mcfg.world_size))
    train_cfg = ConfigDict(dict(weight_main=1.0, weight_entropy_last=1e-3,
                                weight_distortion=0.01, weight_rgbper=0.01,
                                weight_nearclip=0.0))
    keys = ("density", "k0")

    def loss_grads(fwd):
        p = {**params, **{k: params[k].detach().requires_grad_(True)
                          for k in keys}}
        loss = losses_mod.encoder_losses(fwd(p), batch[3], train_cfg,
                                         batch[0].shape[0])[0]
        return loss.item(), torch.autograd.grad(loss, [p[k] for k in keys])

    l_ref, g_ref = loss_grads(lambda p: dvgo.forward(
        mcfg, p, buffers, *batch[:3], stepsize=0.5, near=2.0, far=1e9,
        bg=1.0, is_train=True))
    st: dict = {}
    l_box, g_box = loss_grads(lambda p: box_sweep.sweep_rays_train_box(
        mcfg, p, buffers, *batch[:3], stepsize=0.5, near=2.0, bg=1.0,
        axis=axis, flip=flip, S=S, Pu=Pu, Pv=Pv, use_bf16=False, stats=st))
    g_err = [float((a - b).abs().max()) for a, b in zip(g_ref, g_box)]
    rec["slab_vs_gather"] = dict(
        rays=int(batch[0].shape[0]), plan=[axis, flip, S], window=[Pu, Pv],
        loss_gather=l_ref, loss_slab=l_box, grad_max_abs=g_err,
        grad_max=[float(a.abs().max()) for a in g_ref], **st)
    log(f"  (b) one {sample.patch}x{sample.patch} patch at the final params,"
        f" plan {(axis, flip, S)}, window {(Pu, Pv)}, {st}: loss slab "
        f"{l_box:.7g} vs gather {l_ref:.7g}; gradient max abs difference "
        f"{g_err} (limits: loss 1e-5 relative, gradients 5e-5, the JAX "
        "package's test_box_train.py)")
    if not (abs(l_box - l_ref) <= 1e-5 * abs(l_ref)
            and max(g_err) <= 5e-5):
        raise AssertionError("the slab forward disagrees with the gather "
                             "forward")
    del g_ref, g_box

    # the fine step at full width: forward + backward and MaskedAdam
    lrs = {k: optim.group_lr(v, 10, ft.lrate_decay) for k, v in
           optim.build_group_lrs(ft, params).items()}
    skip = frozenset(ft.skip_zero_grad_fields)
    step_for = trainer.make_box_train_steps(
        dvgo, mcfg, ft, render_kwargs={**rk, "rand_bkgd": False},
        skip_zero_grad=skip, Pu=Pu, Pv=Pv)
    step = step_for(axis, flip, S)
    opt = optim.init_state(params)
    torch.cuda.reset_peak_memory_stats()
    full = event_ms(lambda: step(params, buffers, opt, batch, lrs, None,
                                 None, apply_tv=False, tv_dense=False))
    peak = torch.cuda.max_memory_allocated()
    _, _, grads = step.loss_and_grads(params, buffers, batch, lrs.keys())
    split = {"fwd_bwd": event_ms(lambda: step.loss_and_grads(
                 params, buffers, batch, lrs.keys())),
             "adam": event_ms(lambda: optim.apply_updates(
                 params, grads, opt, lrs, skip_zero_grad=skip))}
    st = {}
    box_sweep.sweep_rays_train_box(
        mcfg, params, buffers, *batch[:3], stepsize=0.5, near=2.0, bg=1.0,
        axis=axis, flip=flip, S=S, Pu=Pu, Pv=Pv, stats=st)
    param_bytes = tree_bytes(params)
    bound_bytes = {"fwd_bwd": 2 * st["samples"] * 8 * (1 + mcfg.k0_dim) * 4
                   + param_bytes, "adam": 7 * param_bytes}
    bound_flops = {"fwd_bwd": 6 * mlp_macs(params["rgbnet"])
                   * st["mlp_samples"], "adam": 0}
    bound, bound_by = bounds_of(bound_bytes, bound_flops)
    gather_ms = bounded["fine_step"]["step_ms"]
    rec["fine_step"] = dict(
        step_ms=full, split_ms=split, split_bound_ms=bound,
        split_bound_by=bound_by, split_bound_bytes=bound_bytes,
        split_bound_flops=bound_flops, rays=int(batch[0].shape[0]),
        params=param_bytes // 4, max_memory_allocated_bytes=peak,
        phase16_gather_step_ms=gather_ms,
        phase16_gather_rays=bounded["fine_step"]["rays"], **st)
    log(f"  (b) fine step at {mcfg.world_size}, {batch[0].shape[0]} rays, "
        f"{st['slots']} slots, {st['samples']} samples, {st['mlp_samples']}"
        f" weighted: {full:.2f} ms (CUDA events, median of 5; phase 16's "
        f"gather step on {bounded['fine_step']['rays']} rays "
        f"{gather_ms:.2f} ms); "
        + ", ".join(f"{k} {v:.4g} ms (bound {bound[k]:.4g}, by "
                    f"{bound_by[k]})" for k, v in split.items())
        + f"; peak memory {peak / 2**30:.2f} GiB")
    rec["fine_step"]["profile"] = profile_call(
        lambda: step(params, buffers, opt, batch, lrs, None, None,
                     apply_tv=False, tv_dense=False), "patch_box fine step",
        top=10)
    del flat, grads, opt, params, buffers, data
    torch.cuda.empty_cache()

    # the tiny CPU-test scene on the card and on the CPU
    tiny = {}
    for name in ("cuda", "cpu"):
        w = Recorder()
        trainer.train(types.SimpleNamespace(
            seed=777, no_reload=True, no_reload_optimizer=False, ft_path="",
            i_print=1, i_val=0, i_weights=0), tiny_patch_box_cfg(
            basedir, f"tiny_{name}"), tiny_scene.bounded_scene(
            h=32, w=32, n_train=3, n_val=1, n_test=1), writer=w,
            device=torch.device(name))
        tiny[name] = np.array(w.values("train/loss"))
    rec["tiny_loss_max_rel_diff"] = tiny_tolerance(tiny, "(b) tiny patch_box"
                                                   " run")
    return rec


def last_parallel(dev, syn, sr_model, launches):
    """Phase 19 (c): ``parallel/`` in a world of one rank on NCCL (see the
    module docstring). ``syn``: phase 4's synthetic frame record, whose
    encoder output phase 11 crops. Returns its record."""
    import socket

    import torch
    import torch.distributed as dist
    from fourk_nerf_torch.models import sr_esrnet
    from fourk_nerf_torch.ops import box_sweep, cuda_box, cuda_sr
    from fourk_nerf_torch.parallel import mesh as pm
    from fourk_nerf_torch.utils import misc

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    rec: dict = {}
    try:
        rec["initialized"] = pm.maybe_initialize_distributed(True)
        rec["backend"] = dist.get_backend()
        mesh = pm.make_mesh()
        rec["mesh"] = [list(mesh.shape), mesh.device_type]
        red = pm.all_reduce_dict(mesh, {"loss": 0.25, "psnr": torch.tensor(
            [31.5], device=dev)})
        rec["all_reduce"] = {k: float(v) for k, v in red.items()}

        # the tiled decode over the data axis, the dense-block kernel
        ch, cw, ts, tp = 189, 252, 96, 10
        img = syn["rgb_feature"][None, :ch, :cw]
        cond = syn["depth"][None, :ch, :cw, None]
        prep = cuda_sr.prepare_sftnet(sr_model)

        def apply_fn(x, c):
            return cuda_sr.sftnet_apply_cuda(prep, x, c, upchain="dilated")

        cuda_sr.rdb_apply.launches = 0
        sharded = sr_esrnet.tile_process_sharded(apply_fn, img, cond, ts,
                                                 mesh, tile_pad=tp)
        sync()
        launches["tile_sharded_rdb"] = cuda_sr.rdb_apply.launches
        plain = sr_esrnet.tile_process(apply_fn, img, cond, ts, tile_pad=tp)
        n_tiles = -(-ch // ts) * -(-cw // ts)
        rec["tile"] = dict(crop=[cw, ch], tile=ts, tiles=n_tiles,
                           bitwise=bool(torch.equal(sharded, plain)),
                           rdb_launches=launches["tile_sharded_rdb"])

        # a fly-through frame over the data axis, the box kernel
        cfg, params, buffers = box_synthetic(dev)
        K, c2w = box_camera(BOX_HW), box_pose(0.1)
        kw = dict(stepsize=BOX_RENDER["stepsize"], near=BOX_RENDER["near"],
                  bg=BOX_RENDER["bg"], device=dev)
        cuda_box.sweep_box.launches = 0
        got = box_sweep.render_frame_box(cfg, params, buffers, BOX_HW,
                                         BOX_HW, K, c2w, tile_mesh=mesh, **kw)
        sync()
        launches["tile_mesh_box"] = cuda_box.sweep_box.launches
        want = cuda_box.render_frame_box_cuda(cfg, params, buffers, BOX_HW,
                                              BOX_HW, K, c2w, **kw)
        rec["box"] = dict(frame=BOX_HW, box_launches=launches[
            "tile_mesh_box"], bitwise=all(torch.equal(got[k], want[k])
                                          for k in want))

        # the grids split along X over grid, and whole again
        sh = pm.shard_grid_params(mesh, params)
        rec["shard_roundtrip"] = all(
            torch.equal(sh[k].full_tensor(), params[k])
            for k in ("density", "k0"))
        misc.check_replica_consistency(sh)
        rec["replica_check"] = "passed"
        del sh, params, buffers, got, want, sharded, plain
        dist.destroy_process_group()
        rec["destroyed"] = not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"  (c) world of 1 rank: {rec}")
    if not (rec["initialized"] and rec["backend"] == "nccl"
            and rec["mesh"] == [[1, 1], "cuda"]
            and rec["all_reduce"] == {"loss": 0.25, "psnr": 31.5}
            and rec["tile"]["bitwise"]
            and launches["tile_sharded_rdb"] == 15 * n_tiles
            and rec["box"]["bitwise"] and launches["tile_mesh_box"] == 1
            and rec["shard_roundtrip"] and rec["destroyed"]):
        raise AssertionError(f"parallel/ at world size 1: {rec}")

    t0 = time.perf_counter()
    rc, tail, err = multihost_run(dev, {**env, "MASTER_PORT": str(port + 1)})
    rec["multihost_s"] = time.perf_counter() - t0
    rec["multihost"] = tail
    for line in tail:
        log(f"  (c) --multihost: {line}")
    if rc != 0 or not any(f"multihost world 1 {rec['backend']}" in line
                          for line in tail):
        raise AssertionError(f"run --multihost: rc {rc}\n{err}")
    return rec


def multihost_run(dev, env):
    """``run.run`` with the CLI's ``--multihost`` on the tiny scene (10
    steps of ``tiny_scene.OVERRIDES``) in a process of its own under the
    ``torchrun`` environment ``env``. Returns (exit code, its log lines
    that tell the world and the steps, the end of its output)."""
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "from fourk_nerf_torch import run\n"
        "from fourk_nerf_torch.config import load_config\n"
        "from fourk_nerf_torch.tools import tiny_scene\n"
        "import torch.distributed as dist\n"
        "args = run.config_parser().parse_args(sys.argv[1:])\n"
        "cfg = tiny_scene.apply_overrides(load_config(args.config), %r)\n"
        "run.run(args, cfg, tiny_scene.scene())\n"
        "print('multihost world', dist.get_world_size(), dist.get_backend())\n"
        "dist.destroy_process_group()\n" % (HERE, os.path.join(
            HERE, "build", "phase19_multihost")))
    out = subprocess.run(
        [sys.executable, "-c", script, "--config",
         os.path.join(HERE, FERN_CFG), "--multihost", "--device", dev.type,
         "--i_print", "5", "--i_val", "0", "--i_weights", "0"],
        env={**os.environ, **env}, capture_output=True, text=True,
        timeout=300)
    tail = [line for line in out.stdout.splitlines()
            if "initialized" in line or "iter" in line or "world" in line]
    return out.returncode, tail, (out.stdout[-2000:] + out.stderr[-2000:])


def run_last_modules(dev, anchor, syn, sr_model, bounded):
    """Phase 19 (see the module docstring). Returns its record and the
    launch counts of its paths."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    basedir = os.path.join(HERE, "build", "phase19_last")
    shutil.rmtree(basedir, ignore_errors=True)
    launches: dict = {}
    rec: dict = {}
    for name, fn in (
            ("dim_rend", lambda: last_dim_rend(dev, anchor, basedir,
                                               launches)),
            ("patch_box", lambda: last_patch_box(dev, basedir, launches,
                                                 bounded)),
            ("parallel", lambda: last_parallel(dev, syn, sr_model,
                                               launches))):
        t0 = time.perf_counter()
        rec[name] = fn()
        rec[name]["part_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    shutil.rmtree(basedir)
    shutil.rmtree(os.path.join(HERE, "build", "phase19_multihost"),
                  ignore_errors=True)
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 19: {rec['phase_s']:.1f} s (parts "
        + ", ".join(f"{k} {rec[k]['part_s']:.1f} s" for k in
                    ("dim_rend", "patch_box", "parallel")) + ")")
    log(json.dumps({"completion": rec}))
    return rec, launches


def run_probes(dev):
    """Phase 12: both probe suites as their users run them, counted."""
    from fourk_nerf_torch.tools import probe_floor, probe_ops
    out = {}
    for name, mod in (("probe_floor", probe_floor), ("probe_ops", probe_ops)):
        mod.run.launches = 0
        res = mod.run(device=dev)
        sync()
        n = mod.run.launches
        for line in mod.report(res):
            log("  " + line)
        if n != res["launches"]:
            raise AssertionError(f"{name}: {n} launches counted, a run "
                                 f"makes {res['launches']}")
        t_bytes = res["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = res["bf16_flop"] / BF16_FLOPS * 1e3 \
            + res.get("f32_flop", 0.0) / FP32_FLOPS * 1e3
        out[name] = dict(
            launches=n, ms=sum(p["ms"] for p in res["probes"].values()),
            err=max(p["max_abs_err"] if "max_abs_err" in p else p["max_err"]
                    for p in res["probes"].values()),
            plain_ms=res["plain_ms"], library_ms=res["library_ms"],
            bound=max(t_bytes, t_ops),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"  {name}: {n} launches, all probes {out[name]['ms']:.3f} ms, "
            f"their torch expressions {res['plain_ms']:.1f} ms, library "
            f"calls {res['library_ms']:.3f} ms, bound "
            f"{out[name]['bound']:.4f} ms (bytes {t_bytes:.4f} ms, operations "
            f"{t_ops:.4f} ms)")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "fourk_nerf_torch")):
        print("chip_smoke: the fourk_nerf_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from fourk_nerf_torch import weights

    regs = phase_build()
    phase_sweep_small(dev)
    sr_model = weights.sftnet_init(num_block=5, seed=1, device=dev)
    phase_rdb_small(dev, sr_model)

    log("[4] 4K frame, synthetic fern-scale scene")
    syn = run_frame("synthetic", *fern_synthetic(dev), sr_model, dev,
                    regs["sweep"])
    torch.cuda.empty_cache()

    log(f"[5] 4K frame, trained anchor "
        f"{os.path.relpath(weights.ANCHOR_ASSET, HERE)}")
    anc = run_frame("anchor", *weights.load_anchor(device=dev), sr_model, dev,
                    regs["sweep"])
    log(f"  anchor asset: {os.path.basename(weights.ANCHOR_ASSET)}, sweep "
        f"{anc['sweep_ms']:.3f} ms, bound {anc['sweep_bound']:.3f} ms")
    del anc
    torch.cuda.empty_cache()

    phase_box_small(dev)
    phase_rrdb_small(dev, sr_model)
    log(f"[8] bounded-scene fly-through, {BOX_FRAMES} frames of "
        f"{BOX_HW}x{BOX_HW}, fuse_rrdb")
    fly = run_flythrough(dev, regs["box"])
    torch.cuda.empty_cache()

    phase_uptail_small(dev, sr_model)
    log("[10] 4K decode with the fused upsample tail, synthetic frame")
    tail = run_fused_tail(dev, sr_model, syn)
    torch.cuda.empty_cache()
    log("[12] probes")
    probes = run_probes(dev)
    log("[13] encoder training at full width, fern pretrain config")
    training, pre = run_training(dev)
    torch.cuda.empty_cache()
    log("[14] joint encoder + SR training at full width, fern joint L1 "
        "config, then its 4K frame")
    joint, joint_launches = run_joint(dev, pre)
    torch.cuda.empty_cache()
    log("[15] joint GAN + perceptual training at full width, fern joint "
        "L1+GAN config, then its 4K frame; the scale-1 GAN config")
    joint_gan, gan_launches = run_joint_gan(dev, pre)
    anchor = {k: v for k, v in pre["data"].items()
              if k not in ("srgt", "w2c")}  # phase 18 trains on them again
    del pre
    torch.cuda.empty_cache()
    log("[16] the bounded-scene path at full width: syn_default coarse -> "
        "fine, --export_coarse_only, --render_only, the chair joint config "
        "with --ftdvcoa_path, then its served frame")
    bounded, bounded_launches = run_bounded(dev)
    torch.cuda.empty_cache()
    log("[17] the unbounded-inward path at full width: syn_default as "
        "DirectContractedVoxGO, --render_only, the tiny run on both devices")
    unbounded, unbounded_launches = run_unbounded(dev)
    torch.cuda.empty_cache()
    log("[18] the secondary models at full width: DirectQVGO (adain_vq), "
        "TensoRF grids in DirectMPIGO and DirectVoxGO, DirectBiVoxGO, the "
        "StyleGAN-heritage ops")
    secondary, secondary_launches = run_secondary(dev, anchor)
    torch.cuda.empty_cache()
    log("[19] the last modules at full width: DirectMPIGO with dim_rend 8, "
        "patch_box in syn_default, parallel/ at world size 1 on NCCL")
    _, last_launches = run_last_modules(dev, anchor, syn, sr_model,
                                        bounded)
    del anchor
    torch.cuda.empty_cache()

    kernels = [
        {"name": "sweep", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/sweep.cu",
         "replaces": "fourk_nerf_tpu/ops/pallas_sweep.py:614",
         "launches": syn["launches"]["sweep"],
         "max_abs_err": syn["sweep_err"], "ms": syn["sweep_ms"],
         "plain_ms": syn["plain_sweep_ms"], "bound_ms": syn["sweep_bound"],
         "bound_by": syn["sweep_bound_by"], "library_ms": None,
         "registers": syn["sweep_registers"],
         "launches_joint": {"i_val": joint_launches["i_val"],
                            "serve": joint_launches["serve"]["sweep"]},
         "launches_joint_gan": {"i_val": gan_launches["i_val"],
                                "serve": gan_launches["serve"]["sweep"]},
         "launches_secondary": {k: secondary_launches[k] for k in (
             "vq_i_val", "vq_render_only", "tensorf_mpi_i_val")},
         "launches_last": {k: last_launches[k] for k in (
             "dim_rend_i_val", "dim_rend_test")}},
        {"name": "rdb", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/rdb.cu",
         "replaces": "fourk_nerf_tpu/ops/pallas_sr.py:481",
         "launches": syn["launches"]["rdb"],
         "max_abs_err": syn["rdb_err"], "ms": syn["rdb_ms"],
         "plain_ms": syn["rdb_plain_ms"], "bound_ms": syn["rdb_bound"],
         "bound_by": syn["rdb_bound_by"], "library_ms": None,
         "conv_chain_ms": syn["conv_chain_ms"],
         "launches_joint": {"serve": joint_launches["serve"]["rdb"]},
         "launches_joint_gan": {"serve": gan_launches["serve"]["rdb"]},
         "launches_bounded": {"serve": bounded_launches["serve"]["rdb"]},
         "launches_last": {"tile_sharded": last_launches[
             "tile_sharded_rdb"]}},
        # library_ms is null for the sweep, the dense block, the box sweep
        # and the RRDB: no single PyTorch call computes any of them
        # (conv_chain_ms: the block's five convs alone as cuDNN calls)
        {"name": "box", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/box.cu",
         "replaces": "fourk_nerf_tpu/ops/pallas_box.py:533",
         "launches": fly["launches"]["box"],
         "max_abs_err": fly["box_err"], "ms": fly["box_ms"],
         "plain_ms": fly["box_plain_ms"], "bound_ms": fly["box_bound"],
         "bound_by": fly["box_bound_by"], "library_ms": None,
         "registers": fly["box_registers"], "samples": fly["box_samples"],
         "launches_bounded": {k: bounded_launches[k] for k in (
             "teacher", "i_val", "render_only", "joint_i_val")}
         | {"serve": bounded_launches["serve"]["box"]},
         "launches_unbounded": unbounded_launches,
         "launches_secondary": {k: secondary_launches[k] for k in (
             "teacher", "tensorf_vox_i_val")},
         "launches_last": {k: last_launches[k] for k in (
             "patch_box_teacher", "patch_box_i_val", "patch_box_test",
             "tile_mesh_box")}},
        {"name": "rrdb", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/rrdb.cu",
         "replaces": "fourk_nerf_tpu/ops/pallas_sr.py:428",
         "launches": fly["launches"]["rrdb"],
         "max_abs_err": fly["rrdb_err"], "ms": fly["rrdb_ms"],
         "plain_ms": fly["rrdb_plain_ms"], "bound_ms": fly["rrdb_bound"],
         "bound_by": fly["rrdb_bound_by"], "library_ms": None},
        # library_ms: the three library convs the fused tail replaces
        {"name": "uptail", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/uptail.cu",
         "replaces": "fourk_nerf_tpu/ops/pallas_sr.py:812",
         "launches": tail["launches"]["uptail"],
         "max_abs_err": tail["uptail_err"], "ms": tail["uptail_ms"],
         "plain_ms": tail["uptail_plain_ms"], "bound_ms": tail["uptail_bound"],
         "bound_by": tail["uptail_bound_by"],
         "library_ms": tail["uptail_library_ms"],
         "tflops": tail["uptail_tflops"],
         "tflops_issued": tail["uptail_tflops_issued"]},
        # ms: a pretrain step's sparse TV + masked Adam of the density and
        # k0 grids, four launches on one step's gradients; bound_ms: the
        # gradient read twice, the touched entries' bytes; no library call
        # computes either stage
        {"name": "grid_update", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/grid_update.cu",
         "replaces": None,
         "launches": training["grid_update_launches"],
         "max_abs_err": training["grid_update"]["max_abs_err"],
         "ms": training["grid_update"]["step_ms"],
         "plain_ms": training["grid_update"]["step_plain_ms"],
         "bound_ms": training["grid_update"]["step_bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "by_stage_ms": training["grid_update"]["ms"]},
        # the probes: ms is the sum over a suite's kernels, one launch each.
        # library_ms: for the floor probes the window product through
        # torch.mm (the loops and the copy ring have no library call), for
        # the construct probes the sum of the six constructs as torch calls
        {"name": "probe_floor", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/probe_floor.cu",
         "replaces": "tools/perf/probe_floor.py:45",
         "launches": probes["probe_floor"]["launches"],
         "max_abs_err": probes["probe_floor"]["err"],
         "ms": probes["probe_floor"]["ms"],
         "plain_ms": probes["probe_floor"]["plain_ms"],
         "bound_ms": probes["probe_floor"]["bound"],
         "bound_by": probes["probe_floor"]["bound_by"],
         "library_ms": probes["probe_floor"]["library_ms"]},
        {"name": "probe_ops", "route": "cuda",
         "source": "fourk_nerf_torch/csrc/probe_ops.cu",
         "replaces": "tools/perf/probe_mosaic.py:18",
         "launches": probes["probe_ops"]["launches"],
         "max_abs_err": probes["probe_ops"]["err"],
         "ms": probes["probe_ops"]["ms"],
         "plain_ms": probes["probe_ops"]["plain_ms"],
         "bound_ms": probes["probe_ops"]["bound"],
         "bound_by": probes["probe_ops"]["bound_by"],
         "library_ms": probes["probe_ops"]["library_ms"]},
    ]
    log(json.dumps({"training": training}))
    log(json.dumps({"joint": joint}))
    log(json.dumps({"joint_gan": joint_gan}))
    log(json.dumps({"bounded": bounded}))
    log(json.dumps({"unbounded": unbounded}))
    log(json.dumps({"secondary": secondary}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
