"""VC-Encoder pretraining CLI of the port (the JAX package's root ``run.py``,
after frozoul/4K-NeRF run.py):

    python -m fourk_nerf_torch.run \
        --config fourk_nerf_torch/configs/llff/fern_lg_pretrain.py --render_test

Trains the fine stage of a forward-facing scene on the card (``--device
cpu`` for the plain versions of the kernels), then renders what the flags
ask for. :func:`main` is :func:`load_everything` then :func:`run`; a
caller with a scene in memory calls :func:`run` with its ``data_dict``.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from fourk_nerf_torch.device import fp32_precision, resolve_device


def config_parser():
    """The flags of the JAX package's ``run.py`` (frozoul/4K-NeRF
    run.py:22-63), and ``--device``."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--config", required=True, help="config file path")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--no_reload", action="store_true")
    p.add_argument("--no_reload_optimizer", action="store_true")
    p.add_argument("--ft_path", type=str, default="")
    p.add_argument("--export_bbox_and_cams_only", type=str, default="")
    p.add_argument("--export_coarse_only", type=str, default="")
    # testing options
    p.add_argument("--render_only", action="store_true")
    p.add_argument("--render_test", action="store_true")
    p.add_argument("--render_train", action="store_true")
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--render_video_flipy", action="store_true")
    p.add_argument("--render_video_rot90", default=0, type=int)
    p.add_argument("--render_video_factor", type=float, default=0)
    p.add_argument("--dump_images", action="store_true")
    p.add_argument("--eval_ssim", action="store_true")
    p.add_argument("--eval_lpips_alex", action="store_true")
    p.add_argument("--eval_lpips_vgg", action="store_true")
    # logging / saving
    p.add_argument("--i_print", type=int, default=500)
    p.add_argument("--i_val", type=int, default=1000)
    p.add_argument("--i_weights", type=int, default=100000)
    # distributed
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training (not ported yet)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu (the kernels' plain versions)")
    return p


def seed_everything(seed: int):
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def load_everything(args, cfg):
    """The dataset's ``data_dict``, trimmed to what training and rendering
    read (frozoul/4K-NeRF run.py:183-206)."""
    from fourk_nerf_torch.data import load_data

    data_dict = load_data(cfg.data)
    kept = {"hwf", "HW", "Ks", "near", "far", "near_clip", "i_train", "i_val",
            "i_test", "irregular_shape", "poses", "render_poses", "images"}
    if cfg.data.load_sr:
        kept |= {"srgt", "w2c"}
    return {k: v for k, v in data_dict.items() if k in kept}


def _write_images(outdir: str, rgbs) -> None:
    import imageio.v2 as imageio  # only dumping images needs it

    from fourk_nerf_torch.utils.metrics import to8b

    for i, rgb in enumerate(rgbs):
        imageio.imwrite(os.path.join(outdir, f"{i:03d}.png"),
                        to8b(rgb.cpu().numpy()))


@fp32_precision()
def run(args, cfg, data_dict) -> dict:
    """Train (or reload) and render on ``args.device``, in full float32
    (no TF32). Returns the ``render_viewpoints`` results by split name
    ("test", "train", "video")."""
    from fourk_nerf_torch.train import checkpoints, trainer
    from fourk_nerf_torch.utils.logging import ScalarWriter, dump_provenance

    if args.multihost:
        raise NotImplementedError("--multihost is not ported yet: ROADMAP.md "
                                  "Queue A item 6 (parallel/)")
    if args.export_coarse_only:
        raise NotImplementedError("--export_coarse_only is not ported yet: "
                                  "ROADMAP.md Queue A item 2 (the coarse "
                                  "stage)")
    dev = resolve_device(args.device)
    rundir = os.path.join(cfg.basedir, cfg.expname)
    dump_provenance(cfg, args, rundir)
    writer = ScalarWriter(os.path.join(rundir, "tb"))
    try:
        if args.export_bbox_and_cams_only:
            xyz_min, xyz_max = trainer.compute_bbox_by_cam_frustrm(
                cfg, data_dict["HW"], data_dict["Ks"], data_dict["poses"],
                data_dict["i_train"], data_dict["near"], data_dict["far"],
                near_clip=data_dict.get("near_clip"), device=dev)
            np.savez_compressed(
                args.export_bbox_and_cams_only, xyz_min=xyz_min,
                xyz_max=xyz_max,
                cam_lst=np.asarray(data_dict["poses"][data_dict["i_train"]]))
            return {}

        if not args.render_only:
            model_mod, model_cfg, params, buffers = trainer.train(
                args, cfg, data_dict, writer=writer, device=dev)
        else:
            model_mod = trainer._select_model_mod(cfg)
            ckpt = args.ft_path or os.path.join(rundir, "fine_last.npz")
            kwargs, params, buffers, *_ = checkpoints.load_checkpoint(
                ckpt, device=dev)
            model_cfg = model_mod.make_config(**kwargs)

        data = trainer.DataFlags.from_config(cfg.data)
        render_kwargs = {
            "near": float(data_dict["near"]), "far": float(data_dict["far"]),
            "bg": 1.0 if cfg.data.white_bkgd else 0.0,
            "stepsize": float(cfg.fine_model_and_render.stepsize)}
        results = {}

        def render_split(idx, name):
            outdir = os.path.join(rundir, f"render_{name}")
            os.makedirs(outdir, exist_ok=True)
            res = trainer.render_viewpoints(
                model_mod, model_cfg, params, buffers,
                data_dict["poses"][idx], data_dict["HW"][idx],
                data_dict["Ks"][idx], data=data, render_kwargs=render_kwargs,
                gt_imgs=[np.asarray(data_dict["images"][i]) for i in idx],
                eval_ssim=args.eval_ssim, eval_lpips_vgg=args.eval_lpips_vgg,
                eval_lpips_alex=args.eval_lpips_alex, device=dev)
            if args.dump_images:
                _write_images(outdir, res["rgbs"])
            results[name] = res

        if args.render_test:
            render_split(data_dict["i_test"], "test")
        if args.render_train:
            render_split(data_dict["i_train"], "train")
        if args.render_video:
            outdir = os.path.join(rundir, "render_video")
            os.makedirs(outdir, exist_ok=True)
            n = len(data_dict["render_poses"])
            res = trainer.render_viewpoints(
                model_mod, model_cfg, params, buffers,
                np.asarray(data_dict["render_poses"]),
                np.tile(data_dict["HW"][0][None], (n, 1)),
                np.tile(data_dict["Ks"][0][None], (n, 1, 1)),
                data=data, render_kwargs=render_kwargs,
                render_factor=args.render_video_factor,
                render_video_flipy=args.render_video_flipy,
                render_video_rot90=args.render_video_rot90, device=dev)
            results["video"] = res
            try:
                import imageio.v2 as imageio

                from fourk_nerf_torch.utils.metrics import to8b

                imageio.mimwrite(os.path.join(outdir, "video.rgb.mp4"),
                                 to8b(res["rgbs"].cpu().numpy()), fps=30,
                                 quality=8)
            except (ImportError, ValueError, RuntimeError) as e:
                print(f"video write skipped: {e}")  # no mp4 writer here
    finally:
        writer.close()
    print("done")
    return results


def main(argv=None) -> dict:
    args = config_parser().parse_args(argv)
    from fourk_nerf_torch.config import load_config

    cfg = load_config(args.config)
    seed_everything(args.seed)
    resolve_device(args.device)  # no card: fail before reading the data
    return run(args, cfg, load_everything(args, cfg))


if __name__ == "__main__":
    main()
