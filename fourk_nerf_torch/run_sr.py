"""Joint 4K training CLI of the port (the JAX package's root ``run_sr.py``,
after frozoul/4K-NeRF run_sr.py):

    python -m fourk_nerf_torch.run_sr \
        --config fourk_nerf_torch/configs/llff/fern_lg_joint_l1.py \
        --ftdv_path <the pretrain's fine_last.npz>

Trains the encoder and the SR generator jointly on the card (``--device
cpu`` for the plain versions of the kernels), or, with ``--render_only``,
reloads a joint checkpoint; then scores the test views (``--render_test``)
and renders the fly-through at 4K (``--render_video``: the sweep kernel,
then the dense-block kernel per RRDB block, or the whole-RRDB kernel
under ``FOURK_SR_FUSE_RRDB=1`` with ``FOURK_SR_FUSE_RRDB_ACK=1``; the
upchain from ``FOURK_SR_UPCHAIN``, ``dilated`` by default). :func:`main` is
:func:`load_everything` then :func:`run`; a caller with a scene in memory
calls :func:`run` with its ``data_dict``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from fourk_nerf_torch.device import fp32_precision, resolve_device
from fourk_nerf_torch.run import load_everything, seed_everything


def config_parser():
    """The flags of the JAX package's ``run_sr.py`` (frozoul/4K-NeRF
    run_sr.py:20-71), and ``--device``. As there, ``--eval_lpips_alex`` is
    parsed and unused: the scored views take LPIPS (vgg) with
    ``--eval_lpips_vgg``."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--no_reload", action="store_true")
    p.add_argument("--no_reload_optimizer", action="store_true")
    p.add_argument("--ft_path", type=str, default="")
    p.add_argument("--ftdv_path", type=str, default="",
                   help="pretrained encoder checkpoint")
    p.add_argument("--ftdvcoa_path", type=str, default="",
                   help="coarse encoder checkpoint")
    p.add_argument("--ftsr_path", type=str, default="",
                   help="SR generator init (.pth)")
    p.add_argument("--sr_path", type=str, default="",
                   help="SR generator for --render_only")
    p.add_argument("--test_tile", type=int, default=0,
                   help="tile size of the 4K decode (e.g. 510)")
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


def video_decode_options() -> dict:
    """The fly-through decode's variant from the environment, as the JAX
    package's ``run_sr.py`` reads it: ``FOURK_SR_FUSE_RRDB=1`` (with
    ``FOURK_SR_FUSE_RRDB_ACK=1``) for one kernel launch per RRDB,
    ``FOURK_SR_UPCHAIN`` for the upsampling form."""
    fuse = os.environ.get("FOURK_SR_FUSE_RRDB") == "1"
    if fuse and os.environ.get("FOURK_SR_FUSE_RRDB_ACK") != "1":
        raise SystemExit("refusing FOURK_SR_FUSE_RRDB=1 without "
                         "FOURK_SR_FUSE_RRDB_ACK=1")
    upchain = os.environ.get("FOURK_SR_UPCHAIN", "dilated")
    if upchain not in ("materialized", "dilated"):
        raise SystemExit("FOURK_SR_UPCHAIN must be 'materialized' or "
                         f"'dilated', got {upchain!r}")
    return {"fuse_rrdb": fuse, "upchain": upchain}


def _imageio():
    """``imageio.v2``: ``--dump_images`` and ``--render_video`` write with
    it, so ``run`` asks for it before it trains."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise SystemExit("--dump_images and --render_video write with "
                         "imageio, which is not installed") from e
    return imageio


def _write_png(path: str, img) -> None:
    from fourk_nerf_torch.utils.metrics import to8b
    _imageio().imwrite(path, to8b(img))


def _write_video(outdir: str, frames) -> None:
    """``video.sr.mp4``, or PNG frames where no mp4 writer is installed."""
    from fourk_nerf_torch.utils.metrics import to8b
    try:
        _imageio().mimwrite(os.path.join(outdir, "video.sr.mp4"),
                            to8b(frames), fps=30, quality=8)
        print(f"wrote {outdir}/video.sr.mp4")
    except (ValueError, RuntimeError, OSError) as e:
        for fi, fr in enumerate(frames):
            _write_png(os.path.join(outdir, f"sr_{fi:03d}.png"), fr)
        print(f"mp4 writer unavailable ({e}); wrote PNG frames")


@fp32_precision()
def run(args, cfg, data_dict) -> dict:
    """Train (or reload) and render on ``args.device``, in full float32 (no
    TF32). Returns ``{"model": (model_mod, model_cfg, params, buffers,
    sr_model)}`` and, when asked for, ``"test"`` (the ``evaluate_sr``
    result) and ``"video"`` (the ``render_video`` result)."""
    from fourk_nerf_torch import pipeline, weights
    from fourk_nerf_torch.models import sr_esrnet
    from fourk_nerf_torch.train import checkpoints, sr_trainer, trainer
    from fourk_nerf_torch.utils.logging import ScalarWriter, dump_provenance

    if args.multihost:
        raise NotImplementedError("--multihost is not ported yet: ROADMAP.md "
                                  "Queue A item 6 (parallel/)")
    if args.ftdvcoa_path:
        raise NotImplementedError("--ftdvcoa_path (the coarse checkpoint's "
                                  "box and mask) is not ported yet: "
                                  "ROADMAP.md Queue A item 2 (the coarse "
                                  "stage)")
    if args.dump_images or args.render_video:
        _imageio()
    dev = resolve_device(args.device)
    rundir = os.path.join(cfg.basedir, cfg.expname)
    dump_provenance(cfg, args, rundir)
    writer = ScalarWriter(os.path.join(rundir, "tb"))
    sr_ratio = int(cfg.data.factor / cfg.data.load_sr) \
        if cfg.data.load_sr else 4
    render_kwargs = {
        "near": float(data_dict["near"]), "far": float(data_dict["far"]),
        "bg": 1.0 if cfg.data.white_bkgd else 0.0,
        "stepsize": float(cfg.fine_model_and_render.stepsize)}
    num_cond = int(cfg.fine_model_and_render.get("num_cond", 1))
    results = {}
    try:
        if not args.render_only:
            model = sr_trainer.train_sr(args, cfg, data_dict, writer=writer,
                                        device=dev)
        else:
            # a GAN run's file also holds the discriminator: read, unused
            ckpt = args.ft_path or os.path.join(rundir, "fine_last.npz")
            model_mod, model_cfg, params, buffers, sr_params, *_ = \
                sr_trainer.load_joint(ckpt, cfg.data.ndc, device=dev)
            sr_model = weights.sftnet_from_flax(sr_params, device=dev)
            if sr_model.scale != sr_ratio:
                raise ValueError(f"the checkpoint's generator is x"
                                 f"{sr_model.scale}, the config's x{sr_ratio}")
            if args.sr_path:
                sd = checkpoints._torch_load(args.sr_path)
                for pk in ("params_ema", "params"):
                    if isinstance(sd, dict) and pk in sd:
                        sd = sd[pk]
                        break
                sr_esrnet.load_reference_state_dict(sr_model, sd)
            model = (model_mod, model_cfg, params, buffers, sr_model)
        results["model"] = model
        model_mod, model_cfg, params, buffers, sr_model = model

        if args.render_test or args.render_only:
            val = sr_trainer.evaluate_sr(
                args, cfg, cfg.fine_model_and_render, model_mod, model_cfg,
                params, buffers, sr_model, data_dict, render_kwargs, sr_ratio,
                split="i_test", eval_lpips=args.eval_lpips_vgg, device=dev)
            if args.dump_images:
                outdir = os.path.join(rundir, "render_test_sr")
                os.makedirs(outdir, exist_ok=True)
                for i, frame in enumerate(val["sr_frames"]):
                    _write_png(os.path.join(outdir, f"sr_{i:03d}.png"),
                               frame.cpu().numpy())
            results["test"] = val

        if args.render_video:
            # the 4K fly-through (run_sr.py:1399-1463): every pose through the
            # encoder, then each frame's decode, timed per frame
            outdir = os.path.join(rundir, "render_video_sr")
            os.makedirs(outdir, exist_ok=True)
            res = pipeline.render_video(
                model_mod, model_cfg, params, buffers, sr_model,
                np.asarray(data_dict["render_poses"]), data_dict["HW"][0],
                data_dict["Ks"][0], data=trainer.DataFlags.from_config(
                    cfg.data),
                render_kwargs=render_kwargs, num_cond=num_cond,
                test_tile=args.test_tile,
                render_factor=args.render_video_factor,
                render_video_flipy=args.render_video_flipy,
                render_video_rot90=args.render_video_rot90, device=dev,
                **video_decode_options())
            n = len(res["sr_times"])
            for fi, t in enumerate(res["sr_times"]):
                print(f"sr time is: {t:.3f}s (frame {fi + 1}/{n})")
            _write_video(outdir, res["frames"].cpu().numpy())
            results["video"] = res
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
