"""The port's second slice as a whole: fourk_nerf_torch.pipeline.
render_video and train.trainer.render_viewpoints on the CPU (the kernels'
plain versions) vs the JAX chain: render_frame_box_pallas /
render_frame_pallas in interpret mode with use_bf16, then
sftnet_apply_pallas (dilated upchain, fuse_rrdb on and off), and the JAX
package's render_viewpoints for the scored float32 path. Encoder maps agree
to 2e-4 (measured ~1e-5), decoded frames to 0.05 (bf16 decoder), PSNR to
1e-3 dB. Plus the port's rules for its entry points."""

import ast
import functools
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import dmpigo as jdm, dvgo as jdv, \
    sr_esrnet as jsr
from fourk_nerf_tpu.ops import pallas_box, pallas_sr, pallas_sweep
from fourk_nerf_tpu.train import trainer as jtrainer
from fourk_nerf_torch import pipeline, weights
from fourk_nerf_torch.models import common as tcommon, dmpigo as tdm, \
    dvgo as tdv, sr_esrnet as tsr
from fourk_nerf_torch.ops import cuda_box, cuda_sr, rays as trays
from fourk_nerf_torch.train import trainer as ttrainer
from test_box_sweep import _camera, _scene as box_scene
from test_plane_sweep import _cam, _scene as mpi_scene
from test_torch_box import port_scene as port_box_scene
from test_torch_sr import numpy_params
from test_torch_sweep import port_scene as port_mpi_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 40, 48  # the smallest frame the fused-RRDB Pallas kernel tiles
ENC_TOL, SR_TOL = 2e-4, 0.05


def _sr(seed, scale=1):
    model = jsr.SFTNet(n_in_colors=3, scale=scale, num_feat=64, num_block=1,
                       num_grow_ch=32, num_cond=1)
    sp = numpy_params(model, np.random.default_rng(seed),
                      jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))
    return sp, weights.sftnet_from_flax(sp, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_decode(fuse):
    """The JAX decode, jitted once per ``fuse`` for both scenes (scale 1)."""
    return jax.jit(functools.partial(
        pallas_sr.sftnet_apply_pallas, scale=1, num_block=1, th=8, tw=16,
        interpret=True, upchain="dilated", fuse_rrdb=fuse))


@functools.lru_cache(maxsize=None)
def _dvgo_case():
    """Scene, camera, poses and the JAX encoder frames (Pallas box kernel,
    bf16 path, interpret mode), shared by the two decode variants."""
    cfg, params, buffers = box_scene(np.random.default_rng(3))
    K, _ = _camera(H, W)
    poses = [_camera(H, W, angle=a)[1] for a in ((0.4, 0.3), (0.0, np.pi))]
    encs = [pallas_box.render_frame_box_pallas(
        cfg, params, buffers, H, W, K, c2w, stepsize=0.5, near=0.2, bg=1.0,
        use_bf16=True, tile=8, interpret=True) for c2w in poses]
    return cfg, params, buffers, K, poses, encs


@functools.lru_cache(maxsize=None)
def _dmpigo_case():
    """The same for the NDC scene (Pallas sweep kernel, bf16 path)."""
    cfg, params, buffers = mpi_scene()
    K, c2w = _cam(H, W, f=40.0)
    # off-centre cameras: a centred one puts whole rows of samples exactly
    # half-way between two voxels, where the nearest mask is a coin toss
    poses = []
    for dx, dy in ((0.013, 0.007), (0.11, -0.023)):
        poses.append(c2w.copy())
        poses[-1][:2, 3] = dx, dy
    encs = [pallas_sweep.render_frame_pallas(
        cfg, params, buffers, H, W, K, c2w, stepsize=1.0, bg=1.0, tile=8,
        patch=24, use_bf16=True, interpret=True) for c2w in poses]
    return cfg, params, buffers, K, poses, encs


def _jax_frames(encs, sp, fuse):
    decode = _jax_decode(fuse)
    out = []
    for jenc in encs:
        sr = decode(sp, jenc["rgb_feature"][None],
                    jenc["depth"][None, ..., None])
        out.append((jenc, np.clip(np.asarray(sr[0]), 0, 1)))
    return out


def _check_video(out, jax_frames, fuse):
    enc = out["encoder"]
    for fi, (jenc, jsr_frame) in enumerate(jax_frames):
        for key, mine in (("rgb_feature", "rgb_features"), ("depth", "depths"),
                          ("alphainv_last", "bgmaps")):
            np.testing.assert_allclose(enc[mine][fi].numpy(),
                                       np.asarray(jenc[key]), atol=ENC_TOL,
                                       err_msg=f"{key} frame {fi}")
        got = out["frames"][fi].numpy()
        assert got.shape == jsr_frame.shape
        assert got.min() >= 0.0 and got.max() <= 1.0
        assert float(np.abs(got - jsr_frame).max()) < SR_TOL, (fi, fuse)


@pytest.mark.parametrize("fuse", [True, False])
def test_render_video_dvgo_matches_jax_chain(fuse):
    cfg, params, buffers, K, poses, encs = _dvgo_case()
    sp, tsr_model = _sr(1)
    jax_frames = _jax_frames(encs, sp, fuse)

    tcfg, tp, tb = port_box_scene(cfg, params, buffers)
    counts = (cuda_box.sweep_box, cuda_sr.rdb_apply, cuda_sr.rrdb_apply)
    for fn in counts:
        fn.launches = 0
    out = pipeline.render_video(
        tdv, tcfg, tp, tb, tsr_model, poses, (H, W), K,
        data=ttrainer.DataFlags(),
        render_kwargs=dict(stepsize=0.5, near=0.2, far=1e9, bg=1.0),
        fuse_rrdb=fuse, device="cpu")
    assert out["encoder"]["path"] == "box"
    assert tuple(out["frames"].shape) == (2, H, W, 3)
    assert len(out["sr_times"]) == 2
    assert [fn.launches for fn in counts] == [0, 0, 0]  # CPU: plain versions
    _check_video(out, jax_frames, fuse)


@pytest.mark.parametrize("fuse", [True, False])
def test_render_video_dmpigo_matches_jax_chain(fuse):
    cfg, params, buffers, K, poses, encs = _dmpigo_case()
    sp, tsr_model = _sr(2)
    jax_frames = _jax_frames(encs, sp, fuse)

    tcfg, tp, tb = port_mpi_scene(cfg, params, buffers)
    out = pipeline.render_video(
        tdm, tcfg, tp, tb, cuda_sr.prepare_sftnet(tsr_model), poses, (H, W),
        K, data=ttrainer.DataFlags(ndc=True),
        render_kwargs=dict(stepsize=1.0, bg=1.0), fuse_rrdb=fuse,
        device="cpu")
    assert out["encoder"]["path"] == "sweep"
    assert tuple(out["frames"].shape) == (2, H, W, 3)
    _check_video(out, jax_frames, fuse)


def _jax_cfg(**data):
    return types.SimpleNamespace(data=types.SimpleNamespace(
        **{"ndc": False, "inverse_y": False, "flip_x": False,
           "flip_y": False, **data}))


@pytest.mark.parametrize("family", ["dvgo", "dmpigo"])
def test_render_viewpoints_scores_like_jax(family):
    """With ground truth both packages render in float32 and score the
    frames: PSNR equal to 1e-3 dB, SSIM to 1e-4, maps to 2e-4."""
    h, w = 20, 28
    if family == "dvgo":
        cfg, params, buffers = box_scene(np.random.default_rng(3))
        K, _ = _camera(h, w)
        poses = [_camera(h, w, angle=a)[1] for a in ((0.4, 0.3), (0.1, 2.0))]
        rk = dict(stepsize=0.5, near=0.2, far=1e9, bg=0.7)
        jmod, tmod, data = jdv, tdv, {}
        tcfg, tp, tb = port_box_scene(cfg, params, buffers)
    else:
        cfg, params, buffers = mpi_scene()
        K, c2w0 = _cam(h, w)
        c2w1 = c2w0.copy()
        c2w1[:2, 3] = 0.05, -0.02
        poses = [c2w0, c2w1]
        rk = dict(stepsize=1.0, near=0.0, far=1.0, bg=0.7)
        jmod, tmod, data = jdm, tdm, {"ndc": True}
        tcfg, tp, tb = port_mpi_scene(cfg, params, buffers)
    rng = np.random.default_rng(9)
    HW = np.array([[h, w]] * 2)
    Ks = np.stack([K, K])
    gts = [rng.uniform(size=(h, w, 3)).astype(np.float32) for _ in poses]
    ref = jtrainer.render_viewpoints(
        jmod, cfg, params, buffers, poses, HW, Ks, cfg=_jax_cfg(**data),
        render_kwargs=rk, gt_imgs=gts, verbose=False)
    got = ttrainer.render_viewpoints(
        tmod, tcfg, tp, tb, poses, HW, Ks, data=ttrainer.DataFlags(**data),
        render_kwargs=rk, gt_imgs=gts, verbose=False, device="cpu")
    assert got["path"] == ("box" if family == "dvgo" else "sweep")
    np.testing.assert_allclose(got["psnrs"], ref["psnrs"], atol=1e-3)
    np.testing.assert_allclose(got["ssims"], ref["ssims"], atol=1e-4)
    for k in ("rgbs", "rgb_features", "depths", "bgmaps"):
        err = np.abs(got[k].numpy() - ref[k])
        err = err.max(-1) if err.ndim == 4 else err
        assert float((err > ENC_TOL).mean()) < 0.02, (k, float(err.max()))
    assert len(got["frame_times"]) == 2


def test_render_viewpoints_chunked_path_and_video_options():
    """A mask at another resolution than the grid is served by the chunked
    forward (decided from the model, no kernel is tried); render_factor
    halves the frame and skips the metrics; flipy and rot90 act on the
    finished frames."""
    h, w = 16, 24
    cfg, params, buffers = box_scene(np.random.default_rng(3),
                                     mask_res=(12, 10, 8))
    tcfg, tp, tb = port_box_scene(cfg, params, buffers)
    K, c2w = _camera(h, w)
    rk = dict(stepsize=0.5, near=0.2, far=1e9, bg=0.3)
    HW, Ks = np.array([[h, w]]), K[None]
    ref = jtrainer.render_viewpoints(
        jdv, cfg, params, buffers, [c2w], HW, Ks, cfg=_jax_cfg(),
        render_kwargs=rk, gt_imgs=[np.zeros((h, w, 3), np.float32)],
        verbose=False)
    kw = dict(data=ttrainer.DataFlags(), render_kwargs=rk, verbose=False,
              device="cpu", chunk=100)
    got = ttrainer.render_viewpoints(
        tdv, tcfg, tp, tb, [c2w], HW, Ks,
        gt_imgs=[np.zeros((h, w, 3), np.float32)], **kw)
    assert got["path"] == "chunked"
    np.testing.assert_allclose(got["rgbs"].numpy(), ref["rgbs"], atol=ENC_TOL)
    np.testing.assert_allclose(got["depths"].numpy(), ref["depths"],
                               atol=ENC_TOL)
    np.testing.assert_allclose(got["psnrs"], ref["psnrs"], atol=1e-3)

    half = ttrainer.render_viewpoints(
        tdv, tcfg, tp, tb, [c2w], HW, Ks, render_factor=2,
        gt_imgs=[np.zeros((h, w, 3), np.float32)], **kw)
    assert tuple(half["rgbs"].shape) == (1, h // 2, w // 2, 3)
    assert half["psnrs"] == []
    turned = ttrainer.render_viewpoints(
        tdv, tcfg, tp, tb, [c2w], HW, Ks, render_video_flipy=True,
        render_video_rot90=1, **kw)
    want = torch.rot90(got["rgbs"][0].flip(0), 1, (0, 1))
    torch.testing.assert_close(turned["rgbs"][0], want)
    assert tuple(turned["depths"].shape) == (1, w, h)

    # a dmpigo scene off the plane-aligned setup also renders in chunks
    mcfg, mparams, mbuffers = mpi_scene()
    tm = port_mpi_scene(mcfg, mparams, mbuffers)
    assert ttrainer.frame_path(tdm, *tm, ttrainer.DataFlags(ndc=True),
                               0.5) == "chunked"
    assert ttrainer.frame_path(tdm, *tm, ttrainer.DataFlags(ndc=True),
                               1.0) == "sweep"


def test_cfg_box_ok_matches_jax():
    import dataclasses
    cfg, _, _ = box_scene(np.random.default_rng(0))
    tcfg = tdv.Config(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    for change in ({}, {"rgbnet_full_implicit": True},
                   {"k0_type": "TensoRFGrid"}, {"density_type": "X"}):
        assert ttrainer.cfg_box_ok(dataclasses.replace(tcfg, **change)) \
            == jtrainer.cfg_box_ok(dataclasses.replace(cfg, **change))


def test_sr_condition_channels():
    depth = torch.rand(6, 8)
    K, c2w = _camera(6, 8)
    data = ttrainer.DataFlags()
    assert tuple(pipeline.sr_condition(1, depth, K, c2w, data,
                                       "cpu").shape) == (1, 6, 8, 1)
    c64 = pipeline.sr_condition(64, depth, K, c2w, data, "cpu")
    c63 = pipeline.sr_condition(63, depth, K, c2w, data, "cpu")
    assert tuple(c64.shape) == (1, 6, 8, 64) and tuple(c63.shape) == (1, 6, 8, 63)
    torch.testing.assert_close(c64[..., :1], depth[None, ..., None])
    torch.testing.assert_close(c64[..., 1:], c63)
    torch.testing.assert_close(c63[..., :3].norm(dim=-1),
                               torch.ones(1, 6, 8))  # unit view directions
    with pytest.raises(ValueError):
        pipeline.sr_condition(2, depth, K, c2w, data, "cpu")


def test_render_video_viewdir_condition_under_render_factor(monkeypatch):
    """num_cond 64 with render_factor 2: the decode gets the JAX video
    loop's condition (run_sr.py): the depth, then the viewdir embedding of
    the unscaled K at the halved frame size."""
    from fourk_nerf_tpu.ops import rays as jrays
    h, w = 16, 24
    cfg, params, buffers = box_scene(np.random.default_rng(3))
    tcfg, tp, tb = port_box_scene(cfg, params, buffers)
    K, _ = _camera(h, w)
    poses = [_camera(h, w, angle=a)[1] for a in ((0.4, 0.3), (0.1, 2.0))]
    seen = []

    def decode(prep, feat, cond, **kw):
        seen.append(cond)
        return torch.zeros(feat.shape[:3] + (3,))

    monkeypatch.setattr(cuda_sr, "sftnet_apply_cuda", decode)
    model = tsr.SFTNet(scale=1, num_block=1, num_cond=64)
    out = pipeline.render_video(
        tdv, tcfg, tp, tb, model, poses, (h, w), K,
        data=ttrainer.DataFlags(),
        render_kwargs=dict(stepsize=0.5, near=0.2, far=1e9, bg=1.0),
        num_cond=64, render_factor=2, device="cpu")
    assert len(seen) == 2
    for fi, c2w in enumerate(poses):
        depth = out["encoder"]["depths"][fi].numpy()
        assert depth.shape == (h // 2, w // 2)
        _, _, vd = jrays.get_rays_of_a_view(h // 2, w // 2, K, c2w[:3, :4],
                                            ndc=False, inverse_y=False,
                                            flip_x=False, flip_y=False)
        want = np.concatenate(
            [depth[..., None], np.asarray(jrays.positional_encoding(vd, 10))],
            -1)
        assert tuple(seen[fi].shape) == (1, h // 2, w // 2, 64)
        np.testing.assert_allclose(seen[fi][0].numpy(), want, atol=1e-5)


def test_sr_geometry_outside_the_kernels_decodes_in_float32():
    """A 32-feature SFTNet (growth 16) is no geometry of the dense-block
    kernels: render_video and FramePipeline decode it with its float32
    forward, chosen up front as the JAX video loop chooses, instead of
    raising in the weight packer."""
    cfg, params, buffers = box_scene(np.random.default_rng(3))
    tcfg, tp, tb = port_box_scene(cfg, params, buffers)
    torch.manual_seed(0)
    model = tsr.SFTNet(scale=2, num_feat=32, num_block=1, num_grow_ch=16)
    K, c2w = _camera(16, 24)
    rk = dict(stepsize=0.5, near=0.2, far=1e9, bg=1.0)
    out = pipeline.render_video(
        tdv, tcfg, tp, tb, model, [c2w], (16, 24), K,
        data=ttrainer.DataFlags(), render_kwargs=rk, fuse_rrdb=True,
        device="cpu")
    enc = out["encoder"]
    with torch.no_grad():
        want = model(enc["rgb_features"][:1], enc["depths"][:1, ..., None])
    assert tuple(out["frames"].shape) == (1, 32, 48, 3)
    torch.testing.assert_close(out["frames"][0], want[0].clamp(0.0, 1.0),
                               rtol=0, atol=0)
    pipe = pipeline.FramePipeline(tcfg, tp, tb, model, stepsize=0.5,
                                  near=0.2, bg=1.0, device="cpu")
    sr, penc = pipe(16, 24, K, c2w)
    with torch.no_grad():
        want = model(penc["rgb_feature"][None],
                     penc["depth"][None, ..., None])
    torch.testing.assert_close(sr, want, rtol=0, atol=0)
    assert not cuda_sr.fits_kernels(model)
    assert cuda_sr.fits_kernels(_sr(3)[1])


def test_frame_pipeline_dvgo_fuse_rrdb():
    """FramePipeline with a dvgo encoder and the fused decode equals the
    two steps called by hand."""
    cfg, params, buffers = box_scene(np.random.default_rng(3))
    tcfg, tp, tb = port_box_scene(cfg, params, buffers)
    _, tsr_model = _sr(3)
    K, c2w = _camera(16, 24)
    pipe = pipeline.FramePipeline(tcfg, tp, tb, tsr_model, fuse_rrdb=True,
                                  stepsize=0.5, near=0.2, bg=1.0,
                                  device="cpu")
    sr, enc = pipe(16, 24, K, c2w)
    ref_enc = cuda_box.render_frame_box_cuda(
        tcfg, tp, tb, 16, 24, K, c2w, stepsize=0.5, near=0.2, bg=1.0,
        use_bf16=True, device="cpu")
    torch.testing.assert_close(enc["rgb_feature"], ref_enc["rgb_feature"])
    ref = cuda_sr.sftnet_apply_plain(tsr_model, enc["rgb_feature"][None],
                                     enc["depth"][None, ..., None],
                                     fuse_rrdb=True, upchain="dilated")
    torch.testing.assert_close(sr, ref, rtol=0, atol=0)


@pytest.mark.parametrize("call", [
    lambda: trays.get_rays(4, 4, np.eye(3), np.eye(4)[:3], False, False,
                           False),
    lambda: trays.get_rays_of_a_view(4, 4, np.eye(3), np.eye(4)[:3], False,
                                     False, False, False),
    lambda: weights.to_torch({"a": np.zeros(2)}),
    lambda: tcommon.mlp_init([3, 4, 3],
                             generator=torch.Generator().manual_seed(0)),
    lambda: weights.dvgo_from_numpy({"a": np.zeros(2)}, {}),
], ids=["get_rays", "get_rays_of_a_view", "to_torch", "mlp_init",
        "dvgo_from_numpy"])
def test_entry_points_default_to_the_card(call):
    """No entry point runs on the CPU unless asked: without a card the
    default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_port_imports_nothing_of_jax():
    """Every import statement, at any depth, of every module of the port and
    of chip_smoke.py: none names jax, jaxlib, flax or the JAX package."""
    banned = {"jax", "jaxlib", "flax", "fourk_nerf_tpu"}
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "fourk_nerf_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", getattr(node.func, "attr", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
