"""The joint trainer's pieces against the JAX package: the patch sampler,
the sweep's slice and window sizes, the LPIPS proxy, the generator's
weights in and out (reference state dicts, flax trees, the JAX init's
distributions), resume by the parsed step, the flags that raise, depth
colouring, LPIPS of the renders by network, and full float32 (no TF32) in
every entry point.

Tolerances: the LPIPS proxy 1e-5 relative; weights exactly; the init's
standard deviations within 5% of the JAX initialisers' (about 2,000 to
37,000 draws a conv)."""

import contextlib
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import dmpigo as jd, sr_esrnet as jsr
from fourk_nerf_tpu.ops import plane_sweep as jps, rays as jrays
from fourk_nerf_tpu.train import sr_trainer as jst
from fourk_nerf_tpu.utils import metrics as jm
from fourk_nerf_torch import pipeline, weights
from fourk_nerf_torch.models import dmpigo as td, sr_esrnet as tsr
from fourk_nerf_torch.ops import plane_sweep as tps
from fourk_nerf_torch.train import sr_trainer as tst
from fourk_nerf_torch.utils import metrics as tm


@pytest.mark.parametrize("inmask", [False, True])
def test_patch_sampler_matches_jax(inmask):
    V, H, W, P = 3, 40, 52, 16
    n = V * 3 * 4
    keep = (np.arange(n) % 3 != 1) if inmask else None
    js = jst.make_patch_sampler(V, H, W, P, 5, inmask=keep)
    ts = tst.make_patch_sampler(V, H, W, P, 5, inmask=keep)
    assert (ts.rows, ts.cols) == (js.rows, js.cols) == ([0, 16, 24],
                                                       [0, 16, 32, 36])
    n_kept = int(keep.sum()) if inmask else n
    draws = [ts(i) for i in range(2 * n_kept + 3)]  # over two epoch bounds
    assert draws == [js(i) for i in range(2 * n_kept + 3)]
    assert sorted(draws[:n_kept]) == sorted(set(draws[:n_kept]))


def test_sweep_sizes_match_jax():
    cfg = jd.make_config(xyz_min=[-2.0, -2.0, -1.0], xyz_max=[2.0, 2.0, 1.0],
                         num_voxels=64 * 64 * 8, mpi_depth=8, rgbnet_dim=6)
    K = np.array([[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[2, 3] = 1.0
    ro, rd, _ = (np.asarray(x) for x in jrays.get_rays_of_a_view(
        32, 32, K, c2w, ndc=True, inverse_y=False, flip_x=False,
        flip_y=False))
    X, Y, Z = cfg.world_size
    sizes = np.array([X, Y], np.float32)
    mn = np.asarray(cfg.xyz_min, np.float32)
    mx = np.asarray(cfg.xyz_max, np.float32)
    a = (ro[None, ..., :2] - mn[:2]) / (mx[:2] - mn[:2]) * (sizes - 1)
    b = rd[None, ..., :2] / (mx[:2] - mn[:2]) * (sizes - 1) / (Z - 1)
    tcfg = td.make_config(**jd.get_kwargs(cfg))
    for P in (4, 8, 16):
        rows, cols = tst.patch_origins(32, 32, P)
        sp = tst.sweep_patch_size_for(tcfg, a, b, rows, cols, P)
        assert sp == jst.sweep_patch_size_for(cfg, a, b, rows, cols, P)
        assert tst.sweep_window_size_for(tcfg, a, b, rows, cols, P, sp) \
            == jst.sweep_window_size_for(cfg, a, b, rows, cols, P, sp)
        blk = (slice(None), slice(8, 8 + P), slice(4, 4 + P))
        want = jax.tree.map(int, jps.sweep_window_origin(
            jnp.asarray(a[blk]), jnp.asarray(b[blk]), Z, X, Y, 40))
        assert tps.sweep_window_origin(
            torch.as_tensor(a[blk]), torch.as_tensor(b[blk]), Z, X, Y,
            40) == tuple(want)


@pytest.mark.parametrize("hw", [(37, 45), (64, 48), (7, 9), (2, 5)])
def test_lpips_proxy_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    a = rng.uniform(size=hw + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = jm.rgb_lpips_proxy(a, b)
    np.testing.assert_allclose(tm.rgb_lpips_proxy(a, b), want, rtol=1e-5)
    np.testing.assert_allclose(tm.rgb_lpips_proxy(torch.as_tensor(a),
                                                  torch.as_tensor(b)),
                               want, rtol=1e-5)
    assert tm.rgb_lpips(a, b) is jm.rgb_lpips(a, b) is None  # no package


def _flax_tree(rng, num_block=2, num_feat=16, grow=8):
    model = jsr.SFTNet(n_in_colors=3, scale=4, num_feat=num_feat,
                       num_block=num_block, num_grow_ch=grow, num_cond=1)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 8, 8, 1)))
    return jax.tree.map(
        lambda leaf: rng.normal(0, 0.1, leaf.shape).astype(np.float32),
        shapes["params"])


def _reference_state_dict(rng, num_block=2, num_feat=16, grow=8):
    """A state dict under the reference's names (torch OIHW): CondNet
    indices, ``SFT_*`` layers, one conv of the wrong shape, one without a
    bias, one key of another module."""
    sd = {}

    def conv(name, cin, cout, k=3, bias=True):
        sd[f"{name}.weight"] = torch.as_tensor(
            rng.normal(0, 0.1, (cout, cin, k, k)).astype(np.float32))
        if bias:
            sd[f"{name}.bias"] = torch.as_tensor(
                rng.normal(0, 0.1, cout).astype(np.float32))

    def sft(name, nf):
        conv(f"{name}.SFT_scale_conv0", 32, grow, 1)
        conv(f"{name}.SFT_scale_conv1", grow, nf, 1)
        conv(f"{name}.SFT_shift_conv0", 32, grow, 1)
        conv(f"{name}.SFT_shift_conv1", grow, nf, 1, bias=False)

    conv("conv_first", 3, num_feat)
    for i, (cin, cout, k) in enumerate(((1, 64, 3), (64, 64, 1), (64, 64, 1),
                                        (64, 32, 1))):
        conv(f"CondNet.{2 * i}", cin, cout, k)
    for b in range(num_block):
        for r in (1, 2, 3):
            for c in range(5):
                conv(f"body.{b}.rdb{r}.conv{c + 1}", num_feat + c * grow,
                     grow if c < 4 else num_feat)
            sft(f"body.{b}.rdb{r}.sft0", num_feat)
            sft(f"body.{b}.rdb{r}.sft1", grow)
        sft(f"body.{b}.sft0", num_feat)
    sft("sftbody", num_feat)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        conv(name, num_feat, num_feat)
    conv("conv_last", num_feat, 5)  # the wrong shape: keeps its init
    del sd["body.1.rdb2.conv3.weight"]  # absent: keeps its init
    sd["conv_extra.weight"] = torch.zeros(3, 3, 3, 3)
    return sd


def test_load_reference_state_dict_matches_jax():
    rng = np.random.default_rng(0)
    init = _flax_tree(rng)
    sd = _reference_state_dict(rng)
    want = jsr.merge_params(jax.tree.map(jnp.asarray, init),
                            jsr.import_sftnet_torch(sd))
    model = weights.sftnet_from_flax(init, device="cpu")
    loaded = tsr.load_reference_state_dict(model, sd)
    assert "conv_last" not in loaded and "body1.rdb2.conv3" not in loaded
    assert "sftbody.shift1" in loaded and "cond3" in loaded
    got = weights.sftnet_to_flax(model)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)),
                 got, want)


def test_sftnet_flax_round_trip():
    tree = _flax_tree(np.random.default_rng(1), num_block=1)
    back = weights.sftnet_to_flax(weights.sftnet_from_flax(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    # the joint optimizer states come across from the JAX layout, the
    # generator's moments in the module's layout, and go back out
    state = {"exp_avg": {"srnet": tree}, "exp_avg_sq": {"srnet": tree},
             "step": np.int32(3)}
    enc = {"exp_avg": {"k0": np.ones((2, 2, 2, 3), np.float32)},
           "exp_avg_sq": {"k0": np.ones((2, 2, 2, 3), np.float32)},
           "step": np.int32(5)}
    joint = weights.joint_opt_state_from_numpy({"enc": enc, "sr": state},
                                               "cpu")
    assert joint["enc"]["step"] == 5 and joint["sr"]["step"] == 3
    port = joint["sr"]
    model = weights.sftnet_from_flax(tree, "cpu")
    assert port["exp_avg"]["srnet"]["conv_first"]["kernel"].shape == \
        model.conv_first.weight.shape
    out = jax.tree.map(lambda t: t.numpy(),
                       weights.flax_kernels(port["exp_avg"]))
    jax.tree.map(np.testing.assert_array_equal, out, state["exp_avg"])


def test_init_like_jax_distributions():
    model = tsr.SFTNet(num_block=1)
    tsr.init_like_jax(model, torch.Generator().manual_seed(0))
    for path, mod in model.named_modules():
        if not isinstance(mod, tsr.Conv):
            continue
        w = mod.weight.detach()
        fan_in = w[0].numel()
        assert torch.count_nonzero(mod.bias) == 0, path
        if w.numel() < 2000:
            continue
        if tsr._dense_conv(path):
            std = 0.1 * np.sqrt(2.0 / fan_in)
        else:
            std = np.sqrt(1.0 / fan_in)  # lecun normal, truncated at 2 sigma
            assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
        np.testing.assert_allclose(float(w.std()), std, rtol=0.05,
                                   err_msg=path)


def _periodic(tmp, steps):
    d = tmp / "run" / "ckpt_saved"
    d.mkdir(parents=True, exist_ok=True)
    for s in steps:
        (d / f"fine_{s:06d}.npz").write_bytes(b"")
    return str(tmp / "run")


def test_resume_picks_the_largest_parsed_step(tmp_path):
    rundir = _periodic(tmp_path, [999999, 1000000, 3])
    (tmp_path / "run" / "ckpt_saved" / "fine_1000001.npz.tmp.npz") \
        .write_bytes(b"")
    args = types.SimpleNamespace(no_reload=False, ftdv_path="")
    got = tst.find_reload_path(args, rundir, "fine")
    assert os.path.basename(got) == "fine_1000000.npz"
    # the JAX package's lexicographic max takes the older file
    assert max(os.listdir(os.path.dirname(got))) == \
        "fine_999999.npz"
    (tmp_path / "run" / "fine_last.npz").write_bytes(b"")
    assert tst.find_reload_path(args, rundir, "fine").endswith(
        "fine_last.npz")
    args.ftdv_path = "/elsewhere/pretrain.npz"
    assert tst.find_reload_path(args, rundir, "fine") == args.ftdv_path
    args.no_reload = True
    assert tst.find_reload_path(args, rundir, "fine") is None


@pytest.mark.parametrize("flag,item", [("--multihost", "item 6"),
                                       ("--ftdvcoa_path=x.npz", "item 2")])
def test_run_sr_unported_flags_raise(tmp_path, flag, item):
    from fourk_nerf_torch import config as tconfig, run_sr
    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = tconfig.load_config(os.path.join(
        root, "fourk_nerf_torch", "configs", "llff", "fern_lg_joint_l1.py"))
    cfg.basedir = str(tmp_path)
    args = run_sr.config_parser().parse_args(
        ["--config", "c.py", "--device", "cpu", flag])
    with pytest.raises(NotImplementedError, match=item):
        run_sr.run(args, cfg, {})


# --- full float32 in the entry points (ROADMAP Queue C 2) -------------------

@pytest.fixture
def cudnn_flags(monkeypatch):
    """Record each entry into ``torch.backends.cudnn.flags``: its
    ``allow_tf32`` and the matmul TF32 setting inside."""
    seen = []

    @contextlib.contextmanager
    def flags(*args, **kw):
        seen.append((kw.get("allow_tf32"),
                     torch.backends.cuda.matmul.allow_tf32))
        yield

    monkeypatch.setattr(torch.backends.cudnn, "flags", flags)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    return seen


def _tiny_frame_scene():
    cfg = td.make_config(xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
                         num_voxels=16 * 16 * 8, mpi_depth=8, rgbnet_dim=6,
                         rgbnet_width=16, fast_color_thres=1.0 / 40)
    params, buffers = td.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    g = torch.Generator().manual_seed(1)
    params["density"] = torch.randn(params["density"].shape, generator=g)
    params["k0"] = torch.randn(params["k0"].shape, generator=g)
    K = np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 1.0
    return cfg, params, buffers, K, c2w


def test_entry_points_run_in_full_float32(cudnn_flags):
    """The frame pipeline's decode, the video loop, the joint step and the
    CLIs enter ``cudnn.flags(allow_tf32=False)`` with the matmul TF32 off,
    and restore the matmul setting after."""
    from fourk_nerf_torch import run, run_sr
    from fourk_nerf_torch.train import trainer
    cfg, params, buffers, K, c2w = _tiny_frame_scene()
    sr = tsr.SFTNet(num_feat=16, num_block=1, num_grow_ch=8)

    pipe = pipeline.FramePipeline(cfg, params, buffers, sr, device="cpu")
    pipe(12, 16, K, c2w)
    assert cudnn_flags == [(False, False)]
    pipeline.render_video(td, cfg, params, buffers, sr, c2w[None],
                          np.array([12, 16]), K,
                          data=trainer.DataFlags(ndc=True),
                          render_kwargs={"stepsize": 1.0, "bg": 0.0},
                          device="cpu")
    assert cudnn_flags[1:] == [(False, False)]
    for mod in (run, run_sr):
        args = mod.config_parser().parse_args(
            ["--config", "c.py", "--device", "cpu", "--multihost"])
        with pytest.raises(NotImplementedError):
            mod.run(args, cfg, {})
    assert cudnn_flags[2:] == [(False, False)] * 2
    assert torch.backends.cuda.matmul.allow_tf32  # restored


def test_joint_step_runs_in_full_float32(cudnn_flags):
    from fourk_nerf_torch.config import ConfigDict
    cfg, params, buffers, K, c2w = _tiny_frame_scene()
    sr = tsr.SFTNet(num_feat=16, num_block=1, num_grow_ch=8)
    ct = ConfigDict(dict(weight_main=1.0, weight_entropy_last=0,
                         weight_distortion=0, weight_rgbper=0,
                         weight_tv_density=0, weight_tv_k0=0))
    step = tst.SRTrainStep(td, cfg, ct, ConfigDict({}),
                           render_kwargs={"stepsize": 1.0, "bg": 0.0},
                           skip_zero_grad={"density", "k0"}, sr_model=sr,
                           n_views=1, patch=4, sr_ratio=4)
    from fourk_nerf_torch.ops import rays
    ro, rd, vd = (t[:4, :4].reshape(-1, 3) for t in rays.get_rays_of_a_view(
        12, 16, K, c2w, ndc=True, inverse_y=False, flip_x=False,
        flip_y=False, device="cpu"))
    batch = (ro, rd, vd, torch.rand(16, 3), torch.rand(256, 3))
    from fourk_nerf_torch.train import optim
    step(params, buffers, optim.init_state(params),
         optim.init_state({"srnet": weights.sftnet_params(sr)}), batch,
         {"enc": {"k0": 0.1}, "srnet": 1e-3}, apply_tv=False,
         tv_dense=False)
    assert cudnn_flags == [(False, False)]


@pytest.mark.parametrize("hw", [(40, 53), (11, 11), (24, 90)])
def test_ssim_on_tensors_matches_jax(hw):
    """``rgb_ssim`` of tensors (torch float64 convolutions, the path
    ``evaluate_sr`` takes on the card) against the JAX package's scipy
    SSIM: 1e-12."""
    rng = np.random.default_rng(hw[1])
    a = rng.uniform(size=hw + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = jm.rgb_ssim(a, b)
    np.testing.assert_allclose(
        tm.rgb_ssim(torch.as_tensor(a), torch.as_tensor(b)), want,
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tm.rgb_ssim(torch.as_tensor(a), b, return_map=True).numpy(),
        jm.rgb_ssim(a, b, return_map=True), rtol=0, atol=1e-12)


def test_tree_update_equals_the_per_leaf_update():
    """MaskedAdam's multi-tensor update of an unmasked group tree (the
    generator's ``srnet``) gives, bit for bit, the per-leaf update."""
    import copy

    from fourk_nerf_torch.train import optim
    tree = weights.sftnet_params(tsr.SFTNet(num_feat=16, num_block=1,
                                            num_grow_ch=8))
    g = torch.Generator().manual_seed(0)

    def draw(like, positive=False):
        t = {k: draw(v, positive) if isinstance(v, dict)
             else torch.randn(v.shape, generator=g) for k, v in like.items()}
        return jax.tree.map(torch.abs, t) if positive else t

    p, grad, m, v = (draw(tree), draw(tree), draw(tree), draw(tree, True))
    state = {"exp_avg": {"srnet": copy.deepcopy(m)},
             "exp_avg_sq": {"srnet": copy.deepcopy(v)}, "step": 6}
    got = {"srnet": copy.deepcopy(p)}
    optim.apply_updates(got, {"srnet": grad}, state, {"srnet": 2e-4})
    size = float(np.float32(2e-4) * np.float32(optim._bias_correction(7)))
    for path, leaf in optim._leaves(p):
        optim._update_leaf(leaf, optim._at(grad, path), optim._at(m, path),
                           optim._at(v, path), size, False)
        for want, have in ((leaf, got["srnet"]), (optim._at(m, path),
                                                  state["exp_avg"]["srnet"]),
                           (optim._at(v, path), state["exp_avg_sq"]["srnet"])):
            assert torch.equal(optim._at(have, path), want), path


def test_native_mask_render_matches_the_jax_xla_sweep():
    """``plane_sweep.render_frame_native`` (the float32 render that reads a
    mask of another resolution at its own, as the JAX package scores) on a
    sparse 32x32x16 scene with a 9x11x8 mask, against the JAX package's
    XLA ``plane_sweep.render_frame(use_bf16=False)`` in NATIVE mode: 1e-5
    per pixel."""
    from fourk_nerf_tpu.ops import plane_sweep as jps_
    rng = np.random.default_rng(0)
    cfg = jd.make_config(xyz_min=[-1.3, -1.2, -1.0], xyz_max=[1.3, 1.2, 1.0],
                         num_voxels=32 * 32 * 16, mpi_depth=16,
                         fast_color_thres=1.0 / 80, rgbnet_dim=6,
                         rgbnet_width=32, viewbase_pe=4, spatial_pe=2)
    params, buffers = jd.init(cfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    params["density"] = rng.normal(-1, 2, params["density"].shape).astype(
        np.float32)
    params["k0"] = rng.normal(0, 1, params["k0"].shape).astype(np.float32)
    for k, v in params["rgbnet"].items():
        params["rgbnet"][k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
    buffers = {"act_shift": np.asarray(buffers["act_shift"]),
               "mask_cache": rng.uniform(size=(9, 11, 8)) < 0.7}
    K = np.array([[40.0, 0, 20], [0, 40.0, 16], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 1.0
    tile, patch = jps_.auto_tile_patch(cfg, 32, 40, K, c2w)
    want = jps_.render_frame(cfg, jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, buffers), 32, 40, K,
                             c2w, stepsize=1.0, bg=1.0, tile=tile,
                             patch=patch, use_bf16=False)
    tp, tb = weights.dmpigo_from_numpy(params, buffers, "cpu")
    got = tps.render_frame_native(td.make_config(**jd.get_kwargs(cfg)), tp,
                                  tb, 32, 40, K, c2w, stepsize=1.0, bg=1.0,
                                  device="cpu")
    for k in ("rgb_marched", "rgb_feature", "depth", "alphainv_last"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("minmax", [None, (0.2, 0.9)])
def test_visualize_depth_matches_jax(minmax):
    depth = np.random.default_rng(5).uniform(0, 1, (9, 11)).astype(
        np.float32)
    depth[0, :3] = 0.0  # the least positive depth, not 0, is the low end
    depth[1, 1] = np.nan
    want = jm.visualize_depth(depth, minmax)
    np.testing.assert_array_equal(tm.visualize_depth(depth, minmax), want)
    np.testing.assert_array_equal(
        tm.visualize_depth(torch.tensor(depth), minmax), want)
    assert want.shape == (9, 11, 3) and want.dtype == np.uint8


def test_render_viewpoints_scores_lpips_by_network(monkeypatch):
    """``eval_lpips_vgg`` / ``eval_lpips_alex`` score each view with the
    ``lpips`` package's network of that name (stubbed here: the package is
    not installed), and give no value where it returns None."""
    from fourk_nerf_torch.train import trainer
    cfg, params, buffers, K, c2w = _tiny_frame_scene()
    calls = []

    def fake(gt, im, net):
        calls.append(net)
        return {"vgg": 0.25, "alex": 0.5}[net]

    kw = dict(data=trainer.DataFlags(ndc=True),
              render_kwargs={"stepsize": 1.0, "bg": 0.0},
              gt_imgs=[np.zeros((12, 16, 3), np.float32)] * 2,
              eval_ssim=False, device="cpu")
    poses, hw, ks = np.stack([c2w] * 2), np.array([[12, 16]] * 2), \
        np.stack([K] * 2)
    monkeypatch.setattr(tm, "rgb_lpips", fake)
    res = trainer.render_viewpoints(td, cfg, params, buffers, poses, hw, ks,
                                    eval_lpips_vgg=True,
                                    eval_lpips_alex=True, **kw)
    assert res["lpips_vgg"] == [0.25, 0.25]
    assert res["lpips_alex"] == [0.5, 0.5]
    assert calls == ["vgg", "alex", "vgg", "alex"]
    monkeypatch.setattr(tm, "rgb_lpips", lambda gt, im, net: None)
    res = trainer.render_viewpoints(td, cfg, params, buffers, poses, hw, ks,
                                    eval_lpips_vgg=True, **kw)
    assert res["lpips_vgg"] == [] and res["lpips_alex"] == []
