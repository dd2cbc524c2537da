"""Port parity of the joint encoder + SR step (``train/sr_trainer.py``)
against the JAX package's ``make_sr_train_step(donate=False)``: one step
of each of its three patch renders (the gather forward, the full-grid
plane sweep with the mask at the grid's resolution, CHANNEL mode, and at
another one, NATIVE mode), from the same params, on an off-centre 8-pixel
patch of a 64x64x8 grid, with an SFTNet of one RRDB (16 features, grow 8);
then the windowed step against the port's full sweep step, and the
windowed MaskedAdam against the full masked update.

Tolerances. Loss and terms 1e-5 relative. Gradients, read from the first
moment after one step from a zero state (``exp_avg = 0.1 g``), each leaf
within a share of its largest entry: the gather path 1e-5; the sweep
paths at bfloat16 grade (the sweep rounds the grid, the x weights and the
MLP to bfloat16 where the JAX sweep does): 2^-8 (3.9e-3) for the grids
and the generator (the JAX package rounds the grid's gradient to
bfloat16, an error of up to 2^-9 of an entry, on top of the rounding
that both packages do upstream), 2^-6 for the rgbnet, whose gradient both
packages compute with bfloat16 matmuls (one bfloat16 ulp at the largest
entry is 2^-7 to 2^-8 of it; two allowed). Second moments twice
those. Params after MaskedAdam: the first step moves an entry by about
``lr * sign(g)``, so an entry whose gradient is within rounding of zero
may move in one package and not the other: in each leaf at most two
entries or 1e-3 of them, whichever is more, off by more than 1e-4. The windowed step equals the full step to 1e-6, the
windowed update the full one exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.config import ConfigDict
from fourk_nerf_tpu.models import dmpigo as jd, sr_esrnet as jsr
from fourk_nerf_tpu.ops import rays as jrays
from fourk_nerf_tpu.train import optim as jo, sr_trainer as jst
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import dmpigo as td
from fourk_nerf_torch.train import optim as to, sr_trainer as tst

PATCH, RATIO = 8, 4
SWEEP_PATCH, GRID_WINDOW = 24, 32
LRS = {"enc": {"density": 0.1, "k0": 0.1, "rgbnet": 1e-3}, "srnet": 2e-4,
       "d": 2e-4}


def _cfg_train(**kw):
    base = dict(weight_main=1.0, weight_entropy_last=1e-3,
                weight_distortion=0.01, weight_rgbper=0.01, weight_gan=0,
                weight_tv_density=1e-4, weight_tv_k0=1e-5, N_patch=PATCH,
                lrate_decay=20, skip_zero_grad_fields=["density", "k0"])
    return ConfigDict({**base, **kw})


def _sr_params(rng):
    """A numpy-drawn flax tree of the small SFTNet (biases non-zero)."""
    model = jsr.SFTNet(n_in_colors=3, scale=RATIO, num_feat=16, num_block=1,
                       num_grow_ch=8, num_cond=1)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, PATCH, PATCH, 3)),
                            jnp.zeros((1, PATCH, PATCH, 1)))["params"]

    def draw(path, leaf):
        if path[-1].key == "bias":
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, np.sqrt(1.0 / fan_in),
                          leaf.shape).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    mcfg = jd.make_config(
        xyz_min=[-2.0, -2.0, -1.0], xyz_max=[2.0, 2.0, 1.0],
        num_voxels=64 * 64 * 8, mpi_depth=8, fast_color_thres=1e-4,
        rgbnet_dim=6, rgbnet_width=16)
    params, buffers = jd.init(mcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    buffers = jax.tree.map(np.asarray, buffers)
    params["density"] = rng.normal(0, 1, params["density"].shape).astype(
        np.float32)
    params["k0"] = rng.normal(0, 1, params["k0"].shape).astype(np.float32)
    for k, v in params["rgbnet"].items():  # a non-trivial MLP (init zeroes
        scale = 0.1 if k[0] == "b" else 1.0 / np.sqrt(v.shape[0])  # the last)
        params["rgbnet"][k] = rng.normal(0, scale, v.shape).astype(np.float32)
    masks = {"channel": rng.uniform(size=mcfg.world_size) < 0.7,
             "native": rng.uniform(size=(40, 44, 8)) < 0.7}
    sr_model, sr_params = _sr_params(rng)
    H = W = 32
    f = 20.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[2, 3] = 1.0
    rays = jrays.get_rays_of_a_view(H, W, K, c2w, ndc=True, inverse_y=False,
                                    flip_x=False, flip_y=False)
    r0, c0 = 19, 5
    ro, rd, vd = (np.asarray(x)[r0:r0 + PATCH, c0:c0 + PATCH].reshape(-1, 3)
                  for x in rays)
    target = rng.uniform(0, 1, (PATCH * PATCH, 3)).astype(np.float32)
    target_hr = rng.uniform(0, 1, (PATCH * RATIO * PATCH * RATIO, 3)).astype(
        np.float32)
    return dict(mcfg=mcfg, params=params, buffers=buffers, masks=masks,
                sr_model=sr_model, sr_params=sr_params,
                batch=(ro, rd, vd, target, target_hr))


def _jax_step(sc, mask, sweep_patch, grid_window=None, apply_tv=False):
    mcfg = sc["mcfg"]
    rk = dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0, rand_bkgd=False,
              ndc_planes=True)
    step = jst.make_sr_train_step(
        jd, mcfg, _cfg_train(), ConfigDict(dict(num_cond=1, dim_rend=3)),
        render_kwargs=rk, skip_zero_grad=frozenset(["density", "k0"]),
        sr_model=sc["sr_model"], d_model=None, n_views=1, patch=PATCH,
        sr_ratio=RATIO, sweep_patch=sweep_patch, grid_window=grid_window,
        donate=False)
    params = jax.tree.map(jnp.asarray, sc["params"])
    buffers = {"act_shift": jnp.asarray(sc["buffers"]["act_shift"]),
               "mask_cache": jnp.asarray(sc["masks"][mask])}
    sr_params = jax.tree.map(jnp.asarray, sc["sr_params"])
    batch = tuple(jnp.asarray(a) for a in sc["batch"]) + (jnp.eye(3),)
    out = step(params, buffers, jo.init_state(params), sr_params,
               jo.init_state({"srnet": sr_params}), None, {}, None, batch,
               LRS, jax.random.PRNGKey(7), apply_tv=apply_tv, tv_dense=True)
    p, eo, sp, so = (jax.tree.map(np.asarray, x) for x in out[:4])
    return dict(params=p, enc_opt=eo, sr_params=sp, sr_opt=so,
                loss=float(out[7]), psnr=float(out[8]),
                terms={k: float(v) for k, v in out[9].items()})


def _port_step(sc, mask, sweep_patch, grid_window=None, apply_tv=False):
    mcfg = td.make_config(**jd.get_kwargs(sc["mcfg"]))
    buffers = {"act_shift": sc["buffers"]["act_shift"],
               "mask_cache": sc["masks"][mask]}
    params, buffers = weights.dmpigo_from_numpy(sc["params"], buffers, "cpu")
    sr_model = weights.sftnet_from_flax(sc["sr_params"], device="cpu")
    rk = dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0, rand_bkgd=False,
              ndc_planes=True)
    step = tst.SRTrainStep(
        td, mcfg, _cfg_train(), ConfigDict(dict(num_cond=1, dim_rend=3)),
        render_kwargs=rk, skip_zero_grad=frozenset(["density", "k0"]),
        sr_model=sr_model, n_views=1, patch=PATCH, sr_ratio=RATIO,
        sweep_patch=sweep_patch, grid_window=grid_window)
    enc_opt = to.init_state(params)
    sr_opt = to.init_state({"srnet": weights.sftnet_params(sr_model)})
    batch = tuple(torch.as_tensor(a) for a in sc["batch"])
    path = step.path(params, buffers, apply_tv)
    loss, psnr, terms = step(params, buffers, enc_opt, sr_opt, batch, LRS,
                             apply_tv=apply_tv, tv_dense=True)
    return dict(params=params, enc_opt=enc_opt, sr_model=sr_model,
                sr_opt=sr_opt, loss=loss.item(), psnr=psnr.item(),
                terms={k: v.item() for k, v in terms.items()}, path=path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    v = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return {prefix[:-1]: v}


@pytest.mark.parametrize("path,mask,sweep_patch", [
    ("gather", "channel", None),
    ("sweep", "channel", SWEEP_PATCH),
    ("sweep", "native", SWEEP_PATCH),
])
def test_sr_step_matches_jax(scene, path, mask, sweep_patch):
    want = _jax_step(scene, mask, sweep_patch)
    got = _port_step(scene, mask, sweep_patch)
    assert got["path"] == path
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)
    assert set(got["terms"]) == set(want["terms"])
    for k, v in want["terms"].items():
        np.testing.assert_allclose(got["terms"][k], v, rtol=1e-5, err_msg=k)

    def grad_tol(k):
        if path == "gather":
            return 1e-5
        return 2.0 ** -6 if k.startswith("enc/rgbnet") else 2.0 ** -8

    # gradients, as the first moments after one step from zero
    gm = {**_flat(got["enc_opt"]["exp_avg"], "enc/"),
          **_flat(weights.flax_kernels(got["sr_opt"]["exp_avg"]), "sr/")}
    wm = {**_flat(want["enc_opt"]["exp_avg"], "enc/"),
          **_flat(want["sr_opt"]["exp_avg"], "sr/")}
    assert set(gm) == set(wm)
    for k, w in wm.items():
        np.testing.assert_allclose(gm[k], w, rtol=0,
                                   atol=grad_tol(k) * np.abs(w).max(),
                                   err_msg=k)
    # params and second moments after the update
    gp = {**_flat(got["params"], "enc/"),
          **_flat(weights.sftnet_to_flax(got["sr_model"]), "sr/")}
    wp = {**_flat(want["params"], "enc/"), **_flat(want["sr_params"], "sr/")}
    gv = {**_flat(got["enc_opt"]["exp_avg_sq"], "enc/"),
          **_flat(weights.flax_kernels(got["sr_opt"]["exp_avg_sq"]), "sr/")}
    wv = {**_flat(want["enc_opt"]["exp_avg_sq"], "enc/"),
          **_flat(want["sr_opt"]["exp_avg_sq"], "sr/")}
    for k, w in wp.items():
        off = int(np.sum(np.abs(gp[k] - w) > 1e-4))
        assert off <= max(2, 1e-3 * w.size), (k, off, w.size)
    for k, w in wv.items():
        np.testing.assert_allclose(gv[k], w, rtol=0,
                                   atol=2 * grad_tol(k) * np.abs(w).max(),
                                   err_msg=k)
    assert got["enc_opt"]["step"] == 1 and got["sr_opt"]["step"] == 1


def test_windowed_step_equals_full_sweep_step(scene):
    full = _port_step(scene, "channel", SWEEP_PATCH)
    win = _port_step(scene, "channel", SWEEP_PATCH, GRID_WINDOW)
    assert (full["path"], win["path"]) == ("sweep", "window")
    np.testing.assert_allclose(win["loss"], full["loss"], rtol=1e-6)
    for a, b in ((win["params"], full["params"]),
                 (win["enc_opt"]["exp_avg"], full["enc_opt"]["exp_avg"]),
                 (win["enc_opt"]["exp_avg_sq"],
                  full["enc_opt"]["exp_avg_sq"]),
                 (weights.sftnet_params(win["sr_model"]),
                  weights.sftnet_params(full["sr_model"]))):
        fa, fb = _flat(a), _flat(b)
        for k in fb:
            np.testing.assert_allclose(fa[k], fb[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    # a TV step takes the full grid, as the JAX step does
    tv = _port_step(scene, "channel", SWEEP_PATCH, GRID_WINDOW,
                    apply_tv=True)
    assert tv["path"] == "sweep"


def test_windowed_masked_adam_equals_full():
    rng = np.random.default_rng(3)
    X, Y, Z, C = 20, 18, 6, 4
    gw, ox, oy = 8, 5, 7
    p = rng.normal(size=(X, Y, Z, C)).astype(np.float32)
    m = rng.normal(size=(X, Y, Z, C)).astype(np.float32) * 0.1
    v = abs(rng.normal(size=(X, Y, Z, C)).astype(np.float32)) * 0.01
    g_win = rng.normal(size=(gw, gw, Z, C)).astype(np.float32)
    g_win[1, 2, 3] = 0.0  # a zero inside the window is skipped too
    g_full = np.zeros_like(p)
    g_full[ox:ox + gw, oy:oy + gw] = g_win

    def run(g, windows):
        params = {"density": torch.tensor(p)}
        state = {"exp_avg": {"density": torch.tensor(m)},
                 "exp_avg_sq": {"density": torch.tensor(v)}, "step": 4}
        to.apply_updates(params, {"density": torch.tensor(g)}, state,
                         {"density": 0.05}, skip_zero_grad={"density"},
                         windows=windows)
        return params, state

    fp, fs = run(g_full, None)
    wp, ws = run(g_win, {"density": (ox, oy)})
    torch.testing.assert_close(wp["density"], fp["density"], rtol=0, atol=0)
    for k in ("exp_avg", "exp_avg_sq"):
        torch.testing.assert_close(ws[k]["density"], fs[k]["density"],
                                   rtol=0, atol=0)
    assert ws["step"] == 5
    with pytest.raises(ValueError, match="masked"):  # an unmasked group
        to.apply_updates(
            {"density": torch.tensor(p)}, {"density": torch.tensor(g_win)},
            to.init_state({"density": torch.tensor(p)}), {"density": 0.05},
            windows={"density": (ox, oy)})


def test_sweep_patch_train_footprint_check_raises():
    sc_cfg = td.make_config(xyz_min=[-2.0, -2.0, -1.0],
                            xyz_max=[2.0, 2.0, 1.0], num_voxels=64 * 64 * 8,
                            mpi_depth=8, rgbnet_dim=6, rgbnet_width=16)
    params, buffers = td.init(sc_cfg, device="cpu")
    from fourk_nerf_torch.ops import plane_sweep, rays
    K = np.array([[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3, :4]
    c2w[2, 3] = 1.0
    ro, rd, vd = (t.reshape(-1, 3) for t in rays.get_rays_of_a_view(
        32, 32, K, c2w, ndc=True, inverse_y=False, flip_x=False,
        flip_y=False, device="cpu"))
    with pytest.raises(ValueError, match="footprint"):
        plane_sweep.sweep_patch_train(sc_cfg, params, buffers, ro, rd, vd,
                                      stepsize=1.0, bg=0.0, patch=16)
