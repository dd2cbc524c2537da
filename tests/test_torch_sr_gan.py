"""Port parity of the joint trainer's GAN and perceptual path against the
JAX package.

One step. ``make_sr_train_step(donate=False)`` with ``weight_gan``,
``weight_pcp`` and ``weight_style`` all on, a shallow perceptual tower
(``conv1_2`` and ``conv2_2``, numpy-drawn) and each of the three
discriminators (``num_feat`` 8, numpy-drawn params and vectors), on the
gather path of ``tests/test_torch_sr_step.py``'s scene; the port's step
from the same state. ``Unet`` also on the full-grid plane sweep with the
mask in NATIVE mode, the path of the published fern config. Then
``Unet`` on the grid-window path against the port's full-grid sweep
step.

The loop. The JAX package's loop trains ``fern_lg_joint_l1_gan`` (cut by
``tools/tiny_scene.py``, TV off) for 6 steps with a periodic file every
3, both packages reading one synthetic torchvision-layout VGG19 from
``./weights``; the port resumes from the JAX file of step 3
(``__disc__``, ``__disc_state__``, ``opt/d``). Its step size is 0.5, so
the patches render through the float32 gather forward: on the plane
sweep the encoder's gradients are of bfloat16 grade (held so by
``tests/test_torch_sr_step.py``), and the perceptual term, large on the
synthetic tower, carries that into the generator's moments until the
losses of step 5 differ by more than 1e-4 (1.4e-4 in ``loss_l1``).
And the CLI: ``run_sr.main`` trains the GAN config with
``allow_random_vgg`` on a tiny LLFF scene and serves from its file.

Tolerances. One step: the loss and every term (the discriminator's
included) 1e-5 relative; gradients, read from the first moments after one
step from a zero state, within 1e-5 of each leaf's largest entry (the
gather path of ``tests/test_torch_sr_step.py``; second moments twice
that), where for the discriminator's leaves the largest entry is that of
``|g_real| + |g_fake|`` if it is larger: its last conv's one-element bias
is a sum of two means of about 0.5 that cancel to about 0.01, so float32
rounding of the parts is 50 times larger relative to the sum (on the
plane sweep the encoder's gradients at the bfloat16 grade of
``tests/test_torch_sr_step.py``'s sweep cases); params after MaskedAdam
(the encoder, the generator and the discriminator, per leaf) at most two
entries or 1e-3 of them off by more than 1e-4, since the first move is
``lr * sign(g)``; the vectors ``u`` 1e-5. The window step equals the full
step to 1e-6. The loop: the losses at each print 1e-4 relative, the final
files as ``tests/test_torch_sr_loop.py`` holds them."""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.config import ConfigDict
from fourk_nerf_tpu.models import dmpigo as jd, sr_unetdisc as jdisc
from fourk_nerf_tpu.train import checkpoints as jc, optim as jo, \
    sr_losses as jl, sr_trainer as jst
from fourk_nerf_torch import config as tconfig, weights
from fourk_nerf_torch.models import dmpigo as td, sr_unetdisc as tdisc
from fourk_nerf_torch.tools import tiny_scene
from fourk_nerf_torch.train import optim as to, sr_losses as tl, \
    sr_trainer as tst
from test_torch_sr_step import (GRID_WINDOW, LRS, PATCH, RATIO, SWEEP_PATCH,
                                _cfg_train, _flat, scene)  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG = os.path.join("configs", "llff", "fern_lg_joint_l1_gan.py")
KINDS = ["Unet", "Unet_pose", "Unet_viewdir"]
LAYERS = {"conv1_2": 1.0, "conv2_2": 1.0}
GAN = dict(weight_gan=0.05, weight_pcp=0.5, weight_style=0.2)


def _vgg_flax(rng):
    out, cin = {}, 3
    for name, cout in (("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128),
                       ("conv2_2", 128)):
        out[name] = {
            "kernel": rng.normal(0, np.sqrt(2.0 / (9 * cin)),
                                 (3, 3, cin, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.01, (cout,)).astype(np.float32)}
        cin = cout
    return out


def _disc(kind, rng):
    """A JAX discriminator of ``num_feat`` 8 and its numpy-drawn params
    and vectors at the step's HR patch."""
    hr = PATCH * RATIO
    if kind == "Unet_pose":
        model = jdisc.UNetDiscriminatorSNPose(num_feat=8, cmap_dim=32)
        args = (jnp.zeros((1, hr, hr, 3)), jnp.zeros((1, 9)))
    elif kind == "Unet_viewdir":
        model = jdisc.UNetDiscriminatorSNViewdir(num_feat=8, cmap_dim=64)
        args = (jnp.zeros((1, hr, hr, 3)), jnp.zeros((1, PATCH, PATCH, 63)))
    else:
        model = jdisc.UNetDiscriminatorSN(num_feat=8)
        args = (jnp.zeros((1, hr, hr, 3)),)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        if name == "u":
            return rng.normal(0, 1, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, np.sqrt(1.0 / fan_in), leaf.shape).astype(
            np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, v["params"], v["spectral"]


@pytest.fixture(scope="module")
def gan(scene):
    rng = np.random.default_rng(11)
    out = {"vgg": _vgg_flax(rng),
           "w2c": rng.normal(0, 1, (3, 3)).astype(np.float32)}
    for kind in KINDS:
        out[kind] = _disc(kind, rng)
    return out


def _rk():
    return dict(near=0.0, far=1.0, bg=1.0, stepsize=1.0, rand_bkgd=False,
                ndc_planes=True)


def _jax_gan_step(sc, g, kind, mask="channel", sweep_patch=None):
    mcfg = sc["mcfg"]
    d_model, d_params, d_state = g[kind]
    perceptual = jl.PerceptualLoss(layer_weights=LAYERS,
                                   perceptual_weight=0.5, style_weight=0.2,
                                   vgg_params=g["vgg"])
    step = jst.make_sr_train_step(
        jd, mcfg, _cfg_train(**GAN),
        ConfigDict(dict(num_cond=1, dim_rend=3, d_model=kind)),
        render_kwargs=_rk(), skip_zero_grad=frozenset(["density", "k0"]),
        sr_model=sc["sr_model"], d_model=d_model, n_views=1, patch=PATCH,
        sr_ratio=RATIO, perceptual=perceptual, d_kind=kind,
        sweep_patch=sweep_patch, donate=False)
    params = jax.tree.map(jnp.asarray, sc["params"])
    buffers = {"act_shift": jnp.asarray(sc["buffers"]["act_shift"]),
               "mask_cache": jnp.asarray(sc["masks"][mask])}
    sr_params = jax.tree.map(jnp.asarray, sc["sr_params"])
    batch = tuple(jnp.asarray(a) for a in sc["batch"]) + (
        jnp.asarray(g["w2c"]),)
    out = step(params, buffers, jo.init_state(params), sr_params,
               jo.init_state({"srnet": sr_params}), d_params, d_state,
               jo.init_state({"d": d_params}), batch, LRS,
               jax.random.PRNGKey(7), g["vgg"], apply_tv=False,
               tv_dense=True)
    p, eo, sp, so, dp, ds, do = (jax.tree.map(np.asarray, x)
                                 for x in out[:7])
    return dict(params=p, enc_opt=eo, sr_params=sp, sr_opt=so, d_params=dp,
                d_state=ds, d_opt=do, loss=float(out[7]), psnr=float(out[8]),
                terms={k: float(v) for k, v in out[9].items()})


def _port_setup(sc, g, kind, sweep_patch=None, grid_window=None,
                mask="channel"):
    mcfg = td.make_config(**jd.get_kwargs(sc["mcfg"]))
    buffers = {"act_shift": sc["buffers"]["act_shift"],
               "mask_cache": sc["masks"][mask]}
    params, buffers = weights.dmpigo_from_numpy(sc["params"], buffers, "cpu")
    sr_model = weights.sftnet_from_flax(sc["sr_params"], device="cpu")
    _, d_params, d_state = g[kind]
    d_model = weights.disc_from_flax(d_params, d_state, device="cpu")
    perceptual = tl.PerceptualLoss(
        layer_weights=LAYERS, perceptual_weight=0.5, style_weight=0.2,
        vgg_params=weights.vgg19_from_flax(g["vgg"], "cpu"), device="cpu")
    step = tst.SRTrainStep(
        td, mcfg, _cfg_train(**GAN),
        ConfigDict(dict(num_cond=1, dim_rend=3, d_model=kind)),
        render_kwargs=_rk(), skip_zero_grad=frozenset(["density", "k0"]),
        sr_model=sr_model, n_views=1, patch=PATCH, sr_ratio=RATIO,
        sweep_patch=sweep_patch, grid_window=grid_window,
        perceptual=perceptual, d_model=d_model)
    enc_opt = to.init_state(params)
    sr_opt = to.init_state({"srnet": weights.sftnet_params(sr_model)})
    d_opt = to.init_state({"d": tdisc.disc_params(d_model)})
    batch = tuple(torch.as_tensor(a) for a in sc["batch"]) + (
        torch.as_tensor(g["w2c"]),)
    return step, params, buffers, enc_opt, sr_opt, d_opt, batch


def _port_gan_step(sc, g, kind, sweep_patch=None, grid_window=None,
                   mask="channel"):
    step, params, buffers, enc_opt, sr_opt, d_opt, batch = _port_setup(
        sc, g, kind, sweep_patch, grid_window, mask)
    sr_model, d_model = step.sr_model, step.d_model
    path = step.path(params, buffers, False)
    loss, psnr, terms = step(params, buffers, enc_opt, sr_opt, batch, LRS,
                             apply_tv=False, tv_dense=True, d_opt=d_opt)
    return dict(params=params, enc_opt=enc_opt, sr_model=sr_model,
                sr_opt=sr_opt, d_model=d_model, d_opt=d_opt,
                loss=loss.item(), psnr=psnr.item(),
                terms={k: v.item() for k, v in terms.items()}, path=path)


def _d_part_scales(sc, g, kind, sweep_patch=None, mask="channel") -> dict:
    """For each discriminator leaf (flax layout), the largest entry of
    ``|g_real| + |g_fake|``: the size of its gradient's two parts before
    they cancel (the last conv's bias: two means of about 0.5 that sum to
    about 0.01), from the port's step state before the step."""
    step, params, buffers, _, _, _, batch = _port_setup(
        sc, g, kind, sweep_patch, mask=mask)
    *_, (rgb_sr, rgb_hr) = step.loss_and_grads(params, buffers, batch,
                                               LRS["enc"].keys())
    cond = step.d_condition(batch)
    leaves = [p for _, p in step.d_model.named_parameters()]
    parts = []
    for x, real in ((rgb_hr, True), (rgb_sr, False)):
        out = tdisc.apply(step.d_model, x, cond, True)
        parts.append(torch.autograd.grad(
            tl.gan_loss(out, real, is_disc=True), leaves, allow_unused=True))
    size = tdisc._tree(
        (n, sum(torch.zeros_like(p) if q is None else q.abs() for q in qs))
        for (n, p), qs in zip(step.d_model.named_parameters(), zip(*parts)))
    return {f"d/d/{k}": float(np.abs(v).max()) for k, v in
            _flat(weights.flax_kernels(size)).items()}


def _few_off(got, want, what):
    off = int(np.sum(np.abs(got - want) > 1e-4))
    assert off <= max(2, 1e-3 * want.size), (what, off, want.size)


@pytest.mark.parametrize("kind", KINDS)
def test_gan_step_matches_jax(scene, gan, kind):
    want = _jax_gan_step(scene, gan, kind)
    got = _port_gan_step(scene, gan, kind)
    assert got["path"] == "gather"
    _check_gan_step(scene, gan, kind, got, want, lambda k: 1e-5)


def test_gan_sweep_step_matches_jax(scene, gan):
    """``Unet`` on the path the published fern config takes: the
    full-grid plane sweep with the mask at another resolution (NATIVE
    mode). The encoder's gradients are held at the bfloat16 grade of
    ``tests/test_torch_sr_step.py``'s sweep cases (2^-8 of a leaf's largest
    entry, 2^-6 for the rgbnet; measured 2.2e-3 and 7.4e-3); the
    generator's and the discriminator's, which see the render's values
    only, at the gather path's 1e-5 (measured 7.5e-7 and 8.2e-7)."""
    want = _jax_gan_step(scene, gan, "Unet", "native", SWEEP_PATCH)
    got = _port_gan_step(scene, gan, "Unet", SWEEP_PATCH, mask="native")
    assert got["path"] == "sweep"

    def grad_tol(k):
        if not k.startswith("enc/"):
            return 1e-5
        return 2.0 ** -6 if k.startswith("enc/rgbnet") else 2.0 ** -8

    _check_gan_step(scene, gan, "Unet", got, want, grad_tol, SWEEP_PATCH,
                    "native")


def _check_gan_step(scene, gan, kind, got, want, grad_tol, sweep_patch=None,
                    mask="channel"):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)
    assert set(got["terms"]) == set(want["terms"])
    assert {"loss_pcp", "loss_style", "loss_g", "loss_d_real",
            "loss_d_fake"} <= set(want["terms"])
    for k, v in want["terms"].items():
        np.testing.assert_allclose(got["terms"][k], v, rtol=1e-5, err_msg=k)

    d_flax = weights.opt_state_to_flax(got["d_opt"])
    parts = _d_part_scales(scene, gan, kind, sweep_patch, mask)
    for moment, scale in (("exp_avg", 1), ("exp_avg_sq", 2)):
        gm = {**_flat(got["enc_opt"][moment], "enc/"),
              **_flat(weights.flax_kernels(got["sr_opt"][moment]), "sr/"),
              **_flat(d_flax[moment], "d/")}
        wm = {**_flat(want["enc_opt"][moment], "enc/"),
              **_flat(want["sr_opt"][moment], "sr/"),
              **_flat(want["d_opt"][moment], "d/")}
        assert set(gm) == set(wm)
        for k, w in wm.items():
            # the first moment is 0.1 g, the second 0.01 g^2
            ref = np.abs(w).max()
            if k in parts:
                ref = max(ref, 0.1 * parts[k] if moment == "exp_avg"
                          else 0.01 * parts[k] ** 2)
            np.testing.assert_allclose(gm[k], w, rtol=0,
                                       atol=scale * grad_tol(k) * ref,
                                       err_msg=f"{moment} {k}")
    dp, ds = weights.disc_to_flax(got["d_model"])
    gp = {**_flat(got["params"], "enc/"),
          **_flat(weights.sftnet_to_flax(got["sr_model"]), "sr/"),
          **_flat(dp, "d/")}
    wp = {**_flat(want["params"], "enc/"), **_flat(want["sr_params"], "sr/"),
          **_flat(want["d_params"], "d/")}
    assert set(gp) == set(wp)
    for k, w in wp.items():
        _few_off(gp[k], w, k)
    gu, wu = _flat(ds), _flat(want["d_state"])
    assert set(gu) == set(wu) and len(wu) == 8
    for k, w in wu.items():
        np.testing.assert_allclose(gu[k], w, rtol=0, atol=1e-5, err_msg=k)
        assert not np.allclose(w, _flat(gan[kind][2])[k])
    assert got["d_opt"]["step"] == 1


def test_generator_side_leaves_the_discriminator(scene, gan):
    """The generator's loss reads the discriminator without moving its
    vectors, and its gradients do not reach its params."""
    got = _port_gan_step(scene, gan, "Unet")
    step = tst.SRTrainStep(
        td, td.make_config(**jd.get_kwargs(scene["mcfg"])),
        _cfg_train(**GAN), ConfigDict(dict(num_cond=1, dim_rend=3)),
        render_kwargs=_rk(), skip_zero_grad=frozenset(["density", "k0"]),
        sr_model=got["sr_model"], n_views=1, patch=PATCH, sr_ratio=RATIO,
        d_model=got["d_model"])
    params = {k: v for k, v in got["params"].items()}
    buffers = weights.dmpigo_from_numpy(
        {}, {"act_shift": scene["buffers"]["act_shift"],
             "mask_cache": scene["masks"]["channel"]}, "cpu")[1]
    before = {k: v.clone() for k, v in _flat_t(
        {**tdisc.disc_spectral(got["d_model"]),
         **tdisc.disc_params(got["d_model"])}).items()}
    batch = tuple(torch.as_tensor(a) for a in scene["batch"]) + (
        torch.as_tensor(gan["w2c"]),)
    _, terms, _, enc_grads, sr_grads, _, sr_hr = step.loss_and_grads(
        params, buffers, batch, ["k0"])
    assert "loss_g" in terms and set(enc_grads) == {"k0"}
    for k, v in _flat_t({**tdisc.disc_spectral(got["d_model"]),
                         **tdisc.disc_params(got["d_model"])}).items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in got["d_model"].parameters())
    assert not sr_hr[0].requires_grad


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_t(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_gan_window_step_equals_full_sweep_step(scene, gan):
    full = _port_gan_step(scene, gan, "Unet", SWEEP_PATCH)
    win = _port_gan_step(scene, gan, "Unet", SWEEP_PATCH, GRID_WINDOW)
    assert (full["path"], win["path"]) == ("sweep", "window")
    np.testing.assert_allclose(win["loss"], full["loss"], rtol=1e-6)
    for k, v in full["terms"].items():
        np.testing.assert_allclose(win["terms"][k], v, rtol=1e-6, err_msg=k)
    for a, b in ((win["params"], full["params"]),
                 (win["enc_opt"]["exp_avg"], full["enc_opt"]["exp_avg"]),
                 (weights.sftnet_params(win["sr_model"]),
                  weights.sftnet_params(full["sr_model"])),
                 (tdisc.disc_params(win["d_model"]),
                  tdisc.disc_params(full["d_model"])),
                 (tdisc.disc_spectral(win["d_model"]),
                  tdisc.disc_spectral(full["d_model"])),
                 (win["d_opt"]["exp_avg_sq"], full["d_opt"]["exp_avg_sq"])):
        fa, fb = _flat(a), _flat(b)
        for k in fb:
            np.testing.assert_allclose(fa[k], fb[k], rtol=0, atol=1e-6,
                                       err_msg=k)


# --- the loop: JAX 6 steps, the port resumed from the JAX file of step 3 ---

N_ITERS = tiny_scene.JOINT_OVERRIDES["fine_train"]["N_iters"]
I_WEIGHTS = 3


def _cut(cfg, basedir):
    cfg = tiny_scene.apply_overrides(cfg, basedir, "joint",
                                     tiny_scene.JOINT_OVERRIDES)
    # float32 patch renders (the gather forward: samples off the planes)
    # and no TV, so one compiled JAX step serves the run
    cfg.fine_model_and_render.stepsize = 0.5
    cfg.fine_train.tv_before = 0
    return cfg


def _args(**kw):
    base = dict(seed=0, no_reload=False, no_reload_optimizer=False,
                ftdv_path="", ftsr_path="", i_print=1, i_val=0,
                i_weights=I_WEIGHTS, test_tile=0)
    return types.SimpleNamespace(**{**base, **kw})


class _Recorder:
    def __init__(self):
        self.rows = []

    def scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def by_step(self):
        out = {}
        for tag, v, step in self.rows:
            out.setdefault(step, {})[tag] = v
        return out


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    from test_torch_sr_losses import _synthetic_sd
    tmp = tmp_path_factory.mktemp("sr_gan_loop")
    (tmp / "weights").mkdir()
    torch.save(_synthetic_sd(), str(tmp / "weights" / "vgg19-synthetic.pth"))
    box = tuple(np.array(v) for v in tiny_scene.SR_BOX)
    data = tiny_scene.sr_scene()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)  # both packages find ./weights/vgg19-synthetic.pth
        mp.setenv("HOME", str(tmp / "home"))
        jcfg = _cut(jconfig.load_config(os.path.join(
            ROOT, "fourk_nerf_tpu", CFG)), str(tmp / "jax"))
        jw = _Recorder()
        jst.scene_rep_reconstruction_sr_patch(
            _args(no_reload=True), jcfg, jcfg.fine_model_and_render,
            jcfg.fine_train, *box, data, stage="fine", writer=jw)
        jdir = os.path.join(jcfg.basedir, jcfg.expname)
        tcfg = _cut(tconfig.load_config(os.path.join(
            ROOT, "fourk_nerf_torch", CFG)), str(tmp / "torch"))
        tw = _Recorder()
        tst.scene_rep_reconstruction_sr_patch(
            _args(ftdv_path=os.path.join(jdir, "ckpt_saved",
                                         "fine_000003.npz")),
            tcfg, tcfg.fine_model_and_render, tcfg.fine_train, *box, data,
            stage="fine", writer=tw, device="cpu")
    return dict(jax_dir=jdir, torch_dir=os.path.join(tcfg.basedir,
                                                     tcfg.expname),
                jax=jw.by_step(), torch=tw.by_step())


def test_gan_resumed_losses_match_jax(loop):
    assert sorted(loop["torch"]) == [4, 5, 6]
    for step, got in loop["torch"].items():
        want = loop["jax"][step]
        assert set(got) == set(want)
        assert {"train/loss_g", "train/loss_pcp", "train/loss_style",
                "train/loss_d_real", "train/loss_d_fake"} <= set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                       err_msg=f"{k} at {step}")


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def test_gan_final_checkpoint_matches_jax(loop):
    got = _npz(os.path.join(loop["torch_dir"], "fine_last.npz"))
    want = _npz(os.path.join(loop["jax_dir"], "fine_last.npz"))
    assert set(got) == set(want)
    assert any(k.startswith("params/__disc__/") for k in want)
    assert any(k.startswith("params/__disc_state__/") for k in want)
    assert "opt/d/step" in want
    start = _npz(os.path.join(loop["jax_dir"], "ckpt_saved",
                              f"fine_{I_WEIGHTS:06d}.npz"))
    off = total = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if k.endswith("/step") or w.dtype == bool:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
            continue
        off += int(np.sum(np.abs(got[k] - w) > 1e-4))
        total += w.size
        moved = np.linalg.norm((w - start[k]).astype(np.float64))
        err = np.linalg.norm((got[k] - w).astype(np.float64))
        assert err <= 0.05 * moved if moved else err <= 1e-4, (k, err, moved)
    assert off < 1e-3 * total, (off, total)
    assert int(got["opt/d/step"]) == N_ITERS


def test_gan_port_file_loads_in_jax_and_the_port(loop):
    path = os.path.join(loop["torch_dir"], "fine_last.npz")
    raw = _npz(path)
    *_, d, ds, step = jst.load_joint(path, ndc=True)
    assert step == N_ITERS
    flat = {f"params/__disc__/{k}": v for k, v in
            jc.common.tree_to_flat_dict(d).items()}
    flat.update({f"params/__disc_state__/{k}": v for k, v in
                 jc.common.tree_to_flat_dict(ds).items()})
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), raw[k], err_msg=k)
    assert set(flat) == {k for k in raw if k.startswith(
        ("params/__disc__/", "params/__disc_state__/"))}
    *_, td_, tds, topt, tstep, meta = tst.load_joint(path, True, "cpu")
    assert tstep == N_ITERS and topt["d"]["step"] == N_ITERS
    model = weights.disc_from_flax(td_, tds, device="cpu")
    p, s = weights.disc_to_flax(model)
    for k, v in {**{f"params/__disc__/{k}": v for k, v in
                    jc.common.tree_to_flat_dict(p).items()},
                 **{f"params/__disc_state__/{k}": v for k, v in
                    jc.common.tree_to_flat_dict(s).items()}}.items():
        np.testing.assert_array_equal(v, raw[k], err_msg=k)
    np.testing.assert_array_equal(
        topt["d"]["exp_avg"]["d"]["conv1"]["kernel"].numpy(),
        raw["opt/d/exp_avg/d/conv1/kernel"].transpose(3, 2, 0, 1))


# --- the CLI ----------------------------------------------------------------

def test_run_sr_cli_trains_gan_and_serves(tmp_path):
    """``run_sr.main`` on the GAN config (``allow_random_vgg``): it trains,
    writes the joint file with the discriminator and its optimizer, and
    ``--render_only`` serves the same scores from it."""
    from test_torch_config_data import _write_llff_scene
    from fourk_nerf_torch import run_sr

    scene_dir = tmp_path / "scene"
    _write_llff_scene(str(scene_dir), n=5, h=12, w=16)
    cfg = tmp_path / "tiny_gan.py"
    cfg.write_text(
        f"_base_ = {os.path.join(ROOT, 'fourk_nerf_torch', CFG)!r}\n"
        f"expname = 'gan'\nbasedir = {str(tmp_path / 'logs')!r}\n"
        f"data = dict(datadir={str(scene_dir)!r}, llffhold=2, width=None, "
        "height=None, rand_bkgd=False)\n"
        "fine_train = dict(N_iters=2, N_patch=4, pg_scale=[], tv_before=0, "
        "allow_random_vgg=True)\n"
        "fine_model_and_render = dict(num_voxels=16 * 16 * 8, mpi_depth=8, "
        "rgbnet_width=16, fast_color_thres=1.0 / 8 / 5)\n")
    base = ["--config", str(cfg), "--device", "cpu", "--i_print", "1",
            "--i_val", "0", "--i_weights", "0"]
    trained = run_sr.main(base + ["--render_test"])
    last = tmp_path / "logs" / "gan" / "fine_last.npz"
    raw = _npz(str(last))
    for prefix in ("params/__disc__/conv9/", "params/__disc_state__/conv1/",
                   "opt/d/exp_avg/d/conv0/"):
        assert any(k.startswith(prefix) for k in raw), prefix
    assert int(raw["opt/d/step"]) == 2
    served = run_sr.main(base + ["--render_only"])
    a, b = trained["test"], served["test"]
    assert np.isfinite(a["psnr_sr"]) and a["psnr_sr"] == b["psnr_sr"]
    for x, y in zip(a["sr_frames"], b["sr_frames"]):
        assert bool((x == y).all())
