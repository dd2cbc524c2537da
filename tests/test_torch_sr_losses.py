"""Port parity of the SR-training losses (``train/sr_losses.py``) against
the JAX package's: the vanilla GAN loss on both sides, the VGG19 tower on
its three default layers, the perceptual and style loss and their
gradient, the Gram matrix, NNFM's three terms; the torchvision-layout
loader on a synthetic ``.pth`` read by both packages, the search for the
weights, the random tower, and the trainer's refusal without weights.

Every tower is numpy-drawn (the real weights are not in the image) and
carried into the port by ``weights.vgg19_from_flax``. Tolerances: losses
1e-5 relative; features and gradients within 1e-5 of each array's
largest entry; imported weights exactly."""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.train import sr_losses as jl
from fourk_nerf_torch import weights
from fourk_nerf_torch.train import sr_losses as tl

DEFAULT = ("conv3_4", "conv4_4", "conv5_4")
_TORCH_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]


def _close(got, want, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _vgg_flax(seed=0, deepest=16):
    """A numpy-drawn flax VGG19 tree (He-scaled kernels, small biases)."""
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for item in jl._VGG19_PLAN:
        if item == "M":
            continue
        name, cout = item
        if len(out) == deepest:
            break
        out[name] = {
            "kernel": rng.normal(0, np.sqrt(2.0 / (9 * cin)),
                                 (3, 3, cin, cout)).astype(np.float32),
            "bias": rng.normal(0, 0.01, (cout,)).astype(np.float32)}
        cin = cout
    return out


@pytest.fixture(scope="module")
def vgg():
    return _vgg_flax()


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    gt = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    return x, gt


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("is_disc", [True, False])
def test_gan_loss_matches_jax(real, is_disc):
    pred = np.random.default_rng(2).normal(0, 30, (1, 8, 8, 1)).astype(
        np.float32)  # large logits: the stable form
    want = jl.gan_loss(jnp.asarray(pred), real, is_disc=is_disc,
                       loss_weight=0.05)
    got = tl.gan_loss(torch.tensor(pred), real, is_disc=is_disc,
                      loss_weight=0.05)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert np.isfinite(float(got))


def test_vgg19_features_match_jax(vgg, images):
    x = images[0]
    model = jl.VGG19Features(layers=DEFAULT)
    want = jax.jit(lambda p, x: model.apply({"params": p}, x))(vgg, x)
    port = tl.VGG19Features(DEFAULT, weights.vgg19_from_flax(vgg, "cpu"),
                            device="cpu")
    got = port(torch.tensor(x))
    assert set(got) == set(DEFAULT)
    for name in DEFAULT:
        assert tuple(got[name].shape) == tuple(want[name].shape)
        _close(got[name], want[name], name)
    # the tower stops at the deepest requested layer
    shallow = tl.VGG19Features(("conv2_2",), weights.vgg19_from_flax(
        vgg, "cpu"), device="cpu")
    assert set(shallow.params) == {"conv1_1", "conv1_2", "conv2_1",
                                   "conv2_2"}


@pytest.mark.parametrize("layers", [None, {"conv1_2": 1.0, "conv2_2": 0.5}])
def test_perceptual_and_style_match_jax(vgg, images, layers):
    """The weighted (perceptual, style) pair and the gradient of their sum
    with respect to the SR output; no gradient reaches the truth."""
    x, gt = images
    jp = jl.PerceptualLoss(layer_weights=layers, perceptual_weight=0.5,
                           style_weight=0.2, vgg_params=vgg)

    @jax.jit
    def f(p, x, gt):
        return jax.value_and_grad(
            lambda x: sum(jp.loss_with_params(p, x, gt)), has_aux=False)(x)

    want_pair = jax.jit(jp.loss_with_params)(vgg, x, gt)
    want_sum, want_grad = f(vgg, x, gt)
    tp = tl.PerceptualLoss(layer_weights=layers, perceptual_weight=0.5,
                           style_weight=0.2,
                           vgg_params=weights.vgg19_from_flax(vgg, "cpu"),
                           device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    gtt = torch.tensor(gt, requires_grad=True)
    pcp, style = tp(xt, gtt)
    for g, w in zip((pcp, style), want_pair):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    (pcp + style).backward()
    np.testing.assert_allclose((pcp + style).item(), float(want_sum),
                               rtol=1e-5)
    _close(xt.grad, want_grad, "grad x")
    assert gtt.grad is None
    for p in tp.model.params.values():
        assert not any(t.requires_grad for t in p.values())


def test_style_weight_zero_gives_zero(vgg, images):
    x, gt = images
    tp = tl.PerceptualLoss(style_weight=0.0,
                           vgg_params=weights.vgg19_from_flax(vgg, "cpu"),
                           device="cpu")
    pcp, style = tp(torch.tensor(x), torch.tensor(gt))
    assert float(style) == 0.0 and float(pcp) > 0


def test_gram_matches_jax():
    f = np.random.default_rng(3).normal(0, 1, (2, 5, 7, 6)).astype(
        np.float32)
    _close(tl._gram(torch.tensor(f)), jl._gram(jnp.asarray(f)))
    assert tuple(tl._gram(torch.tensor(f)).shape) == (2, 6, 6)


def test_nnfm_terms_match_jax(vgg, images):
    """NNFM's three terms on a shallow tower, and the nearest-neighbour
    term in blocks smaller than the features (its gradient too)."""
    x, gt = images
    layers = ("conv1_2", "conv2_2")
    names = ("nnfm_loss", "gram_loss", "content_loss")
    want = jl.NNFMLoss(layers=layers, vgg_params=vgg)(
        jnp.asarray(x), jnp.asarray(gt), loss_names=names)
    got = tl.NNFMLoss(layers=layers,
                      vgg_params=weights.vgg19_from_flax(vgg, "cpu"),
                      device="cpu")(torch.tensor(x), torch.tensor(gt),
                                    loss_names=names)
    assert set(got) == set(names)
    for k in names:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    rng = np.random.default_rng(4)
    a = rng.normal(0, 1, (1, 9, 10, 8)).astype(np.float32)
    b = rng.normal(0, 1, (1, 6, 7, 8)).astype(np.float32)
    w_val, w_grad = jax.value_and_grad(
        lambda a: jl.nn_feature_match_loss(a, jnp.asarray(b), block=16))(
        jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    g_val = tl.nn_feature_match_loss(at, torch.tensor(b), block=16)
    g_val.backward()
    np.testing.assert_allclose(g_val.item(), float(w_val), rtol=1e-5)
    _close(at.grad, w_grad, "nnfm grad")


def _synthetic_sd(seed=0):
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    chans = [item[1] for item in jl._VGG19_PLAN if isinstance(item, tuple)]
    for idx, cout in zip(_TORCH_IDX, chans):
        sd[f"features.{idx}.weight"] = torch.tensor(
            rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.tensor(
            rng.normal(0, 0.01, (cout,)).astype(np.float32))
        cin = cout
    return sd


class _Holder:
    """An object the safe unpickler refuses, with a ``state_dict``."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def test_import_vgg19_torch_matches_jax(tmp_path, monkeypatch):
    sd = _synthetic_sd()
    pth = tmp_path / "vgg19-synthetic.pth"
    torch.save(sd, str(pth))
    got = tl.import_vgg19_torch(str(pth))
    want = jl.import_vgg19_torch(str(pth))
    assert set(got) == set(want) and len(got) == 16
    for name, p in want.items():
        np.testing.assert_array_equal(
            weights.flax_kernels(got[name])["kernel"].numpy(),
            np.asarray(p["kernel"]), err_msg=name)
        np.testing.assert_array_equal(got[name]["bias"].numpy(),
                                      np.asarray(p["bias"]), err_msg=name)
    # a file the safe unpickler refuses needs the explicit opt-in
    bad = tmp_path / "vgg19-pickled.pth"
    torch.save(_Holder(sd), str(bad))
    monkeypatch.delenv("FOURK_ALLOW_UNSAFE_PICKLE", raising=False)
    with pytest.raises(RuntimeError, match="allow_unsafe_pickle"):
        tl.import_vgg19_torch(str(bad))
    again = tl.import_vgg19_torch(str(bad), allow_unsafe_pickle=True)
    assert torch.equal(again["conv5_4"]["kernel"], got["conv5_4"]["kernel"])
    monkeypatch.setenv("FOURK_ALLOW_UNSAFE_PICKLE", "1")
    assert torch.equal(tl.import_vgg19_torch(str(bad))["conv1_1"]["bias"],
                       got["conv1_1"]["bias"])


def test_find_vgg19_weights_looks_where_jax_does(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    assert tl.find_vgg19_weights() is None and jl.find_vgg19_weights() is None
    with pytest.raises(FileNotFoundError, match="allow_random_vgg"):
        tl.PerceptualLoss(device="cpu")
    (tmp_path / "pretrained").mkdir()
    (tmp_path / "pretrained" / "vgg19-b.pth").write_bytes(b"")
    (tmp_path / "weights").mkdir()
    (tmp_path / "weights" / "vgg19-z.pth").write_bytes(b"")
    (tmp_path / "weights" / "vgg19-a.pth").write_bytes(b"")
    (tmp_path / "weights" / "resnet.pth").write_bytes(b"")
    assert tl.find_vgg19_weights() == jl.find_vgg19_weights() == os.path.join(
        ".", "weights", "vgg19-a.pth")


def test_random_tower_is_fixed_and_lecun_scaled():
    a, b = tl.random_vgg19_params(), tl.random_vgg19_params()
    assert list(a) == [item[0] for item in tl.VGG19_PLAN
                       if isinstance(item, tuple)]
    for name in a:
        assert torch.equal(a[name]["kernel"], b[name]["kernel"])
        k = a[name]["kernel"]
        fan_in = k[0].numel()
        assert abs(float(k.std()) * np.sqrt(fan_in) - 1.0) < 0.05, name
        assert not a[name]["bias"].any()
    tp = tl.PerceptualLoss(allow_random_vgg=True, device="cpu")
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    pcp, _ = tp(x, x.flip(1))
    assert float(pcp) > 0


def _refusal_cfg(tmp_path, **fine_train):
    from fourk_nerf_torch import config as tconfig
    from fourk_nerf_torch.tools import tiny_scene
    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = tconfig.load_config(os.path.join(
        root, "fourk_nerf_torch", "configs", "llff",
        "fern_lg_joint_l1_gan.py"))
    cfg = tiny_scene.apply_overrides(cfg, str(tmp_path), "pcp",
                                     tiny_scene.JOINT_OVERRIDES)
    cfg.fine_train.N_iters = 1
    cfg.fine_train.weight_gan = 0
    for k, v in fine_train.items():
        cfg.fine_train[k] = v
    return cfg


def test_trainer_refuses_weight_pcp_without_weights(tmp_path, monkeypatch):
    """weight_pcp > 0 with no VGG19 weights is an error before training,
    as in the JAX package (tests/test_sr_losses_vgg.py:85); the two
    explicit escape hatches drop the term or take the random tower."""
    from fourk_nerf_torch.tools import tiny_scene
    from fourk_nerf_torch.train import sr_trainer as tst
    monkeypatch.setattr(tl, "find_vgg19_weights", lambda: None)
    cfg = _refusal_cfg(tmp_path)
    args = types.SimpleNamespace(seed=0, no_reload=True, ftdv_path="",
                                 ftsr_path="", i_print=1, i_val=0,
                                 i_weights=0, test_tile=0)
    box = tuple(np.array(v) for v in tiny_scene.SR_BOX)
    with pytest.raises(RuntimeError, match="weight_pcp=0.5"):
        tst.scene_rep_reconstruction_sr_patch(
            args, cfg, cfg.fine_model_and_render, cfg.fine_train, *box,
            tiny_scene.sr_scene(), stage="fine", device="cpu")
    assert not os.path.exists(os.path.join(str(tmp_path), "pcp",
                                           "fine_last.npz"))
    missing = _refusal_cfg(tmp_path, allow_missing_vgg=True)
    assert tst.build_perceptual(missing.fine_train, device="cpu") is None
    rand = _refusal_cfg(tmp_path, allow_random_vgg=True)
    pl = tst.build_perceptual(rand.fine_train, device="cpu")
    assert (pl.perceptual_weight, pl.style_weight) == (0.5, 0.2)
    assert torch.equal(pl.model.params["conv1_1"]["kernel"],
                       tl.random_vgg19_params()["conv1_1"]["kernel"])
    assert tst.build_perceptual(_refusal_cfg(
        tmp_path, weight_pcp=0).fine_train, device="cpu") is None
