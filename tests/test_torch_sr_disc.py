"""Port parity of the spectral-norm U-Net discriminators
(``models/sr_unetdisc.py``) against the JAX package's flax modules: the
plain ``Unet``, ``Unet_pose`` and ``Unet_viewdir`` at ``num_feat`` 8, the
same numpy-drawn params and vectors ``u`` carried into both packages by
``weights.disc_from_flax``; a 32x32 input (batch 2, so the minibatch
stddev sees a group) and a 20x20 one (resized to 16x16, antialiased, as
``jax.image.resize`` shrinks).

Tolerances: outputs and gradients (params and input) within 1e-5 of each
array's largest entry; the vectors ``u`` (unit norm) within 1e-5; weight
trees exactly; sigma after 30 power iterations within 5% of the largest
singular value, as the JAX package's own test holds it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fourk_nerf_tpu.models import sr_unetdisc as jd
from fourk_nerf_tpu.ops import rays as jrays
from fourk_nerf_torch import weights
from fourk_nerf_torch.models import sr_unetdisc as td

KINDS = ["Unet", "Unet_pose", "Unet_viewdir"]
NF = 8


def _jax_model(kind):
    if kind == "Unet_pose":
        return jd.UNetDiscriminatorSNPose(num_feat=NF, cmap_dim=32)
    if kind == "Unet_viewdir":
        return jd.UNetDiscriminatorSNViewdir(num_feat=NF, cmap_dim=64)
    return jd.UNetDiscriminatorSN(num_feat=NF)


def _inputs(kind, hw, n, rng):
    x = rng.uniform(0, 1, (n, hw, hw, 3)).astype(np.float32)
    if kind == "Unet_pose":
        return x, rng.normal(0, 1, (n, 9)).astype(np.float32)
    if kind == "Unet_viewdir":
        return x, rng.normal(0, 1, (n, hw // 4, hw // 4, 63)).astype(
            np.float32)
    return x, None


def _draw(kind, x, cond, rng):
    """Numpy-drawn flax params (biases non-zero) and spectral vectors."""
    model = _jax_model(kind)
    args = (x,) if cond is None else (x, cond)
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


def _jax_apply(model, update_sn):
    @jax.jit
    def f(p, s, x, c):
        args = (x,) if c is None else (x, c)
        return model.apply({"params": p, "spectral": s}, *args,
                           update_sn=update_sn, mutable=["spectral"])
    return f


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().numpy() if isinstance(
        tree, torch.Tensor) else np.asarray(tree)}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.fixture(scope="module")
def cases():
    out = {}
    rng = np.random.default_rng(0)
    for kind in KINDS:
        for hw, n in ((32, 2), (20, 1)):
            x, c = _inputs(kind, hw, n, rng)
            model, p, s = _draw(kind, x, c, rng)
            out[kind, hw] = dict(model=model, params=p, spectral=s, x=x,
                                 cond=c)
    return out


def _port(case):
    d = weights.disc_from_flax(case["params"], case["spectral"],
                               device="cpu")
    x = torch.tensor(case["x"])
    c = None if case["cond"] is None else torch.tensor(case["cond"])
    return d, x, c


@pytest.mark.parametrize("hw", [32, 20])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_and_power_iteration_match_jax(cases, kind, hw):
    case = cases[kind, hw]
    want, new = _jax_apply(case["model"], True)(
        case["params"], case["spectral"], case["x"], case["cond"])
    d, x, c = _port(case)
    assert d.kind == kind
    got = td.apply(d, x, c, update_sn=True)
    assert tuple(got.shape) == tuple(want.shape)
    if kind == "Unet":
        assert tuple(got.shape[1:3]) == (hw // 8 * 8,) * 2
    _close(got.detach().numpy(), np.asarray(want), "output")
    gu, wu = _flat(td.disc_spectral(d)), _flat(new["spectral"])
    assert set(gu) == set(wu) and len(wu) == 8
    for k, w in wu.items():
        np.testing.assert_allclose(gu[k], w, rtol=0, atol=1e-5, err_msg=k)
        assert not np.allclose(w, _flat(case["spectral"])[k])  # u moved


@pytest.mark.parametrize("kind", KINDS)
def test_no_update_leaves_u_and_matches_jax(cases, kind):
    case = cases[kind, 32]
    want, new = _jax_apply(case["model"], False)(
        case["params"], case["spectral"], case["x"], case["cond"])
    d, x, c = _port(case)
    before = {k: v.clone() for k, v in _flat_t(td.disc_spectral(d)).items()}
    got = td.apply(d, x, c, update_sn=False)
    _close(got.detach().numpy(), np.asarray(want), "output")
    for k, v in _flat_t(td.disc_spectral(d)).items():
        assert torch.equal(v, before[k]), k
        np.testing.assert_array_equal(v.numpy(),
                                      _flat(new["spectral"])[k])


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_t(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("kind,hw", [("Unet", 32), ("Unet_pose", 32),
                                     ("Unet_viewdir", 32), ("Unet", 20)])
def test_gradients_match_jax(cases, kind, hw):
    """The gradients of ``sum(D(x) * cotangent)`` with respect to every
    parameter and to the input, with the vectors updated on the way."""
    case = cases[kind, hw]
    model = case["model"]
    ct = np.random.default_rng(1).normal(
        0, 1, _jax_apply(model, True)(case["params"], case["spectral"],
                                      case["x"], case["cond"])[0].shape
    ).astype(np.float32)

    @jax.jit
    def jgrad(p, s, x, c):
        def f(p, x):
            args = (x,) if c is None else (x, c)
            out, _ = model.apply({"params": p, "spectral": s}, *args,
                                 update_sn=True, mutable=["spectral"])
            return jnp.sum(out * ct)
        return jax.grad(f, argnums=(0, 1))(p, x)

    gp, gx = jgrad(case["params"], case["spectral"], case["x"], case["cond"])
    d, x, c = _port(case)
    x.requires_grad_(True)
    (td.apply(d, x, c, update_sn=True) * torch.tensor(ct)).sum().backward()
    tgrad = td._tree((n, p.grad) for n, p in d.named_parameters())
    got, want = _flat(weights.flax_kernels(tgrad)), _flat(gp)
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, k)
    _close(x.grad.numpy(), np.asarray(gx), "input")


def test_spectral_norm_bounds_singular_value():
    """30 power iterations from the same ``u`` on a kernel scaled by 37:
    the port's vector equals the JAX module's, and its sigma is within 5%
    of the largest singular value (the JAX package's test)."""
    rng = np.random.default_rng(2)
    model = jd.SNConv(features=8, kernel_size=(3, 3))
    x = np.ones((1, 8, 8, 4), np.float32)
    kernel = (rng.normal(0, 1, (3, 3, 4, 8)) * 37.0).astype(np.float32)
    state = {"u": rng.normal(0, 1, 8).astype(np.float32)}
    step = jax.jit(lambda p, s: model.apply(
        {"params": p, "spectral": s}, x, True, mutable=["spectral"]))
    conv = td.SNConv(4, 8, 3)
    with torch.no_grad():
        conv.kernel.copy_(torch.tensor(kernel).permute(3, 2, 0, 1))
        conv.u.copy_(torch.tensor(state["u"]))
    for _ in range(30):
        state = step({"kernel": kernel}, state)[1]["spectral"]
        conv(torch.ones(1, 4, 8, 8), update_sn=True)
    np.testing.assert_allclose(conv.u.numpy(), np.asarray(state["u"]),
                               rtol=0, atol=1e-5)
    w = conv.kernel.detach().reshape(8, -1).numpy()
    true_sigma = np.linalg.svd(w, compute_uv=False)[0]
    sigma = float(conv.sigma(update_sn=False))
    assert abs(sigma - true_sigma) / true_sigma < 0.05
    # the normalized kernel's largest singular value is about 1
    y = conv(torch.ones(1, 4, 8, 8), update_sn=False)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("kind", KINDS)
def test_flax_trees_round_trip(cases, kind):
    """``disc_to_flax(disc_from_flax(p, s))`` is ``(p, s)`` bit for bit,
    with the flax collections' tree structure (no params for the pose
    variant's unused ``trunk``)."""
    case = cases[kind, 32]
    d, _, _ = _port(case)
    p, s = weights.disc_to_flax(d)
    fp, fs = _flat(p), _flat(s)
    assert set(fp) == set(_flat(case["params"]))
    assert set(fs) == set(_flat(case["spectral"]))
    for k, v in _flat(case["params"]).items():
        np.testing.assert_array_equal(fp[k], v, err_msg=k)
    for k, v in _flat(case["spectral"]).items():
        np.testing.assert_array_equal(fs[k], v, err_msg=k)
    if kind != "Unet":
        assert set(p) == {"feat", "mapping", "epilogue"}
        assert set(s) == {"feat"}


@pytest.mark.parametrize("n", [1, 4])
def test_minibatch_std_matches_jax(n):
    x = np.random.default_rng(3).normal(0, 1, (n, 5, 6, 8)).astype(
        np.float32)
    want = jax.jit(lambda x: jd.MinibatchStdLayer().apply({}, x))(x)
    got = td.minibatch_std(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    if n == 1:  # one sample: the stddev channel is sqrt(1e-8)
        np.testing.assert_allclose(got[..., -1].numpy(), 1e-4, rtol=1e-6)


def test_conditions_match_the_jax_step():
    """The viewdir PE map and the flattened w2c the JAX step builds
    (sr_trainer.py:142-150)."""
    rng = np.random.default_rng(4)
    vd = rng.normal(0, 1, (16, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    w2c = rng.normal(0, 1, (3, 3)).astype(np.float32)
    want = np.asarray(jrays.positional_encoding(jnp.asarray(vd), 10)
                      ).reshape(1, 4, 4, -1)
    got = td.d_condition("Unet_viewdir", torch.tensor(vd), None, 4)
    assert tuple(got.shape) == (1, 4, 4, 63) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        td.d_condition("Unet_pose", None, torch.tensor(w2c), 4).numpy(),
        w2c.reshape(1, 9))
    assert td.d_condition("Unet", torch.tensor(vd), None, 4) is None
    with pytest.raises(ValueError, match="w2c"):
        td.d_condition("Unet_pose", torch.tensor(vd), None, 4)


@pytest.mark.parametrize("kind", KINDS)
def test_init_like_flax_distributions(kind):
    """Kernels lecun-normal (std within 5% of 1/sqrt(fan_in) where a
    leaf has 2,000 draws or more), biases zero, ``u`` standard normal;
    the same seed draws the same weights."""
    def make(seed):
        d = td.build(kind, 16, td.fc_in_for(16, (32, 32)))
        return td.init_like_flax(d, torch.Generator().manual_seed(seed))

    d = make(0)
    for name, p in d.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = p.shape[0] if p.dim() == 2 else p[0].numel()
        if p.numel() >= 2000:
            std = float(p.detach().std()) * np.sqrt(fan_in)
            assert abs(std - 1.0) < 0.05, (name, std)
        assert float(p.detach().abs().max()) <= 2.0 / 0.8796256 / np.sqrt(
            fan_in), name
    us = torch.cat([b for n, b in d.named_buffers() if n.endswith("u")])
    assert abs(float(us.std()) - 1.0) < 0.15
    again = make(0)
    for (n, a), (_, b) in zip(d.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n
