"""The program's spans and counters (``fourk_nerf_torch.utils.trace``) on
the CPU at toy sizes: inert when off, the records' tree and self times,
the profiler's clock, the spans of a frame and of a train step, the dense
forward's sample counters, the record cap, and the benchmark's readers
of them."""

import dataclasses

import numpy as np
import pytest
import torch

from fourk_nerf_torch.config import ConfigDict
from fourk_nerf_torch.models import dmpigo, dvgo, sr_esrnet
from fourk_nerf_torch.pipeline import FramePipeline
from fourk_nerf_torch.train import optim, trainer
from fourk_nerf_torch.utils import trace
from portbench import inputs, program, run
from portbench.tests.tiny import SEED, shrunk

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean():
    """Tracing off and no records around each test; one intra-op thread
    (beside the other test workers, torch's small parallel ops would wait
    on threads the host has no cores for)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    torch.set_num_threads(n)


def _tree():
    """{name: (id, parent, root)} of the records (one record a name)."""
    return {r.name: (r.id, r.parent, r.root) for r in trace._records}


def _frame():
    """A tiny chair frame's pipeline and camera (box sweep, scale 1)."""
    cfg = shrunk(inputs.config, "chair_syn")
    cam, dec, m = cfg["camera"], cfg["decoder"], cfg["model"]
    params, buffers = inputs.scene(cfg, SEED, CPU)
    sr = sr_esrnet.SFTNet(scale=dec["scale"], num_feat=dec["num_feat"],
                          num_block=dec["num_block"],
                          num_grow_ch=dec["num_grow_ch"],
                          num_cond=dec["num_cond"])
    sr.load_state_dict(inputs.decoder(cfg, SEED, CPU))
    pipe = FramePipeline(program.model_config(cfg), params, buffers,
                         sr.eval(), stepsize=m["stepsize"], near=cam["near"],
                         bg=cam["bg"], device=CPU)
    c2w = inputs.path(inputs.traffic("flythrough")["path"], SEED)[0]
    return pipe, (cam["H"], cam["W"], inputs.intrinsics(cam), c2w)


def _rays(n, ndc, seed=0):
    g = np.random.default_rng(seed)
    if ndc:  # NDC origins on the near plane, toward the far one
        ro = np.concatenate([g.uniform(-0.8, 0.8, (n, 2)),
                             -np.ones((n, 1))], 1)
        rd = np.concatenate([g.uniform(-0.1, 0.1, (n, 2)),
                             2 * np.ones((n, 1))], 1)
    else:  # from a sphere of radius 4 toward the blob at the centre
        ro = g.normal(size=(n, 3))
        ro = 4 * ro / np.linalg.norm(ro, axis=1, keepdims=True)
        rd = -ro / 4 + g.normal(scale=0.05, size=(n, 3))
    vd = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    return tuple(torch.as_tensor(a, dtype=torch.float32)
                 for a in (ro, rd, vd))


def _scene(name):
    cfg = shrunk(inputs.config, name)
    params, buffers = inputs.scene(cfg, SEED, CPU)
    return cfg, program.model_config(cfg), params, buffers


def _train_step():
    """One tiny DirectVoxGO step with TV: a callable and its step."""
    cfg, mcfg, params, buffers = _scene("chair_syn")
    cam, t = cfg["camera"], cfg["train"]
    cfg_train = ConfigDict(dict(t, weight_tv_density=1e-4,
                                weight_tv_k0=1e-4))
    step = trainer.TrainStep(
        dvgo, mcfg, cfg_train,
        render_kwargs={"near": cam["near"], "far": cam["far"],
                       "bg": cam["bg"], "stepsize": cfg["model"]["stepsize"]},
        skip_zero_grad=frozenset(t["skip_zero_grad_fields"]))
    ro, rd, vd = _rays(64, ndc=False)
    batch = (ro, rd, vd, torch.rand(64, 3, generator=torch.Generator()
                                    .manual_seed(1)))
    opt = optim.init_state(params)
    lrs = {"density": 0.1, "k0": 0.1, "rgbnet": 1e-3}

    def call():
        return step(params, buffers, opt, batch, lrs, None, None,
                    apply_tv=True, tv_dense=False)
    return call


def _raise(*a, **k):
    raise AssertionError("called with tracing off")


def test_off_is_inert(monkeypatch):
    pipe, cam = _frame()
    call = _train_step()
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    assert not trace.on()
    pipe(*cam)
    call()
    s = trace.summary()
    assert trace._records == [] and not trace._stack
    assert s == {"spans": {}, "roots": {}, "counters": {}, "dropped": 0}


def test_spans_nest_with_parent_and_root_ids():
    outer, inner = trace.span("outer", root=True), trace.span("inner")
    trace.enable()
    with outer:
        with inner:
            torch.ones(4).sum()
        with trace.span("leaf"):
            pass
    with trace.span("alone"):
        with trace.span("under"):
            pass
    t = _tree()
    o = t["outer"][0]
    assert t["outer"] == (o, None, o)
    assert t["inner"][1:] == (o, o) and t["leaf"][1:] == (o, o)
    a = t["alone"][0]
    assert t["alone"] == (a, None, a) and t["under"][1:] == (a, a)
    s = trace.summary()
    assert s["roots"] == {"outer": 1, "alone": 1}
    assert {k: v["count"] for k, v in s["spans"].items()} == {
        "outer": 1, "inner": 1, "leaf": 1, "alone": 1, "under": 1}
    sp = s["spans"]
    assert sp["outer"]["self_host_ms"] == pytest.approx(
        sp["outer"]["host_ms"] - sp["inner"]["host_ms"]
        - sp["leaf"]["host_ms"])
    assert sp["outer"]["device_ms"] is None  # no CUDA here


def test_self_device_time_is_duration_less_children():
    trace.enable()
    step = trace.span("step", root=True)
    for _ in range(2):
        with step:
            with trace.span("a"):
                pass
            with trace.span("b"):
                with trace.span("c"):
                    pass
    for r, ms in zip(trace._records, [10.0, 3.0, 4.0, 1.5] * 2):
        r.ms = ms  # device intervals, as the events would give them
    s = trace.summary()["spans"]
    assert s["step"]["device_ms"] == 20.0
    assert s["step"]["self_device_ms"] == pytest.approx(2 * (10 - 3 - 4))
    assert s["b"]["self_device_ms"] == pytest.approx(2 * (4 - 1.5))
    assert s["c"]["self_device_ms"] == s["c"]["device_ms"] == 3.0


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.rand(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        with trace.span("outer", root=True):
            a @ a
            with trace.span("inner"):
                a @ a
    assert not trace.on()
    assert trace.summary()["roots"] == {"outer": 1}
    ev = prof.events()
    span = {e.name: e.time_range for e in ev if e.name in ("outer", "inner")}
    mms = [e.time_range for e in ev if e.name == "aten::mm"]
    assert set(span) == {"outer", "inner"} and len(mms) == 2
    for r in mms:
        assert span["outer"].start <= r.start <= r.end <= span["outer"].end
    assert sum(span["inner"].start <= r.start <= r.end <= span["inner"].end
               for r in mms) == 1


def test_a_frame_emits_its_span_tree():
    pipe, cam = _frame()
    trace.enable()
    pipe(*cam)
    t = _tree()
    f = t["frame"][0]
    assert t["frame"] == (f, None, f)
    assert t["encode"][1:] == (f, f) and t["decode"][1:] == (f, f)
    d = t["decode"][0]
    assert t["decode.blocks"][1:] == (d, f)
    assert t["decode.tail"][1:] == (d, f)
    assert set(t) == {"frame", "encode", "decode", "decode.blocks",
                      "decode.tail"}


def test_a_train_step_emits_its_span_tree():
    call = _train_step()
    trace.enable()
    call()
    t = _tree()
    s = t["train_step"][0]
    assert t["train_step"] == (s, None, s)
    for name in ("train.forward", "train.backward", "train.tv",
                 "train.adam"):
        assert t[name][1:] == (s, s), name
    order = [r.name for r in trace._records]
    assert order[:5] == ["train_step", "train.forward", "train.backward",
                         "train.tv", "train.adam"]
    c = trace.summary()["counters"]
    # DirectVoxGO colours only its weighted samples
    assert c["samples.k0"] == c["samples.weighted"] > 0


@pytest.mark.parametrize("name,mod,ndc,kw,thres", [
    ("chair_syn", dvgo, False, {"near": 2.0, "far": 6.0}, None),
    ("chair_syn", dvgo, False, {"near": 2.0, "far": 6.0}, 0.0),
    ("fern_lg", dmpigo, True, {"ndc_planes": True}, None),
], ids=["dvgo", "dvgo_thres0", "dmpigo"])
def test_dense_forward_counts_its_rows(name, mod, ndc, kw, thres):
    """``samples.k0`` counts the rows the k0 gather and the rgbnet
    compute: DirectVoxGO's weighted rows where its ``fast_color_thres`` is
    above 0, every row of a DirectVoxGO at 0 and of a DirectMPIGO."""
    cfg, mcfg, params, buffers = _scene(name)
    if thres is not None:
        mcfg = dataclasses.replace(mcfg, fast_color_thres=thres)
    ro, rd, vd = _rays(96, ndc=ndc, seed=2)
    fwd = dict(stepsize=cfg["model"]["stepsize"], bg=1.0, **kw)
    mod.forward(mcfg, params, buffers, ro, rd, vd, **fwd)
    assert trace.summary()["counters"] == {}  # off: nothing counted
    trace.enable()
    outs = [mod.forward(mcfg, params, buffers, ro, rd, vd, **fwd)
            for _ in range(2)]
    c = trace.summary()["counters"]
    w = outs[0]["weights"]
    n_rows = 2 * w.shape[0] * w.shape[1]
    assert w.shape[0] == 96
    assert c["samples.weighted"] == 2 * int((w > 0).sum())
    assert 0 < c["samples.weighted"] < n_rows
    if mod is dvgo and mcfg.fast_color_thres > 0:
        assert c["samples.k0"] == c["samples.weighted"]
    else:
        assert c["samples.k0"] == n_rows


def test_records_past_the_limit_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(trace, "LIMIT", 3)
    trace.enable()
    sp = trace.span("s", root=True)
    for _ in range(5):
        with sp:
            with trace.span("child"):
                pass
    s = trace.summary()
    assert len(trace._records) == 3 and s["dropped"] == 7
    assert s["spans"]["s"]["count"] == 2 and s["spans"]["child"]["count"] == 1
    ids = [r.id for r in trace._records]
    assert ids == sorted(set(ids))
    trace.count("n", 2)
    trace.count("n", torch.tensor(3))
    assert trace.summary()["counters"] == {"n": 5}
    trace.reset()
    assert trace.summary() == {"spans": {}, "roots": {}, "counters": {},
                               "dropped": 0}
    with sp:
        pass
    assert trace.summary()["roots"] == {"s": 1}


def test_a_span_opened_off_is_not_closed_on():
    sp = trace.span("x")
    with sp:
        trace.enable()  # turned on inside: the span never opened
        with trace.span("y"):
            pass
    assert [r.name for r in trace._records] == ["y"] and not trace._stack


HAND = {"spans": {"decode.blocks": {"device_ms": 800.0},
                  "decode.tail": {"device_ms": 350.0},
                  "train.forward": {"device_ms": 240.0},
                  "train.backward": {"device_ms": 120.0},
                  "train.tv": {"device_ms": 96.0},
                  "train.adam": {"device_ms": 36.0}},
        "roots": {"frame": 10, "train_step": 12},
        "counters": {"samples.k0": 4_500_000, "samples.weighted": 22_500},
        "dropped": 0}
READINGS = {"blocks_ms.render": ("decode.blocks", "frame", 80.0),
            "tail_ms.render": ("decode.tail", "frame", 35.0),
            "forward_ms.train": ("train.forward", "train_step", 20.0),
            "backward_ms.train": ("train.backward", "train_step", 10.0),
            "tv_ms.train": ("train.tv", "train_step", 8.0),
            "adam_ms.train": ("train.adam", "train_step", 3.0),
            "k0_useful.train": ("samples.weighted", None, 0.5)}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readers_of_spans_and_counters(monkeypatch, name):
    import copy
    read = run.reader(name)
    key, root, want = READINGS[name]
    hand = copy.deepcopy(HAND)
    monkeypatch.setattr(trace, "summary", lambda: hand)
    traced = {"profile": {}}
    assert read(traced) == pytest.approx(want)
    assert read({}) is None  # no traced window
    if root is None:
        del hand["counters"][key]
        assert read(traced) is None
        hand["counters"] = {key: 1}
    else:
        hand["spans"][key]["device_ms"] = None  # no CUDA events
        assert read(traced) is None
        del hand["spans"][key]
        assert read(traced) is None
        hand["spans"][key] = {"device_ms": 1.0}
        del hand["roots"][root]
    assert read(traced) is None
