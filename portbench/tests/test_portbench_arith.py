"""The benchmark's arithmetic on made-up timings and the frozen bounds
against hand counts."""

import math

import pytest

from portbench import inputs, timing
from portbench.metrics import _yardstick as Y


def test_rate_and_percentile():
    assert timing.rate(231, 30.0) == pytest.approx(7.7)
    vals = list(range(1, 101))
    assert timing.percentile(vals, 95) == pytest.approx(95.05)
    assert timing.percentile([5.0], 95) == 5.0
    lat = [0.1] * 90 + [0.2] * 10
    assert timing.percentile(lat, 95) == pytest.approx(0.2)
    assert timing.percentile(lat, 50) == pytest.approx(0.1)


def test_idle_share_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (6.0, 6.5)]
    assert timing.union_seconds(iv) == pytest.approx(3.5)
    assert timing.idle_share(3.5, 7.0) == pytest.approx(50.0)
    host = [(2.0, 3.0, "aten::copy_"), (0.0, 10.0, "step"),
            (4.5, 5.5, "cudaStreamSynchronize")]
    g = timing.gaps(iv, host)
    assert g == [["cudaStreamSynchronize", pytest.approx(2.0)],
                 ["aten::copy_", pytest.approx(1.0)]]
    assert timing.gaps([(0, 1)], []) == []


def test_kernel_mean():
    import re
    k = [["void rdb_kernel<1>(RdbArgs)", 0.015, 3],
         ["void rrdb_kernel<1>(RrdbArgs)", 9.0, 1]]
    assert timing.kernel_mean_s(k, re.compile(r"\brdb_kernel\b")) == \
        pytest.approx(0.005)
    assert timing.kernel_mean_s(k, re.compile(r"\bbox_kernel\b")) is None


def test_dense_block_hand_count():
    assert Y.rdb_macs_per_px() == 249_856
    fern = inputs.config("fern_lg")
    # 381 GFLOP a launch at the 1008x756 encoder frame: 0.385 ms at peak
    flops = 2 * Y.rdb_macs_per_px() * 1008 * 756
    assert flops == pytest.approx(381e9, rel=2e-3)
    assert Y.rdb_bound_s(fern) == pytest.approx(0.385e-3, rel=2e-3)


def test_sweep_and_box_byte_counts():
    fern = inputs.config("fern_lg")
    # 363x405x256 voxels x 11 live bf16 channels + 7 floats a ray in +
    # 5 out, 1008x756 rays
    assert Y.sweep_bytes(fern) == 363 * 405 * 256 * 11 * 2 \
        + 762048 * 7 * 4 + 762048 * 5 * 4
    # the plane sweep's bound is its MLP: 55.4M weighted samples of the
    # 15-64-64-3 rgbnet, 0.588 ms at the bf16 peak
    assert Y.sweep_bound_s(fern, 55.4e6) == pytest.approx(0.588e-3,
                                                            rel=2e-3)
    chair = inputs.config("chair_syn")
    # 113 MB of live grid channels + 90 MB of per-ray inputs + 13 MB of
    # maps: 0.0642 ms at 3.35 TB/s
    grid = 159 ** 3 * 14 * 2
    assert grid == pytest.approx(113e6, rel=5e-3)
    assert Y.sweep_bytes(chair) == grid + 640000 * 35 * 4 + 640000 * 20
    assert Y.sweep_bound_s(chair, 665_943) == pytest.approx(0.0642e-3,
                                                             rel=5e-3)


def test_frame_and_step_counts():
    fern = inputs.config("fern_lg")
    macs = Y.frame_decode_macs(fern["decoder"], 756, 1008)
    # the 15 dense blocks are 2.86 TMAC of the frame's ~3.95 TMAC
    assert 15 * 249_856 * 762048 / macs == pytest.approx(0.724, abs=0.01)
    assert Y.mlp_flops([15, 64, 64, 3]) == 2 * (15 * 64 + 64 * 64 + 64 * 3)
    chair = inputs.config("chair_syn")
    f = Y.train_step_flops(chair, valid=1000, weighted=10)
    assert f == 3 * 2 * (39 * 128 + 128 * 128 + 128 * 3) * 10 \
        + 2 * 2 * 8 * (1000 + 12 * 10)
    assert math.isclose(Y.frame_flops(chair, 0.0),
                        2 * Y.frame_decode_macs(chair["decoder"], 800, 800))
