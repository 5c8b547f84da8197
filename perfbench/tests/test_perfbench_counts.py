"""The yardstick's counts against hand-worked values, and the per-layer
readers on made-up spans and profiles."""
import pytest
import torch

from perfbench.lib import harness, peaks, weights
from perfbench.lib import profile as P
from perfbench.tests import tiny

RWKV = {"d_model": 2048, "d_ff": 7168, "n_layers": 24, "vocab_size": 65536}


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "reader_" + name)


def test_vgg11_forward_flops():
    # 2 x MACs of the eight convolutions at 32, 16, 8, 8, 4, 4, 2, 2 and
    # the 512 x 10 dense layer
    convs = [(32, 3, 64), (16, 64, 128), (8, 128, 256), (8, 256, 256),
             (4, 256, 512), (4, 512, 512), (2, 512, 512), (2, 512, 512)]
    want = sum(2 * s * s * 9 * ci * co for s, ci, co in convs) + 2 * 512 * 10
    assert want == 305_539_072
    assert reader("mfu.sagin_round").forward_flops() == want


def test_vgg11_params():
    assert weights.vgg11_param_count() == 9_225_610
    p = weights.vgg11(1, "cpu")
    n = sum(c["w"].numel() + c["b"].numel() for c in p["convs"])
    assert n + p["fc"]["w"].numel() + p["fc"]["b"].numel() == 9_225_610


def test_rwkv6_counts():
    assert reader("mfu.fl_step").multiplying_params(RWKV) == 1_543_503_872
    cfg = tiny.fl_context(1).config
    assert cfg["param_count"] == 1_678_265_856
    assert cfg["multiplying_params"] == 1_543_503_872


def test_fedavg_agg_bytes():
    """(clients + 1) x params x 4 bytes, at the HBM rate."""
    vgg = 9_225_610 * 4
    assert peaks.roofline_s(0.0, 57 * vgg, "float32") == pytest.approx(
        57 * 36_902_440 / 3.35e12)
    rwkv = 5 * 1_678_265_856 * 4
    assert rwkv == 33_565_317_120
    assert peaks.roofline_s(0.0, rwkv, "float32") == pytest.approx(
        rwkv / 3.35e12)


def test_wkv6_counts():
    """At (B, H, T, D) = (2, 32, 2048, 64) in bf16: five tensors of
    8,388,608 elements (plus u) forward, nine backward."""
    f, b = reader("wkv6_roofline.fl_step"), reader(
        "wkv6_bwd_roofline.fl_step")
    flops, nbytes = f.per_call(2, 32, 2048, 64)
    assert nbytes == 5 * 2 * 32 * 2048 * 64 * 2 + 32 * 64 * 2 == 83_890_176
    assert flops == 7 * 2 * 32 * 2048 * 64 * 64
    bflops, bbytes = b.per_call(2, 32, 2048, 64)
    assert bbytes == 9 * 8_388_608 * 2 + 2 * 32 * 64 * 2
    assert bflops == 2 * flops
    # both are bound by bytes
    assert peaks.roofline_s(flops, nbytes, "bfloat16") == nbytes / 3.35e12


def _profile(events, window=(0, 10_000_000)):
    return {"events": events, "window_s": (window[1] - window[0]) * 1e-9,
            "busy_s": sum(b - a for a, b in P.union(
                [(e[0], e[1]) for e in events])) * 1e-9}


def test_rooflines_read_kernel_time():
    events = [(0, 1_000_000, "fedavg_agg_kernel(Table, float const*)"),
              (2_000_000, 2_500_000, "void wkv6_chunked<64>(...)"),
              (3_000_000, 3_100_000, "void wkv6_bwd_chunk<64>(...)")]
    data = {"profile": _profile(events), "profiled": [{"clients": 56}],
            "n_params": 9_225_610}
    got = reader("fedavg_agg_roofline.sagin").read(data)
    assert got == pytest.approx(100 * 57 * 9_225_610 * 4 / 3.35e12 / 1e-3)
    assert reader("fedavg_agg_roofline.sagin").read(
        dict(data, profile=_profile(events[1:]))) is None
    ctx = tiny.fl_context(1)
    data = {"profile": _profile(events), "profiled": [{}],
            "workload": ctx.workload, "config": ctx.config}
    # 8 rows a replica: five (8, 32, 2048, 64) bf16 tensors and u a call
    calls = 4 * 2 * 24
    assert 5 * 8 * 32 * 2048 * 64 * 2 + 32 * 64 * 2 == 335_548_416
    want = 100 * calls * 335_548_416 / 3.35e12 / 0.5e-3
    assert reader("wkv6_roofline.fl_step").read(data) == pytest.approx(want)
    assert reader("wkv6_bwd_roofline.fl_step").read(data) > 0


def test_idle_share_and_union():
    events = [(0, 4_000_000, "a"), (2_000_000, 6_000_000, "b")]
    data = {"profile": _profile(events)}
    assert reader("idle_share.sagin").read(data) == pytest.approx(0.4)
    assert reader("idle_share.fl_step").read({}) is None


def test_span_readers():
    spans = [{"kind": "bucket_dispatch", "round": 7, "dur_wall": 0.5,
              "attrs": {"real": 60, "layout": 100}},
             {"kind": "bucket_dispatch", "round": 7, "dur_wall": 0.25,
              "attrs": {"real": 20, "layout": 60}},
             {"kind": "round", "round": 7, "dur_wall": 0.0, "attrs": {}}]
    data = {"spans": spans, "rounds": [{"round": 7, "t0": 1.0, "t1": 2.0}]}
    assert reader("control_ms.sagin").read(data) == pytest.approx(250.0)
    assert reader("local_update_ms.sagin").read(data) == pytest.approx(750.0)
    assert reader("cohort_real_share.sagin").read(data) == pytest.approx(0.5)
    assert reader("control_ms.sagin").read({"spans": []}) is None


def test_mfu_readers():
    cfg = harness.context("sagin_round.vgg11.adaptive", 1).config
    data = {"profiled": [{"real_samples": 600, "t0": 0.0, "t1": 1.5},
                         {"real_samples": 400, "t0": 1.5, "t1": 2.0}],
            "rounds": [{"real_samples": 1, "t0": 0.0, "t1": 9.0}],
            "wall_s": 9.0, "config": cfg}
    want = 100 * 3 * 305_539_072 * 1000 / (2.0 * 67e12)
    assert reader("mfu.sagin_round").read(data) == pytest.approx(want)
    fcfg = tiny.fl_context(1).config
    data = {"rounds": [{}], "wall_s": 2.0, "tokens": 32768, "config": fcfg}
    want = 100 * 6 * 1_543_503_872 * 32768 / (2.0 * 989e12)
    assert reader("mfu.fl_step").read(data) == pytest.approx(want)


def test_profile_reduction_on_the_cpu():
    """The reduction runs on a CPU profile: the window mark is found and,
    with no device events, the card was busy 0 s."""
    with P.capture(True) as prof:
        with torch.profiler.record_function(P.WINDOW):
            torch.ones(64, 64) @ torch.ones(64, 64)
    red = P.reduce(prof)
    assert red["window_s"] > 0
    assert set(red["breakdown"]) == {"device_ops", "idle_gaps"}
    if not torch.cuda.is_available():
        assert red["busy_s"] == 0.0
