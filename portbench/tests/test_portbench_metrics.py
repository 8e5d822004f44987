"""The metric arithmetic: tails count unserved requests as +inf, rates
and gaps are taken over the window only, and the per-layer readers read
what the run gives them and nothing where it gives nothing."""
import math

import pytest

from portbench import harness, peaks, reduce, spec, stats, tracing


def test_unserved_request_is_inf_in_the_tail():
    due = {r: 0.0 for r in range(10)}
    first = {r: 0.1 * (r + 1) for r in range(9)}          # rid 9 never
    t = stats.ttfts(due, first)
    assert t[9] == math.inf
    assert stats.nearest_rank(t, 90) == pytest.approx(0.9)
    assert stats.nearest_rank(t, 95) == math.inf
    assert stats.nearest_rank([3.0, 1.0, 2.0], 50) == 2.0
    assert stats.nearest_rank([], 90) == math.inf


def test_rates_and_gaps_over_the_window_only():
    stamps = [0.5, 1.0, 1.2, 2.0, 3.5, 4.0]
    assert stats.tokens_in(stamps, 1.0, 3.5) == 3          # [1.0, 3.5)
    assert stats.gaps_in(stamps, 1.0, 3.5) == pytest.approx([0.5, 0.2, 0.8])


def test_backlog_trend():
    tr = stats.backlog_trend([(t, 2 * t + 1) for t in range(10)])
    assert tr["slope_per_s"] == pytest.approx(2.0)
    assert (tr["start"], tr["end"], tr["max"]) == (1, 19, 19)


def _trace(kernel_ms=2.0):
    """A synthetic chrome trace: a 10 ms slice, two kernels and a copy,
    the host inside plane.scale during the longest gap."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.slice",
           "ts": 1000.0, "dur": 10000.0},
          {"ph": "X", "cat": "kernel", "name": "void flash_decode_kernel<1>",
           "ts": 1000.0, "dur": kernel_ms * 1e3},
          {"ph": "X", "cat": "kernel", "name": "ampere_bf16_gemm",
           "ts": 2500.0, "dur": 1000.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 9000.0, "dur": 500.0},
          {"ph": "X", "cat": "user_annotation", "name": "plane.step",
           "ts": 3000.0, "dur": 6000.0},
          {"ph": "X", "cat": "user_annotation", "name": "plane.scale",
           "ts": 4000.0, "dur": 4000.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
           "ts": 5000.0, "dur": 100.0}]
    return ev


def test_reduce_trace():
    r = tracing.reduce_trace(_trace())
    assert r["slice_s"] == pytest.approx(0.010)
    assert r["busy_s"] == pytest.approx(0.003)         # 1000-3500, 9000-9500
    assert r["kernel_s"] == {"flash_decode": pytest.approx(0.002)}
    assert r["idle_gaps"][0] == ["plane.scale", pytest.approx(0.0055)]
    assert r["device_ops"][0][0] == "void flash_decode_kernel<1>"


def _ctx(root, trace):
    cfg = spec.load_cell(root, "granite-3-8b.chat").config
    window = {"ticks": 4, "plane_host_s": 0.2, "sync_wait_s": 0.04,
              "captures": 2, "decode_dispatches": 5, "decode_tokens": 50,
              "replicas": [2, 4, 4, 6], "ttft_p90_s": 0.375}
    return harness.Ctx(cfg, window, trace, root)


def test_readers(root):
    ctx = _ctx(root, None)
    read = lambda n: spec.metric_reader(root, n)(ctx)
    assert read("plane.host_ms_per_tick") == pytest.approx(50.0)
    assert read("frontend.sync_wait_ms_per_tick") == pytest.approx(10.0)
    assert read("plane.mean_replicas") == pytest.approx(4.0)
    assert read("graphs.captures") == 2
    assert read("frontend.ttft_p90_s") == pytest.approx(0.375)
    ctx.window["ttft_p90_s"] = float("inf")          # one never served
    assert read("frontend.ttft_p90_s") is None
    assert read("engine.rows_per_decode") == pytest.approx(10.0)
    for n in ("model.mfu.tail", "flash_decode_roofline.tail",
              "flash_attention_roofline", "ssd_scan_roofline",
              "device.idle_share.tail"):
        assert read(n) is None                      # no trace: nothing


def test_roofline_and_mfu_from_records(root):
    t = dict(tracing.reduce_trace(_trace()),
             records=[("decode", 7, [100, 300]), ("prefill", 7, [64])])
    ctx = _ctx(root, t)
    cfg = ctx.cfg
    fl, by = ctx.counts("flash_decode").work([100, 300], cfg)
    want = 100 * cfg["num_layers"] * peaks.bound_s(
        fl, by, peaks.BF16_FLOPS_PER_S) / 0.002
    assert reduce.roofline(ctx, "flash_decode") == pytest.approx(want)
    # flash_attention ran in no slice kernel: nothing, not 0
    assert reduce.roofline(ctx, "flash_attention") is None
    assert reduce.roofline(ctx, "ssd_scan") is None
    mf = ctx.counts("model_dense").flops
    total = mf(cfg, 2, 400, 2) + mf(cfg, 64, 64 * 65 / 2, 1)
    assert reduce.mfu(ctx) == pytest.approx(
        100 * total / (0.010 * peaks.BF16_FLOPS_PER_S))
    assert reduce.idle_share(ctx) == pytest.approx(70.0)
