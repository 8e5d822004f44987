"""The kernels' work and the model FLOPs against hand counts, and the
dense count against ``torch.utils.flop_counter`` on the reference."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import spec
from portbench.tests.tiny import DENSE

G8 = {"num_heads": 32, "num_kv_heads": 8, "head_dim": 128}


def test_flash_decode_work(root):
    work = spec.kernel_counts(root, "flash_decode").work
    fl, by = work([10, 20], G8)
    assert fl == 4 * 30 * 32 * 128                     # 2 MACs a pair-head
    assert by == 2 * (2 * 30 * 8 * 128 + 2 * 2 * 32 * 128)
    assert work([], G8) == (0.0, 0.0)


def test_flash_attention_work(root):
    work = spec.kernel_counts(root, "flash_attention").work
    fl, by = work([3, 4], G8)
    assert fl == 4 * (6 + 10) * 32 * 128               # causal pairs 6, 10
    assert by == 2 * 7 * 128 * (2 * 32 + 2 * 8)


def test_ssd_scan_work(root):
    work = spec.kernel_counts(root, "ssd_scan").work
    cfg = {"d_model": 2048, "ssm_expand": 2, "ssm_head_dim": 64,
           "ssm_state": 128}
    fl, by = work([100, 28], cfg)
    H, P, N = 64, 64, 128
    assert fl == 5 * 128 * H * P * N
    assert by == 4 * (128 * (2 * H * P + H + 2 * N) + 2 * H * P * N)


def test_dense_flops_match_the_flop_counter(root):
    cfg = dict(spec.load_cell(root, "granite-3-8b.chat").config, **DENSE)
    ref = spec.load_module(root / "portbench/reference/dense.py",
                           "portbench_ref_dense")
    w = ref.make_weights(cfg, 3, torch.device("cpu"), torch.float32)
    T = 12
    with FlopCounterMode(display=False) as fc:
        ref.logits(w, cfg, [list(range(1, T + 1))], [0])
    # the reference scores every pair (masking after) and runs the head at
    # every position
    want = spec.kernel_counts(root, "model_dense").flops(cfg, T, T * T, T)
    assert fc.get_total_flops() == pytest.approx(want)


def test_ssm_flops_by_hand(root):
    flops = spec.kernel_counts(root, "model_ssm").flops
    cfg = {"d_model": 8, "vocab_size": 10, "num_layers": 2, "ssm_expand": 2,
           "ssm_head_dim": 4, "ssm_state": 3, "ssm_conv_width": 4}
    d, di, H, P, N, W = 8, 16, 4, 4, 3, 4
    per = 2 * d * (2 * di + 2 * N + H) + 2 * di * d + 2 * W * (di + 2 * N) \
        + 5 * H * P * N
    assert flops(cfg, 5, 99, 1) == 2 * 5 * per + 2 * d * 10
