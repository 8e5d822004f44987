"""The granite-4.0-h-small cell's files at a tiny size on the CPU: the
plain reference (``reference/hybrid_moe.py``) against the program's
served path, its chunked recurrence against ``reference/ssm.py``'s
quadratic form, its float8 control, the FLOP count by hand, the cell's
two readers on a tiny session, and whole runs of the harness (sound, and
broken underneath).

Tolerances: 1e-4 of the logits' largest value between the program and
the reference (f32 on both sides; the program's paths sum in another
order: grouped products, the chunked scan, the kernels' plain versions);
1e-5 between the reference's chunked and quadratic recurrences (the same
sums, split at other points)."""
import copy
import math
import time

import pytest
import torch

from portbench import harness, spec

CELL = "granite-4.0-h-small.docrag"
TINY = dict(num_layers=4, layer_types=["mamba", "attention", "mamba", "mamba"],
            d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96,
            moe_d_ff=32, num_experts=8, experts_held=4,
            num_experts_per_tok=3, vocab_size=512, ssm_state=16,
            ssm_head_dim=16, ssm_chunk=16, attention_multiplier=0.125)
SECONDS = 1.5


def _cell(root):
    return spec.load_cell(root, CELL)


def _cfg(root):
    return dict(_cell(root).config, **TINY)


def _ref(root):
    return _cell(root).reference()


def tiny_cell(root, limit: float = 1e-4):
    """The cell at a tiny size, float32. The limit is the dense tiny
    cell's 0.01 scaled to these logits, which ``logits_scaling`` (16)
    and the small tied embedding make ~0.05 at their largest: a sound run
    reads 0, a decode that keeps no state ~3e-3."""
    cell = copy.deepcopy(_cell(root))
    cell.config.update(TINY, dtype="float32", cache_dtype="float32",
                       limits={"served_gap": limit})
    t = cell.traffic
    t["prompt"].update(median=16, min=4, max=40)
    t["output"] = {"dist": "uniform", "min": 8, "max": 16}
    t["engine"].update(max_seq=64, max_batch=4)
    t.update(rate=16.0, warmup_s=0.5, drain_cap_s=30.0, trace_s=0.5)
    return cell


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("position", ["nope", "rope"])
def test_reference_matches_the_served_path(root, position):
    # "rope": the branch granite-4.0-h-small does not take, at rope_theta
    from repro_torch.models.model import make_model

    cfg, ref = dict(_cfg(root), position_embedding_type=position), _ref(root)
    w = ref.make_weights(cfg, 2**31 + 9, torch.device("cpu"), torch.float32)
    model = make_model(harness.arch_config(cfg))
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(1, cfg["vocab_size"], (2, 40), generator=g)
    lens = torch.tensor([32, 21])
    # a bucketed prefill (row 1 padded), then decode through the cache
    with torch.no_grad():
        lg, state, pos = model.prefill(w, {"tokens": toks[:, :32],
                                           "lengths": lens}, cache_len=64,
                                       cache_dtype=torch.float32)
        steps = [lg]
        for j in range(8):
            nxt = torch.stack([toks[0, 32 + j], toks[1, 21 + j]])[:, None]
            lg, state = model.decode(w, state, nxt, pos)
            pos = pos + 1
            steps.append(lg)
    served = torch.stack(steps, dim=1)                     # (2, 9, V)
    seqs = [toks[0, :40].tolist(), toks[1, :29].tolist()]
    mine = ref.logits(w, cfg, seqs, [31, 20])
    for p, m in zip(served, mine):
        assert _rel(p, m) < 1e-4


def test_reference_chunks_equal_the_quadratic_form(root):
    cfg, ref = _cfg(root), _ref(root)
    ssm = spec.load_module(root / "portbench/reference/ssm.py",
                           "portbench_ref_ssm")
    w = ref.make_weights(cfg, 5, torch.device("cpu"), torch.float32)
    p = w["layers"][0]["mamba"]
    x = torch.randn(37, cfg["d_model"], generator=torch.Generator()
                    .manual_seed(1))
    want = ssm._mixer(p, x, cfg, None)
    for chunk in (16, 5, 64):
        got = ref._mamba(p, x, dict(cfg, ssm_chunk=chunk), None)
        assert _rel(got, want) < 1e-5


def test_fp8_control_departs(root):
    cfg, ref = _cfg(root), _ref(root)
    w = ref.make_weights(cfg, 4, torch.device("cpu"), torch.float32)
    seq = list(range(3, 43))
    exact = ref.logits(w, cfg, [seq], [0])[0]
    low = ref.logits(w, cfg, [seq], [0], quant="fp8")[0]
    assert 1e-3 < _rel(low, exact) < 0.5


def test_flops_by_hand(root):
    flops = spec.kernel_counts(root, "model_hybrid_moe").flops
    cfg = _cell(root).config
    d, di, Hs, P, N, W = 4096, 8192, 128, 64, 128, 4
    mamba = 2 * d * (2 * di + 2 * N + Hs) + 2 * di * d \
        + 2 * W * (di + 2 * N) + 5 * Hs * P * N
    attn = 2 * d * 48 * 128 + 2 * 32 * 128 * d
    ffn = 2 * d * 72 + 10 * 18 / 72 * 6 * d * 768 + 6 * d * 1536
    per_token = 36 * mamba + 4 * attn + 40 * ffn
    assert flops(cfg, 1, 0, 0) == pytest.approx(per_token)
    assert per_token == pytest.approx(11.31e9, rel=1e-3)   # a prompt token
    assert flops(cfg, 3, 10, 2) == pytest.approx(
        3 * per_token + 10 * 4 * 4 * 32 * 128 + 2 * 2 * d * 100352)


def test_cells_load(root):
    cell = _cell(root)
    assert cell.config["family"] == "hybrid_moe"
    assert cell.reference().logits and cell.generator().generate
    assert {m["name"] for m in cell.end_to_end} == {"output_tok_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"model.mfu.docrag",
                                                   "moe.pad_share"}


def test_readers(root, one_thread):
    # a tiny prefill and decode step under a CPU profiler session: the pad
    # share reads the session's expert counters, the MFU the slice's
    # records through counts/model_hybrid_moe.py
    from repro_torch import telemetry
    from portbench import peaks
    from repro_torch import telemetry
    from repro_torch.models.model import make_model

    cfg = dict(_cfg(root), dtype="float32")
    model = make_model(harness.arch_config(cfg))
    w = _ref(root).make_weights(cfg, 3, torch.device("cpu"), torch.float32)
    toks = torch.randint(1, cfg["vocab_size"], (2, 16),
                         generator=torch.Generator().manual_seed(4))
    lens = torch.tensor([16, 5])
    telemetry.session()                # close what an earlier run left open
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            _, st, pos = model.prefill(
                w, {"tokens": toks, "lengths": lens, "host_lengths": [16, 5]},
                cache_len=32, cache_dtype=torch.float32)
            model.decode(w, st, toks[:, :1], pos)
    s = telemetry.session()
    # the prefill computes its pairs alone; the decode step every held
    # expert of each of the L layers over both rows, of which each row
    # picked at most k
    held, k, L = cfg["experts_held"], cfg["num_experts_per_tok"], 4
    slots = s.counters["moe.slots"]
    assert L * (held - k) * 2 <= slots - s.counters["moe.pairs"] \
        <= L * held * 2
    trace = {"records": [("prefill", 1, [16, 5]), ("decode", 1, [16, 5])],
             "slice_s": 0.5, "busy_s": 0.4}
    cell = _cell(root)
    ctx = harness.Ctx(cfg, {"ticks": 1}, trace, root)
    pad = spec.metric_reader(root, "moe.pad_share")(ctx)
    assert pad == pytest.approx(100 * (1 - s.counters["moe.pairs"] / slots))
    assert 0 < pad < 100
    flops = spec.kernel_counts(root, "model_hybrid_moe").flops
    want = flops(cfg, 21, 16 * 17 / 2 + 5 * 6 / 2, 2) \
        + flops(cfg, 2, 21, 2)
    assert spec.metric_reader(root, "model.mfu.docrag")(ctx) \
        == pytest.approx(100 * want / (0.5 * peaks.MODEL_PEAK_FLOPS))
    for n in ("moe.pad_share", "model.mfu.docrag"):
        assert spec.metric_reader(root, n)(
            harness.Ctx(cell.config, {"ticks": 1}, None, root)) is None


def test_sound_run_is_correct(root, one_thread):
    from repro_torch import telemetry

    before = {k: int(v) for k, v in telemetry._REG.device.items()}
    cell = tiny_cell(root)
    res = harness.run(cell, 2**31 + 11, SECONDS, False, time.perf_counter(),
                      device="cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] == round(cell.traffic["rate"] * SECONDS)
    assert res["failed"] == 0
    line = harness.result_line(cell, res, False, "cpu")
    assert set(line["metrics"]) == {"output_tok_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    # the run's expert layers counted their pairs and rows on the device
    moved = {k[0]: int(v) - before.get(k, 0)
             for k, v in telemetry._REG.device.items()}
    assert 0 < moved["moe.pairs"] < moved["moe.slots"]


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged"])
def test_broken_path_is_not_correct(root, one_thread, monkeypatch, fault):
    from repro_torch.serving import engine

    if fault == "token_altered":
        core = engine.FleetGroup._fleet_core

        def altered(self, *a, **kw):
            nxt, done = core(self, *a, **kw)
            return (nxt + 1) % self.model.cfg.vocab_size, done
        monkeypatch.setattr(engine.FleetGroup, "_fleet_core", altered)
    else:
        from repro_torch.models import attention, ssd

        def frozen(state, x, dt, A, Bm, Cm, rows=None):
            return ssd._decode_step(state.clone(), x, dt, A, Bm, Cm,
                                    rows)[0], state
        monkeypatch.setattr(ssd, "ssd_decode_step", frozen)
        monkeypatch.setattr(attention, "write_kv",
                            lambda k, v, *a, **kw: (k, v))
    res = harness.run(tiny_cell(root), 5, SECONDS, False,
                      time.perf_counter(), device="cpu")
    assert not res["correct"]
    c = res["checks"]["served_gap"]
    assert c["value"] > c["limit"], res["checks"]
    assert math.isfinite(c["value"])
