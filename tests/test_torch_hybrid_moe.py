"""The hybrid_moe family (granitemoehybrid: Mamba-2 and attention layers
side by side, each followed by a dropless top-k MoE over the experts a
device holds, plus a shared expert), on the CPU at a tiny size in f32:
the serve path against itself and the expert layer against plain math.
(portbench/tests/test_portbench_hybrid_moe.py holds the served logits to
the plain reference.)

Tolerances: 1e-5 of the logits' largest value where two paths compute
the same f32 sums in another order or over another shape (a bucket's
padded rows give the matrix products other shapes); bit for bit where a
value is not computed again (the rows a step does not write).

On the card (marker ``chip``, skipped without one): a decode step
captured in a CUDA graph equals the eager step, and the eager step makes
no host sync. Run it with ``PYTHONPATH=src python -m pytest -q
--noconftest -m chip`` on this file (tests/conftest.py imports JAX).
"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from repro_torch import telemetry
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models.model import make_model
from repro_torch.serving.engine import ReplicaEngine

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
TINY = dict(name="hm-tiny", family="hybrid_moe", num_layers=4,
            layer_types=("mamba", "attention", "mamba", "mamba"),
            d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96,
            moe_d_ff=32, num_experts=8, experts_held=4,
            num_experts_per_tok=3, moe_shared_expert=True, vocab_size=256,
            tie_embeddings=True, ssm_state=16, ssm_head_dim=16,
            ssm_chunk=16, attention_multiplier=0.125,
            embedding_multiplier=12.0, residual_multiplier=0.22,
            logits_scaling=16.0, position_embedding_type="nope",
            max_seq_len=128)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    m = make_model(ArchConfig(**TINY))
    return m, m.init(seed=3, device="cpu")


def _close(a, b, rel=REL):
    assert (a - b).abs().max() <= rel * b.abs().max(), \
        float((a - b).abs().max() / b.abs().max())


def _toks(B, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, TINY["vocab_size"], (B, S), generator=g)


def test_decode_through_the_cache_equals_the_longer_prefill(tiny):
    m, p = tiny
    toks = _toks(2, 30)
    with torch.no_grad():
        lg, st, pos = m.prefill(p, {"tokens": toks[:, :24]}, cache_len=64,
                                cache_dtype=torch.float32)
        for j in range(24, 30):
            lg, st = m.decode(p, st, toks[:, j:j + 1], pos)
            pos = pos + 1
        whole, _, _ = m.prefill(p, {"tokens": toks[:, :30]}, cache_len=64,
                                cache_dtype=torch.float32)
    # the decode's last step predicts from token 29, as the whole prefill
    _close(lg, whole)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_bucketed_prefill_equals_exact_lengths(tiny, backend):
    m, p = tiny
    lens = [32, 19, 7, 1]
    toks = _toks(4, 32, seed=1)
    with torch.no_grad():
        lg, st, pos = m.prefill(
            p, {"tokens": toks, "lengths": torch.tensor(lens)},
            cache_len=64, cache_dtype=torch.float32, attn_backend=backend)
        for i, n in enumerate(lens):
            lg1, st1, pos1 = m.prefill(p, {"tokens": toks[i:i + 1, :n]},
                                       cache_len=64,
                                       cache_dtype=torch.float32,
                                       attn_backend=backend)
            _close(lg[i], lg1[0])
            assert int(pos[i]) == int(pos1[0]) == n
            for name in ("ssm", "conv"):
                _close(st[name][:, i], st1[name][:, 0])
            for name in ("attn_k", "attn_v"):
                _close(st[name][:, i, :n], st1[name][:, 0, :n])


def test_pads_route_to_no_expert(tiny):
    m, p = tiny
    lens = torch.tensor([20, 5])
    toks = _toks(2, 32, seed=2)
    cfg = m.cfg
    with _profile():
        with torch.no_grad():
            m.prefill(p, {"tokens": toks, "lengths": lens}, cache_len=64,
                      cache_dtype=torch.float32)
    c = telemetry.session().counters
    # every layer's pairs are the real tokens' picks among the held
    # experts (at most top-k x tokens), and the grouped products compute
    # exactly those rows
    assert c["moe.slots"] == c["moe.pairs"]
    assert 0 < c["moe.pairs"] <= cfg.num_layers * cfg.num_experts_per_tok \
        * int(lens.sum())


def test_decode_counts_every_held_expert_on_every_row(tiny):
    m, p = tiny
    with torch.no_grad():
        st = m.init_serve_state(4, 64, torch.float32, device="cpu")
        rows = torch.tensor([1, 3, 3, 3], dtype=torch.int32)
        with _profile():
            m.decode(p, st, _toks(4, 1),
                     torch.full((4,), 5, dtype=torch.int32), write_rows=rows)
    c = telemetry.session().counters
    cfg = m.cfg
    assert c["moe.slots"] == cfg.num_layers * cfg.held_experts * 4
    # two rows write: their picks of the held experts, counted once each
    assert 0 < c["moe.pairs"] <= cfg.num_layers * 2 * cfg.num_experts_per_tok


def test_write_rows_keep_the_other_rows_bit_for_bit(tiny):
    m, p = tiny
    with torch.no_grad():
        _, st, pos = m.prefill(p, {"tokens": _toks(4, 12, seed=4)},
                               cache_len=64, cache_dtype=torch.float32)
        before = {n: t.clone() for n, t in st.items()}
        full = {n: t.clone() for n, t in st.items()}
        tok = _toks(4, 1, seed=5)
        # the fleet's write index: the stepping rows, padded by repeating
        # them to the slab's row count
        rows = torch.tensor([0, 2, 2, 0], dtype=torch.int32)
        lg, _ = m.decode(p, st, tok, pos, write_rows=rows)
        lg_all, _ = m.decode(p, full, tok, pos)
    # the written rows step as in a full step (the others' logits read a
    # cache their token was not written to, and the fleet drops them)
    _close(lg[[0, 2]], lg_all[[0, 2]])
    for n in st:
        assert torch.equal(st[n][:, [1, 3]], before[n][:, [1, 3]]), n
        assert torch.equal(st[n][:, [0, 2]], full[n][:, [0, 2]]), n
        assert not torch.equal(st[n][:, [0, 2]], before[n][:, [0, 2]]), n


def _layer(E=8, held=8, d=32, ff=16, sff=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    return moe.init_held_moe(g, d, ff, sff, E, held, torch.float32)


def _every_expert(params, x, k):
    """Every expert on every token, combined with the gates of the top-k
    (``moe.moe_dense_oracle``'s math over the held experts), plus the
    shared expert."""
    xt = x.reshape(-1, x.shape[-1])
    probs, top_p, top_i = moe.route(params["router"], xt, k)
    held = params["w_gate"].shape[0]
    gates = torch.zeros_like(probs).scatter(-1, top_i, top_p)[:, :held]
    outs = moe._expert_ffn(params, xt.expand(held, -1, -1).contiguous(),
                           "swiglu")
    y = torch.einsum("te,etd->td", gates, outs) \
        + moe._dense_ffn(params["shared"], xt, "swiglu")
    return y.reshape(x.shape)


def _apply(params, x, k, path):
    if path == "prefill":
        return moe.held_moe_prefill(params, x, top_k=k)
    return moe.held_moe_decode(params, x.reshape(-1, 1, x.shape[-1]),
                               top_k=k)[0].reshape(x.shape)


@pytest.mark.parametrize("path", ["prefill", "decode"])
def test_dropless_routing_matches_every_expert(path):
    # a router rigged so that every token picks the same three experts:
    # a capacity dispatch would drop most of their pairs, this one none
    p = _layer()
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, [1, 4, 6]] = torch.tensor([3.0, 2.0, 1.0])
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 40, 32, generator=g).abs()   # positive: the rig holds
    _, _, top_i = moe.route(p["router"], x.reshape(-1, 32), 3)
    assert (top_i.sort(-1).values == torch.tensor([1, 4, 6])).all()
    _close(_apply(p, x, 3, path), _every_expert(p, x, 3))


@pytest.mark.parametrize("path", ["prefill", "decode"])
def test_the_shares_add_up_to_the_whole_layer(path):
    # four devices of an expert-parallel layer: device s holds experts
    # [2 s, 2 s + 2) of 8, as its ids [0, 2) with the router's columns
    # rolled to match; each computes its held experts' part, and the
    # parts, with the shared expert that every device computes alike
    # counted once, add up to the uncut layer
    whole = _layer(E=8, held=8, seed=2)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 10, 32, generator=g)
    shared = moe._dense_ffn(whole["shared"], x, "swiglu")
    total = shared.clone()
    for s in range(4):
        lo = 2 * s
        part = {"router": whole["router"].roll(-lo, dims=1),
                "shared": whole["shared"],
                **{n: whole[n][lo:lo + 2] for n in ("w_gate", "w_up",
                                                    "w_down")}}
        total += _apply(part, x, 3, path) - shared
    _close(total, _apply(whole, x, 3, path))


def test_prefill_blocks_equal_one_block(monkeypatch):
    p = _layer(held=5, seed=4)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 23, 32, generator=g)
    want = moe.held_moe_prefill(p, x, top_k=3)
    monkeypatch.setattr(moe, "HELD_BLOCK", 7)
    _close(moe.held_moe_prefill(p, x, top_k=3), want)


def test_attention_takes_the_multiplier(tiny):
    # the kernels' softmax scale: attention_multiplier, through the
    # kernel wrappers and the einsum path alike, and 1/sqrt(hd) by default
    m, p = tiny
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, 9, 2, 2, 16, generator=g)
    k, v = torch.randn(2, 2, 9, 2, 16, generator=g).unbind(1)
    a = ops.flash_attention(q, k, v, causal=True, scale=0.125)
    b = ops.flash_attention(q, k, v, causal=True)
    assert not torch.allclose(a, b)
    assert torch.equal(ops.flash_attention(q, k, v, causal=True, scale=None),
                       b)
    pos = torch.tensor([8, 3], dtype=torch.int32)
    d = ops.flash_decode(q[:, -1], k, v, pos, scale=0.125)
    _close(d[0], a[0, -1])
    with torch.no_grad():
        outs = [m.prefill(p, {"tokens": _toks(2, 20, seed=7)}, cache_len=32,
                          cache_dtype=torch.float32, attn_backend=be)[0]
                for be in ("pallas", "einsum")]
    _close(outs[0], outs[1])
    assert m.cfg.softmax_scale == 0.125
    plain = dataclasses.replace(m.cfg, attention_multiplier=0.0)
    assert plain.softmax_scale == 0.25


def test_what_the_family_does_not_do(tiny):
    m, p = tiny
    with pytest.raises(NotImplementedError, match="training"):
        m.forward(p, {"tokens": _toks(1, 4)})
    with pytest.raises(ValueError, match="chunked"):
        m.prefill_chunk(p, None, _toks(1, 4), torch.zeros(1),
                        torch.ones(1))
    with pytest.raises(ValueError, match="int8"):
        m.init_serve_state(1, 8, "int8", device="cpu")
    eng = ReplicaEngine(m, p, max_batch=2, max_seq=32, chunk_len=8,
                        cache_dtype=torch.float32, device="cpu")
    assert eng.bucket_prompts and eng.chunk_len == 0


def test_the_configuration_file():
    # the benchmark's configuration: the published widths and layer kinds
    # in both of its views (the catalog's keys and the port's fields),
    # 18 of 72 experts held, and the reduced config keeps both kinds
    cfg = json.loads((ROOT / "portbench/configs/granite-4.0-h-small.json")
                     .read_text())
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    c = ArchConfig(**{k: v for k, v in cfg.items() if k in names})
    assert c.layer_types == tuple(cfg["layer_types"])
    assert [i for i, t in enumerate(c.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (c.d_model, c.num_layers, c.num_heads, c.num_kv_heads) == \
        (cfg["hidden_size"], cfg["num_hidden_layers"],
         cfg["num_attention_heads"], cfg["num_key_value_heads"])
    assert (c.ssm_heads, c.ssm_head_dim, c.ssm_state, c.ssm_conv_width,
            c.ssm_groups, c.ssm_chunk) == \
        (cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"],
         cfg["mamba_d_conv"], cfg["mamba_n_groups"],
         cfg["mamba_chunk_size"])
    assert (c.moe_d_ff, c.d_ff, c.held_experts) == \
        (cfg["intermediate_size"], cfg["shared_intermediate_size"],
         cfg["num_local_experts"])
    assert (c.num_experts, cfg["published"]["num_local_experts"]) == (72, 72)
    assert c.max_seq_len == cfg["max_position_embeddings"] == 4096
    assert round(c.param_count() / 1e8) == 322          # 32.2 B published
    assert round(c.active_param_count() / 1e8) == 88    # 32B-A9B
    assert c.softmax_scale == 0.0078125 and c.sub_quadratic
    r = c.reduced()
    assert set(r.layer_types) == {"mamba", "attention"}
    assert len(r.layer_types) == r.num_layers and r.held_experts >= 4
    hash(c)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_device_counter_session():
    telemetry.session()
    with _profile():
        telemetry.count_on_device("t.device", torch.tensor(3), "cpu")
        telemetry.count_on_device("t.device", 4, "cpu")
    assert telemetry.session().counters == {"t.device": 7}
    telemetry.count_on_device("t.device", 5, "cpu")   # outside a session
    with _profile():
        telemetry.count("t.other", 1)
    assert telemetry.session().counters == {"t.other": 1}
    assert not autograd_profiler._is_profiler_enabled


# ------------------------------------------------------------------- card
@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_graph_equals_eager_on_the_card(card, dtype):
    from repro_torch.serving.graphs import DecodeGraphs

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ArchConfig(**dict(TINY, d_model=128, head_dim=32, d_ff=256,
                            moe_d_ff=128, ssm_head_dim=32))
    m = make_model(cfg)
    p = m.init(seed=1, dtype=dtype, device=card)
    toks = torch.randint(1, 256, (4, 24), device=card)
    lens = torch.tensor([24, 17, 9, 3], dtype=torch.int32, device=card)
    _, st, pos = m.prefill(p, {"tokens": toks, "lengths": lens},
                           cache_len=64, cache_dtype=dtype)
    eager = {n: t.clone() for n, t in st.items()}
    graph = {n: t.clone() for n, t in st.items()}
    tok = toks[:, :1].int().contiguous()
    rows = torch.tensor([0, 2, 2, 2], dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")      # a host sync raises
    try:
        want, _ = m.decode(p, eager, tok, pos, write_rows=rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graphs = DecodeGraphs(card)
    step = lambda: (m.decode(p, graph, tok, pos, write_rows=rows)[0],)
    graphs.run("k", step)                        # eager warm-up, capture
    for n in graph:                              # from the same state
        graph[n].copy_(st[n])
    got = graphs.run("k", step)[0]               # a replay
    assert graphs.replays == 1
    assert torch.equal(got, want)
    for n in st:
        assert torch.equal(graph[n], eager[n]), n
        assert torch.equal(graph[n][:, [1, 3]], st[n][:, [1, 3]]), n


@pytest.mark.chip
@pytest.mark.parametrize("scale", [None, 0.0078125])
def test_kernels_take_the_scale_on_the_card(card, scale):
    # granite-4.0-h-small's attention shapes (32 q / 8 kv heads, hd 128)
    # in bf16: each kernel against its plain version at the same softmax
    # scale, within the kernels' bf16 tolerance (the kernels round P to
    # bf16 before the P.V product; the plain versions keep f32)
    from repro_torch.kernels import ref

    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(2, 300, 8, 4, 128, generator=g, device=card,
                    dtype=torch.bfloat16)
    k, v = torch.randn(2, 2, 300, 8, 128, generator=g, device=card,
                       dtype=torch.bfloat16).unbind(1)
    got = ops.flash_attention(q, k, v, causal=True, scale=scale)
    want = ref.flash_attention_ref(q, k, v, causal=True, scale=scale)
    _close(got.float(), want.float(), rel=3e-2)
    pos = torch.tensor([299, 117], dtype=torch.int32, device=card)
    got = ops.flash_decode(q[:, -1].contiguous(), k, v, pos, scale=scale)
    want = ref.flash_decode_ref(q[:, -1], k, v, pos, scale=scale)
    _close(got.float(), want.float(), rel=3e-2)


def test_prefill_row_groups_equal_one_group(tiny, monkeypatch):
    from repro_torch.models import hybrid_moe

    m, p = tiny
    toks = _toks(5, 16, seed=8)
    lens = torch.tensor([16, 3, 9, 16, 1])
    batch = {"tokens": toks, "lengths": lens}
    with torch.no_grad():
        want = m.prefill(p, batch, cache_len=32, cache_dtype=torch.float32)
        monkeypatch.setattr(hybrid_moe, "PREFILL_TOKENS", 40)   # 2 rows
        got = m.prefill(p, batch, cache_len=32, cache_dtype=torch.float32)
    _close(got[0], want[0])
    assert torch.equal(got[2], want[2])
    for n in want[1]:
        _close(got[1][n], want[1][n])


@pytest.mark.parametrize("n,bucket,want", [
    (1, 64, 8), (7, 64, 8), (9, 64, 16), (16, 64, 16), (17, 64, 32),
    (33, 64, 48), (48, 64, 48), (49, 64, 64), (20, 16, 16)])
def test_fit_len(n, bucket, want):
    from repro_torch.models.hybrid_moe import fit_len

    # TINY's chunk is 16: powers of two up to it, multiples of it past it
    assert fit_len(n, bucket, TINY["ssm_chunk"]) == want


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_host_lengths_run_each_row_at_its_own_length(tiny, backend):
    m, p = tiny
    lens = [40, 19, 7, 45, 1, 1]          # the last two: the bucket's pads
    toks = _toks(6, 64, seed=9)
    batch = {"tokens": toks, "lengths": torch.tensor(lens)}
    with torch.no_grad():
        want = m.prefill(p, batch, cache_len=64,
                         cache_dtype=torch.float32, attn_backend=backend)
        got = m.prefill(p, dict(batch, host_lengths=lens[:4]), cache_len=64,
                        cache_dtype=torch.float32, attn_backend=backend)
    assert torch.equal(got[2], want[2])
    for i, n in enumerate(lens[:4]):
        _close(got[0][i], want[0][i])
        for name in ("ssm", "conv"):
            _close(got[1][name][:, i], want[1][name][:, i])
        for name in ("attn_k", "attn_v"):
            _close(got[1][name][:, i, :n], want[1][name][:, i, :n])
    # the pad rows compute nothing
    assert not got[0][4:].any()
    assert all(not t[:, 4:].any() for t in got[1].values())
