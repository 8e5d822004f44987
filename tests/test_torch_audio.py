"""The port's audio family (whisper-base, an encoder-decoder) against the
JAX reference, in one process.

Modules first: ``layer_norm`` and ``sinusoidal_positions`` (1e-6), the
full-sequence ``attention`` with ``causal=False`` and ``kv_x`` over T != S
keys (1e-5, both backends; ``ops.flash_attention`` takes that shape
without ``q_offset`` and still refuses a causal one). Then reduced
whisper-base (64 frames, 2 encoder and 2 decoder layers, d_model 128) with
the reference's weights bridged in (``params_from_jax``: ``enc_layers``
and ``dec_layers`` split per layer), f32, the same numpy-seeded tokens and
frames: ``encode``, ``encdec_prefill`` and greedy ``encdec_decode`` give the
reference's at 1e-4 on both backends (``"pallas"``: the decode's cross
pass is ``flash_decode`` at position Le - 1); the mirror of
tests/test_models.py::test_prefill_decode_consistency (2e-4); and the
port's ``ReplicaEngine`` with ``frame_embeds`` extras gives the reference
engine's streams, clocks and positions on both backends (the reference's
engine serves audio on einsum only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import encdec, layers
from repro_torch.models.dims import padded_dims
from repro_torch.serving.engine import FleetGroup, ReplicaEngine
from test_torch_vlm import (_one_torch_thread, check_config,  # noqa: F401
                            consistency_vs_reference, extras_of,
                            greedy_vs_reference, pair, port_engine,
                            reference_engine)

ARCH = "whisper-base"
TOL = dict(atol=1e-4, rtol=1e-4)
CLOSE = dict(atol=1e-6, rtol=1e-6)


def test_config_is_the_references():
    check_config(ARCH)
    red = pair(ARCH)[2].cfg
    assert (red.encoder_seq_len, red.encoder_layers, red.d_model) == \
        (64, 2, 128)


@pytest.mark.parametrize("d", [128, 512])
def test_layer_norm_and_sinusoidal_positions(d):
    rng = np.random.default_rng(d)
    x = (3.0 * rng.standard_normal((2, 5, d)) + 1.0).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    np.testing.assert_allclose(layers.sinusoidal_positions(1500, d),
                               jlayers.sinusoidal_positions(1500, d), **CLOSE)


def _attention_params(seed, d, dims, hd):
    """The reference's attention weights with drawn biases, as numpy."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(seed), d, dims, hd, True, jnp.float32))
    for b in ("bq", "bk", "bv"):
        p[b] = (0.1 * rng.standard_normal(p[b].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
@pytest.mark.parametrize("S,T,causal", [(5, 23, False), (9, 9, False),
                                        (9, 9, True)])
def test_attention_matches_reference(backend, S, T, causal):
    """Cross-attention (S queries over T != S keys of ``kv_x``, full) and
    self-attention (full and causal), biases drawn: the reference's
    ``attention`` at 1e-5."""
    cfg = pair(ARCH)[2].cfg
    dims = padded_dims(cfg, 1)
    hd = cfg.resolved_head_dim
    p = _attention_params(S + T, cfg.d_model, dims, hd)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32) \
        if T != S else None
    want = jattn.attention(p, jnp.asarray(x), dims, causal=causal,
                           kv_x=None if kv is None else jnp.asarray(kv))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got = tattn.attention(tp, torch.from_numpy(x), dims, causal=causal,
                          kv_x=None if kv is None else torch.from_numpy(kv),
                          backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_flash_attention_takes_a_cross_shape_only_when_full(monkeypatch):
    """On the CPU the wrapper runs the plain version at S != Sk, full. On a
    card its checks (which run before any launch: here with the device
    test forced to say "cuda") pass that shape and refuse a causal call at
    S != Sk without ``q_offset``."""
    q = torch.randn(1, 3, 2, 2, 32)
    k, v = torch.randn(1, 40, 2, 32), torch.randn(1, 40, 2, 32)
    want = ops.flash_attention(q, k, v, causal=False)
    assert want.shape == q.shape and ops.LAUNCHES["flash_attention"] == 0
    monkeypatch.setattr(ops, "_on_cuda", lambda *a: True)
    launched = []
    monkeypatch.setattr(ops.fa, "launch", lambda *a: launched.append(a))
    ops.flash_attention(q, k, v, causal=False)
    assert len(launched) == 1
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, k, v, causal=True)
    ops.reset_launches()


def test_bridge_maps_the_encdec_tree():
    jm, jp, tm, tp = pair(ARCH)
    assert len(tp["enc_layers"]) == 2 and len(tp["dec_layers"]) == 2
    np.testing.assert_array_equal(
        tp["dec_layers"][1]["cross"]["bk"].numpy(),
        np.asarray(jp["dec_layers"]["cross"]["bk"][1]))
    np.testing.assert_array_equal(
        tp["enc_layers"][0]["ffn_norm"]["scale"].numpy(),
        np.asarray(jp["enc_layers"]["ffn_norm"]["scale"][0]))
    np.testing.assert_array_equal(tp["dec_pos"].numpy(),
                                  np.asarray(jp["dec_pos"]))
    own = tm.init(seed=0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(tp)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_encode_matches_reference(backend):
    jm, jp, tm, tp = pair(ARCH)
    frames = extras_of(tm.cfg, 2, 3)
    x = np.concatenate([f["frame_embeds"] for f in frames])
    want = jencdec.encode(jp, jnp.asarray(x), jm.cfg, jm.dims)
    got = encdec.encode(tp, torch.from_numpy(x), tm.cfg, tm.dims,
                        attn_backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_prefill_and_decode_match_reference(backend):
    """Two rows of 12 tokens over their frames: the reference's
    ``encdec_prefill`` / ``encdec_decode`` logits and greedy streams; the
    cross cache holds Le positions a row."""
    _, _, tm, _ = pair(ARCH)
    rng = np.random.default_rng(2)
    frames = extras_of(tm.cfg, 2, 6)
    batch = {"tokens": rng.integers(1, tm.cfg.vocab_size, (2, 12))
             .astype(np.int32),
             "frame_embeds": np.concatenate([f["frame_embeds"]
                                             for f in frames])}
    greedy_vs_reference(ARCH, batch, backend, "f32")
    state = tm.init_serve_state(2, 24, torch.float32, device="cpu")
    assert tuple(state["cross_k"].shape[1:3]) == (2, 64)
    with pytest.raises(ValueError, match="int8 cache needs"):
        tm.init_serve_state(2, 24, "int8", device="cpu")


def test_prefill_decode_consistency_mirror():
    consistency_vs_reference(ARCH)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_engine_with_extras_matches_reference(backend):
    """Four requests carrying ``frame_embeds`` through a standalone
    replica of 2 slots and max_seq 32: the reference engine's streams,
    clocks, per-step slot positions and count of prefill shapes."""
    args = (ARCH, 32, (4, 6, 4, 6), (7, 3, 5, 9))
    assert port_engine(*args, backend) == reference_engine(*args)


def test_fleet_and_cli_refuse_audio():
    """A fleet of audio replicas serves (parity: tests/test_torch_fleet_
    extras.py): its slab holds the decoder's self cache and the fixed-Le
    cross K/V a row. The CLI still refuses the family, as the
    reference's CLI fails on it."""
    _, _, tm, tp = pair(ARCH)
    g = FleetGroup(tm, tp, max_batch=2, max_seq=32, device="cpu")
    g.add(ReplicaEngine(tm, tp, max_batch=2, max_seq=32, device="cpu"))
    assert g.slab["self_k"].shape[1:3] == (2, 32)
    assert g.slab["cross_k"].shape[1:3] == (2, tm.cfg.encoder_seq_len)
    with pytest.raises(SystemExit, match="frame_embeds"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "2"])
