"""The port's ssm/hybrid model and its SSD-scan kernel against the JAX package.

``ref.ssd_scan_ref`` (the kernel's plain version, which ``ops.ssd_scan``
runs on CPU tensors) is held to the Pallas ``ssd_scan`` in interpret mode
at the reference's tolerance, 1e-4 (``tests/test_kernels.py``). The port's
Mamba-2 block and the whole ssm / hybrid LM (reduced mamba2-1.3b and
zamba2-2.7b) run on the reference's weights, bridged through
``params_from_jax``, with prompts from numpy: both backends (the scan
through ``ops.ssd_scan``, and the einsum oracle ``ssd_chunked``) must give
the reference's outputs and states within 1e-4 in f32 at the same chunk,
1e-3 across chunk sizes, and the same greedy streams.

``ref.ssd_scan_tiled_ref`` (the CUDA kernel's arithmetic: step tiles of 16,
32 or 64, heads in groups that share one C.B^T tile, products in split
TF32) is held to the Pallas kernel at the same 1e-4; one TF32 pass is not.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import make_model as jax_make_model
from repro.models import ssd as jax_ssd
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models import ssd
from repro_torch.models.model import make_model
from test_torch_kernels import _attention_case, _decode_case
from test_torch_vlm import _one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
CROSS_CHUNK_TOL = dict(atol=1e-3, rtol=1e-3)
CACHE_LEN = 32
ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]


def _scan_inputs(B, T, H, P, N, seed):
    """Inputs in the model's range: dt in [1e-3, 1e-1], A in [-16, -1]."""
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, T, H)))
    A = -rng.uniform(1.0, 16.0, (H,))
    x = rng.standard_normal((B, T, H, P)) * dt[..., None]
    bm, cm = rng.standard_normal((2, B, T, N))
    return [np.asarray(v, np.float32) for v in (x, dt * A, bm, cm)]


# the reference's sweep (tests/test_kernels.py) plus a chunk that is the
# whole sequence, a full-width head (P 64, N 128) and zamba2's N 64
@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 32), (2, 256, 4, 32, 16, 64), (1, 128, 8, 16, 32, 32),
    (2, 16, 4, 32, 16, 16), (1, 128, 2, 64, 128, 64), (2, 96, 3, 64, 64, 32),
])
def test_ssd_scan_plain_matches_pallas(B, T, H, P, N, chunk):
    x, a, bm, cm = _scan_inputs(B, T, H, P, N, seed=T + N)
    y_want, st_want = jax_ssd_scan(*map(jnp.asarray, (x, a, bm, cm)),
                                   chunk=chunk, interpret=True)
    y, st = ref.ssd_scan_ref(*map(torch.from_numpy, (x, a, bm, cm)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), **TOL)


@pytest.mark.parametrize("B,T,H,P,N,chunk", [
    (2, 8, 4, 16, 8, 8), (1, 24, 3, 64, 64, 8), (2, 64, 2, 32, 16, 32),
])
def test_ssd_scan_plain_from_a_carried_state(B, T, H, P, N, chunk):
    """The plain scan from a non-zero ``init_state`` (a chunked prefill's
    carried state) against the reference's ``ssd_chunked(...,
    init_state=)`` at the same block length, 1e-4; ``ops.ssd_scan`` on CPU
    tensors returns the plain version's result."""
    rng = np.random.default_rng(T + N)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, T, H)))
    A = -rng.uniform(1.0, 16.0, (H,))
    x = rng.standard_normal((B, T, H, P))
    bm, cm = rng.standard_normal((2, B, T, N))
    s0 = rng.standard_normal((B, H, P, N)) * 0.5
    f32 = lambda v: np.asarray(v, np.float32)
    y_want, st_want = jax_ssd.ssd_chunked(
        *map(jnp.asarray, map(f32, (x, dt, A, bm[:, :, None],
                                    cm[:, :, None]))), chunk,
        init_state=jnp.asarray(f32(s0)))
    args = [torch.from_numpy(f32(v)) for v in (x * dt[..., None],
                                                dt * A, bm, cm)]
    y, st = ops.ssd_scan(*args, chunk=chunk,
                         init_state=torch.from_numpy(f32(s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), **TOL)


def test_ssd_scan_plain_is_chunk_independent():
    """The SSD decomposition is exact for any block length, which is what
    lets the CUDA kernel block its own way: chunks of 1 (the per-step
    recurrence), 8 and 32 agree with the whole sequence as one chunk up to
    f32 rounding."""
    x, a, bm, cm = map(torch.from_numpy, _scan_inputs(2, 64, 4, 16, 16, 3))
    y0, st0 = ref.ssd_scan_ref(x, a, bm, cm, 64)
    for chunk in (1, 8, 32):
        y, st = ref.ssd_scan_ref(x, a, bm, cm, chunk)
        torch.testing.assert_close(y, y0, **TOL)
        torch.testing.assert_close(st, st0, **TOL)


def test_ops_ssd_scan_cpu_takes_the_plain_path():
    x, a, bm, cm = map(torch.from_numpy, _scan_inputs(2, 48, 3, 16, 8, 5))
    before = dict(ops.LAUNCHES)
    y, st = ops.ssd_scan(x, a, bm, cm, chunk=16)
    y_ref, st_ref = ref.ssd_scan_ref(x, a, bm, cm, 16)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(st, st_ref, rtol=0, atol=0)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(x, a, bm, cm, chunk=32)


def test_ops_ssd_scan_refuses_other_devices():
    t = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan(t, torch.empty(1, 8, 2, device="meta"),
                     torch.empty(1, 8, 8), torch.empty(1, 8, 8), chunk=8)


# ------------------------------------------- the kernel's arithmetic
@functools.lru_cache(maxsize=None)
def _pallas_case(T, N, seed):
    """Inputs at P 64 and the Pallas kernel's outputs on them, at the
    largest chunk up to 64 that divides T."""
    x, a, bm, cm = _scan_inputs(2, T, 4, 64, N, seed=seed)
    chunk = max(c for c in range(1, min(T, 64) + 1) if T % c == 0)
    y, st = jax_ssd_scan(*map(jnp.asarray, (x, a, bm, cm)), chunk=chunk,
                         interpret=True)
    return (tuple(map(torch.from_numpy, (x, a, bm, cm))),
            (np.asarray(y), np.asarray(st)))


@pytest.mark.parametrize("tile", ssd_scan.TILES)
@pytest.mark.parametrize("N", [128, 64])
@pytest.mark.parametrize("T", [1, 8, 16, 24, 96, 200])
def test_ssd_scan_split_tf32_matches_pallas(T, N, tile):
    """Three TF32 passes meet the reference's 1e-4 at every tile, for T
    below, at and across it (ragged last blocks), with heads in groups of
    1, 2 and 4; sharing the score tile changes nothing, bit for bit."""
    (x, a, bm, cm), (y_want, st_want) = _pallas_case(T, N, T + N)
    outs = []
    for hpb in (1, 2, 4):
        y, st = ref.ssd_scan_tiled_ref(x, a, bm, cm, tile=tile,
                                       heads_per_block=hpb,
                                       precision="3xtf32")
        np.testing.assert_allclose(y.numpy(), y_want, **TOL)
        np.testing.assert_allclose(st.numpy(), st_want, **TOL)
        outs.append((y, st))
    for y, st in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(st, outs[0][1])


def test_one_tf32_pass_misses_the_gate_three_meet_it():
    """Why the kernel splits: at the model's input range, one TF32 pass
    (a 10-bit mantissa) misses the reference's 1e-4 in y and the state;
    three passes meet it, as plain f32 does."""
    (x, a, bm, cm), (y_want, st_want) = _pallas_case(512, 128, 11)
    out = {p: ref.ssd_scan_tiled_ref(x, a, bm, cm, tile=64,
                                     heads_per_block=2, precision=p)
           for p in ref.SSD_PRECISIONS}
    y1, st1 = out["tf32"]
    assert not np.allclose(y1.numpy(), y_want, **TOL)
    assert not np.allclose(st1.numpy(), st_want, **TOL)
    for p in ("3xtf32", "f32"):
        np.testing.assert_allclose(out[p][0].numpy(), y_want, **TOL)
        np.testing.assert_allclose(out[p][1].numpy(), st_want, **TOL)


def test_tf32_round_is_cvt_rna():
    """To nearest with a 10-bit mantissa, ties away from zero; hi + lo
    holds a value to about 2^-22 of its size."""
    e = 2.0 ** -11                                 # half a TF32 step at 1
    v = torch.tensor([1.0, 1 + e, 1 + 3 * e, -(1 + e), 1 + e / 2, 3.0])
    want = [1.0, 1 + 2 * e, 1 + 4 * e, -(1 + 2 * e), 1.0, 3.0]
    assert ref.tf32_round(v).tolist() == want
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi = ref.tf32_round(r)
    lo = ref.tf32_round(r - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -21).all()


# blocks an SM of each (tile, hpb) on an H100 by the kernel's registers and
# shared memory (ptxas, cudaOccupancyMaxActiveBlocksPerMultiprocessor): at
# N 128 one 256-thread block or two 128-thread blocks; at N 64 one or three
OCCUPANCY = {128: {(16, 1): 3, (16, 2): 1, (32, 1): 2, (32, 2): 1},
             64: {(16, 1): 3, (16, 2): 1, (32, 1): 3, (32, 2): 1}}


@pytest.mark.parametrize("B,T,H,N,want", [
    (8, 512, 64, 128, (32, 2)),  # mamba2's drain: as many warps, shared tile
    (8, 512, 80, 64, (32, 1)),   # zamba2's: 12 warps an SM against 8
    (4, 16, 64, 128, (16, 1)),   # mamba2's fleet prefill: 128 blocks < 132
    (8, 16, 64, 128, (16, 1)),   # 3 blocks of 4 warps beat 1 of 8
    (1, 1, 64, 128, (16, 1)), (2, 17, 80, 64, (32, 1)),
    (9, 33, 64, 128, (32, 2)),
])
def test_plan_sizes_the_tile_to_T_and_shares_where_occupancy_allows(
        B, T, H, N, want):
    occ = OCCUPANCY[N]
    assert ssd_scan.plan(B, T, H, lambda q, h: occ[(q, h)], 132) == want


# ------------------------------------------------------------- the block
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    name = request.param
    jm = jax_make_model(jax_get_config(name).reduced(), tp=1)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                            jnp.float32))
    tm = make_model(get_config(name).reduced(), tp=1)
    return jm, jax.tree.map(jnp.asarray, tree), tm, \
        params_from_jax(tree, device="cpu")


def _block_input(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
@pytest.mark.parametrize("T,lengths", [(12, None), (40, None),
                                       (16, [16, 5]), (40, [33, 1])])
def test_mamba2_forward_matches_reference(pair, backend, T, lengths):
    """Prefill of one Mamba-2 block (layer 1's weights): output, SSM state
    and conv tail, with and without right-padded ``lengths``; T = 40 is
    no multiple of the chunk (32), so both sides pad."""
    jm, jp, tm, tp = pair
    x = _block_input(tm.cfg, 2, T, seed=T)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jout, jst = jax_ssd.mamba2_forward(
        jax.tree.map(lambda a: a[1], jp["layers"]["mamba"]),
        jnp.asarray(x), jm.cfg, return_state=True,
        lengths=None if lens is None else jnp.asarray(lens))
    out, st = ssd.mamba2_forward(
        tp["layers"][1]["mamba"], torch.from_numpy(x), tm.cfg,
        return_state=True,
        lengths=None if lens is None else torch.from_numpy(lens),
        attn_backend=backend)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **TOL)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_mamba2_forward_across_chunk_sizes(pair, backend):
    """The port at chunk 8 against the reference at its chunk (32)."""
    jm, jp, tm, tp = pair
    x = _block_input(tm.cfg, 2, 48, seed=9)
    jout, jst = jax_ssd.mamba2_forward(
        jax.tree.map(lambda a: a[0], jp["layers"]["mamba"]),
        jnp.asarray(x), jm.cfg, return_state=True)
    cfg8 = dataclasses.replace(tm.cfg, ssm_chunk=8)
    out, st = ssd.mamba2_forward(tp["layers"][0]["mamba"],
                                 torch.from_numpy(x), cfg8,
                                 return_state=True, attn_backend=backend)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               **CROSS_CHUNK_TOL)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]),
                               **CROSS_CHUNK_TOL)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
@pytest.mark.parametrize("T,lengths", [(8, [8, 3]), (40, None)])
def test_mamba2_forward_continues_a_chunk(pair, backend, T, lengths):
    """A chunk of a chunked prefill: the block from a random carried SSM
    state and raw conv window, with and without right-padded ``lengths``
    (the conv tail is gathered from [carry | chunk]), against the
    reference's ``mamba2_forward(init_state=, conv_state=)``."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(T + 1)
    x = _block_input(cfg, 2, T, seed=T + 2)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    s0 = (rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state)) * 0.3).astype(np.float32)
    c0 = rng.standard_normal((2, cfg.ssm_conv_width - 1,
                              conv_ch)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jout, jst = jax_ssd.mamba2_forward(
        jax.tree.map(lambda a: a[0], jp["layers"]["mamba"]),
        jnp.asarray(x), jm.cfg, init_state=jnp.asarray(s0),
        conv_state=jnp.asarray(c0), return_state=True,
        lengths=None if lens is None else jnp.asarray(lens))
    out, st = ssd.mamba2_forward(
        tp["layers"][0]["mamba"], torch.from_numpy(x), cfg,
        init_state=torch.from_numpy(s0), conv_state=torch.from_numpy(c0),
        return_state=True,
        lengths=None if lens is None else torch.from_numpy(lens),
        attn_backend=backend)
    if lens is not None:     # pad rows' outputs are discarded by the caller
        keep = np.arange(T)[None, :] < lens[:, None]
        out, jout = out.numpy()[keep], np.asarray(jout)[keep]
    np.testing.assert_allclose(np.asarray(out), np.asarray(jout), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), **TOL)


def test_mamba2_decode_matches_reference(pair):
    """Three decode steps of one block from a random carried state; the
    port updates the state in place."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    st = {"ssm": rng.standard_normal((3, cfg.ssm_heads, cfg.ssm_head_dim,
                                      cfg.ssm_state)).astype(np.float32),
          "conv": rng.standard_normal(
              (3, cfg.ssm_conv_width - 1,
               cfg.d_inner + 2 * cfg.ssm_state)).astype(np.float32)}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    jparams = jax.tree.map(lambda a: a[2], jp["layers"]["mamba"])
    for step in range(3):
        x = _block_input(cfg, 3, 1, seed=20 + step)
        jout, jst = jax_ssd.mamba2_decode(jparams, jnp.asarray(x), jm.cfg,
                                          jst)
        out, same = ssd.mamba2_decode(tp["layers"][2]["mamba"],
                                      torch.from_numpy(x), cfg, tst)
        assert same is tst
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       **TOL)


# ------------------------------------------------------------ the LM
def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, size=(3, 16)).astype(np.int32)
    return toks, np.array([16, 7, 1], np.int32)


def _prefill_both(pair, backend):
    jm, jp, tm, tp = pair
    toks, lens = _prompts(jm.cfg.vocab_size)
    jl, jst, jpos = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                    "lengths": jnp.asarray(lens)},
                               cache_len=CACHE_LEN, cache_dtype=jnp.float32)
    tl, tst, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                    "lengths": torch.from_numpy(lens)},
                               cache_len=CACHE_LEN,
                               cache_dtype=torch.float32,
                               attn_backend=backend)
    return (jl, jst, jpos), (tl, tst, tpos)


def _close_state(tst, jst):
    assert sorted(tst) == sorted(jst)
    for k in jst:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_prefill_and_decode_match_reference(pair, backend):
    """Prefill logits, state and pos (ragged lengths, one of them 1), then
    one decode step at per-row positions: logits and every state leaf."""
    jm, jp, tm, tp = pair
    (jl, jst, jpos), (tl, tst, tpos) = _prefill_both(pair, backend)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_state(tst, jst)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    jl2, jst2 = jm.decode(jp, jst, jnp.asarray(tok), jpos)
    tl2, tst2 = tm.decode(tp, tst, torch.from_numpy(tok), tpos,
                          attn_backend=backend)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    _close_state(tst2, jst2)


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
def test_greedy_streams_match_reference(pair, backend):
    """Ten greedy steps after the prefill: identical token streams."""
    jm, jp, tm, tp = pair
    (jl, jst, jpos), (tl, tst, tpos) = _prefill_both(pair, backend)
    jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
    js, ts = [np.asarray(jtok)], [ttok.numpy()]
    for _ in range(10):
        jl, jst = jm.decode(jp, jst, jtok[:, None].astype(jnp.int32), jpos)
        tl, tst = tm.decode(tp, tst, ttok[:, None].to(torch.int32), tpos,
                            attn_backend=backend)
        jpos, tpos = jpos + 1, tpos + 1
        jtok, ttok = jnp.argmax(jl, axis=-1), torch.argmax(tl, dim=-1)
        js.append(np.asarray(jtok))
        ts.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(ts), np.stack(js))


def test_decode_write_rows_keeps_other_rows_bit_for_bit(pair):
    """A decode with ``write_rows`` changes the SSM, conv and attention
    state of those rows only, and gives them the state and logits of a
    full decode."""
    _, _, tm, tp = pair
    gen = torch.Generator().manual_seed(0)
    state = tm.init_serve_state(4, CACHE_LEN, torch.float32, device="cpu")
    for t in state.values():
        t.normal_(generator=gen)
    tok = torch.tensor([[3], [9], [27], [81]], dtype=torch.int32)
    pos = torch.tensor([5, 0, 17, 31], dtype=torch.int32)
    rows = torch.tensor([1, 2], dtype=torch.int32)
    full = {k: t.clone() for k, t in state.items()}
    part = {k: t.clone() for k, t in state.items()}
    lf, _ = tm.decode(tp, full, tok, pos)
    lp, _ = tm.decode(tp, part, tok, pos, write_rows=rows)
    torch.testing.assert_close(lp[1:3], lf[1:3], rtol=0, atol=0)
    for k in state:
        assert torch.equal(part[k][:, [0, 3]], state[k][:, [0, 3]]), k
        assert torch.equal(part[k][:, [1, 2]], full[k][:, [1, 2]]), k
        assert not torch.equal(part[k][:, [1, 2]], state[k][:, [1, 2]]), k


def test_bridge_maps_the_ssm_tree(pair):
    """Stacked ``layers/{norm, mamba/*}`` split per layer; the hybrid's
    ``shared_attn`` block maps whole, unsplit."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    assert len(tp["layers"]) == cfg.num_layers
    w = np.asarray(jp["layers"]["mamba"]["in_proj"])
    for i, lp in enumerate(tp["layers"]):
        np.testing.assert_array_equal(lp["mamba"]["in_proj"].numpy(), w[i])
        assert sorted(lp) == ["mamba", "norm"]
    if cfg.family == "hybrid":
        wq = np.asarray(jp["shared_attn"]["attn"]["wq"])
        assert tuple(tp["shared_attn"]["attn"]["wq"].shape) == wq.shape
        np.testing.assert_array_equal(tp["shared_attn"]["attn"]["wq"].numpy(),
                                      wq)
    else:
        assert "shared_attn" not in tp


def test_port_init_keeps_the_reference_decay_draws():
    """A_log and dt_bias are the reference's numpy draws, whatever the
    generator: the port's own init gives the reference's values."""
    cfg = get_config("mamba2-1.3b").reduced()
    jp = jax_make_model(jax_get_config("mamba2-1.3b").reduced(),
                        tp=1).init(jax.random.PRNGKey(0), jnp.float32)
    tp = make_model(cfg).init(seed=5, device="cpu")
    for k in ("A_log", "dt_bias", "D"):
        np.testing.assert_array_equal(
            tp["layers"][0]["mamba"][k].numpy(),
            np.asarray(jp["layers"]["mamba"][k][0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_versions_at_head_dim_80(dtype):
    """zamba2-2.7b's shared block at full width has head dim 80 (32 q and
    32 kv heads): both attention plain versions against the Pallas kernels
    there, and both kernels' wrappers take it."""
    from repro_torch.kernels import decode_attention, flash_attention
    assert get_config("zamba2-2.7b").resolved_head_dim == 80
    assert 80 in decode_attention.HEAD_DIMS
    assert 80 in flash_attention.HEAD_DIMS
    _decode_case(2, 4, 4, 96, 80, [0, 95], dtype, 96, 11)
    for causal in (True, False):
        _attention_case(2, 4, 4, 40, 80, causal, dtype, 40, 40, 12)
