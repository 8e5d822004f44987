"""The port's plain kernel versions (``repro_torch.kernels.ref``) against the
JAX Pallas kernels run in interpret mode, and the ``ops`` wrappers' CPU
path.

Inputs come from numpy with a seed and go to both packages. The port keeps
the serve layout -- q (B, G, qpg, hd) / (B, S, G, qpg, hd), caches
(B, S, G, hd) -- while the JAX kernels take heads before positions, so
the tests transpose on the JAX side. Tolerances are the reference's
(``tests/test_kernels.py``): f32 2e-5, bf16 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from repro_torch.kernels import decode_attention, ops, ref
from test_torch_vlm import _one_torch_thread  # noqa: F401

TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOLS[dtype])


def _decode_case(B, Hq, Hkv, S, d, pos, dtype, block_kv, seed):
    """JAX flash_decode (interpret) vs the port's plain flash_decode."""
    rng = np.random.default_rng(seed)
    qj, qt = _both(rng.standard_normal((B, Hq, d), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((B, Hkv, S, d), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((B, Hkv, S, d), np.float32), dtype)
    want = jax_flash_decode(qj, kj, vj, jnp.asarray(pos, jnp.int32),
                            block_kv=block_kv, interpret=True)
    got = ref.flash_decode_ref(qt.reshape(B, Hkv, Hq // Hkv, d),
                               kt.transpose(1, 2), vt.transpose(1, 2),
                               torch.as_tensor(pos, dtype=torch.int32))
    _close(got.reshape(B, Hq, d), want, dtype)


def _attention_case(B, Hq, Hkv, S, d, causal, dtype, block_q, block_kv,
                    seed):
    """JAX flash_attention (interpret) vs the port's plain
    flash_attention."""
    rng = np.random.default_rng(seed)
    qj, qt = _both(rng.standard_normal((B, Hq, S, d), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((B, Hkv, S, d), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((B, Hkv, S, d), np.float32), dtype)
    want = jax_flash_attention(qj, kj, vj, causal=causal, block_q=block_q,
                               block_kv=block_kv, interpret=True)
    q = qt.transpose(1, 2).reshape(B, S, Hkv, Hq // Hkv, d)
    got = ref.flash_attention_ref(q, kt.transpose(1, 2), vt.transpose(1, 2),
                                  causal=causal)
    _close(got.reshape(B, S, Hq, d).transpose(1, 2), want, dtype)


# the sweep of tests/test_kernels.py (block sizes as large as the shape
# allows: the function does not depend on them, the interpreter's time
# does)
@pytest.mark.parametrize("B,Hq,Hkv,S,d", [
    (1, 4, 4, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 256, 128),
    (2, 6, 2, 384, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_jax(B, Hq, Hkv, S, d, dtype, causal):
    _attention_case(B, Hq, Hkv, S, d, causal, dtype, 128, 128, B * S + d)


@pytest.mark.parametrize("B,Hq,Hkv,S,d,pos", [
    (1, 4, 4, 256, 64, 0), (2, 4, 2, 512, 64, 100), (1, 8, 1, 256, 128, 255),
    (3, 4, 1, 512, 32, 384),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_jax(B, Hq, Hkv, S, d, pos, dtype):
    _decode_case(B, Hq, Hkv, S, d, pos, dtype, 256, pos + S)


def _decode_split_case(B, Hq, Hkv, S, d, pos, dtype, chunk, seed):
    """JAX flash_decode (interpret) and the port's dense plain version
    against the port's split-KV plain version at chunk length ``chunk``."""
    rng = np.random.default_rng(seed)
    qj, qt = _both(rng.standard_normal((B, Hq, d), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((B, Hkv, S, d), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((B, Hkv, S, d), np.float32), dtype)
    want = jax_flash_decode(qj, kj, vj, jnp.asarray(pos, jnp.int32),
                            block_kv=S, interpret=True)
    args = (qt.reshape(B, Hkv, Hq // Hkv, d), kt.transpose(1, 2),
            vt.transpose(1, 2), torch.as_tensor(pos, dtype=torch.int32))
    got = ref.flash_decode_split_ref(*args, chunk)
    _close(got.reshape(B, Hq, d), want, dtype)
    torch.testing.assert_close(got.float(),
                               ref.flash_decode_ref(*args).float(),
                               **TOLS[dtype])


# ragged depths: 0, S - 1, multiples of the chunk and one past them, a
# chunk that straddles pos; one pool as long as the kernel's S = 4096 pool
# cut to 32 chunks of 16
@pytest.mark.parametrize("S,chunk,pos", [
    (100, 16, [0, 99, 15, 16, 31, 32, 50, 64]),
    (512, 16, [0, 511, 255, 256, 300, 17, 48, 1]),
    (300, decode_attention.CHUNK, [0, 299, 127, 128, 255, 256, 200, 5]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_split_plain_matches_jax(S, chunk, pos, dtype):
    _decode_split_case(len(pos), 8, 2, S, 32, pos, dtype, chunk, S + chunk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_split_row_independent_of_batch(dtype):
    """A row's split-KV result is the same, bit for bit, alone and inside a
    larger batch whose other rows reach other depths: the chunk length is
    fixed, never derived from the batch."""
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s, np.float32)).to(TDT[dtype])
    B, G, qpg, S, d = 6, 2, 4, 400, 32
    q, k, v = t(B, G, qpg, d), t(B, S, G, d), t(B, S, G, d)
    pos = torch.tensor([5, 399, 128, 255, 0, 300], dtype=torch.int32)
    chunk = decode_attention.CHUNK
    full = ref.flash_decode_split_ref(q, k, v, pos, chunk)
    for r in range(B):
        alone = ref.flash_decode_split_ref(q[r:r + 1], k[r:r + 1],
                                           v[r:r + 1], pos[r:r + 1], chunk)
        assert torch.equal(alone, full[r:r + 1]), r
    pair = ref.flash_decode_split_ref(q[1:3], k[1:3], v[1:3], pos[1:3],
                                      chunk)
    assert torch.equal(pair, full[1:3])


@pytest.mark.parametrize("S", [8, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_ragged_s(S, causal):
    """S that is no multiple of any tile (serving buckets start at 8): the
    JAX kernel runs with one block as long as S."""
    _attention_case(2, 8, 2, S, 32, causal, "float32", S, S, S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_vector_pos_ragged_s(dtype):
    """Per-row pos (0, S-1 and values inside a tile) over a ragged S."""
    _decode_case(4, 8, 2, 100, 64, [0, 99, 37, 64], dtype, 100, 7)


def test_ops_cpu_tensors_take_the_plain_path():
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32))
    q, k, v = t(2, 2, 3, 32), t(2, 20, 2, 32), t(2, 20, 2, 32)
    pos = torch.tensor([0, 13], dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    torch.testing.assert_close(ops.flash_decode(q, k, v, pos),
                               ref.flash_decode_ref(q, k, v, pos),
                               rtol=0, atol=0)
    qa = t(2, 20, 2, 3, 32)
    for causal in (True, False):
        torch.testing.assert_close(
            ops.flash_attention(qa, k, v, causal=causal),
            ref.flash_attention_ref(qa, k, v, causal=causal), rtol=0, atol=0)
    assert ops.LAUNCHES == before


def test_ops_refuse_other_devices():
    """No silent path: a device that is neither the CPU nor CUDA raises, and
    so do tensors split across devices."""
    q = torch.empty(1, 1, 1, 32, device="meta")
    k = torch.empty(1, 8, 1, 32, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.flash_decode(q, k, k, pos)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(torch.empty(1, 8, 1, 1, 32), k, k)


# --------------------------------- a cache offset (chunked prefill), int8
def _attn_setup(rope, seed):
    """Reduced granite's attention dims with random numpy weights, shared
    by the two packages (the same (d, n, hd) layouts)."""
    from repro.configs import get_config as jax_get_config
    from repro.models.dims import padded_dims as jax_padded_dims
    from repro_torch.configs import get_config
    from repro_torch.models.dims import padded_dims

    jcfg = jax_get_config("granite-3-8b").reduced()
    cfg = get_config("granite-3-8b").reduced()
    jd, td = jax_padded_dims(jcfg), padded_dims(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32)
    params = {"wq": w(d, td.n_q, hd), "wk": w(d, td.n_kv, hd),
              "wv": w(d, td.n_kv, hd), "wo": w(td.n_q, hd, d)}
    return jd, td, params, rng, d, hd


@pytest.mark.parametrize("backend", ["pallas", "einsum"])
@pytest.mark.parametrize("rope", [0.0, 10_000.0])
def test_chunk_prefill_attention_matches_reference(backend, rope):
    """One chunk at ragged cache offsets (0 and S - C among them) over rows
    of a larger pool, against the reference's ``chunk_prefill_attention``
    on those rows: the real columns' outputs and the written K/V within
    f32's 2e-5 (RoPE's cos/sin differ in the last ulp between the two
    libraries), the chunk written at the reference's positions only (pad
    columns land on the pool's last position, which the reference leaves
    alone) and the other pool rows untouched."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as attn

    jd, td, params, rng, d, hd = _attn_setup(rope, seed=int(rope) + 3)
    R, B, C, S = 6, 3, 8, 40
    rows = np.asarray([4, 0, 2], np.int32)
    offs = np.asarray([0, 13, S - C - 1], np.int32)
    lens = np.asarray([C, 5, C], np.int32)
    pos = offs[:, None] + np.arange(C, dtype=np.int32)[None]
    x = rng.standard_normal((B, C, d)).astype(np.float32)
    pool = rng.standard_normal((2, R, S, td.n_kv, hd)).astype(np.float32)
    jout, jcache = jax_attn.chunk_prefill_attention(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jd,
        {"k": jnp.asarray(pool[0][rows]), "v": jnp.asarray(pool[1][rows])},
        jnp.asarray(pos), jnp.asarray(lens), rope_theta=rope)
    kc, vc = (torch.from_numpy(p.copy()) for p in pool)
    out = attn.chunk_prefill_attention(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), td, kc, vc, torch.from_numpy(pos),
        torch.from_numpy(lens), rope_theta=rope, backend=backend,
        rows=torch.from_numpy(rows))
    real = np.arange(C)[None, :] < lens[:, None]
    np.testing.assert_allclose(out.numpy()[real], np.asarray(jout)[real],
                               **TOLS["float32"])
    for got, want in ((kc, jcache["k"]), (vc, jcache["v"])):
        np.testing.assert_allclose(got.numpy()[rows][:, :S - 1],
                                   np.asarray(want)[:, :S - 1],
                                   **TOLS["float32"])
    others = np.setdiff1d(np.arange(R), rows)
    np.testing.assert_array_equal(kc.numpy()[others], pool[0][others])


def test_flash_attention_plain_offset_matches_whole_prompt():
    """``ops.flash_attention`` with ``q_offset`` over a prefix the earlier
    chunks wrote equals the single-shot causal attention's rows for that
    chunk (the decomposition chunked prefill rests on)."""
    rng = np.random.default_rng(4)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32))
    q, k, v = t(2, 24, 2, 3, 32), t(2, 24, 2, 32), t(2, 24, 2, 32)
    whole = ops.flash_attention(q, k, v, causal=True)
    for c0 in (0, 8, 16):
        got = ops.flash_attention(q[:, c0:c0 + 8], k, v, causal=True,
                                  q_offset=torch.full((2,), c0,
                                                      dtype=torch.int32))
        torch.testing.assert_close(got, whole[:, c0:c0 + 8], rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("jax_backend", ["einsum", "pallas"])
@pytest.mark.parametrize("backend", ["pallas", "einsum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_matches_reference(dtype, backend, jax_backend):
    """One decode over an int8 pool at ragged depths: the port's read (its
    kernel's plain version, or the dense einsum, each dequantizing to q's
    dtype) against the reference's ``dequantize`` -> ``decode_attend``
    path (``repro.models.lm``'s int8 branch) on the same int8 values and
    scales, at f32's 2e-5 and bf16's 3e-2."""
    from repro.models import attention as jax_attn
    from repro.serving.kv_quant import dequantize
    from repro_torch.models import attention as attn
    from repro_torch.serving import kv_quant

    jd, td, params, rng, d, hd = _attn_setup(0.0, seed=11)
    B, S = 3, 48
    pos = np.asarray([0, 47, 20], np.int32)
    kq, ks = kv_quant.quantize(torch.from_numpy(
        rng.standard_normal((B, S, td.n_kv, hd)).astype(np.float32)))
    vq, vs = kv_quant.quantize(torch.from_numpy(
        rng.standard_normal((B, S, td.n_kv, hd)).astype(np.float32)))
    qn = rng.standard_normal((B, 1, td.n_kv, td.q_per_group,
                              hd)).astype(np.float32)
    qj = jnp.asarray(qn, JDT[dtype])
    kc = dequantize(jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()))
    vc = dequantize(jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()))
    jp = {k: jnp.asarray(v, JDT[dtype]) for k, v in params.items()}
    want = jax_attn.decode_attend(jp, qj, kc.astype(qj.dtype),
                                  vc.astype(qj.dtype), jnp.asarray(pos), jd,
                                  backend=jax_backend)
    tp = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in params.items()}
    got = attn.decode_attend(tp, torch.from_numpy(qn).to(TDT[dtype]), kq, vq,
                             torch.from_numpy(pos), td, backend=backend,
                             k_scale=ks, v_scale=vs)
    _close(got, want, dtype)
