"""Public wrappers of the port's kernels: one per kernel, and for the GCN
kernel two more, ``gcn_actor``, its whole-action entry point, and
``gcn_layer_bwd``, one layer's backward.

A wrapper runs the kernel's plain version (``kernels.ref``) when its
tensors lie on the CPU, and launches the CUDA kernel when they lie on a
CUDA device; there it checks device, dtype, shape and strides first and
raises on anything the kernel does not take. Nothing falls back: a CUDA
tensor either reaches the kernel or raises.

``LAUNCHES`` counts kernel launches (plain integers, one per kernel); only
a launch of the CUDA kernel adds to it, so a run can show that its path
went through the kernels.

``flash_decode``, ``flash_attention``, ``ssd_scan`` and ``ssd_decode``
have no backward: the CUDA kernel writes its output through ``ctypes``,
outside autograd. Under grad, with an input that requires grad, each
raises on either device (on the CPU its plain version would
differentiate and hide what the card would drop); training goes through
the plain paths (``backend="einsum"``). ``gcn_layer`` has its backward
(``gcn_layer_bwd``, through ``core.gcn.GCNLayer``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import decode_attention, flash_attention as fa
from repro_torch.kernels import gcn_fused, ref, ssd_decode as ssd_step
from repro_torch.kernels import ssd_scan as ssd

LAUNCHES = {"flash_decode": 0, "flash_attention": 0, "gcn_layer": 0,
            "gcn_layer_bwd": 0, "ssd_scan": 0, "ssd_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, *tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _no_grad(name: str, *tensors) -> None:
    """Raise when autograd would record through a kernel that has no
    backward (see the module docstring)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its kernel writes its output outside "
            "autograd, so the inputs' gradient would be lost; training "
            "goes through the plain path (backend='einsum')")


def _check_dtype(name, dtypes, *tensors):
    dt = tensors[0].dtype
    if dt not in dtypes or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name}: q, k and v must share one dtype of "
                        f"{sorted(map(str, dtypes))}, got "
                        f"{[str(t.dtype) for t in tensors]}")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None, *,
                 scale: float | None = None) -> torch.Tensor:
    """Single-token GQA attention. q: (B, G, qpg, hd); caches (B, S, G, hd)
    (any 16-byte aligned strides with a contiguous last dim, e.g. one
    layer of the serve pool) in q's dtype, or int8 with their f32 scales
    ``k_scale`` / ``v_scale`` (B, S, G) (the ``serving.kv_quant`` codec:
    each value is int8 * scale, rounded to q's dtype); pos: (B,) int32,
    row b attends 0..pos[b]. ``scale``: the softmax scale, 1/sqrt(hd) when
    None. Returns (B, G, qpg, hd)."""
    quant = k_cache.dtype == torch.int8
    scales = (k_scale, v_scale) if quant else ()
    if quant and (k_scale is None or v_scale is None):
        raise ValueError("flash_decode: an int8 cache needs k_scale and "
                         "v_scale")
    _no_grad("flash_decode", q, k_cache, v_cache, *scales)
    if not _on_cuda("flash_decode", q, k_cache, v_cache, pos, *scales):
        return ref.flash_decode_ref(q, k_cache, v_cache, pos,
                                    k_scale=k_scale, v_scale=v_scale,
                                    scale=scale)
    if quant:
        _check_dtype("flash_decode", decode_attention.DTYPES, q)
        if v_cache.dtype != torch.int8:
            raise TypeError("flash_decode: k and v caches must both be int8")
    else:
        _check_dtype("flash_decode", decode_attention.DTYPES, q, k_cache,
                     v_cache)
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    B, G, qpg, hd = q.shape
    if k_cache.shape[0] != B or k_cache.shape[2] != G \
            or k_cache.shape[3] != hd:
        raise ValueError(f"flash_decode: cache {tuple(k_cache.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if hd not in decode_attention.HEAD_DIMS or qpg > decode_attention.MAX_QPG:
        raise ValueError(f"flash_decode: head dim {hd} / group size {qpg} "
                         "not supported")
    if q.stride(3) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("flash_decode: the head dim must be contiguous")
    esize = k_cache.element_size()
    for t in (k_cache, v_cache):        # the kernel copies 16-byte chunks
        if t.data_ptr() % 16 or any(t.stride(i) * esize % 16
                                    for i in range(3)):
            raise ValueError("flash_decode: cache rows must be 16-byte "
                             f"aligned, got strides {t.stride()}")
    if quant:
        for t in scales:                # 4-byte copies, K's and V's alike
            if t.dtype != torch.float32 or tuple(t.shape) != \
                    tuple(k_cache.shape[:3]) or t.stride() != k_scale.stride():
                raise ValueError(
                    f"flash_decode: scales must be f32 "
                    f"{tuple(k_cache.shape[:3])} with equal strides, got "
                    f"{t.dtype} {tuple(t.shape)} {t.stride()}")
    if pos.dtype != torch.int32 or pos.shape != (B,) or not pos.is_contiguous():
        raise ValueError(f"flash_decode: pos must be contiguous int32 ({B},), "
                         f"got {pos.dtype} {tuple(pos.shape)}")
    out = torch.empty((B, G, qpg, hd), dtype=q.dtype, device=q.device)
    part = torch.empty(decode_attention.partial_floats(
        B, G, qpg, hd, k_cache.shape[1]), dtype=torch.float32,
        device=q.device)
    sm = 1.0 / math.sqrt(hd) if scale is None else scale
    if quant:
        decode_attention.launch_int8(q, k_cache, v_cache, k_scale, v_scale,
                                     pos, out, part, sm)
    else:
        decode_attention.launch(q, k_cache, v_cache, pos, out, part, sm)
    LAUNCHES["flash_decode"] += 1
    return out


def _int32_rows(name: str, what: str, t, B: int) -> None:
    if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous int32 ({B},), "
                         f"got {t.dtype} {tuple(t.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: torch.Tensor | None = None,
                    kv_rows: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Causal or full GQA attention. Without ``q_offset``: over a whole
    sequence, q (B, S, G, qpg, hd) against k, v (B, S, G, hd); or, full
    (``causal=False``), S queries against Sk keys of any length, k, v
    (B, Sk, G, hd) -- a cross-attention over an encoder's output. With
    ``q_offset`` (B,) int32: q is one chunk of S queries against a layer of
    the serve pool, k, v (R, Sk, G, hd) with Sk >= S; query i of row b sits
    at position q_offset[b] + i and (causal) sees keys 0 .. q_offset[b] + i.
    ``kv_rows`` (B,) int32 names the pool row each q row reads (default:
    row b). Any strides with a contiguous last dim; S need not be a
    multiple of any tile. ``scale``: the softmax scale, 1/sqrt(hd) when
    None. Returns (B, S, G, qpg, hd)."""
    extra = tuple(t for t in (q_offset, kv_rows) if t is not None)
    _no_grad("flash_attention", q, k, v)
    if not _on_cuda("flash_attention", q, k, v, *extra):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset, kv_rows=kv_rows,
                                       scale=scale)
    _check_dtype("flash_attention", fa.DTYPES, q, k, v)
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, G, qpg, hd = q.shape
    R, Sk = k.shape[:2]
    rows_ok = R >= B if kv_rows is not None else R == B
    if not rows_ok or tuple(k.shape[2:]) != (G, hd) \
            or (Sk < S if q_offset is not None else causal and Sk != S):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (q_offset "
                         f"{q_offset is not None}, kv_rows "
                         f"{kv_rows is not None})")
    if q_offset is not None:
        _int32_rows("flash_attention", "q_offset", q_offset, B)
    if kv_rows is not None:
        _int32_rows("flash_attention", "kv_rows", kv_rows, B)
    if hd not in fa.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not supported")
    if q.stride(4) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if qpg > fa.MAX_QPG:
        raise ValueError(f"flash_attention: group size {qpg} not supported")
    if q.dtype == torch.bfloat16:   # 16-byte K/V copies, 4-byte q reads
        for t, align in ((k, 16), (v, 16), (q, 4)):
            if t.data_ptr() % align or any(t.stride(i) * 2 % align
                                           for i in range(t.dim() - 1)):
                raise ValueError("flash_attention: bf16 rows must be "
                                 f"{align}-byte aligned, got strides "
                                 f"{t.stride()}")
    out = torch.empty((B, S, G, qpg, hd), dtype=q.dtype, device=q.device)
    fa.launch(q, k, v, out, causal,
              1.0 / math.sqrt(hd) if scale is None else scale, q_offset,
              kv_rows)
    LAUNCHES["flash_attention"] += 1
    return out


def gcn_layer(a_hat: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor, *, relu: bool = True) -> torch.Tensor:
    """One GCN layer, relu?(a_hat . x . w + b), in f32. a_hat: (N, N); x:
    (N, F) or (Bt, N, F); w: (F, H); b: (H,); all contiguous. Returns
    (N, H) or (Bt, N, H)."""
    if not _on_cuda("gcn_layer", a_hat, x, w, b):
        return ref.gcn_layer_ref(a_hat, x, w, b, relu=relu)
    for t in (a_hat, x, w, b):
        if t.dtype != torch.float32:
            raise TypeError(f"gcn_layer: f32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gcn_layer: inputs must be contiguous, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    if x.dim() not in (2, 3) or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"gcn_layer: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    n, f = x.shape[-2:]
    if tuple(a_hat.shape) != (n, n) or w.shape[0] != f \
            or b.shape[0] != w.shape[1]:
        raise ValueError(f"gcn_layer: a_hat {tuple(a_hat.shape)}, x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)} do not chain")
    x3 = x.reshape(-1, n, f)
    out = torch.empty((x3.shape[0], n, w.shape[1]), dtype=torch.float32,
                      device=x.device)
    gcn_fused.launch(a_hat, x3, w, b, out, relu)
    LAUNCHES["gcn_layer"] += 1
    return out.reshape(*x.shape[:-1], w.shape[1])


def gcn_layer_bwd(a_hat: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, out: torch.Tensor, dh: torch.Tensor, *,
                  relu: bool = True, need_dx: bool = True) -> tuple:
    """The backward of ``gcn_layer``: for out = relu?(a_hat . x . w + b)
    and its gradient dh (like out), returns (dx or None, dw, db), dw and db
    summed over the batch, in f32. The kernel masks dh by ``out`` > 0 (the
    relu's derivative) and never reads b; the plain version differentiates
    ``ref.gcn_layer_ref`` at b. Contiguous inputs, as ``gcn_layer``."""
    if not _on_cuda("gcn_layer_bwd", a_hat, x, w, b, out, dh):
        return ref.gcn_layer_bwd_ref(a_hat, x, w, b, dh, relu=relu,
                                     need_dx=need_dx)
    for t in (a_hat, x, w, b, out, dh):
        if t.dtype != torch.float32:
            raise TypeError(f"gcn_layer_bwd: f32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gcn_layer_bwd: inputs must be contiguous, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    if x.dim() not in (2, 3) or w.dim() != 2:
        raise ValueError(f"gcn_layer_bwd: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    n, f = x.shape[-2:]
    h = w.shape[1]
    want = tuple(x.shape[:-1]) + (h,)
    if tuple(a_hat.shape) != (n, n) or w.shape[0] != f \
            or tuple(b.shape) != (h,) or tuple(out.shape) != want \
            or tuple(dh.shape) != want:
        raise ValueError(f"gcn_layer_bwd: a_hat {tuple(a_hat.shape)}, x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}, out "
                         f"{tuple(out.shape)}, dh {tuple(dh.shape)} do not "
                         "chain")
    if gcn_fused.bwd_smem_bytes(n, f, h, need_dx) > gcn_fused.MAX_SMEM:
        raise ValueError(f"gcn_layer_bwd: a graph of {n} nodes (F {f}, H "
                         f"{h}) does not fit one block's shared memory")
    x3 = x.reshape(-1, n, f)
    dw = torch.empty((f, h), dtype=torch.float32, device=x.device)
    db = torch.empty((h,), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x3) if need_dx else None
    gcn_fused.launch_bwd(a_hat, x3, w, out.reshape(-1, n, h),
                         dh.reshape(-1, n, h), dx, dw, db, relu)
    LAUNCHES["gcn_layer_bwd"] += 1
    return (dx.reshape(x.shape) if need_dx else None), dw, db


def gcn_actor_fits(n: int, f: int, h: int, hidden: int,
                   n_layers: int = 2) -> bool:
    """Whether ``gcn_actor`` takes an actor of ``n_layers`` GCN layers at
    most ``h`` wide over ``n`` nodes of ``f`` features with a head of
    ``hidden`` units: one block's shared memory must hold the whole
    graph's features, two layer outputs and the head's partials."""
    return 1 <= n_layers <= gcn_fused.MAX_LAYERS and gcn_fused.smem_bytes(
        n, [f] + [h] * n_layers, hidden) <= gcn_fused.MAX_SMEM


def _rows(name: str, t, lead: tuple, n: int) -> int:
    """The batch stride of ``t``, a row of n for every observation (n) or
    one for all (0)."""
    if tuple(t.shape) == lead + (n,):
        return n if lead else 0
    if tuple(t.shape) == (n,):
        return 0
    raise ValueError(f"gcn_actor: {name} {tuple(t.shape)} is neither "
                     f"{lead + (n,)} nor ({n},)")


def gcn_actor(a_hat: torch.Tensor, obs: torch.Tensor, gcn_params: dict,
              head_params: dict, up_mask: torch.Tensor | None = None,
              noise: torch.Tensor | None = None) -> torch.Tensor:
    """The balancer's greedy action (``core.ddpg.actor_action``) in one
    launch: the GCN layers of ``gcn_params`` (relu on all but the last),
    the head of ``head_params`` over [h_L, obs], ``+ noise``, -1e9 where
    ``up_mask`` <= 0, softmax over the nodes. obs: (N, F) or (Bt, N, F);
    up_mask, noise: (N,) or obs' (..., N); all f32 and contiguous. Returns
    the fractions (N,) or (Bt, N)."""
    ws, bs = list(gcn_params["w"]), list(gcn_params["b"])
    head = [head_params[k] for k in ("w1", "b1", "w2", "b2")]
    rows = [t for t in (up_mask, noise) if t is not None]
    if not _on_cuda("gcn_actor", a_hat, obs, *ws, *bs, *head, *rows):
        return ref.gcn_actor_ref(a_hat, obs, gcn_params, head_params,
                                 up_mask=up_mask, noise=noise)
    for t in (a_hat, obs, *ws, *bs, *head, *rows):
        if t.dtype != torch.float32:
            raise TypeError(f"gcn_actor: f32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gcn_actor: inputs must be contiguous, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    if obs.dim() not in (2, 3) or not ws or len(ws) != len(bs):
        raise ValueError(f"gcn_actor: obs {tuple(obs.shape)}, {len(ws)} "
                         f"weights, {len(bs)} biases")
    n, f = obs.shape[-2:]
    dims = [f] + [w.shape[1] for w in ws]
    w1, b1, w2, b2 = head
    hidden = w1.shape[-1]
    if tuple(a_hat.shape) != (n, n) or any(
            tuple(w.shape) != (dims[i], dims[i + 1])
            or tuple(b.shape) != (dims[i + 1],)
            for i, (w, b) in enumerate(zip(ws, bs))) \
            or tuple(w1.shape) != (dims[-1] + f, hidden) \
            or tuple(b1.shape) != (hidden,) \
            or tuple(w2.shape) != (hidden, 1) or tuple(b2.shape) != (1,):
        raise ValueError(
            f"gcn_actor: a_hat {tuple(a_hat.shape)}, obs {tuple(obs.shape)}, "
            f"layers {[tuple(w.shape) for w in ws]}, head "
            f"{[tuple(t.shape) for t in head]} do not chain")
    if not gcn_actor_fits(n, f, max(dims[1:]), hidden, len(ws)):
        raise ValueError(f"gcn_actor: {len(ws)} layers over {n} nodes "
                         f"(F {f}, widths {dims[1:]}, hidden {hidden}) do "
                         "not fit one block (gcn_actor_fits)")
    lead = tuple(obs.shape[:-2])
    mask_bs = 0 if up_mask is None else _rows("up_mask", up_mask, lead, n)
    noise_bs = 0 if noise is None else _rows("noise", noise, lead, n)
    out = torch.empty(lead + (n,), dtype=torch.float32, device=obs.device)
    gcn_fused.launch_actor(a_hat, obs.reshape(-1, n, f), ws, bs, head,
                           noise, noise_bs, up_mask, mask_bs, out)
    LAUNCHES["gcn_layer"] += 1
    return out


def ssd_scan(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int,
             init_state: torch.Tensor | None = None) -> tuple:
    """The Mamba-2 SSD scan from ``init_state`` (B, H, P, N), zeros when
    None (a chunked prefill carries its earlier chunks' state). x:
    (B, T, H, P) dt-preweighted; a: (B, T, H) log decays (<= 0); Bm, Cm:
    (B, T, N) (one group); all f32 and contiguous. ``chunk`` is the
    reference's block length: min(chunk, T) must divide T, as in the TPU
    kernel. The CUDA kernel blocks its own way (the result is the same up
    to f32 rounding). Returns (y (B, T, H, P), final state (B, H, P, N)),
    f32."""
    T = x.shape[1]
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"ssd_scan: T {T} is not a multiple of chunk "
                         f"{chunk}")
    inits = () if init_state is None else (init_state,)
    _no_grad("ssd_scan", x, a, Bm, Cm, *inits)
    if not _on_cuda("ssd_scan", x, a, Bm, Cm, *inits):
        return ref.ssd_scan_ref(x, a, Bm, Cm, chunk, init_state=init_state)
    for t in (x, a, Bm, Cm, *inits):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: f32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("ssd_scan: inputs must be contiguous, got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, T, H, P), got "
                         f"{tuple(x.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(a.shape) != (B, T, H) or tuple(Bm.shape) != (B, T, N) \
            or Cm.shape != Bm.shape or any(tuple(s.shape) != (B, H, P, N)
                                           for s in inits):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, init_state "
                         f"{[tuple(s.shape) for s in inits]} do not match")
    if P > ssd.MAX_HEAD_DIM or N > ssd.MAX_STATE:
        raise ValueError(f"ssd_scan: head dim {P} / state {N} not supported")
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    ssd.launch(x, a, Bm, Cm, y, state, init_state=init_state)
    LAUNCHES["ssd_scan"] += 1
    return y, state


def ssd_decode(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
               A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
               write: torch.Tensor | None = None) -> torch.Tensor:
    """One Mamba-2 decode step of the carried state, in place. state:
    (B, H, P, N) f32, updated in place -- only the rows of ``write`` (an
    int index tensor, duplicates allowed) when given, the others keeping
    theirs bit for bit; x: (B, H, P); dt: (B, H) f32; A: (H,) f32; Bm, Cm:
    (B, G, N). Returns y (B, H, P) f32. The CUDA kernel takes what
    ``ssd_scan`` takes, P <= 64 and N <= 128 with one group, x, Bm and Cm
    in one dtype of f32 and bf16 with their last dim contiguous, a state
    with (P, N) contiguous, and ``write`` as contiguous int32; its written
    state is the plain version's bit for bit, y up to the order of its
    sum."""
    writes = () if write is None else (write,)
    _no_grad("ssd_decode", state, x, dt, A, Bm, Cm)
    if not _on_cuda("ssd_decode", state, x, dt, A, Bm, Cm, *writes):
        return ref.ssd_decode_ref(state, x, dt, A, Bm, Cm, write)
    if state.dtype != torch.float32 or dt.dtype != torch.float32 \
            or A.dtype != torch.float32:
        raise TypeError(f"ssd_decode: state, dt and A must be f32, got "
                        f"{state.dtype}, {dt.dtype}, {A.dtype}")
    if x.dtype not in ssd_step.DTYPES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_decode: x, Bm and Cm must share one dtype of "
                        f"{sorted(map(str, ssd_step.DTYPES))}, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if state.dim() != 4:
        raise ValueError(f"ssd_decode: state must be (B, H, P, N), got "
                         f"{tuple(state.shape)}")
    B, H, P, N = state.shape
    if Bm.dim() == 3 and Bm.shape[1] != 1:
        raise NotImplementedError(f"ssd_decode with {Bm.shape[1]} B/C "
                                  "groups is not yet ported (one group only)")
    if tuple(x.shape) != (B, H, P) or tuple(dt.shape) != (B, H) \
            or tuple(A.shape) != (H,) or tuple(Bm.shape) != (B, 1, N) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_decode: shapes state {tuple(state.shape)}, x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)} do not match")
    if P > ssd_step.MAX_HEAD_DIM or N > ssd_step.MAX_STATE:
        raise ValueError(f"ssd_decode: head dim {P} / state {N} not "
                         f"supported (P <= {ssd_step.MAX_HEAD_DIM}, N <= "
                         f"{ssd_step.MAX_STATE})")
    if state.stride(3) != 1 or state.stride(2) != N:
        raise ValueError("ssd_decode: the state's (P, N) must be contiguous, "
                         f"got strides {state.stride()}")
    if x.stride(2) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1 \
            or A.stride(0) != 1:
        raise ValueError(f"ssd_decode: the last dim of x, Bm, Cm and A must "
                         f"be contiguous, got strides {x.stride()}, "
                         f"{Bm.stride()}, {Cm.stride()}, {A.stride()}")
    mask = None
    if write is not None:
        if write.dtype != torch.int32 or write.dim() != 1 \
                or not write.is_contiguous():
            raise ValueError(f"ssd_decode: write must be contiguous 1-D "
                             f"int32, got {write.dtype} "
                             f"{tuple(write.shape)}")
        mask = torch.empty(B, dtype=torch.uint8, device=state.device)
    y = torch.empty((B, H, P), dtype=torch.float32, device=state.device)
    ssd_step.launch(state, x, dt, A, Bm, Cm, y, write, mask)
    LAUNCHES["ssd_decode"] += 1
    return y
