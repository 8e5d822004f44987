"""Binding of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``src/repro/kernels/flash_attention.py``: causal or full GQA attention of
q ``(B, S, G, qpg, hd)`` over k/v ``(B, S, G, hd)``, read by strides in the
model's grouped layout, with a ragged S masked in the kernel. It backs the
bucketed prefill, and with a per-row cache offset ``q_off`` over a layer
of the serve pool (k/v ``(R, Sk, G, hd)``, rows ``kv_rows``) every chunk of
a chunked prefill; full attention also takes k/v of another length than
q (``(B, Sk, G, hd)``), the cross-attention of an encoder-decoder. bf16
runs on the tensor cores (``wgmma``, the group's q heads packed into one
64-row tile); f32 runs SIMT, for the f32 parity gates. See the source
for the design. Callers go through ``repro_torch.kernels.ops``, which
checks the arguments and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)
MAX_QPG = 64         # the bf16 body packs qpg heads into 64 rows

_LongPtr = ctypes.POINTER(ctypes.c_longlong)
_Strides3 = ctypes.c_longlong * 3
_Strides4 = ctypes.c_longlong * 4


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.flash_attention_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [_LongPtr] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    return lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, scale: float,
           q_off: torch.Tensor | None = None,
           kv_rows: torch.Tensor | None = None) -> None:
    """Enqueue one launch on the current stream; raises if CUDA refused
    it. Arguments must already be checked (``ops.flash_attention``)."""
    lib = _lib()
    B, S, G, qpg, hd = q.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    qs = _Strides4(q.stride(0), q.stride(1), q.stride(2), q.stride(3))
    ks = _Strides3(k.stride(0), k.stride(1), k.stride(2))
    vs = _Strides3(v.stride(0), v.stride(1), v.stride(2))
    code = lib.flash_attention_launch(
        DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), ptr(q_off), ptr(kv_rows), B, S, k.shape[1], G, qpg,
        int(causal), qs, ks, vs, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed ({code}): {msg}")
