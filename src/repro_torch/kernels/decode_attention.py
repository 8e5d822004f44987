"""Binding of the Hopper flash-decode kernel (``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``_decode_kernel`` / ``flash_decode`` of
``src/repro/kernels/decode_attention.py``: single-token GQA attention of
q ``(B, G, qpg, hd)`` over the serve caches ``(B, S, G, hd)``, row b over
positions ``0..pos[b]``. The kernel reads the caches natively (by strides,
in their own dtype); it is bound by the bytes of the filled cache. An int8
cache (``serving.kv_quant``: int8 K/V, f32 scales ``(B, S, G)``) is
dequantized in the kernel's loads (``launch_int8``), so its HBM stream is
the int8 bytes and the scales. Each
row's cache is split into chunks of ``CHUNK`` positions, one block each,
whose partials the row's last block merges (see the source). Callers go
through ``repro_torch.kernels.ops``, which checks the arguments, allocates
the partials and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "flash_decode"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)
MAX_QPG = 16
CHUNK = 128          # the kernel's kChunk: KV positions a block

# device -> int32 ticket counters, zeros the kernel leaves zero. A grown
# buffer keeps the older ones alive: a captured CUDA graph may point at them.
_tickets: dict = {}

_LongPtr = ctypes.POINTER(ctypes.c_longlong)
_Strides3 = ctypes.c_longlong * 3


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.flash_decode_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 4 + [_LongPtr] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        fn8 = lib.flash_decode_int8_launch
        fn8.restype = ctypes.c_int
        fn8.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
                        + [ctypes.c_int] * 4 + [_LongPtr] * 4
                        + [ctypes.c_float, ctypes.c_void_p])
        if lib.flash_decode_chunk() != CHUNK:
            raise RuntimeError(f"flash_decode: kernel chunk "
                               f"{lib.flash_decode_chunk()} != {CHUNK}")
    return lib


def partial_floats(B: int, G: int, qpg: int, hd: int, S: int) -> int:
    """f32 elements of the partials scratch: (acc, m, l) per chunk."""
    return B * G * -(-S // CHUNK) * qpg * (hd + 2)


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """The per-(b, g) ticket counters of ``device``: zeroed once, grown
    when a launch needs more, and left zero by every launch."""
    bufs = _tickets.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1 << 16), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _strides(t) -> _Strides3:
    return _Strides3(t.stride(0), t.stride(1), t.stride(2))


def _raise(lib, code: int) -> None:
    if code != 0:
        msg = lib.flash_decode_error_string(code).decode()
        raise RuntimeError(f"flash_decode launch failed ({code}): {msg}")


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           pos: torch.Tensor, out: torch.Tensor, part: torch.Tensor,
           scale: float) -> None:
    """Enqueue one launch on the current stream; raises if CUDA refused
    it. Arguments must already be checked and ``part`` sized by
    ``partial_floats`` (``ops.flash_decode``)."""
    lib = _lib()
    B, G, qpg, hd = q.shape
    _raise(lib, lib.flash_decode_launch(
        DTYPES[q.dtype], hd, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets(q.device, B * G).data_ptr(), B, G, qpg, k_cache.shape[1],
        _strides(q), _strides(k_cache), _strides(v_cache), scale,
        torch.cuda.current_stream(q.device).cuda_stream))


def launch_int8(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, k_scale: torch.Tensor,
                v_scale: torch.Tensor, pos: torch.Tensor, out: torch.Tensor,
                part: torch.Tensor, scale: float) -> None:
    """``launch`` over an int8 cache with its f32 scales (B, S, G), which
    share strides. Arguments must already be checked."""
    lib = _lib()
    B, G, qpg, hd = q.shape
    _raise(lib, lib.flash_decode_int8_launch(
        DTYPES[q.dtype], hd, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets(q.device, B * G).data_ptr(), B, G, qpg, k_cache.shape[1],
        _strides(q), _strides(k_cache), _strides(v_cache),
        _strides(k_scale), scale,
        torch.cuda.current_stream(q.device).cuda_stream))
