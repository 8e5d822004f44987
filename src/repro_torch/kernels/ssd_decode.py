"""Binding of the Hopper Mamba-2 decode-step kernel (``csrc/ssd_decode.cu``).

Replaces no Pallas kernel: the reference's decode step is plain ``jnp``.
One recurrence step of a layer's carried SSM state ``(B, H, P, N)`` f32 in
place, every row or only the rows of a ``write`` index buffer, with the
read-out y ``(B, H, P)`` f32: the state is read once and written once,
where the plain version (``ref.ssd_decode_ref``) makes seven to ten passes
over state-sized tensors. It is bound by those bytes; see the source for
the design. Callers go through ``repro_torch.kernels.ops``, which checks
the arguments, allocates y and the mask and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_decode"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # x, Bm and Cm
MAX_HEAD_DIM = 64      # what ssd_scan takes
MAX_STATE = 128


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_decode_launch
    if not fn.argtypes:
        i64, ptr, i32 = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        fn.argtypes = [ptr, i64, i64, ptr, i64, i64, i32, ptr, i64, i64,
                       ptr, ptr, i64, ptr, i64, ptr, i32, ptr, ptr, i32,
                       i32, i32, i32, ptr]
        lib.ssd_decode_error_string.restype = ctypes.c_char_p
        lib.ssd_decode_error_string.argtypes = [i32]
    return lib


def launch(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
           A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
           y: torch.Tensor, write: torch.Tensor | None = None,
           mask: torch.Tensor | None = None) -> None:
    """Enqueue one step on the current stream (the mask's kernel first when
    ``write`` is given); raises if CUDA refused a launch. Arguments must
    already be checked (``ops.ssd_decode``): Bm and Cm are (B, 1, N)."""
    lib = _lib()
    B, H, P, N = state.shape
    code = lib.ssd_decode_launch(
        state.data_ptr(), state.stride(0), state.stride(1), x.data_ptr(),
        x.stride(0), x.stride(1), DTYPES[x.dtype], dt.data_ptr(),
        dt.stride(0), dt.stride(1), A.data_ptr(), Bm.data_ptr(),
        Bm.stride(0), Cm.data_ptr(), Cm.stride(0),
        None if write is None else write.data_ptr(),
        0 if write is None else write.numel(),
        None if mask is None else mask.data_ptr(), y.data_ptr(), B, H, P, N,
        torch.cuda.current_stream(state.device).cuda_stream)
    if code != 0:
        msg = lib.ssd_decode_error_string(code).decode()
        raise RuntimeError(f"ssd_decode launch failed ({code}): {msg}")
