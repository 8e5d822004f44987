"""Binding of the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_scan`` of
``src/repro/kernels/ssd_scan.py``: the Mamba-2 SSD blocked scan of a
prefill, x ``(B, T, H, P)`` dt-preweighted, log decays a ``(B, T, H)``,
one group of B/C ``(B, T, N)``, from a zero state, returning y
``(B, T, H, P)`` and the final state ``(B, H, P, N)``, all f32. One block
per (head, batch row) keeps the state in shared memory across the chunks;
it is bound by its operations. See the source for the design. Callers go
through ``repro_torch.kernels.ops``, which checks the arguments and counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
MAX_HEAD_DIM = 64
MAX_STATE = 128


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_scan_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    return lib


def launch(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, y: torch.Tensor, state: torch.Tensor) -> None:
    """Enqueue one launch on the current stream; raises if CUDA refused
    it. Arguments must already be checked (``ops.ssd_scan``)."""
    lib = _lib()
    B, T, H, P = x.shape
    code = lib.ssd_scan_launch(
        x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, T, H, P, Bm.shape[-1],
        torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.ssd_scan_error_string(code).decode()
        raise RuntimeError(f"ssd_scan launch failed ({code}): {msg}")
