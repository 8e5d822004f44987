"""Binding of the Hopper GCN-layer kernel (``csrc/gcn_layer.cu``).

Replaces the Pallas TPU kernel ``_gcn_kernel`` / ``gcn_layer`` of
``src/repro/kernels/gcn_fused.py``: one layer of the paper's Eq. 6,
``relu?(A_hat . X . W + b)`` in f32, with ``A_hat . X`` kept in shared
memory. At the control plane's graph sizes a call is bound by its launch,
not by bytes or operations. See the source for the design. Callers go
through ``repro_torch.kernels.ops``, which checks the arguments and counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "gcn_layer"


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.gcn_layer_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        lib.gcn_layer_error_string.restype = ctypes.c_char_p
        lib.gcn_layer_error_string.argtypes = [ctypes.c_int]
    return lib


def launch(a_hat: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor, out: torch.Tensor, relu: bool) -> None:
    """Enqueue one launch on the current stream; raises if CUDA refused
    it. ``x`` is (Bt, N, F) and ``out`` (Bt, N, H); arguments must already
    be checked (``ops.gcn_layer``)."""
    lib = _lib()
    bt, n, f = x.shape
    code = lib.gcn_layer_launch(
        a_hat.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), bt, n, f, w.shape[1], int(relu),
        torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.gcn_layer_error_string(code).decode()
        raise RuntimeError(f"gcn_layer launch failed ({code}): {msg}")
