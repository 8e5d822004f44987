"""Binding of the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_scan`` of
``src/repro/kernels/ssd_scan.py``: the Mamba-2 SSD blocked scan of a
prefill, x ``(B, T, H, P)`` dt-preweighted, log decays a ``(B, T, H)``,
one group of B/C ``(B, T, N)``, from a zero state or from a carried
``init_state`` ``(B, H, P, N)`` (a chunked prefill's), returning y
``(B, T, H, P)`` and the final state ``(B, H, P, N)``, all f32. Its
products run on the tensor cores in split TF32 (f32 accuracy); a block
serves ``hpb`` heads of one batch row, shares their C.B^T tile and keeps
their states in registers across the blocks of ``tile`` steps. ``plan``
picks both from T, the grid and the card's occupancy of each
instantiation; see the source for the design. Callers go through
``repro_torch.kernels.ops``, which checks the arguments and counts
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
MAX_HEAD_DIM = 64
MAX_STATE = 128
TILES = (16, 32)        # the kernel's step tiles (template instantiations)
MAX_HPB = 2             # heads a block serves: 1 or 2
WARPS_PER_HEAD = 4


def plan(B: int, T: int, H: int, blocks_per_sm, sms: int) -> tuple:
    """(tile, hpb) of one launch. The tile: 16 steps for T <= 16, else 32.
    Heads a block: 2 (one C.B^T tile for both) where that keeps as many
    warps on an SM as 1 head does and leaves at least one block per SM;
    else 1. ``blocks_per_sm(tile, hpb)`` is the card's occupancy of that
    instantiation, ``sms`` its SM count."""
    tile = TILES[0] if T <= TILES[0] else TILES[-1]

    def warps(hpb):
        return blocks_per_sm(tile, hpb) * WARPS_PER_HEAD * hpb

    two = B * -(-H // MAX_HPB) >= sms and warps(MAX_HPB) >= warps(1)
    return tile, MAX_HPB if two else 1


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_scan_launch
    if not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_blocks_per_sm.restype = ctypes.c_int
        lib.ssd_scan_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    return lib


@functools.lru_cache(maxsize=None)
def blocks_per_sm(tile: int, hpb: int, N: int, device: int) -> int:
    """How many blocks of instantiation (tile, hpb) at state dim N one SM
    of CUDA device ``device`` holds at once."""
    with torch.cuda.device(device):
        n = _lib().ssd_scan_blocks_per_sm(tile, hpb, N)
    if n <= 0:
        raise RuntimeError(f"ssd_scan occupancy query failed ({n})")
    return n


def device_plan(B: int, T: int, H: int, N: int, device) -> tuple:
    """``plan`` on the card that holds ``device``."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return plan(B, T, H, lambda q, h: blocks_per_sm(q, h, N, index),
                torch.cuda.get_device_properties(index).multi_processor_count)


def launch(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, y: torch.Tensor, state: torch.Tensor,
           instantiation: tuple | None = None,
           init_state: torch.Tensor | None = None) -> None:
    """Enqueue one launch on the current stream; raises if CUDA refused
    it. Arguments must already be checked (``ops.ssd_scan``).
    ``instantiation`` (tile, hpb) overrides ``plan``: the parity checks
    run every instantiation, whichever the plan picks. ``init_state``
    None starts from zeros."""
    lib = _lib()
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    tile, hpb = instantiation or device_plan(B, T, H, N, x.device)
    init = None if init_state is None else init_state.data_ptr()
    code = lib.ssd_scan_launch(
        x.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), init,
        y.data_ptr(), state.data_ptr(), B, T, H, P, N, tile, hpb,
        torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.ssd_scan_error_string(code).decode()
        raise RuntimeError(f"ssd_scan launch failed ({code}): {msg}")


def smem_bytes(tile: int, hpb: int, N: int) -> int:
    """Dynamic shared memory of one launch of instantiation (tile, hpb) at
    state dim N."""
    return int(_lib().ssd_scan_smem_bytes(tile, hpb, N))
