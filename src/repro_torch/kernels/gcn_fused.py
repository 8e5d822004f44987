"""Binding of the Hopper GCN kernel (``csrc/gcn_layer.cu``).

Replaces the Pallas TPU kernel ``_gcn_kernel`` / ``gcn_layer`` of
``src/repro/kernels/gcn_fused.py``: one layer of the paper's Eq. 6,
``relu?(A_hat . X . W + b)`` in f32, with ``A_hat . X`` kept in shared
memory. The same kernel also runs the balancer's whole greedy action in
one launch: the GCN layers, the actor's head and the masked softmax over
the nodes, one block per observation with every intermediate in shared
memory (A_hat and the weights too, copied in by the tensor memory
accelerator). A third entry point is one layer's backward (dW, db and
optionally dX, the batch summed in a fixed order), which the DDPG update
differentiates through. At the control plane's graph sizes a call is bound
by its launch, not by bytes or operations. See the source for the design.
Callers go through ``repro_torch.kernels.ops``, which checks the arguments
and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "gcn_layer"
# the kernel's constants (csrc/gcn_layer.cu): rows a tile, input rows a
# step, threads a block, layers of one action, the card's shared memory a
# block
TM, KM, THREADS, MAX_LAYERS = 16, 16, 256, 4
MAX_SMEM = 232448
# the backward's: rows of dW a block, graph nodes a block sums
BWD_FT, BWD_ROWS = 4, 128

# device -> int32 ticket counters of the backward, zeros every launch leaves
# zero. A grown buffer keeps the older ones alive: a captured CUDA graph
# may point at them.
_tickets: dict = {}


def smem_bytes(n: int, dims, hidden: int = 0) -> int:
    """Dynamic shared memory of one launch over ``n`` nodes with layer
    widths ``dims`` (``dims[0]`` = F) and a head of ``hidden`` units (0: one
    layer alone); the source's ``make_layout``, every buffer rounded up to
    16 bytes."""
    fin, fout = max(dims[:-1]), max(dims[1:])
    sizes = [TM * fin]
    if hidden == 0:
        sizes += [TM * KM, KM * fin]             # A_hat and X in tiles
    else:     # copy barriers, A_hat, X, the outputs, the weights, the head,
        sizes += [2 * (MAX_LAYERS + 1), n * n, n * dims[0]] \
            + [n * fout] * min(len(dims) - 1, 2) \
            + [s for i, o in zip(dims[:-1], dims[1:]) for s in (i * o, o)] \
            + [(dims[-1] + dims[0]) * hidden, hidden, hidden, 1, n, n,
               n * -(-hidden // 32), n, THREADS // 32]   # mask, noise, ...
    return 4 * sum(-(-s // 4) * 4 for s in sizes)


def bwd_graphs(n: int) -> int:
    """Graphs a dW block of the backward sums (whole graphs, up to
    BWD_ROWS nodes)."""
    return 1 if n >= BWD_ROWS else BWD_ROWS // n


def bwd_chunks(batch: int, n: int) -> int:
    """Chunks of graphs the backward cuts the batch into: the rows of its
    partial sums."""
    return -(-batch // bwd_graphs(n))


def bwd_smem_bytes(n: int, f: int, h: int, with_dx: bool) -> int:
    """Dynamic shared memory of one backward launch (the source's
    ``bwd_smem_floats``)."""
    r4 = lambda v: -(-v // 4) * 4
    rows = bwd_graphs(n) * n
    wblk = r4(n * n) + 2 * r4(rows * BWD_FT) + r4(rows * h)
    xblk = r4(n * n) + r4(n * h) + r4(n * f) + r4(f * (h + 1))
    return 4 * (max(wblk, xblk) if with_dx else wblk)


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """The backward's per-tile ticket counters on ``device``: zeroed once,
    grown when a launch needs more, and left zero by every launch."""
    bufs = _tickets.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not lib.gcn_layer_launch.argtypes:
        ptr, ptrs, i = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                        ctypes.c_int)
        lib.gcn_layer_launch.restype = i
        lib.gcn_layer_launch.argtypes = [ptr] * 5 + [i] * 5 + [ptr]
        lib.gcn_actor_launch.restype = i
        lib.gcn_actor_launch.argtypes = (
            [ptr, ptr, ptrs, ptrs, ctypes.POINTER(i), i] + [ptr] * 4
            + [i, ptr, i, ptr, i, ptr, i, i, ptr])
        lib.gcn_layer_bwd_launch.restype = i
        lib.gcn_layer_bwd_launch.argtypes = [ptr] * 11 + [i] * 5 + [ptr]
        lib.gcn_layer_error_string.restype = ctypes.c_char_p
        lib.gcn_layer_error_string.argtypes = [i]
    return lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.gcn_layer_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed ({code}): {msg}")


def launch(a_hat: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor, out: torch.Tensor, relu: bool) -> None:
    """Enqueue one layer on the current stream; raises if CUDA refused
    it. ``x`` is (Bt, N, F) and ``out`` (Bt, N, H); arguments must already
    be checked (``ops.gcn_layer``)."""
    lib = _lib()
    bt, n, f = x.shape
    _check(lib, lib.gcn_layer_launch(
        a_hat.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), bt, n, f, w.shape[1], int(relu),
        torch.cuda.current_stream(x.device).cuda_stream), "gcn_layer")


def launch_actor(a_hat: torch.Tensor, x: torch.Tensor, ws, bs, head,
                 noise, noise_bs: int, mask, mask_bs: int,
                 out: torch.Tensor) -> None:
    """Enqueue one action on the current stream; raises if CUDA refused
    it. ``x`` is (Bt, N, F), ``ws``/``bs`` the GCN layers' weights and
    biases, ``head`` (W1, b1, W2, b2), ``noise``/``mask`` None or rows of N
    ``*_bs`` apart, ``out`` (Bt, N); arguments must already be checked
    (``ops.gcn_actor``)."""
    lib = _lib()
    bt, n, f = x.shape
    L = len(ws)
    dims = [f] + [w.shape[1] for w in ws]
    w1, b1, w2, b2 = head
    _check(lib, lib.gcn_actor_launch(
        a_hat.data_ptr(), x.data_ptr(),
        (ctypes.c_void_p * L)(*[w.data_ptr() for w in ws]),
        (ctypes.c_void_p * L)(*[b.data_ptr() for b in bs]),
        (ctypes.c_int * (L + 1))(*dims), L, w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), w1.shape[1],
        None if noise is None else noise.data_ptr(), noise_bs,
        None if mask is None else mask.data_ptr(), mask_bs, out.data_ptr(),
        bt, n, torch.cuda.current_stream(x.device).cuda_stream), "gcn_actor")


def launch_bwd(a_hat: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
               out: torch.Tensor, dh: torch.Tensor, dx, dw: torch.Tensor,
               db: torch.Tensor, relu: bool) -> None:
    """Enqueue one layer's backward on the current stream; raises if CUDA
    refused it. ``x`` is (Bt, N, F), ``out`` and ``dh`` (Bt, N, H), ``dx``
    (Bt, N, F) or None (no gradient of x); arguments must already be
    checked (``ops.gcn_layer_bwd``). The partial sums' scratch is
    allocated here; the ticket counters are the device's (one launch at a
    time uses them: the port runs every update on one stream)."""
    lib = _lib()
    bt, n, f = x.shape
    h = w.shape[1]
    chunks = bwd_chunks(bt, n)
    part = torch.empty((chunks, f, h), dtype=torch.float32, device=x.device)
    part_db = torch.empty((chunks, h), dtype=torch.float32, device=x.device)
    _check(lib, lib.gcn_layer_bwd_launch(
        a_hat.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
        dh.data_ptr(), None if dx is None else dx.data_ptr(), dw.data_ptr(),
        db.data_ptr(), part.data_ptr(), part_db.data_ptr(),
        tickets(x.device, -(-f // BWD_FT)).data_ptr(), bt, n, f, h,
        int(relu), torch.cuda.current_stream(x.device).cuda_stream),
        "gcn_layer_bwd")
