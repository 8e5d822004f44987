"""The Mamba-2 decode step: its kernel's wrapper (``ops.ssd_decode``) and
plain version (``ref.ssd_decode_ref``), without JAX. (tests/test_torch_ssd.py
holds the plain step to the reference's ``mamba2_decode``.)

On the CPU: a masked step, with a subset of rows or the fleet's
fixed-length write buffer padded with wrapped duplicates, equals the
unmasked step on its rows and keeps the others bit for bit, at mamba2-1.3b's
heads (H 64, P 64, N 128) and zamba2-2.7b's (H 80, N 64). The wrapper's
CUDA branch runs here on CPU tensors with the device test answering CUDA
and the launch replaced by the plain version (``fake_card``): its checks,
its count and the model's backends.

On the card (marker ``chip``, skipped without one) the kernel is held to
the plain version at rag's shapes (B 128 and 256), zamba2's, the reduced
configs' (P 32, N 16) and two uneven ones (N 10, not a multiple of 4; P 40,
N 48), every row written and a padded write buffer, eager and inside a
captured CUDA graph: the written state bit for bit, rows outside ``write``
unchanged, y within 1e-4 (the repo's ssd tolerance). On a machine with a
card and no JAX, run ``pytest -q --noconftest -m chip`` on this file with
``PYTHONPATH=src`` (``--noconftest`` skips tests/conftest.py, which imports
JAX).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_decode as ssd_step
from repro_torch.models import ssd
from repro_torch.models.model import make_model

TOL = dict(atol=1e-4, rtol=1e-4)
HEADS = {"mamba2-1.3b": (64, 64, 128), "zamba2-2.7b": (80, 64, 64)}
# (H, P, N) the kernel takes besides: the reduced ssm and hybrid configs',
# N not a multiple of 4 (a float a load) and P short of a block's rows
SHAPES = {**HEADS, "reduced": (8, 32, 16), "n10": (3, 24, 10),
          "p40-n48": (5, 40, 48)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WRITES = ["all", "subset", "padded"]


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip")
    return torch.device("cuda")


def _inputs(B, H, P, N, dtype, seed, G=1, device="cpu"):
    """A state ~ N(0, 1), dt in [1e-3, 1e-1] (softplus's range in the
    model), A in [-16, -1] (mamba2's init); x, B and C ~ N(0, 1) in
    ``dtype``, laid out as the model's decode lays them: views of one
    (B, H P + 2 G N) buffer."""
    g = torch.Generator().manual_seed(seed)
    state = torch.randn(B, H, P, N, generator=g)
    xbc = torch.randn(B, H * P + 2 * G * N, generator=g).to(dtype)
    dt = torch.empty(B, H).uniform_(math.log(1e-3), math.log(1e-1),
                                    generator=g).exp()
    A = -torch.empty(H).uniform_(1.0, 16.0, generator=g)
    state, xbc, dt, A = (t.to(device) for t in (state, xbc, dt, A))
    x = xbc[:, :H * P].reshape(B, H, P)
    Bm = xbc[:, H * P:H * P + G * N].reshape(B, G, N)
    Cm = xbc[:, H * P + G * N:].reshape(B, G, N)
    return state, x, dt, A, Bm, Cm


def _write(kind, B, device="cpu"):
    """None (every row), every odd row, or those rows repeated to B
    entries, as the fleet fills its fixed-length write buffer."""
    if kind == "all":
        return None
    rows = np.arange(1, B, 2)
    if kind == "padded":
        rows = np.resize(rows, B)
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _unwritten(rows, B):
    return sorted(set(range(B)) - set(rows.tolist()))


# ------------------------------------------------------------ the CPU
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("write", ["subset", "padded"])
@pytest.mark.parametrize("arch", list(HEADS))
def test_plain_step_writes_only_its_rows(arch, write, dtype):
    """A masked step, through ``ops.ssd_decode`` on CPU tensors (the plain
    version) and both backends of the model's step, gives the unmasked
    step's y, its state on the rows of ``write`` (duplicates and all) and
    the old state bit for bit on every other row."""
    H, P, N = HEADS[arch]
    B = 4
    state, x, dt, A, Bm, Cm = _inputs(B, H, P, N, DTYPES[dtype], seed=N)
    rows = _write(write, B)
    stepped = state.clone()
    y_want = ref.ssd_decode_ref(stepped, x, dt, A, Bm, Cm)
    keep = _unwritten(rows, B)
    want = stepped.clone()
    want[keep] = state[keep]
    before = dict(ops.LAUNCHES)
    got = state.clone()
    y = ops.ssd_decode(got, x, dt, A, Bm, Cm, write=rows)
    assert torch.equal(got, want) and torch.equal(y, y_want)
    for backend in ("pallas", "einsum"):
        got = state.clone()
        y, same = ssd.ssd_decode_step(got, x, dt, A, Bm, Cm, rows,
                                      backend=backend)
        assert same is got
        assert torch.equal(got, want) and torch.equal(y, y_want), backend
    assert ops.LAUNCHES == before                  # no kernel on the CPU
    assert not torch.equal(got[rows.long()], state[rows.long()])


def test_plain_step_takes_groups():
    """The plain version repeats each B/C group over its heads: two groups
    step as the same B/C given to every head (a group a head)."""
    state, x, dt, A, Bm, Cm = _inputs(2, 8, 16, 8, torch.float32, seed=3,
                                      G=2)
    want = state.clone()
    y_want = ref.ssd_decode_ref(want, x, dt, A, Bm, Cm)
    y = ref.ssd_decode_ref(state, x, dt, A, Bm.repeat_interleave(4, dim=1),
                           Cm.repeat_interleave(4, dim=1))
    assert torch.equal(state, want) and torch.equal(y, y_want)


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: the device test answers
    CUDA and the launch runs the plain version into the kernel's output.
    Yields the list of the launches' ``write`` arguments."""
    launched = []

    def launch(state, x, dt, A, Bm, Cm, y, write=None, mask=None):
        assert (mask is None) == (write is None)
        assert mask is None or (mask.dtype == torch.uint8
                                and mask.shape == (state.shape[0],))
        launched.append(write)
        y.copy_(ref.ssd_decode_ref(state, x, dt, A, Bm, Cm, write))

    saved = dict(ops.LAUNCHES)
    monkeypatch.setattr(ops, "_on_cuda", lambda name, *tensors: True)
    monkeypatch.setattr(ssd_step, "launch", launch)
    yield launched
    ops.LAUNCHES.update(saved)


@pytest.mark.parametrize("write", WRITES)
@pytest.mark.parametrize("arch", list(SHAPES))
def test_wrapper_checks_then_launches(fake_card, arch, write):
    H, P, N = SHAPES[arch]
    state, x, dt, A, Bm, Cm = _inputs(3, H, P, N, torch.bfloat16, seed=7)
    rows = _write(write, 3)
    want = state.clone()
    y_want = ref.ssd_decode_ref(want, x, dt, A, Bm, Cm, rows)
    ops.reset_launches()
    y = ops.ssd_decode(state, x, dt, A, Bm, Cm, write=rows)
    assert ops.LAUNCHES["ssd_decode"] == 1 and len(fake_card) == 1
    assert fake_card[0] is rows
    assert torch.equal(state, want) and torch.equal(y, y_want)


def _bad(case):
    """Arguments the kernel does not take, one fault each."""
    state, x, dt, A, Bm, Cm = _inputs(2, 4, 64, 128, torch.bfloat16, seed=1)
    write = None
    if case == "state_dtype":
        state = state.double()
    elif case == "x_dtype":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif case == "bc_dtype":
        Bm = Bm.float()
    elif case == "dt_dtype":
        dt = dt.double()
    elif case == "x_shape":
        x = x[:, :3]
    elif case == "dt_shape":
        dt = dt[:1]
    elif case == "head_dim":
        state, x, dt, A, Bm, Cm = _inputs(2, 4, 80, 128, torch.bfloat16, 1)
    elif case == "state_dim":
        state, x, dt, A, Bm, Cm = _inputs(2, 4, 64, 256, torch.bfloat16, 1)
    elif case == "groups":
        state, x, dt, A, Bm, Cm = _inputs(2, 4, 64, 128, torch.bfloat16, 1,
                                          G=2)
    elif case == "state_stride":
        state = state.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "x_stride":
        x = torch.cat([x, x], dim=-1)[..., ::2]
    elif case == "write_dtype":
        write = torch.tensor([1], dtype=torch.int64)
    return (state, x, dt, A, Bm, Cm), write


BAD = ["state_dtype", "x_dtype", "bc_dtype", "dt_dtype", "x_shape",
       "dt_shape", "head_dim", "state_dim", "groups", "state_stride",
       "x_stride", "write_dtype"]


@pytest.mark.parametrize("case", BAD)
def test_wrapper_refuses_what_the_kernel_does_not_take(fake_card, case):
    args, write = _bad(case)
    with pytest.raises((TypeError, ValueError, NotImplementedError),
                       match="ssd_decode"):
        ops.ssd_decode(*args, write=write)
    assert not fake_card


def _unaligned(state):
    """A copy of ``state`` that starts 4 bytes past a 16-byte boundary (the
    kernel then loads a float at a time)."""
    out = torch.empty(state.numel() + 1, device=state.device)[1:]
    return out.view(state.shape).copy_(state)


@pytest.mark.parametrize("arch", list(HEADS))
def test_wrapper_takes_unaligned_states(fake_card, arch):
    H, P, N = HEADS[arch]
    state, x, dt, A, Bm, Cm = _inputs(2, H, P, N, torch.bfloat16, seed=4)
    state = _unaligned(state)
    assert state.data_ptr() % 16
    want = state.clone()
    y_want = ref.ssd_decode_ref(want, x, dt, A, Bm, Cm)
    y = ops.ssd_decode(state, x, dt, A, Bm, Cm)
    assert len(fake_card) == 1
    assert torch.equal(state, want) and torch.equal(y, y_want)


def test_wrapper_refuses_grad_and_other_devices():
    state, x, dt, A, Bm, Cm = _inputs(2, 4, 64, 128, torch.float32, seed=2)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_decode(state, x.clone().requires_grad_(), dt, A, Bm, Cm)
    meta = [torch.empty(t.shape, device="meta")
            for t in (state, x, dt, A, Bm, Cm)]
    with pytest.raises(ValueError, match="device"):
        ops.ssd_decode(*meta)


def _small_mamba2():
    """mamba2-1.3b reduced: 4 layers of 8 heads, P 32, N 16."""
    cfg = get_config("mamba2-1.3b").reduced()
    model = make_model(cfg)
    return cfg, model, model.init(seed=0, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_backends_launch_once_a_layer_or_never(fake_card, masked):
    """The model's decode counts one ``ssd_decode`` a mamba layer on
    ``"pallas"`` and none on ``"einsum"``, with the same logits and state
    bit for bit; a masked decode hands its write rows to every launch."""
    cfg, model, params = _small_mamba2()
    B = 4
    state = model.init_serve_state(B, 16, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in state.values():
        t.normal_(generator=gen)
    tok = torch.tensor([[3], [9], [27], [81]], dtype=torch.int32)
    pos = torch.tensor([5, 0, 7, 15], dtype=torch.int32)
    rows = torch.tensor([1, 2, 1, 2], dtype=torch.int32) if masked else None
    out = {}
    for backend in ("pallas", "einsum"):
        st = {k: t.clone() for k, t in state.items()}
        ops.reset_launches()
        logits, _ = model.decode(params, st, tok, pos, attn_backend=backend,
                                 write_rows=rows)
        out[backend] = (logits, st, ops.LAUNCHES["ssd_decode"])
    assert out["pallas"][2] == cfg.num_layers and out["einsum"][2] == 0
    assert len(fake_card) == cfg.num_layers
    assert all(w is rows for w in fake_card)
    assert torch.equal(out["pallas"][0], out["einsum"][0])
    for k in state:
        assert torch.equal(out["pallas"][1][k], out["einsum"][1][k]), k


def test_reset_launches_clears_ssd_decode():
    saved = dict(ops.LAUNCHES)
    try:
        assert "ssd_decode" in ops.LAUNCHES
        ops.LAUNCHES["ssd_decode"] = 5
        ops.reset_launches()
        assert ops.LAUNCHES["ssd_decode"] == 0
    finally:
        ops.LAUNCHES.update(saved)


def test_unknown_backend_raises():
    state, x, dt, A, Bm, Cm = _inputs(1, 2, 8, 4, torch.float32, seed=0)
    with pytest.raises(ValueError, match="backend"):
        ssd.ssd_decode_step(state, x, dt, A, Bm, Cm, backend="triton")


# ----------------------------------------------------------- the card
def _captured(fn):
    """``fn`` captured in a CUDA graph (which runs nothing) and replayed
    once."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    return out


@pytest.mark.chip
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("write", ["all", "padded"])
@pytest.mark.parametrize("arch", list(SHAPES))
@pytest.mark.parametrize("B", [128, 256])
def test_kernel_matches_plain_on_card(card, B, arch, write, graph, dtype):
    H, P, N = SHAPES[arch]
    state, x, dt, A, Bm, Cm = _inputs(B, H, P, N, DTYPES[dtype],
                                      seed=B + N, device=card)
    rows = _write(write, B, card)
    want = state.clone()
    y_want = ref.ssd_decode_ref(want, x, dt, A, Bm, Cm, rows)
    # load the library outside any capture
    ops.ssd_decode(state.clone(), x, dt, A, Bm, Cm, write=rows)
    got = state.clone()
    before = ops.LAUNCHES["ssd_decode"]
    step = lambda: ops.ssd_decode(got, x, dt, A, Bm, Cm, write=rows)
    y = _captured(step) if graph else step()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_decode"] == before + 1
    assert torch.equal(got, want), \
        f"{(got != want).sum().item()} state values differ"
    torch.testing.assert_close(y, y_want, **TOL)
    if rows is not None:
        keep = _unwritten(rows.cpu(), B)
        assert torch.equal(got[keep], state[keep])


@pytest.mark.chip
@pytest.mark.parametrize("write", ["all", "padded"])
@pytest.mark.parametrize("arch", list(SHAPES))
def test_kernel_takes_unaligned_states_on_card(card, arch, write):
    """A state 4 bytes past a 16-byte boundary (a float a load) steps as
    the plain version does, bit for bit."""
    H, P, N = SHAPES[arch]
    B = 64
    state, x, dt, A, Bm, Cm = _inputs(B, H, P, N, torch.bfloat16, seed=6,
                                      device=card)
    state = _unaligned(state)
    rows = _write(write, B, card)
    want = state.clone()
    y_want = ref.ssd_decode_ref(want, x, dt, A, Bm, Cm, rows)
    y = ops.ssd_decode(state, x, dt, A, Bm, Cm, write=rows)
    torch.cuda.synchronize()
    assert torch.equal(state, want), \
        f"{(state != want).sum().item()} state values differ"
    torch.testing.assert_close(y, y_want, **TOL)


@pytest.mark.chip
@pytest.mark.parametrize("arch", list(SHAPES))
def test_kernel_steps_head_blocks_on_card(card, arch):
    """Two head blocks of one state (views with the whole state's row
    stride, as a head-split fleet slab holds them), each stepped by its own
    launch, give the whole step's state bit for bit."""
    H, P, N = SHAPES[arch]
    B, half = 96, H // 2
    state, x, dt, A, Bm, Cm = _inputs(B, H, P, N, torch.bfloat16, seed=5,
                                      device=card)
    rows = _write("padded", B, card)
    want = state.clone()
    y_want = ref.ssd_decode_ref(want, x, dt, A, Bm, Cm, rows)
    ys = [ops.ssd_decode(state[:, s], x[:, s], dt[:, s],
                         A[s].contiguous(), Bm, Cm, write=rows)
          for s in (slice(0, half), slice(half, H))]
    torch.cuda.synchronize()
    assert torch.equal(state, want)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_want, **TOL)
