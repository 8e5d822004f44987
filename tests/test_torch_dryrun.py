"""The port's dry-run (``python -m repro_torch.launch.dryrun``) on the CPU,
each cell in its own process (the ``fake`` process group is
process-global), all at once: granite-3-8b ``train_4k`` on
``--mesh-spec 4x2:data,model``, mamba2-1.3b ``decode_32k`` on the same
mesh, and the CLI's ``--mesh single`` (the 256-rank production mesh), at
the reduced configs on fake CPU tensors; beside them the reference's
dry-run of the decode cell (8 host devices, the reference's config
reduced).

  * every cell writes the reference's JSON keys (``lower_s`` and
    ``compile_s`` become the port's ``trace_s``);
  * ``memory.argument_bytes`` is the sum, over leaves, of the local block
    sizes that the reference's ``param_pspec`` (and its batch and
    serve-state rules) give rank 0: params, ``mu`` and ``nu`` (f32 at this
    size), the step counter and the batch; for decode the params, the serve
    state and the new tokens and positions (the port's decode takes one
    position a row, the reference's one scalar);
  * ``flops_per_device`` is within 10% of the cell's matmul flops
    reckoned from its shapes: the dense train step's 4 x (the forward's
    2 x params-in-matmuls + the attention's 4 x S x hd x heads) a token
    (``remat="full"`` recomputes the forward: forward, recompute and a
    backward of twice the forward), split over the data and model axes;
    the decode's 2 x the matmul weights each token meets. The reference's
    ``cost_analysis`` is not the yardstick: XLA counts a ``scan`` body once,
    not once a trip (its layers, the attention's query chunks and the CE's
    chunks are scans), so its count for this train cell is 1.37e12 against
    the reckoned 2.58e12.

``SHAPES``, ``applicable_shapes`` and ``ARCH_NAMES`` equal the
reference's for every arch.
"""
import json
import os
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.distributed.sharding as jsh
from repro.configs import get_config as jax_get_config
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import ARCH_NAMES, SHAPES, applicable_shapes
from repro_torch.configs import get_config

SRC = Path(__file__).resolve().parent.parent / "src"
MESH = OrderedDict([("data", 4), ("model", 2)])
CELLS = {
    "train": ["--arch", "granite-3-8b", "--shape", "train_4k",
              "--mesh-spec", "4x2:data,model"],
    "decode": ["--arch", "mamba2-1.3b", "--shape", "decode_32k",
               "--mesh-spec", "4x2:data,model"],
    "single": ["--arch", "granite-3-8b", "--shape", "train_4k",
               "--mesh", "single"],
}
REF_KEYS = {"arch", "shape", "mesh", "mode", "ok", "n_devices", "tp",
            "lower_s", "compile_s", "flops_per_device", "bytes_per_device",
            "memory", "collectives", "model", "shape_info", "opts"}

_REF_CELL = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import repro.configs as C
from repro.configs import base
full = base.get_config
C.get_config = lambda name: full(name).reduced()
import repro.launch.dryrun as D
print(json.dumps(D.run_cell(sys.argv[1], sys.argv[2], "single",
                            {"mesh_spec": sys.argv[3]})))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Every cell's JSON (the port's by name, the reference's as "ref")."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = {}
    for name, argv in CELLS.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
             "cpu", "--reduced", "--out", str(tmp / f"{name}.json")] + argv,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    (tmp / "ref.py").write_text(_REF_CELL)
    procs["ref"] = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), "mamba2-1.3b", "decode_32k",
         "4x2:data,model"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, p in procs.items():
        text, _ = p.communicate(timeout=600)
        assert p.returncode == 0, text[-3000:]
        out[name] = json.loads(text.strip().splitlines()[-1]) \
            if name == "ref" else json.loads(
                (tmp / f"{name}.json").read_text())
    return out


def _local_bytes(shape, entries, itemsize) -> int:
    n = 1
    for dim, size in enumerate(shape):
        e = entries[dim] if dim < len(entries) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n *= size // int(np.prod([MESH[a] for a in axes]))
    return n * itemsize


class _Mesh:
    shape = MESH
    axis_names = tuple(MESH)


@pytest.fixture
def ref_rules(monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    return jsh


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_writes_the_references_keys(cells, name):
    res = cells[name]
    assert res["ok"] is True
    assert set(res) == (REF_KEYS - {"lower_s", "compile_s"}) | {"trace_s"}
    assert set(res) - {"trace_s"} == set(cells["ref"]) - {"lower_s",
                                                           "compile_s"}
    for part in ("memory", "collectives", "model", "shape_info"):
        assert set(res[part]) == set(cells["ref"][part]), part
    assert res["n_devices"] == (256 if name == "single" else 8)


def test_train_argument_bytes_are_the_reference_rules_blocks(cells,
                                                             ref_rules):
    c = jax_get_config("granite-3-8b").reduced()
    m = jax_make_model(c, tp=2)
    params = jax.eval_shape(lambda k: m.init(k, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    plan = ref_rules.ShardPlan(_Mesh(), "train")
    want = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = tuple(ref_rules.param_pspec(plan, path, leaf))
        want += _local_bytes(leaf.shape, spec, leaf.dtype.itemsize)
        want += 2 * _local_bytes(leaf.shape, spec, 4)       # mu, nu in f32
    want += 4                                               # step, int32
    tokens = _Spec((256, 4096))
    bspec = tuple(ref_rules.batch_shardings(plan, {"t": tokens})["t"])
    want += _local_bytes(tokens.shape, bspec, 4)
    assert cells["train"]["memory"]["argument_bytes"] == want


class _Spec:
    def __init__(self, shape):
        self.shape = tuple(shape)


def test_decode_argument_bytes_are_the_reference_rules_blocks(cells,
                                                              ref_rules):
    c = jax_get_config("mamba2-1.3b").reduced()
    m = jax_make_model(c, tp=2)
    params = jax.eval_shape(lambda k: m.init(k, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    plan = ref_rules.ShardPlan(_Mesh(), "serve")
    want = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = tuple(ref_rules.param_pspec(plan, path, leaf))
        want += _local_bytes(leaf.shape, spec, leaf.dtype.itemsize)
    state = jax.eval_shape(lambda: m.init_serve_state(128, 32768))
    for k, spec in ref_rules.serve_state_shardings(plan, state, c).items():
        want += _local_bytes(state[k].shape, tuple(spec),
                             state[k].dtype.itemsize)
    rows = tuple(ref_rules.batch_shardings(
        plan, {"t": _Spec((128, 1))})["t"])
    want += 2 * _local_bytes((128, 1), rows, 4)     # tokens, one pos a row
    assert cells["decode"]["memory"]["argument_bytes"] == want


def test_flops_are_the_cells_reckoned_matmul_flops(cells):
    c = jax_get_config("granite-3-8b").reduced()
    hd = c.resolved_head_dim
    d, ff, V, L = c.d_model, c.d_ff, c.vocab_size, c.num_layers
    nq, nkv = c.num_heads, c.num_kv_heads
    S, tokens = 4096, 256 * 4096 // MESH["data"]
    per_layer = 2 * d * hd * (2 * nq + 2 * nkv) + 2 * 3 * d * ff \
        + 4 * S * hd * nq
    fwd = (L * per_layer + 2 * d * V) / MESH["model"]
    train = 4 * fwd * tokens
    got = cells["train"]["flops_per_device"]
    assert abs(got - train) / train < 0.10, (got, train)

    c = jax_get_config("mamba2-1.3b").reduced()
    d_in = 2 * c.d_inner + 2 * c.ssm_groups * c.ssm_state + c.ssm_heads
    per_tok = c.num_layers * (2 * c.d_model * d_in
                              + 2 * c.d_inner * c.d_model / MESH["model"]
                              + 2 * c.ssm_heads * c.ssm_head_dim
                              * c.ssm_state / MESH["model"]) \
        + 2 * c.d_model * c.vocab_size / MESH["model"]
    decode = per_tok * 128 // MESH["data"]
    got = cells["decode"]["flops_per_device"]
    assert abs(got - decode) / decode < 0.10, (got, decode)
    # the collectives of the train step are counted, by kind
    coll = cells["train"]["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0


def test_shapes_and_arch_names_match_reference():
    from repro.configs import ARCH_NAMES as JAX_NAMES
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import applicable_shapes as jax_applicable

    assert ARCH_NAMES == JAX_NAMES
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in JAX_SHAPES.items()}
    for arch in ARCH_NAMES:
        assert [s.name for s in applicable_shapes(get_config(arch))] == \
            [s.name for s in jax_applicable(jax_get_config(arch))], arch
