"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, in this process, with no extra devices: the reference's
``ShardPlan``, ``param_pspec``, ``make_shard_fn``, ``batch_shardings`` and
``serve_state_shardings`` read only a mesh's ``shape`` and ``axis_names``,
so one stub mesh serves both packages (the reference's ``NamedSharding``
and ``with_sharding_constraint`` are stubbed to hand back the spec).

For every param leaf of every reduced arch (``jax.eval_shape`` of the
reference's init at tp 2), on the meshes (4, 2) ``data,model``, (2, 2, 2)
``data,expert,model`` and (2, 4, 2) ``pod,data,model``, in train and
serve mode, with ``expert_sharding`` none and data, the port's entries
equal the reference's ``PartitionSpec`` entries; on the port's own tree
(one dict a layer, ``bridge.params_from_jax``) each leaf's entries are the
reference's stacked leaf's without its leading layer dims. The same for
the activation tags, the batch specs and ``serve_state_shardings``.

One subprocess pair holds the placements themselves: each of 8 gloo ranks
places ``arange`` tensors by ``sharding.placements`` on the (4, 2) and
(2, 2, 2) meshes and reports its block's offset and shape, which must be
the slice ``NamedSharding.devices_indices_map`` gives the same device in
the reference's run with 8 host devices. ``collective_bytes`` equals the
reference's on tests/test_distributed.py's HLO text (and an all-to-all);
entries whose axes come out of the mesh's order, or that split two dims
over one axis, raise; a ``DeviceMesh`` without a process group raises.
"""
import json
import os
import subprocess
import sys
import textwrap
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.distributed.sharding as jsh
from repro.configs import get_config as jax_get_config
from repro.models.model import make_model as jax_make_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import parse_mesh_spec

SRC = Path(__file__).resolve().parent.parent / "src"
MESHES = {"4x2": (("data", 4), ("model", 2)),
          "2x2x2": (("data", 2), ("expert", 2), ("model", 2)),
          "2x4x2": (("pod", 2), ("data", 4), ("model", 2))}
PLANS = [(mode, es) for mode in ("train", "serve") for es in ("none", "data")]


class _Mesh:
    """A mesh as the rules read it: axis names and sizes, no devices."""

    def __init__(self, axes):
        self.shape = OrderedDict(axes)
        self.axis_names = tuple(self.shape)


class _Spec:
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


@pytest.fixture
def ref_rules(monkeypatch):
    """The reference's rules with NamedSharding and the sharding
    constraint handing back the PartitionSpec."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    return jsh


def _plans(mesh_key, mode, es):
    m = _Mesh(MESHES[mesh_key])
    return jsh.ShardPlan(m, mode, es), tsh.ShardPlan(m, mode, es)


_TREES = {}


def _ref_tree(arch):
    """The reference's reduced param shapes at tp 2, cached."""
    if arch not in _TREES:
        m = jax_make_model(jax_get_config(arch).reduced(), tp=2)
        _TREES[arch] = jax.eval_shape(lambda k: m.init(k, jnp.float32),
                                      jax.random.PRNGKey(0))
    return _TREES[arch]


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_entries_match_reference(ref_rules, arch, mesh_key):
    tree = _ref_tree(arch)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    # each reference leaf filled with its index, bridged into the port's
    # tree: a port leaf's first element names its reference leaf
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [np.full(s.shape, i, np.float32) for i, (_, s) in enumerate(flat)])
    port_tree = params_from_jax(tagged, "cpu")
    checked = 0
    for mode, es in PLANS:
        jplan, tplan = _plans(mesh_key, mode, es)
        want = [tuple(ref_rules.param_pspec(jplan, path, leaf))
                for path, leaf in flat]
        got = [tsh.param_pspec(tplan, path, leaf) for path, leaf in flat]
        assert got == want, (mode, es)
        port = tsh.param_shardings(tplan, port_tree)

        def walk(t, e):
            nonlocal checked
            if isinstance(t, dict):
                for k in t:
                    walk(t[k], e[k])
            elif isinstance(t, list):
                for v, ev in zip(t, e):
                    walk(v, ev)
            else:
                ref = want[int(t.reshape(-1)[0])]
                lead = len(flat[int(t.reshape(-1)[0])][1].shape) - t.dim()
                assert e == ref[lead:] if ref else e == (), (e, ref)
                checked += 1
        walk(port_tree, port)
    assert checked >= 4 * len(flat)


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_activation_tags_batch_and_serve_state_match_reference(ref_rules,
                                                               mesh_key):
    shapes = [(8, 16, 64), (3, 16, 64), (8, 16, 512), (8, 16, 4, 2, 32),
              (8, 16, 2, 32), (3, 16, 3, 32), (4, 8, 6, 64), (4, 3, 6, 64),
              (8, 16)]
    tags = ["act_btd", "logits", "qkv", "kv", "moe_buf", "unknown"]
    for mode, es in PLANS:
        jplan, tplan = _plans(mesh_key, mode, es)
        jfn = ref_rules.make_shard_fn(jplan)
        for tag in tags:
            for shape in shapes:
                x = _Spec(shape)
                ref = jfn(x, tag)
                got = tsh.activation_entries(tplan, tag, shape)
                assert got == (None if ref is x else tuple(ref)), \
                    (mode, es, tag, shape)
        for B in (8, 3):
            specs = {"tokens": _Spec((B, 32)),
                     "patch_embeds": _Spec((B, 16, 64))}
            ref = ref_rules.batch_shardings(jplan, specs)
            got = tsh.batch_shardings(tplan, specs)
            assert {k: tuple(v) for k, v in ref.items()} == got
        for arch in ("granite-3-8b", "mamba2-1.3b", "zamba2-2.7b",
                     "whisper-base", "internvl2-2b"):
            jc = jax_get_config(arch).reduced()
            m = jax_make_model(jc, tp=2)
            for B in (8, 3):
                st = jax.eval_shape(lambda: m.init_serve_state(B, 32))
                ref = ref_rules.serve_state_shardings(jplan, st, jc)
                got = tsh.serve_state_shardings(
                    tplan, {k: _Spec(v.shape) for k, v in st.items()},
                    get_config(arch).reduced())
                assert {k: tuple(v) for k, v in ref.items()} == got, arch


def test_plan_properties_match_reference():
    for key in MESHES:
        for mode, es in PLANS:
            jplan, tplan = _plans(key, mode, es)
            for name in ("dp_axes", "ep_axis", "expert_inner_axes",
                         "tp_axis", "fsdp", "tp_size"):
                assert getattr(tplan, name) == getattr(jplan, name), name


def test_collective_bytes_matches_reference():
    hlo = textwrap.dedent("""
      %ag = bf16[16,1024]{1,0} all-gather(bf16[2,1024]{1,0} %x), dims={0}
      %ar.1 = f32[512]{0} all-reduce(f32[512]{0} %y), to_apply=%add
      %rs = f32[64,8]{1,0} reduce-scatter(f32[512,8]{1,0} %z), dims={0}
      %cp = u32[4]{0} collective-permute(u32[4]{0} %w)
      %fusion.all-reduce-like = f32[9]{0} fusion(f32[9]{0} %v)
      %ard = (f32[8]{0}, f32[8]{0}) all-reduce-start(f32[8]{0} %q)
      %a2a = s8[4,4]{1,0} all-to-all(s8[4,4]{1,0} %r), dimensions={0}
    """)
    assert tsh.collective_bytes(hlo) == jsh.collective_bytes(hlo)
    assert tsh.collective_bytes(hlo)["all-reduce"] == 512 * 4 * 2 + 128


def test_entries_out_of_mesh_order_raise():
    from torch.distributed.tensor import Replicate, Shard

    m = _Mesh(MESHES["2x4x2"])
    assert tsh.placements(m, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert tsh.placements(m, (None, "data")) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        tsh.placements(m, (("data", "pod"), None))
    with pytest.raises(ValueError, match="two dims"):
        tsh.placements(m, ("data", "data"))


def test_device_mesh_needs_a_process_group():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already up in this worker")
    with pytest.raises(RuntimeError, match="process group"):
        parse_mesh_spec("2x2:data,model", device="cpu", distributed=True)


# (mesh, global shape, entries): the layouts the rules give -- FSDP + TP
# weights, an expert stack under EP, a batch over every data axis
CASES = [
    ("4x2", (8, 6, 4), ("data", "model", None)),
    ("4x2", (6, 8), ("model", "data")),
    ("4x2", (16, 4), (("data", "model"), None)),
    ("4x2", (4, 10, 2), (None, None, "model")),
    ("2x2x2", (4, 8, 6), ("expert", "data", "model")),
    ("2x2x2", (8, 3, 4, 2), (("data", "expert"), None, "model", None)),
    ("2x2x2", (6, 16), (None, ("data", "expert", "model"))),
]

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
out = []
for key, shape, entries in cases:
    dims = [int(x) for x in key.split("x")]
    names = {"4x2": ("data", "model"),
             "2x2x2": ("data", "expert", "model")}[key]
    mesh = Mesh(np.array(jax.devices()).reshape(dims), names)
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in entries])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out.append({str(d.id): [[s.start or 0, (s.stop or n) - (s.start or 0)]
                            for s, n in zip(idx, shape)]
                for d, idx in m.items()})
print(json.dumps(out))
"""

_GLOO_SCRIPT = r"""
import json, os, sys
import torch, torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, cases, port, path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=8)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import placements
    meshes = {"4x2": init_device_mesh("cpu", (4, 2),
                                      mesh_dim_names=("data", "model")),
              "2x2x2": init_device_mesh("cpu", (2, 2, 2),
                                        mesh_dim_names=("data", "expert",
                                                        "model"))}
    out = []
    for key, shape, entries in cases:
        ent = [tuple(e) if isinstance(e, list) else e for e in entries]
        n = 1
        for s in shape:
            n *= s
        whole = torch.arange(n, dtype=torch.float64).reshape(shape)
        x = distribute_tensor(whole, meshes[key], placements(meshes[key], ent))
        loc = x.to_local()
        # the block's first element is its offset's row-major index
        flat = int(loc.reshape(-1)[0].item())
        off, rest = [], flat
        for s in reversed(shape):
            off.append(rest % s)
            rest //= s
        off = off[::-1]
        out.append([[o, int(m)] for o, m in zip(off, loc.shape)])
    with open(f"{path}.{rank}", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()

if __name__ == "__main__":
    cases = json.loads(sys.argv[1])
    mp.spawn(run, args=(cases, int(sys.argv[2]), sys.argv[3]), nprocs=8)
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_rank_blocks_equal_devices_indices_map(tmp_path):
    cases = json.dumps(CASES)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    (tmp_path / "port_blocks.py").write_text(_GLOO_SCRIPT)
    (tmp_path / "ref_blocks.py").write_text(_JAX_SCRIPT)
    out = str(tmp_path / "blocks")
    gloo = subprocess.Popen([sys.executable, str(tmp_path / "port_blocks.py"),
                             cases, str(_free_port()), out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    ref = subprocess.run([sys.executable, str(tmp_path / "ref_blocks.py"), cases],
                         env=env, capture_output=True, text=True, timeout=300)
    _, err = gloo.communicate(timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert gloo.returncode == 0, err[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    for rank in range(8):
        got = json.loads(Path(f"{out}.{rank}").read_text())
        for i, case in enumerate(CASES):
            assert got[i] == want[i][str(rank)], (rank, case)
