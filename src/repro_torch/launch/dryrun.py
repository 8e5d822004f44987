"""The multi-device dry-run of the port (``repro.launch.dryrun``'s twin):
trace one (arch x shape x mesh) cell on fake ranks, without the devices.

For each cell this shows, on no more than one process:
  * that the sharding is coherent: the params, the optimizer state and
    the inputs are placed as ``DTensor``s by the ``ShardPlan`` over the
    production mesh (16 x 16 single-pod, 2 x 16 x 16 multi-pod) and one
    train step, prefill or decode runs through them;
  * whether it fits: the bytes a device holds (``memory``);
  * the roofline inputs: the flops a device does and the collective bytes
    it moves.

The process plays rank 0 of a ``fake`` process group as large as the mesh
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), and every tensor is a ``FakeTensor`` on ``--device`` (shapes and
dtypes only, no memory). One dispatch mode below DTensor sees rank 0's
local ops: it counts their flops (``torch.utils.flop_counter``'s
formulas), their collectives (``sharding.comm_bytes``'s kinds and ring
factors) and the storages alive, whose peak is ``peak_hbm_bytes``. The
figures are the port's eager step's: it holds the old and the new params
and moments at the end of an update, where the reference's jitted step
donates them. ``trace_s`` is the cell's wall time (the reference reports a
lower and a compile time).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k \\
      --mesh single --out results/dryrun/cell.json
  python -m repro_torch.launch.dryrun --all --mesh both --jobs 4
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import weakref

import torch
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.tree import leaves
from repro_torch.distributed.sharding import (
    _TRAFFIC_FACTOR, _CommCounter, _nbytes, _zip_map, local_block,
    placements)


def _fake_group(world: int) -> None:
    """Rank 0 of a ``fake`` process group of ``world`` ranks (replacing
    any group this process had)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


class _Tally(_CommCounter):
    """The dispatch mode that counts rank 0's local work (see the module
    docstring). DTensor's sharding propagation runs each new op once on
    fake tensors of the global shape to learn the result's shape; that is
    not rank 0's work, and ``_paused_in_propagation`` stops the count
    meanwhile."""

    def __init__(self):
        super().__init__({k: 0.0 for k in _TRAFFIC_FACTOR})
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes = WeakIdKeyDictionary()
        self.paused = False

    def track(self, t) -> None:
        """Count ``t``'s storage as alive until it is freed."""
        t = getattr(t, "_local_tensor", t)
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st = t.untyped_storage()
        if st in self._sizes:
            return
        n = st.nbytes()
        self._sizes[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = super().__torch_dispatch__(func, types, args, kwargs)
        if res is NotImplemented or self.paused:
            return res
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **(kwargs or {}), out_val=res)
        outs = res if isinstance(res, (tuple, list)) else (res,)
        for t in outs:
            self.track(t)
        # operand and result bytes of every op: XLA's "bytes accessed"
        self.bytes += sum(_nbytes(t) for t in (*args, *outs)
                          if isinstance(t, torch.Tensor))
        return res


@contextlib.contextmanager
def _paused_in_propagation(tally):
    """``tally.paused`` while DTensor computes an op's result shape on
    global-shaped fake tensors (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)

    def paused(self, *args, **kwargs):
        before, tally.paused = tally.paused, True
        try:
            return orig(self, *args, **kwargs)
        finally:
            tally.paused = before

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _place_fake(mesh, tree, entries_tree, device):
    """Every leaf of ``tree`` (anything with a shape and dtype) as a
    DTensor whose local block is a new fake tensor of the block's shape on
    ``device``: the placed arguments of rank 0, and nothing more, exist."""
    from torch.distributed.tensor import DTensor

    coords = [0] * mesh.ndim

    def one(x, e):
        shape = [n for _, n in local_block(mesh, e, tuple(x.shape), coords)]
        local = torch.empty(shape, dtype=x.dtype, device=device)
        return DTensor.from_local(local, mesh, placements(mesh, e),
                                  run_check=False)
    return _zip_map(one, tree, entries_tree)


def _grad_accum_and_chunk(cfg, shape, mesh_shape, v_phys, opts) -> tuple:
    """The reference's microbatching (the per-device activation-checkpoint
    footprint L x local_tokens / ga x d_model x 2 B under ~2.5 GiB) and CE
    chunk (the (B_micro_local x chunk x V) f32 logits tile under ~0.5
    GiB)."""
    dp = (mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
          * mesh_shape.get("expert", 1))
    local_tokens = shape.global_batch // dp * shape.seq_len
    grad_accum = opts.get("grad_accum", 0)
    if not grad_accum:
        ckpt_budget = 2.5 * 2**30
        grad_accum = 1
        while (cfg.num_layers * (local_tokens // grad_accum) * cfg.d_model * 2
               > ckpt_budget
               and shape.global_batch % (grad_accum * 2) == 0
               and shape.global_batch // (grad_accum * 2) >= dp):
            grad_accum *= 2
    local_rows = max(shape.global_batch // dp // grad_accum, 1)
    loss_chunk = 2048
    while local_rows * loss_chunk * v_phys * 4 > 0.5 * 2**30 and \
            loss_chunk > 128:
        loss_chunk //= 2
    return grad_accum, loss_chunk


def _config(arch: str, opts: dict):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if opts.get("reduced"):
        cfg = cfg.reduced()
    if opts.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=int(opts["layers"]))
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str, opts: dict = None,
             device: str = "cuda") -> dict:
    """Trace one cell on fake ranks and report the reference's JSON keys.
    ``opts``: the CLI's ``expert_sharding``, ``remat``, ``grad_accum``,
    ``accum``, ``mesh_spec``; and the port's ``reduced`` (the config's
    ``reduced()``), ``layers`` (depth cut to that many layers),
    ``global_batch`` / ``seq_len`` (the shape's, overridden),
    ``param_dtype`` ("bf16", the reference's, or "f32") and
    ``loss_chunk`` (the CE chunk, pinned)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, applicable_shapes
    from repro_torch.device import resolve_device
    from repro_torch.distributed.sharding import (
        ShardPlan, _mesh_shape, batch_shardings, make_shard_fn,
        param_shardings, serve_state_shardings)
    from repro_torch.launch.mesh import make_production_mesh, \
        parse_mesh_spec
    from repro_torch.models.model import (make_decode_step, make_model,
                                          make_prefill_step, make_train_step)
    from repro_torch.models.optim import AdamW

    opts = dict(opts or {})
    t0 = time.time()
    dev = resolve_device(device)
    cfg = _config(arch, opts)
    shape = SHAPES[shape_name]
    if shape not in applicable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": True,
                "reason": "long_500k needs sub-quadratic decode"}
    if opts.get("global_batch") or opts.get("seq_len"):
        shape = dataclasses.replace(
            shape, global_batch=int(opts.get("global_batch")
                                    or shape.global_batch),
            seq_len=int(opts.get("seq_len") or shape.seq_len))
    dtype = torch.float32 if opts.get("param_dtype") == "f32" \
        else torch.bfloat16
    spec = opts.get("mesh_spec")
    if spec:
        n_dev = 1
        for s in spec.split(":")[0].split("x"):
            n_dev *= int(s)
    else:
        n_dev = 512 if mesh_kind == "multi" else 256
    _fake_group(n_dev)
    try:
        mesh = parse_mesh_spec(spec, device=dev.type, distributed=True) \
            if spec else make_production_mesh(
                multi_pod=(mesh_kind == "multi"), device=dev.type)
        mshape = _mesh_shape(mesh)
        tp = mshape.get("model", 1)
        mode = "train" if shape.kind == "train" else "serve"
        plan = ShardPlan(mesh, mode, opts.get("expert_sharding", "none"))
        shard_fn = make_shard_fn(plan)
        remat = opts.get("remat") or ("full" if mode == "train" else "none")
        model = make_model(cfg, tp=tp, remat=remat)
        grad_accum, loss_chunk = _grad_accum_and_chunk(
            cfg, shape, mshape, model.dims.vocab, opts)
        loss_chunk = int(opts.get("loss_chunk") or loss_chunk)
        tally = _Tally()
        with FakeTensorMode(allow_non_fake_inputs=True), \
                _paused_in_propagation(tally):
            whole = model.init(seed=0, dtype=dtype, device=dev)
            pent = param_shardings(plan, whole)
            specs = model.input_specs(shape, act_dtype=dtype)
            with tally:
                params = _place_fake(mesh, whole, pent, dev)
                del whole
                gc.collect()
                if shape.kind == "train":
                    big = cfg.param_count() > 1e11
                    opt = AdamW(lr=3e-4, moment_dtype=torch.bfloat16 if big
                                else torch.float32)
                    opt_state = opt.init(params)
                    batch = _place_fake(mesh, specs,
                                        batch_shardings(plan, specs), dev)
                    args = (params, opt_state, batch)
                    step = make_train_step(
                        model, opt, shard_fn, grad_accum=grad_accum,
                        loss_chunk=loss_chunk,
                        accum_dtype=torch.bfloat16
                        if opts.get("accum", "") == "bf16" else torch.float32)
                elif shape.kind == "prefill":
                    batch = _place_fake(mesh, specs,
                                        batch_shardings(plan, specs), dev)
                    args = (params, batch)
                    step = make_prefill_step(model, shape.seq_len, shard_fn,
                                             attn_backend="einsum")
                else:
                    state = _place_fake(
                        mesh, specs["state"],
                        serve_state_shardings(plan, specs["state"], cfg), dev)
                    rows = {k: specs[k] for k in ("tokens", "pos")}
                    rows = _place_fake(mesh, rows,
                                       batch_shardings(plan, rows), dev)
                    args = (params, state, rows["tokens"], rows["pos"])
                    step = make_decode_step(model, shard_fn,
                                            attn_backend="einsum")
                arg_bytes = tally.live
                for k in tally.out:
                    tally.out[k] = 0.0
                tally.flops = tally.bytes = 0
                tally.peak = tally.live
                with torch.no_grad() if shape.kind != "train" else \
                        torch.enable_grad():
                    out = step(*args)
                out_bytes = sum(
                    getattr(x, "_local_tensor", x).untyped_storage().nbytes()
                    for x in leaves(list(out)) if isinstance(x, torch.Tensor))
                del out, args
        coll = dict(tally.out, total=sum(tally.out.values()))
        trace_s = time.time() - t0
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "mode": mode, "ok": True,
            "n_devices": n_dev, "tp": tp,
            "trace_s": round(trace_s, 1),
            "flops_per_device": float(tally.flops),
            "bytes_per_device": float(tally.bytes),
            "memory": {
                "argument_bytes": int(arg_bytes),
                "output_bytes": int(out_bytes),
                "temp_bytes": int(tally.peak - arg_bytes - out_bytes),
                "alias_bytes": 0,
                "peak_hbm_bytes": int(tally.peak),
            },
            "collectives": coll,
            "model": {
                "params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
                "pad_flops_ratio": model.dims.pad_flops_ratio,
            },
            "shape_info": {"seq_len": shape.seq_len,
                           "global_batch": shape.global_batch,
                           "kind": shape.kind},
            "opts": dict(opts, grad_accum=grad_accum, remat=remat,
                         loss_chunk=loss_chunk, device=dev.type),
        }
    finally:
        import torch.distributed as dist
        from repro_torch.models import layers
        dist.destroy_process_group()
        # tables cached on the device in the fake mode are fake
        layers._rope_freqs_on.cache_clear()
        layers.sinusoidal_positions_on.cache_clear()
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
          f"(trace {trace_s:.0f}s, "
          f"peak/device {result['memory']['peak_hbm_bytes']/2**30:.2f} GiB, "
          f"flops/device {result['flops_per_device']:.3g})")
    print(f"[dryrun]   collectives: "
          f"{ {k: f'{v/2**20:.1f}MiB' for k, v in coll.items()} }")
    return result


def _cells(mesh_kind: str):
    from repro_torch.configs import ARCH_NAMES, applicable_shapes, get_config
    meshes = ["single", "multi"] if mesh_kind == "both" else [mesh_kind]
    for arch in ARCH_NAMES:
        for shape in applicable_shapes(get_config(arch)):
            for m in meshes:
                yield arch, shape.name, m


def orchestrate(args):
    """Run every cell in a subprocess pool; write one JSON per cell."""
    os.makedirs(args.outdir, exist_ok=True)
    cells = list(_cells(args.mesh))
    if args.filter:
        cells = [c for c in cells if args.filter in f"{c[0]}/{c[1]}/{c[2]}"]
    running = []
    idx = 0
    while idx < len(cells) or running:
        while idx < len(cells) and len(running) < args.jobs:
            arch, shape, mesh = cells[idx]
            out = os.path.join(args.outdir, f"{arch}__{shape}__{mesh}.json")
            idx += 1
            if args.resume and os.path.exists(out):
                print(f"[orchestrator] skip existing {out}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", out, "--device", args.device]
            if args.expert_sharding != "none":
                cmd += ["--expert-sharding", args.expert_sharding]
            if args.remat:
                cmd += ["--remat", args.remat]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            running.append((p, arch, shape, mesh, out, time.time()))
            print(f"[orchestrator] start {arch} x {shape} x {mesh} "
                  f"({idx}/{len(cells)})")
        time.sleep(2)
        still = []
        for (p, arch, shape, mesh, out, t0) in running:
            if p.poll() is None:
                if time.time() - t0 > args.timeout:
                    p.kill()
                    p.wait()
                    print(f"[orchestrator] TIMEOUT {arch} x {shape} x {mesh}")
                    with open(out, "w") as f:
                        json.dump({"arch": arch, "shape": shape,
                                   "mesh": mesh, "ok": False,
                                   "error": "timeout"}, f)
                else:
                    still.append((p, arch, shape, mesh, out, t0))
                continue
            tail = (p.stdout.read() or "")[-2000:]
            if p.returncode != 0 and not os.path.exists(out):
                print(f"[orchestrator] FAIL {arch} x {shape} x {mesh}:\n{tail}")
                with open(out, "w") as f:
                    json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                               "ok": False, "error": tail[-1000:]}, f)
            else:
                print(f"[orchestrator] done {arch} x {shape} x {mesh} "
                      f"({time.time()-t0:.0f}s)")
        running = still
    n_ok = n_skip = n_fail = 0
    for fn in os.listdir(args.outdir):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(args.outdir, fn)) as f:
            r = json.load(f)
        if r.get("ok"):
            n_ok += 1
        elif r.get("skipped"):
            n_skip += 1
        else:
            n_fail += 1
    print(f"[orchestrator] summary: {n_ok} ok, {n_skip} skipped, "
          f"{n_fail} failed")
    return n_fail


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--outdir", default="results/dryrun")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--filter", default="")
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--expert-sharding", default="none",
                    choices=["none", "data"])
    ap.add_argument("--remat", default="")
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--accum", default="", choices=["", "bf16"])
    ap.add_argument("--mesh-spec", default="",
                    help="e.g. 2x8x16:data,expert,model (overrides --mesh)")
    ap.add_argument("--device", default="cuda",
                    help="the kind of the fake tensors: cuda or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() (CPU tests)")
    args = ap.parse_args(argv)

    if args.all:
        sys.exit(1 if orchestrate(args) else 0)

    opts = {}
    if args.expert_sharding != "none":
        opts["expert_sharding"] = args.expert_sharding
    if args.remat:
        opts["remat"] = args.remat
    if args.grad_accum:
        opts["grad_accum"] = args.grad_accum
    if args.accum:
        opts["accum"] = args.accum
    if args.mesh_spec:
        opts["mesh_spec"] = args.mesh_spec
    if args.reduced:
        opts["reduced"] = True
    try:
        result = run_cell(args.arch, args.shape, args.mesh, opts,
                          device=args.device)
    except Exception as e:  # noqa: BLE001 -- recorded as a failed cell
        import traceback
        result = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                  "ok": False, "error": traceback.format_exc()[-2000:]}
        print(f"[dryrun] FAILED: {e}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    if not result.get("ok") and not result.get("skipped"):
        sys.exit(1)


if __name__ == "__main__":
    main()
