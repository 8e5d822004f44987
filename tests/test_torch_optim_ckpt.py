"""The port's optimizer stack, checkpoints and training data against the
JAX reference, on the CPU.

``models.optim``: ``cosine_schedule`` and ``global_norm`` to 1e-6
relative; ``AdamW`` (f32 moments, and bf16 moments) and ``SGD`` (with and
without momentum) over three updates on identical inputs: params and
state to 1e-6 relative (bf16 moments to one bf16 step). ``bridge.
adamw_state_from_jax`` carries the reference's state across, and the next
update matches. ``checkpoint.manager``: the six behaviours of
tests/test_checkpoint.py (round trip, keep-k, a corrupt newest falls
back, an incomplete directory is skipped, an empty directory restores
nothing, optimizer state survives a resume), a bf16 round trip bit for
bit, the reference's on-disk layout (each package restores the other's
checkpoint of the same tree; a bf16 leaf is the reference's ``|V2``
bytes), its restore rule (the newest checkpoint with the leaf count,
as stored), the ``uint16`` bf16 leaves of earlier versions, and an
undecodable leaf skipped as corrupt. ``data.pipeline``: ``MarkovCorpus``
and ``DataLoader`` give the reference's tokens and unigram entropy.
``core.tree``: a train step leaves no tensor in a reference cycle, so a
step's gradient and old state go as soon as they are dropped, not at the
garbage collector's next full pass (on the card they once held up to 40
GB).
"""
import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.data import pipeline as jdata
from repro.models import optim as joptim
from repro_torch.bridge import adamw_state_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.checkpoint.manager import (list_checkpoints, restore_latest,
                                            save_checkpoint)
from repro_torch.core import tree
from repro_torch.data.pipeline import DataLoader, MarkovCorpus
from repro_torch.models.model import make_model, make_train_step
from repro_torch.models.optim import (SGD, AdamW, cosine_schedule,
                                      global_norm)

RTOL = 1e-6


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"w": f(8, 8), "nested": {"b": f(4), "c": f(3, 5)},
            "layers": [f(6), f(2, 3)]}


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _torch(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def _assert_close(got, want, rtol=RTOL, atol=1e-7):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w, g = w.astype(np.float32), g.float()
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol)


def test_cosine_schedule_matches_reference():
    ref, port = joptim.cosine_schedule(6e-4, 40, 300), \
        cosine_schedule(6e-4, 40, 300)
    for step in (0, 1, 20, 39, 40, 41, 100, 299, 300, 350):
        np.testing.assert_allclose(
            float(port(torch.tensor(step, dtype=torch.int32))),
            float(ref(jnp.int32(step))), rtol=RTOL)


def test_global_norm_matches_reference():
    t = _np_tree(0)
    np.testing.assert_allclose(float(global_norm(_torch(t))),
                               float(joptim.global_norm(_jax(t))), rtol=RTOL)


OPTIMIZERS = {
    "adamw": lambda m: (m.AdamW(lr=m.cosine_schedule(1e-2, 2, 10)),),
    "adamw_bf16": lambda m: (m.AdamW(
        lr=3e-3, moment_dtype=jnp.bfloat16 if m is joptim
        else torch.bfloat16),),
    "adamw_noclip": lambda m: (m.AdamW(lr=1e-2, clip_norm=0.0,
                                       weight_decay=0.0),),
    "sgd": lambda m: (m.SGD(lr=0.1),),
    "sgd_momentum": lambda m: (m.SGD(lr=0.1, momentum=0.9),),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    """Three updates on identical params and gradients (the gradients
    large enough that clipping engages on AdamW's first step)."""
    import repro_torch.models.optim as toptim
    (jopt,), (topt,) = OPTIMIZERS[name](joptim), OPTIMIZERS[name](toptim)
    params = _np_tree(0)
    jp, tp = _jax(params), _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = _np_tree(10 + i, scale=1.0 if i else 3.0)
        jp, js, jstats = jopt.update(_jax(g), js, jp)
        tp, ts, tstats = topt.update(_torch(g), ts, tp)
        _assert_close(tp, jp)
        for k in jstats:
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=RTOL)
    moments_rtol = 2 ** -8 if name == "adamw_bf16" else RTOL
    for k in ("mu", "nu", "vel"):
        if k in js:
            _assert_close(ts[k], js[k], rtol=moments_rtol)
            assert str(ts[k]["w"].dtype) == f"torch.{js[k]['w'].dtype}"
    if "step" in js:
        assert ts["step"].dtype == torch.int32
        assert int(ts["step"]) == int(js["step"]) == 3


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_state_from_jax_continues(moment_dtype):
    """The reference's params and AdamW state after two updates, bridged
    (a stacked ``layers`` tree splits per layer), update on as the
    reference's third update does."""
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"embed": f(16, 8), "final_norm": f(8),
              "layers": {"w": f(2, 8, 8), "n": f(2, 8)}}
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), params) for _ in range(3)]
    jopt = joptim.AdamW(lr=1e-2, moment_dtype=jnp.dtype(moment_dtype))
    topt = AdamW(lr=1e-2, moment_dtype=getattr(torch, moment_dtype))
    jp, js = _jax(params), jopt.init(_jax(params))
    for g in grads[:2]:
        jp, js, _ = jopt.update(_jax(g), js, jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = adamw_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    assert ts["mu"]["layers"][1]["w"].dtype == getattr(torch, moment_dtype)
    jp, js, _ = jopt.update(_jax(grads[2]), js, jp)
    tp, ts, _ = topt.update(params_from_jax(grads[2], "cpu"), ts, tp)
    want = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for a, b in zip(tree.leaves(tp), tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=1e-7)
    assert int(ts["step"]) == 3


# ------------------------------------------------------------- checkpoints
def _ckpt_tree(seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 8, generator=g) * scale,
            "nested": {"b": torch.randn(4, generator=g) * scale,
                       "step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    t = _ckpt_tree()
    save_checkpoint(str(tmp_path), 10, t)
    step, restored = restore_latest(str(tmp_path), t)
    assert step == 10
    for a, b in zip(tree.leaves(t), tree.leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_keep_k(tmp_path):
    t = _ckpt_tree()
    for s in range(6):
        save_checkpoint(str(tmp_path), s, t, keep=3)
    assert [s for s, _, _ in list_checkpoints(str(tmp_path))] == [3, 4, 5]


def test_corrupt_latest_falls_back(tmp_path):
    t = _ckpt_tree()
    save_checkpoint(str(tmp_path), 1, t)
    save_checkpoint(str(tmp_path), 2, _ckpt_tree(scale=2.0))
    with open(os.path.join(str(tmp_path), "step_0000000002", "leaves.npz"),
              "wb") as f:
        f.write(b"garbage")
    step, restored = restore_latest(str(tmp_path), t)
    assert step == 1
    assert torch.equal(restored["w"], t["w"])


def test_incomplete_dir_skipped(tmp_path):
    t = _ckpt_tree()
    save_checkpoint(str(tmp_path), 5, t)
    bad = os.path.join(str(tmp_path), "step_0000000009")
    os.makedirs(bad)
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        json.dump({"complete": False}, f)
    step, _ = restore_latest(str(tmp_path), t)
    assert step == 5


def test_restore_empty_dir(tmp_path):
    assert restore_latest(str(tmp_path), _ckpt_tree()) == (None, None)
    assert restore_latest(str(tmp_path / "missing"), _ckpt_tree()) == \
        (None, None)


def test_train_resume_continuity(tmp_path):
    """Optimizer state survives: the resumed Adam step equals the
    uninterrupted one."""
    opt = AdamW(lr=1e-2)
    p, s = {"w": torch.ones(4, 4)}, None
    s = opt.init(p)
    grads = {"w": torch.full((4, 4), 0.1)}
    for _ in range(2):
        p, s, _ = opt.update(grads, s, p)
    save_checkpoint(str(tmp_path), 2, {"params": p, "opt": s})
    p3, _, _ = opt.update(grads, s, p)
    _, restored = restore_latest(str(tmp_path), {"params": p, "opt": s})
    rp3, rs3, _ = opt.update(grads, restored["opt"], restored["params"])
    assert torch.equal(p3["w"], rp3["w"])
    assert int(rs3["step"]) == 3 and rs3["step"].dtype == torch.int32


def test_bf16_roundtrip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(1)
    t = {"p": torch.randn(5, 7, generator=g).to(torch.bfloat16),
         "mu": [torch.randn(3, generator=g).to(torch.bfloat16),
                torch.randn(2, 2, generator=g)]}
    save_checkpoint(str(tmp_path), 4, t)
    (_, _, man), = list_checkpoints(str(tmp_path))
    assert man["dtypes"] == ["bfloat16", "float32", "bfloat16"]
    with np.load(os.path.join(str(tmp_path), "step_0000000004",
                              "leaves.npz")) as data:
        assert data["leaf_2"].dtype == np.dtype("V2")
    _, restored = restore_latest(str(tmp_path), t)
    for a, b in zip(tree.leaves(t), tree.leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_layout_is_the_references(tmp_path):
    """A tree of one structure on both sides: each package restores the
    other's checkpoint. With a bf16 leaf: the port restores the
    reference's file bit for bit, and the reference does with the port's
    file what it does with its own (it cannot cast the ``|V2`` leaf, so it
    finds nothing to restore)."""
    t = _np_tree(5)
    save_checkpoint(str(tmp_path / "port"), 3, _torch(t))
    step, jt = jckpt.restore_latest(str(tmp_path / "port"), _jax(t))
    assert step == 3
    _assert_close(_torch(jax.tree.map(np.asarray, jt)), t, rtol=0, atol=0)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 6, _jax(t))
    step, tt = restore_latest(str(tmp_path / "ref"), _torch(t))
    assert step == 6
    _assert_close(tt, t, rtol=0, atol=0)

    jb, tb = _bf16_trees(t)
    jckpt.save_checkpoint(str(tmp_path / "ref_bf16"), 7, jb)
    step, got = restore_latest(str(tmp_path / "ref_bf16"), tb)
    assert step == 7
    _assert_bits_equal(got, jb)
    save_checkpoint(str(tmp_path / "port_bf16"), 8, tb)
    assert jckpt.restore_latest(str(tmp_path / "port_bf16"), jb) == \
        jckpt.restore_latest(str(tmp_path / "ref_bf16"), jb) == (None, None)


def _bf16_trees(t):
    """(the reference's, the port's) tree of ``t`` with its "w" in bf16."""
    jb = dict(_jax(t), w=jnp.asarray(t["w"]).astype(jnp.bfloat16))
    tb = dict(_torch(t), w=torch.from_numpy(t["w"]).to(torch.bfloat16))
    return jb, tb


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_bits_equal(got, want):
    gl, wl = tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_bf16_leaf_is_stored_as_the_reference_stores_it(tmp_path):
    """The same bf16 values saved by each package: the port's ``leaf_i``
    has the reference's dtype (``|V2``) and bytes, and its manifest has
    the reference's keys (plus ``dtypes``) with the same leaf count."""
    jb, tb = _bf16_trees(_np_tree(6))
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jb)
    save_checkpoint(str(tmp_path / "port"), 1, tb)
    (_, rpath, rman), = jckpt.list_checkpoints(str(tmp_path / "ref"))
    (_, ppath, pman), = list_checkpoints(str(tmp_path / "port"))
    with np.load(os.path.join(rpath, "leaves.npz")) as r, \
            np.load(os.path.join(ppath, "leaves.npz")) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            assert r[k].dtype == p[k].dtype and r[k].shape == p[k].shape
            assert r[k].tobytes() == p[k].tobytes(), k
        assert any(r[k].dtype == np.dtype("V2") for k in r.files)
    assert set(pman) == set(rman) | {"dtypes"}
    assert pman["n_leaves"] == rman["n_leaves"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_restore_takes_the_newest_as_stored(tmp_path, writer):
    """Step 1 holds a (2, 2) leaf and step 2 a (4, 4) one; restored into
    a (2, 2) tree, both packages give step 2 as stored, as the
    reference's rule has it (it checks the leaf count only)."""
    d = str(tmp_path)
    if writer == "port":
        save_checkpoint(d, 1, {"w": torch.zeros(2, 2)})
        save_checkpoint(d, 2, {"w": torch.ones(4, 4)})
    else:
        jckpt.save_checkpoint(d, 1, {"w": jnp.zeros((2, 2))})
        jckpt.save_checkpoint(d, 2, {"w": jnp.ones((4, 4))})
    step, got = restore_latest(d, {"w": torch.zeros(2, 2)})
    assert step == 2 and torch.equal(got["w"], torch.ones(4, 4))
    jstep, jgot = jckpt.restore_latest(d, {"w": jnp.zeros((2, 2))})
    assert jstep == 2 and np.array_equal(np.asarray(jgot["w"]),
                                         np.ones((4, 4), np.float32))


def test_uint16_checkpoint_of_earlier_versions_restores(tmp_path):
    """A checkpoint that the port wrote before it took the reference's
    ``|V2`` (a bf16 leaf as ``uint16``, marked ``bfloat16`` in
    ``dtypes``) restores bit for bit; a ``uint16`` leaf that ``dtypes``
    marks ``uint16`` stays numbers."""
    g = torch.Generator().manual_seed(2)
    p = torch.randn(3, 5, generator=g).to(torch.bfloat16)
    u = torch.arange(6, dtype=torch.int32)
    d = os.path.join(str(tmp_path), "step_0000000003")
    os.makedirs(d)
    np.savez(os.path.join(d, "leaves.npz"),
             leaf_0=p.view(torch.int16).numpy().view(np.uint16),
             leaf_1=np.arange(6, dtype=np.uint16))
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"step": 3, "n_leaves": 2,
                   "dtypes": ["bfloat16", "uint16"], "treedef": "",
                   "time": 0.0, "extra": {}, "complete": True}, f)
    step, got = restore_latest(str(tmp_path), {"p": p, "u": u})
    assert step == 3 and got["p"].dtype == torch.bfloat16
    assert torch.equal(got["p"].view(torch.int16), p.view(torch.int16))
    assert torch.equal(got["u"], u)


def test_undecodable_leaf_falls_back(tmp_path):
    """A newest checkpoint whose leaf no tensor can hold (a ``|V4``
    array) counts as corrupt: the older one is restored, and nothing
    raises."""
    t = _ckpt_tree()
    save_checkpoint(str(tmp_path), 1, t)
    save_checkpoint(str(tmp_path), 2, _ckpt_tree(scale=2.0))
    path = os.path.join(str(tmp_path), "step_0000000002", "leaves.npz")
    with np.load(path) as data:
        arrays = dict(data)
    arrays["leaf_2"] = arrays["leaf_2"].view("V4")
    np.savez(path, **arrays)
    step, got = restore_latest(str(tmp_path), t)
    assert step == 1 and torch.equal(got["w"], t["w"])


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seed", [(512, 0), (8000, 3)])
def test_markov_corpus_and_loader_match_reference(vocab, seed):
    jc, tc = jdata.MarkovCorpus(vocab, seed=seed), MarkovCorpus(vocab,
                                                                seed=seed)
    np.testing.assert_array_equal(tc.successors, jc.successors)
    np.testing.assert_array_equal(tc.probs, jc.probs)
    jl = jdata.DataLoader(jc, 8, 64, seed=seed)
    tl = DataLoader(tc, 8, 64, seed=seed)
    for _ in range(3):
        jb, tb = next(jl), next(tl)
        for k in ("tokens", "targets"):
            assert tb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])
    assert tc.unigram_entropy() == jc.unigram_entropy()


# -------------------------------------------------------------------- tree
def test_train_step_leaves_no_reference_cycle():
    """With the collector off, a step's inputs die when dropped: nothing
    in ``value_and_grad``, ``unflatten`` or the update holds them in a
    cycle."""
    m = make_model(get_config("granite-3-8b").reduced())
    params = m.init(seed=0, device="cpu")
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    batch = {"tokens": torch.randint(0, 512, (2, 16), dtype=torch.int32)}
    step = make_train_step(m, opt, grad_accum=2)
    gc.collect()
    gc.disable()
    try:
        refs = [weakref.ref(t) for t in tree.leaves([params, state])]
        params, state, _ = step(params, state, batch)
        grads = tree.value_and_grad(lambda p: m.loss(p, batch)[0],
                                    params)[1]
        refs += [weakref.ref(t) for t in tree.leaves(grads)]
        del grads
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
