"""The plain references against the port's own forward at a tiny size on
the CPU, on the weights the benchmark makes: the same equations give the
same logits (float32; the port's paths differ only in the order of their
sums)."""
import pytest
import torch

from portbench import harness, spec
from portbench.tests.tiny import DENSE, SSM


@pytest.mark.parametrize("cell,tiny", [("granite-3-8b.chat", DENSE),
                                       ("mamba2-1.3b.rag", SSM)])
def test_reference_matches_the_port(root, cell, tiny):
    from repro_torch.models.model import make_model

    c = spec.load_cell(root, cell)
    cfg = dict(c.config, **tiny)
    ref = c.reference()
    w = ref.make_weights(cfg, 2**31 + 9, torch.device("cpu"), torch.float32)
    model = make_model(harness.arch_config(cfg))
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(1, cfg["vocab_size"], (2, 40), generator=gen)
    with torch.no_grad():
        port, _ = model.forward(w, {"tokens": toks})
    mine = ref.logits(w, cfg, [t.tolist() for t in toks], [0, 0])
    for p, m in zip(port, mine):
        scale = m.abs().max()
        assert (p - m).abs().max() / scale < 1e-4
    # the served path: a bucketed prefill, then decode through the cache
    # (the kernels' plain versions on the CPU), against the reference
    with torch.no_grad():
        lg, state, pos = model.prefill(w, {"tokens": toks[:, :32]},
                                       cache_len=64,
                                       cache_dtype=torch.float32)
        steps = [lg]
        for j in range(32, 40):
            lg, state = model.decode(w, state, toks[:, j:j + 1], pos)
            pos = pos + 1
            steps.append(lg)
    served = torch.stack(steps, dim=1)                     # (2, 9, V)
    mine = ref.logits(w, cfg, [t.tolist() for t in toks], [31, 31])
    for p, m in zip(served, mine):
        assert (p - m[:9]).abs().max() / m.abs().max() < 1e-4


def test_fp8_control_departs(root):
    c = spec.load_cell(root, "granite-3-8b.chat")
    cfg = dict(c.config, **DENSE)
    ref = c.reference()
    w = ref.make_weights(cfg, 4, torch.device("cpu"), torch.float32)
    seq = list(range(3, 43))
    exact = ref.logits(w, cfg, [seq], [0])[0]
    low = ref.logits(w, cfg, [seq], [0], quant="fp8")[0]
    rel = ((exact - low).abs().max() / exact.abs().max()).item()
    assert 1e-3 < rel < 0.5
