"""The port's training entry point, ``python -m repro_torch.launch.train``,
called in-process (``main(argv)``) on the CPU, as tests/test_train_e2e.py
runs the reference's: a short run's loss falls below 0.75 x its first on
the Markov corpus, and a checkpointed run followed by a longer one
resumes from its checkpoint. Without ``--device cpu`` and with no card,
the entry point raises.
"""
import json
import os

import pytest
import torch

from repro_torch.launch import train

SMOKE = ["--scale", "smoke", "--batch", "8", "--seq", "64", "--log-every",
         "20", "--arch", "granite-3-8b", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_loss_drops(tmp_path, capsys):
    res = tmp_path / "r.json"
    final, uni = train.main(SMOKE + ["--steps", "80", "--out", str(res)])
    r = json.loads(res.read_text())
    assert len(r["losses"]) == 80 and r["final"] == final
    assert r["unigram_entropy"] == uni
    # Markov corpus: the loss must fall well below the start
    assert r["final"] < 0.75 * r["losses"][0], (r["losses"][0], r["final"])
    out = capsys.readouterr().out
    assert "[train] arch=granite-3-8b-smoke" in out
    assert "[train] final loss" in out


def test_train_resume_from_checkpoint(tmp_path, capsys):
    ck = tmp_path / "ckpt"
    train.main(SMOKE + ["--steps", "30", "--ckpt-dir", str(ck),
                        "--ckpt-every", "20"])
    assert sorted(d for d in os.listdir(ck) if d.startswith("step_")) == \
        ["step_0000000020"]
    assert "resumed" not in capsys.readouterr().out
    train.main(SMOKE + ["--steps", "40", "--ckpt-dir", str(ck),
                        "--ckpt-every", "20"])
    out = capsys.readouterr().out
    assert "resumed from step 20" in out
    assert "[train] step    20 " in out and "[train] step     0 " not in out
    assert "step_0000000040" in os.listdir(ck)


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main([a for a in SMOKE if a not in ("--device", "cpu")]
                   + ["--steps", "1"])
