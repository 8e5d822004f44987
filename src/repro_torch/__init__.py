"""PyTorch/CUDA port of the serving system in ``repro`` (JAX).

The JAX package is the reference; module paths mirror it
(``repro/models/lm.py`` <-> ``repro_torch/models/lm.py``). This package imports
``torch`` and never ``jax`` or anything of ``repro``. Entry points take an
explicit ``device`` that defaults to ``"cuda"`` and raise when CUDA is asked
for and absent; the CPU runs only when the caller passes ``device="cpu"``.
"""
