"""The whole step's share of the bf16 peak over the traced slice
(``reduce.mfu``), in %, in the docrag cell (granite-4.0-h-small's
hybrid_moe FLOPs from ``counts/model_hybrid_moe.py``)."""
from portbench import reduce


def read(ctx):
    return reduce.mfu(ctx)
