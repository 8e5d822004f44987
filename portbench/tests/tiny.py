"""Tiny versions of the benchmark's cells for CPU tests: the cell's own
files, with the configuration cut to two layers of toy width, float32,
and the traffic cut to short prompts, a small rate and a short clock."""
import copy

from portbench import spec

DENSE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=512,
             attention_multiplier=0.25)
SSM = dict(num_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
           vocab_size=512, ssm_chunk=16)


def tiny_cell(root, name: str, limit: float = 0.01):
    cell = copy.deepcopy(spec.load_cell(root, name))
    cfg = cell.config
    cfg.update(DENSE if cfg["family"] == "dense" else SSM)
    cfg.update(dtype="float32", cache_dtype="float32",
               limits={"served_gap": limit})
    t = cell.traffic
    t["prompt"].update(median=12, min=4, max=40)
    t["output"] = {"dist": "uniform", "min": 8, "max": 16}
    t["engine"].update(max_seq=64, max_batch=4)
    t.update(rate=16.0, warmup_s=0.5, drain_cap_s=30.0, trace_s=0.5)
    return cell
