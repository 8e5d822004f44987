"""Model FLOPs of the ssm family (Mamba-2), for ``model.mfu.*``: what a
served token needs.

Per token and layer: ``in_proj`` 2 d (2 d_in + 2 N + H), ``out_proj``
2 d_in d, the depthwise conv 2 W (d_in + 2 N), and the recurrence's state
update and read-out, 5 H P N (``counts/ssd_scan.py``); per row whose
logits are computed, the head, 2 d V. Attention pairs count nothing."""


def flops(cfg: dict, tokens: float, pairs: float, head_rows: float) -> float:
    d, V, L = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    d_in = cfg["ssm_expand"] * d
    P, N, W = cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_conv_width"]
    H = d_in // P
    per_token = (2.0 * d * (2 * d_in + 2 * N + H) + 2.0 * d_in * d
                 + 2.0 * W * (d_in + 2 * N) + 5.0 * H * P * N)
    return L * tokens * per_token + head_rows * 2.0 * d * V
