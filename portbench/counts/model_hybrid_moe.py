"""Model FLOPs of the hybrid_moe family (granitemoehybrid), for
``model.mfu.*``: the matrix products a served token needs.

Per token, on each Mamba-2 layer (``counts/model_ssm.py``'s terms):
``in_proj`` 2 d (2 d_in + 2 N + H), ``out_proj`` 2 d_in d, the conv
2 W (d_in + 2 N) and the recurrence 5 H P N; on each attention layer the
projections 2 d (H + 2 G) hd + 2 H hd d, and 4 H hd a query-key pair; on
every layer the expert FFN: the router over all E experts, 2 d E, the
routed experts in expectation, top-k x held / E of a SwiGLU of width ff
(6 d ff; the other experts' pairs lie on other cards), and the shared
expert's SwiGLU, 6 d F. Per row whose logits are computed, the head,
2 d V. A decode step computes every held expert over every row; these
are the model's FLOPs, not that step's."""


def flops(cfg: dict, tokens: float, pairs: float, head_rows: float) -> float:
    d, V = cfg["d_model"], cfg["vocab_size"]
    kinds = cfg["layer_types"]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attention")
    d_in = cfg["ssm_expand"] * d
    P, N, W = cfg["ssm_head_dim"], cfg["ssm_state"], cfg["ssm_conv_width"]
    Hs = d_in // P
    H, G, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    E, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    held = cfg.get("experts_held") or E
    mamba = (2.0 * d * (2 * d_in + 2 * N + Hs) + 2.0 * d_in * d
             + 2.0 * W * (d_in + 2 * N) + 5.0 * Hs * P * N)
    attn = 2.0 * d * (H + 2 * G) * hd + 2.0 * H * hd * d
    ffn = (2.0 * d * E + k * held / E * 6.0 * d * cfg["moe_d_ff"]
           + 6.0 * d * cfg["d_ff"])
    per_token = n_mamba * mamba + n_attn * attn + len(kinds) * ffn
    return (tokens * per_token + pairs * n_attn * 4.0 * H * hd
            + head_rows * 2.0 * d * V)
