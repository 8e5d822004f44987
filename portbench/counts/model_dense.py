"""Model FLOPs of the dense family, for ``model.mfu.*``: the matrix
products a served token needs.

Per token and layer: the q, k, v and output projections, 2 d (H + 2 G) hd
+ 2 H hd d, and the SwiGLU MLP, 3 x 2 d F; per query-key pair and layer,
4 H hd (scores and values); per row whose logits are computed, the head,
2 d V. A prefill row of L tokens is L tokens, L (L + 1) / 2 pairs and
one head row (the program computes the logits of its last token only); a
decode row at write position pos is one token, pos + 1 pairs and one
head row."""


def flops(cfg: dict, tokens: float, pairs: float, head_rows: float) -> float:
    d, H, G = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd, F, V, L = cfg["head_dim"], cfg["d_ff"], cfg["vocab_size"], \
        cfg["num_layers"]
    per_token = 2.0 * d * (H + 2 * G) * hd + 2.0 * H * hd * d + 6.0 * d * F
    return (L * (tokens * per_token + pairs * 4.0 * H * hd)
            + head_rows * 2.0 * d * V)
