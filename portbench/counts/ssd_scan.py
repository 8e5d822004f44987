"""Work of one ``ssd_scan`` launch (one Mamba-2 layer of a prefill): what
its real prompt rows need, each input byte read once and each output byte
written once, all float32.

A row of L tokens reads x (L x H x P), the log decays (L x H), B and C
(L x N each, one group) and writes y (L x H x P) and its final state
(H x P x N). The recurrence's products: a state update (decay and outer
product, 3 P N a head a token) and its read-out (2 P N), so 5 x L x H x P
x N flops. Pad positions (dt = 0) need nothing."""


def work(lengths, cfg: dict, esize: int = 4) -> tuple:
    d_in = cfg["ssm_expand"] * cfg["d_model"]
    P, N = cfg["ssm_head_dim"], cfg["ssm_state"]
    H = d_in // P
    toks = sum(lengths)
    flops = 5.0 * toks * H * P * N
    nbytes = esize * (toks * (2.0 * H * P + H + 2.0 * N)
                      + len(lengths) * H * P * N)
    return flops, nbytes
