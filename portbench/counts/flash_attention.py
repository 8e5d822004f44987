"""Work of one ``flash_attention`` launch (one attention layer of a
prefill): what its real prompt rows need, each input byte read once and
each output byte written once.

A causal row of L tokens reads Q (L x H x hd), K and V (L x G x hd each)
and writes L x H x hd; its query-key pairs are L (L + 1) / 2, each 2 x
hd multiply-adds (score and value) a head. Pad rows and pad positions of
the bucket are not needed and count nothing."""


def work(lengths, cfg: dict, esize: int = 2) -> tuple:
    """(flops, bytes) of one launch over rows of ``lengths`` real tokens."""
    H, G, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    pairs = sum(L * (L + 1) / 2 for L in lengths)
    toks = sum(lengths)
    flops = 4.0 * pairs * H * hd
    nbytes = esize * toks * hd * (2.0 * H + 2.0 * G)
    return flops, nbytes
