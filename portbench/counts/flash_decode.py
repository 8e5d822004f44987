"""Work of one ``flash_decode`` launch (one attention layer of a decode
step): what the rows that step need, each input byte read once and each
output byte written once.

A row at write position ``pos`` attends keys 0 .. pos: it reads pos + 1
positions of K and V (G heads x hd each) and its query (H x hd), and
writes H x hd; its products are 2 x (pos + 1) x H x hd multiply-adds
(scores and values). Rows that do not step in the launch need nothing."""


def work(kv_lens, cfg: dict, esize: int = 2) -> tuple:
    """(flops, bytes) of one launch over rows reading ``kv_lens``
    positions each; ``esize``: bytes a cache and query element."""
    H, G, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    n = sum(kv_lens)
    flops = 4.0 * n * H * hd
    nbytes = esize * (2.0 * n * G * hd + 2.0 * len(kv_lens) * H * hd)
    return flops, nbytes
