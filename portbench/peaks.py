"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit): the roofline and
MFU denominators. Which peak a kernel is held to is its work's precision:
bf16 products at the bf16 tensor-core rate; ssd_scan's float32-accurate
products at the TF32 rate, the highest the card offers for them, so its
share cannot pass 100%."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
KERNEL_PEAK_FLOPS = {"flash_decode": BF16_FLOPS_PER_S,
                     "flash_attention": BF16_FLOPS_PER_S,
                     "ssd_scan": TF32_FLOPS_PER_S}
MODEL_PEAK_FLOPS = BF16_FLOPS_PER_S


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory's bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
