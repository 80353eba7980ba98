"""Published peaks of the cards the benchmark knows, keyed by
``torch.cuda.get_device_name()``: NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the card's full 700 W. A card not listed
gets no mfu and no roofline share."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}
