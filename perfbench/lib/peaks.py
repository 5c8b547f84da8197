"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A roofline share
or an ``mfu`` divides by these; the card's power limit is printed beside
every run."""

FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,     # outside the tensor cores
    "fp8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate of ``precision`` and bytes over the HBM bandwidth."""
    return max(flops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)
