"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
that limit runs slower under load: every run prints the card's limit."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "bfloat16": 989e12,  # tensor cores
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # CUDA cores: cuBLAS's float32 products with TF32 off
}
# The hand-written kernels' fp32 route runs each product as three TF32
# passes on the tensor cores: a third of TF32's rate is the
# most that route can reach, so its roofline cannot pass 100%.
KERNEL_OPS_PER_S = dict(OPS_PER_S, float32=495e12 / 3)
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_seconds(moved_bytes: float, ops: float, dtype: str) -> float:
    """The least time a hand-written kernel could take: the larger of
    bytes over the memory's bandwidth and operations over its route's
    peak rate."""
    return max(moved_bytes / HBM_BYTES_PER_S, ops / KERNEL_OPS_PER_S[dtype])
