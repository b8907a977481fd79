"""Fused global average + max pooling (counterpart of `coastline/pallas/pools.py`).

Replaces the TPU kernel `coastline/pallas/pools.py:56` `fused_avg_max_pool`,
which computes the same function as `coastline/pallas/cbam.py:141`
`avg_max_pool`. Both run `kernels.cbam.run_avg_max_pool`: one launch of one
CUDA kernel, `csrc/avg_max_pool.cu` (a thread block cluster per image and
channel chunk, folded in distributed shared memory; its design and bound
are in the source and `kernels/cbam.py`), at the same geometry, so the two
give the same bits. This name is the one `ChannelAttention` calls at eval
(`coastline/ops/blocks.py:103-108`), and it keeps its own launch count.
In a row split (the mesh's `space` axis) it launches the kernel's partials
mode and returns the whole image's mean and max (`kernels/cbam.py`).
"""

from coastline_torch.kernels.cbam import run_avg_max_pool


def fused_avg_max_pool(x):
    """(B, H, W, C) float32 or bfloat16 -> (avg (B, C), max (B, C)) in x.dtype,
    one read of x. A CUDA tensor launches the kernel (or raises); a CPU
    tensor runs `avg_max_pool_plain`."""
    return run_avg_max_pool(x, fused_avg_max_pool)


fused_avg_max_pool.launches = 0
