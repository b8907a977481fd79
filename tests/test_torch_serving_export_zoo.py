"""The int8 serving program of the nine zoo architectures (CPU): for each,
`export_serving` at 64^2, batch 2, is bit-equal to the eager
`QuantizedModel` on the same weights and input, and its graph holds one
`coastline_torch::int8_conv` node per int8 conv of the forward. Tolerance:
none (the program runs the eager forward's ops; see
`test_torch_serving_export.py`).
"""

import pytest
import torch

from test_torch_serving_export import exported_matches_eager

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["waternet", "mswnet", "hrnet_water", "pspnet", "deeplabv3p",
                                  "yoloseg", "fastscnn", "enet", "segformer_lite"])
def test_exported_forward_equals_eager(arch):
    exported_matches_eager(arch, 64)
