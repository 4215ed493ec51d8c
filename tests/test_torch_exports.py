"""The port exports the Householder and WY building blocks at the top
level, as the JAX package does."""

import pytest

import mixedprecisionblockqr_tpu_torch as port
from mixedprecisionblockqr_tpu_torch.ops import householder, wy

NAMES = {
    "householder_reflector": householder,
    "q_backward_accumulation": householder,
    "build_t_matrix": wy,
    "wy_representation": wy,
    "apply_block_reflector_left_t": wy,
    "apply_block_reflector_right": wy,
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_building_block_is_exported(name):
    assert name in port.__all__
    assert getattr(port, name) is getattr(NAMES[name], name)
