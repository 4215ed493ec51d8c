"""The port exports the Householder and WY building blocks, the
Givens / recursive-least-squares functions and the distributed layer at
the top level, as the JAX package does, and a counterpart of every name
of the JAX package's ``__all__``."""

import pytest

import mixedprecisionblockqr_tpu_torch as port
from mixedprecisionblockqr_tpu_torch.models import lstsq
from mixedprecisionblockqr_tpu_torch.ops import givens, householder, wy

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


STREAMING = {
    **{name: givens for name in (
        "givens_qr", "qr_rank1_update", "qr_append_row", "qr_insert_col",
        "qr_delete_col", "qr_delete_row")},
    **{name: lstsq for name in ("RLSState", "rls_init", "rls_update",
                                "rls_solve")},
}


@pytest.mark.parametrize("name", sorted(STREAMING))
def test_streaming_name_is_exported(name):
    import mixedprecisionblockqr_tpu as reference

    assert name in reference.__all__
    assert name in port.__all__
    assert getattr(port, name) is getattr(STREAMING[name], name)


def test_port_exports_every_reference_name():
    import mixedprecisionblockqr_tpu as reference

    missing = sorted(set(reference.__all__) - set(port.__all__))
    assert not missing, missing


DISTRIBUTED = {
    "dist_block_qr": "dist_qr", "tsqr_sharded": "tsqr",
    "make_mesh": "mesh", "block_qr_batched_sharded": "batched",
    "tsqr_batched_sharded_2d": "batched",
}


@pytest.mark.parametrize("name", sorted(DISTRIBUTED))
def test_distributed_name_is_exported(name):
    from mixedprecisionblockqr_tpu_torch import parallel

    assert name in port.__all__
    module = getattr(parallel, DISTRIBUTED[name])
    assert getattr(port, name) is getattr(module, name)
