"""The port's distributed layer at world size 4 against the JAX package on
4 virtual CPU devices: every case of ``torch_dist_cases`` (with the
(batch x rows) = (2 x 2) mesh of ``tsqr_batched_sharded_2d`` and the
(rows x cols) = (2 x 2) mesh of ``dist_block_qr_2d``) on four
gloo ranks spawned once for the file, the guards and the NaN canary.
Tolerances in ``torch_dist_reference``; world size 2 and the checks that
need no spawn are in ``test_torch_dist.py``."""

import pytest

import torch_dist_cases as C
import torch_dist_reference as ref

WORLD = 4


@pytest.fixture(scope="module")
def per_rank(tmp_path_factory):
    return C.run_world(WORLD, str(tmp_path_factory.mktemp("dist4")))


@pytest.mark.parametrize("name", sorted(ref.cases(WORLD)))
def test_dist_parity_world4(per_rank, name):
    ref.check_parity(per_rank, name, WORLD)


@pytest.mark.parametrize("name", [g[0] for g in C.GUARD_SPECS])
def test_dist_guard_world4(per_rank, name):
    ref.check_guard(per_rank, name, WORLD)


def test_dist_nan_canary_world4(per_rank):
    ref.check_nan(per_rank, WORLD)
