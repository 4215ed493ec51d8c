"""The port's distributed layer (``parallel/mesh.py``, ``tsqr_sharded``,
``parallel/batched.py``, ``parallel/dist_qr.py``) on the CPU over gloo.

World size 2: every case of ``torch_dist_cases`` on two ranks spawned
once for the file, held against the JAX package on 2 virtual CPU devices
(tolerances in ``torch_dist_reference``), the guards and the NaN canary.
World size 4 is ``test_torch_dist4.py``.  Without spawning: at world size
1 (an in-process gloo group) ``dist_block_qr`` equals the port's own
``block_qr`` of the same tier and ``tsqr_sharded`` its ``tsqr``, within
1e-5 relative Frobenius; ``make_mesh`` without CUDA and without
``device_type`` raises."""

import pytest
import torch
import torch.distributed as dist

import mixedprecisionblockqr_tpu_torch as pt
import torch_dist_cases as C
import torch_dist_reference as ref

WORLD = 2
REL_WORLD1 = 1e-5


@pytest.fixture(scope="module")
def per_rank(tmp_path_factory):
    return C.run_world(WORLD, str(tmp_path_factory.mktemp("dist2")))


@pytest.mark.parametrize("name", sorted(ref.cases(WORLD)))
def test_dist_parity_world2(per_rank, name):
    ref.check_parity(per_rank, name, WORLD)


@pytest.mark.parametrize("name", [g[0] for g in C.GUARD_SPECS])
def test_dist_guard_world2(per_rank, name):
    ref.check_guard(per_rank, name, WORLD)


def test_dist_nan_canary_world2(per_rank):
    ref.check_nan(per_rank, WORLD)


@pytest.fixture(scope="module")
def mesh1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield pt.make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _rel(x, y):
    return float(torch.linalg.norm(x - y) / torch.linalg.norm(y))


def _canonical(Q, R):
    """Rows of R (and columns of Q) with a nonnegative diagonal: the
    reflector tier's Yamamoto sign fix flips some of them against the
    compact-WY Householder driver."""
    D = torch.where(torch.diagonal(R) < 0, -1.0, 1.0)
    return Q * D[None, :], R * D[:, None]


@pytest.mark.parametrize("seed,shape,kw", [
    (60, (128, 64), {"panel_method": "householder"}),
    (61, (128, 64), {"panel_method": "bgs"}),
    (61, (128, 64), {"panel_method": "bgs1"}),
    (62, (128, 128), {"panel_method": "bgs2", "loop_mode": "scan",
                      "group_panels": 4}),
    (63, (128, 64), {"panel_method": "cholqr2"}),
])
def test_world1_equals_block_qr(mesh1, seed, shape, kw):
    a = torch.from_numpy(C.uniform(seed, shape, centered=True))
    Qd, Rd = pt.dist_block_qr(a, mesh1, 16, mode="reduced", **kw)
    Qs, Rs = pt.block_qr(a, 16, mode="reduced", **kw)
    if kw["panel_method"] == "householder":
        (Qd, Rd), (Qs, Rs) = _canonical(Qd, Rd), _canonical(Qs, Rs)
    assert _rel(Qd, Qs) <= REL_WORLD1 and _rel(Rd, Rs) <= REL_WORLD1


def test_world1_tsqr_sharded_equals_tsqr(mesh1):
    a = torch.from_numpy(C.uniform(64, (256, 16)))
    Qd, Rd = pt.tsqr_sharded(a, mesh1, local_leaves=4)
    Qs, Rs = pt.tsqr(a, n_leaves=4)
    assert _rel(Qd, Qs) <= REL_WORLD1 and _rel(Rd, Rs) <= REL_WORLD1


def test_world1_mesh_helpers(mesh1):
    from torch.distributed.tensor import Replicate, Shard

    from mixedprecisionblockqr_tpu_torch.parallel import mesh as tm

    x = torch.arange(12.0).reshape(4, 3)
    assert tm.row_sharding(mesh1) == (Shard(0),)
    assert tm.replicated(mesh1) == (Replicate(),)
    assert torch.equal(tm.shard_rows(x, mesh1), x)
    assert torch.equal(tm.gather_rows(x, mesh1), x)
    assert torch.equal(tm.gather_cols(x, mesh1), x)
    assert torch.equal(tm.psum(x.clone(), mesh1, tm.ROWS_AXIS), x)
    with pytest.raises(ValueError, match="mesh shape"):
        pt.make_mesh((2,), device_type="cpu")


def test_make_mesh_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        pt.make_mesh()

