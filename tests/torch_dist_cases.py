"""The distributed cases of ``tests/test_torch_dist*.py``: inputs, the
port's SPMD calls and the worker that every spawned rank runs.

This module imports torch and the port only, never JAX: the ranks that
``torch.multiprocessing.spawn`` starts import it, and the JAX reference
runs in the pytest process alone.  Each case names its inputs (numpy,
from a seed), its keyword arguments and, for each output, how the ranks'
slabs make the global array: a tuple of ``(dim, axis)`` splits, ``()``
for a value every rank holds whole.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

ROWS = ((0, "rows"),)
COLS = ((1, "rows"),)
BLOCK2D = ((0, "rows"), (1, "cols"))
REP = ()
BATCH = ((0, "batch"),)
BATCH_ROWS = ((0, "batch"), (1, "rows"))


def uniform(seed, shape, centered=False):
    a = np.random.default_rng(seed).random(shape).astype(np.float32)
    return a - 0.5 if centered else a


def _dist(seed, shape, centered=False, b_seed=None, **kw):
    return {"kind": "dist", "a": (seed, shape, centered), "b_seed": b_seed,
            "kw": kw}


#: dist_block_qr cases, after tests/test_distributed.py (fp32 unless the
#: policy says otherwise).  Block sizes divide every rank's rows at d = 2
#: and d = 4; reduced Q's columns divide over d.
DIST_CASES = {
    "refl_b16_complete": _dist(0, (128, 64), block_size=16,
                               mode="complete"),
    "refl_b32_reduced": _dist(1, (256, 64), block_size=32, mode="reduced"),
    "refl_mixed_complete": _dist(2, (128, 64), block_size=16,
                                 policy="mixed", mode="complete"),
    "refl_r_b": _dist(3, (256, 96), b_seed=103, block_size=32, mode="r"),
    "refl_square_scan": _dist(21, (128, 128), block_size=16,
                              mode="complete", loop_mode="scan"),
    "cholqr2_complete": _dist(5, (128, 64), block_size=16, mode="complete",
                              panel_method="cholqr2"),
    "cholqr2s_scan": _dist(7, (128, 64), block_size=16, mode="complete",
                           panel_method="cholqr2s", loop_mode="scan"),
    "bgs_reduced": _dist(10, (128, 64), True, block_size=16,
                         mode="reduced", panel_method="bgs"),
    "bgs1_reduced": _dist(10, (128, 64), True, block_size=16,
                          mode="reduced", panel_method="bgs1"),
    "bgs2_reduced": _dist(10, (128, 64), True, block_size=16,
                          mode="reduced", panel_method="bgs2"),
    "bgs_complete_square": _dist(11, (64, 64), True, block_size=16,
                                 mode="complete", panel_method="bgs"),
    "bgs_r_b": _dist(12, (128, 64), True, b_seed=112, block_size=16,
                     mode="r", panel_method="bgs"),
    "bgs_scan": _dist(16, (128, 64), True, block_size=16, mode="reduced",
                      panel_method="bgs", loop_mode="scan"),
    "bgs1_scan_g2": _dist(14, (128, 64), True, block_size=16,
                          mode="reduced", panel_method="bgs1",
                          loop_mode="scan", group_panels=2),
    "bgs2_scan_g4": _dist(18, (128, 128), True, block_size=16,
                          mode="reduced", panel_method="bgs2",
                          loop_mode="scan", group_panels=4),
    "bgs1_mixed": _dist(13, (128, 64), True, block_size=16,
                        policy="mixed", mode="reduced",
                        panel_method="bgs1"),
    "quality_fast": _dist(33, (128, 128), block_size=16, mode="reduced",
                          quality="fast", loop_mode="scan",
                          group_panels=4),
    "quality_balanced": _dist(33, (128, 128), block_size=16,
                              mode="reduced", quality="balanced",
                              loop_mode="scan", group_panels=4),
    "quality_robust": _dist(34, (128, 64), block_size=16, mode="complete",
                            quality="robust"),
}


def _dist2d(seed, shape, centered=False, b_seed=None, **kw):
    return {"kind": "dist2d", "a": (seed, shape, centered), "b_seed": b_seed,
            "kw": kw}


#: dist_block_qr_2d cases, after the 2-D tests of
#: tests/test_distributed.py cut to 128 x 64 at block 16; each runs on
#: every 2-D mesh of its world (``dist2d_meshes``).
DIST2D_CASES = {
    "refl_r_b": _dist2d(11, (128, 64), b_seed=111, block_size=16),
    "cholqr2_r": _dist2d(12, (128, 64), block_size=16,
                         panel_method="cholqr2"),
    "refl_complete": _dist2d(13, (128, 64), block_size=16,
                             mode="complete"),
    "scan_cholqr2_b": _dist2d(14, (128, 64), b_seed=114, block_size=16,
                              panel_method="cholqr2", loop_mode="scan"),
    "scan_complete": _dist2d(15, (128, 64), block_size=16,
                             mode="complete", loop_mode="scan"),
    "bgs_reduced": _dist2d(40, (128, 64), True, block_size=16,
                           panel_method="bgs", mode="reduced"),
    "bgs2_reduced": _dist2d(40, (128, 64), True, block_size=16,
                            panel_method="bgs2", mode="reduced"),
    "bgs1_reduced": _dist2d(40, (128, 64), True, block_size=16,
                            panel_method="bgs1", mode="reduced"),
    "bgs_mixed_b": _dist2d(41, (128, 64), True, b_seed=141, block_size=16,
                           policy="mixed", panel_method="bgs",
                           mode="reduced"),
}


def dist2d_meshes(world):
    """The (rows, cols) mesh shapes the 2-D cases run on at ``world``."""
    return {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2)]}[world]


def dist2d_cases(world):
    """Every 2-D case on every mesh of ``world``, named
    ``2d_<case>_<dr>x<dc>``."""
    out = {}
    for dr, dc in dist2d_meshes(world):
        for name, case in DIST2D_CASES.items():
            out[f"2d_{name}_{dr}x{dc}"] = dict(
                case, mesh=((dr, dc), ("rows", "cols")))
    return out


#: The other SPMD entry points.  ``mesh`` is the mesh's (shape, names)
#: as a function of the world size d.
OTHER_CASES = {
    "tsqr_sharded_l1": {"kind": "tsqr", "a": (40, (256, 16), True),
                        "kw": {"local_leaves": 1}},
    "tsqr_sharded_l2": {"kind": "tsqr", "a": (41, (256, 16), True),
                        "kw": {"local_leaves": 2}},
    "batched_sharded": {"kind": "batched", "a": (7, (8, 96, 48), False),
                        "kw": {"block_size": 16}},
}
#: Only at d = 4: the (2, 2) mesh.
TSQR_2D_CASE = {"kind": "tsqr2d", "a": (8, (4, 256, 16), False), "kw": {}}


def all_cases(world):
    """Every case the ranks of a ``world``-rank group run (world 1: the 2-D
    cases on the (1, 1) mesh only)."""
    if world == 1:
        return dist2d_cases(1)
    out = dict(DIST_CASES, **OTHER_CASES)
    if world == 4:
        out["tsqr_2d"] = TSQR_2D_CASE
    out.update(dist2d_cases(world))
    return out


def outputs_of(case):
    """``(names, splits)`` of a case's outputs, in the order its call
    returns them."""
    kind = case["kind"]
    if kind == "tsqr":
        return ("Q", "R"), (ROWS, REP)
    if kind == "batched":
        return ("Q", "R"), (BATCH, BATCH)
    if kind == "tsqr2d":
        return ("Q", "R"), (BATCH_ROWS, BATCH)
    kw = case["kw"]
    with_b = case.get("b_seed") is not None
    if kind == "dist2d":
        mode = kw.get("mode", "r")
        if kw.get("panel_method", "householder").startswith("bgs"):
            names, splits = ("R",), (REP,)
            if mode != "r":
                names, splits = ("Q",) + names, (BLOCK2D,) + splits
        elif mode == "complete":
            names, splits = ("Qt", "R"), (BLOCK2D, REP)
        else:
            names, splits = ("R",), (REP,)
        if with_b:
            names, splits = names + ("QtB",), splits + (REP,)
        return names, splits
    mode = kw.get("mode", "reduced")
    method = kw.get("panel_method", "householder")
    if kw.get("quality") is not None:
        method = {"fast": "bgs1", "balanced": "bgs2",
                  "high": "bgs"}.get(kw["quality"], "householder")
    if mode == "r":
        return (("R", "QtB"), (REP, REP)) if with_b else (("R",), (REP,))
    q_split = ROWS if method.startswith("bgs") else COLS
    names, splits = ("Q", "R"), (q_split, REP)
    if with_b:
        names, splits = names + ("QtB",), splits + (REP,)
    return names, splits


def inputs_of(case):
    """The numpy inputs of a case: ``(a, b or None)``."""
    a = uniform(*case["a"])
    b = None
    if case.get("b_seed") is not None:
        rng = np.random.default_rng(case["b_seed"])
        x = rng.random(a.shape[1]).astype(np.float32)
        b = a @ x
    return a, b


def mesh_spec(case, d):
    if "mesh" in case:
        return case["mesh"]
    if case["kind"] == "batched":
        return (d,), ("batch",)
    if case["kind"] == "tsqr2d":
        return (2, d // 2), ("batch", "rows")
    return (d,), ("rows",)


def run_port(case, mesh):
    """One case on this rank: the tuple its entry point returns."""
    from mixedprecisionblockqr_tpu_torch import (
        block_qr_batched_sharded,
        dist_block_qr,
        policy_by_name,
        tsqr_batched_sharded_2d,
        tsqr_sharded,
    )
    from mixedprecisionblockqr_tpu_torch.parallel import dist_block_qr_2d

    a, b = inputs_of(case)
    kw = dict(case["kw"])
    kind = case["kind"]
    if kind == "tsqr":
        return tsqr_sharded(torch.from_numpy(a), mesh, **kw)
    if kind == "batched":
        return block_qr_batched_sharded(torch.from_numpy(a), mesh, **kw)
    if kind == "tsqr2d":
        return tsqr_batched_sharded_2d(torch.from_numpy(a), mesh, **kw)
    if "policy" in kw:
        kw["policy"] = policy_by_name(kw["policy"])
    if kind == "dist2d":
        return dist_block_qr_2d(torch.from_numpy(a), mesh, b=b, **kw)
    return dist_block_qr(torch.from_numpy(a), mesh, b=b, **kw)


def record(name, case, out, mesh):
    """One rank's saved outputs of a case (its slabs as numpy) and its
    mesh coordinates: ``(results, coords)`` entries for ``name``."""
    out = out if isinstance(out, tuple) else (out,)
    keys, _ = outputs_of(case)
    assert len(out) == len(keys), (name, len(out), keys)
    return ({k: v.detach().float().numpy().copy() for k, v in zip(keys, out)},
            {ax: mesh.get_local_rank(ax) for ax in mesh.mesh_dim_names})


#: Calls that must raise: ``(name, exception class, message fragment)``;
#: ``guard_calls()[name](mesh, d)`` makes the call on every rank, on the
#: mesh ``guard_mesh(name, d)`` describes.
GUARD_SPECS = (
    ("block_size", "ValueError", "block_size"),
    ("bgs_width", "ValueError", "block_size"),
    ("bgs_complete", "ValueError", "complete"),
    ("square_leaf", "ValueError", "aspect"),
    ("rows_divide", "ValueError", "divide"),
    ("tsqr_rows_divide", "ValueError", "divide"),
    ("tsqr_short_leaf", "ValueError", "leaf height"),
    ("tsqr_local_leaves", "ValueError", "power of two"),
    ("2d_mesh_divide", "ValueError", "must divide over mesh"),
    ("2d_row_straddle", "ValueError", "straddle row shards"),
    ("2d_complete_cols", "ValueError", "must divide over cols"),
    ("2d_aspect", "ValueError", "aspect"),
    ("2d_bgs_tall", "ValueError", "m >= n"),
    ("2d_bgs_block_n", "ValueError", "block_size | n"),
    ("2d_bgs_straddle", "ValueError", "straddle column shards"),
    ("2d_bgs_complete", "ValueError", "complete"),
)

#: The 2-D guards' calls: ``(seed, shape, keyword arguments)``, each on the
#: (1, d) mesh of ``guard_mesh``.
GUARDS_2D = {
    "2d_mesh_divide": (4, (128, 65), {"block_size": 16}),
    "2d_row_straddle": (4, (100, 64), {"block_size": 64}),
    "2d_complete_cols": (4, (75, 52), {"block_size": 25,
                                       "mode": "complete"}),
    "2d_aspect": (8, (64, 64), {"block_size": 64,
                                "panel_method": "cholqr2"}),
    "2d_bgs_tall": (4, (64, 128), {"block_size": 16, "panel_method": "bgs"}),
    "2d_bgs_block_n": (4, (128, 120), {"block_size": 16,
                                       "panel_method": "bgs"}),
    "2d_bgs_straddle": (42, (256, 128), {"block_size": 128,
                                         "panel_method": "bgs"}),
    "2d_bgs_complete": (42, (256, 128), {"block_size": 32,
                                         "panel_method": "bgs",
                                         "mode": "complete"}),
}


def guard_mesh(name, d):
    """``(shape, names)`` of the mesh guard ``name`` runs on."""
    if name in GUARDS_2D:
        return (1, d), ("rows", "cols")
    return (d,), ("rows",)


def guard_calls():
    from mixedprecisionblockqr_tpu_torch import dist_block_qr, tsqr_sharded
    from mixedprecisionblockqr_tpu_torch.parallel import dist_block_qr_2d

    def dist(shape, seed=4, **kw):
        return lambda mesh, d: dist_block_qr(
            torch.from_numpy(uniform(seed, shape)), mesh, **kw)

    def tsqr(shape, **kw):
        return lambda mesh, d: tsqr_sharded(
            torch.from_numpy(uniform(9, shape(d))), mesh, **kw)

    return {
        # 128 rows over d ranks: 64 / 32 each; block 24 divides neither.
        "block_size": dist((128, 64), block_size=24, mode="r"),
        "bgs_width": dist((128, 100), 14, block_size=32,
                          panel_method="bgs"),
        "bgs_complete": dist((256, 128), 15, block_size=32,
                             mode="complete", panel_method="bgs"),
        # Square cholqr leaves: block = rows per rank.
        "square_leaf": lambda mesh, d: dist_block_qr(
            torch.from_numpy(uniform(8, (256, 256))), mesh,
            block_size=256 // d, mode="r", panel_method="cholqr2"),
        "rows_divide": dist((129, 64), block_size=16),
        "tsqr_rows_divide": tsqr(lambda d: (129, 16)),
        # 2d leaves of 16 rows for 64 columns.
        "tsqr_short_leaf": tsqr(lambda d: (32 * d, 64), local_leaves=2),
        "tsqr_local_leaves": tsqr(lambda d: (256, 16), local_leaves=3),
        **{name: (lambda mesh, d, seed=seed, shape=shape, kw=kw:
                  dist_block_qr_2d(torch.from_numpy(uniform(seed, shape)),
                                   mesh, **kw))
           for name, (seed, shape, kw) in GUARDS_2D.items()},
    }


def nan_input():
    a = uniform(50, (128, 64), True)
    a[5, 3] = np.nan
    return a


NAN_KW = {"block_size": 16, "mode": "reduced", "panel_method": "bgs1"}


def worker(rank, world, store_path, out_dir):
    """One spawned rank: every case on a gloo group of ``world`` ranks,
    the outputs (this rank's slabs), each case's mesh coordinates and
    the guards' exceptions saved to ``out_dir/rank<rank>.pt``."""
    import torch.distributed as dist

    from mixedprecisionblockqr_tpu_torch import (
        NonFiniteError,
        dist_block_qr,
        make_mesh,
    )

    torch.set_num_threads(1)
    # A rank that fails leaves the others in a collective: time out.
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        meshes = {}

        def mesh_for(shape, names):
            if (shape, names) not in meshes:
                meshes[shape, names] = make_mesh(shape, names,
                                                 device_type="cpu")
            return meshes[shape, names]

        results, coords = {}, {}
        for name, case in all_cases(world).items():
            mesh = mesh_for(*mesh_spec(case, world))
            results[name], coords[name] = record(name, case,
                                                 run_port(case, mesh), mesh)
        rows_mesh = mesh_for((world,), ("rows",))
        guards = {}
        for gname, call in guard_calls().items():
            try:
                call(mesh_for(*guard_mesh(gname, world)), world)
                guards[gname] = None
            except (ValueError, RuntimeError) as e:
                guards[gname] = (type(e).__name__, str(e))
        try:
            dist_block_qr(torch.from_numpy(nan_input()), rows_mesh,
                          **NAN_KW)
            guards["nan"] = None
        except NonFiniteError as e:
            guards["nan"] = (type(e).__name__, str(e))
        torch.save({"results": results, "coords": coords, "guards": guards},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(world, tmp_dir):
    """Spawn ``world`` ranks over gloo (a FileStore under ``tmp_dir``) and
    return each rank's saved dict, in rank order."""
    import torch.multiprocessing as mp

    store = os.path.join(tmp_dir, "store")
    mp.spawn(worker, args=(world, store, tmp_dir), nprocs=world,
             join=True)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def assemble(per_rank, name, key, splits):
    """The global array of output ``key`` of case ``name`` from the ranks'
    slabs: each slab placed by its rank's mesh coordinates along the
    split dims; ranks that hold the same block (replicas) must agree bit
    for bit."""
    blocks = {}
    for rk in per_rank:
        x = rk["results"][name][key]
        pos = tuple(rk["coords"][name][ax] for _, ax in splits)
        if pos in blocks:
            np.testing.assert_array_equal(blocks[pos], x,
                                          err_msg=f"{name}.{key} replicas")
        else:
            blocks[pos] = x
    if not splits:
        return blocks[()]
    sizes = [1 + max(p[i] for p in blocks) for i in range(len(splits))]
    first = next(iter(blocks.values()))
    shape = list(first.shape)
    for (dim, _), s in zip(splits, sizes):
        shape[dim] *= s
    out = np.empty(shape, first.dtype)
    for pos, x in blocks.items():
        idx = [slice(None)] * x.ndim
        for (dim, _), p in zip(splits, pos):
            idx[dim] = slice(p * x.shape[dim], (p + 1) * x.shape[dim])
        out[tuple(idx)] = x
    return out
