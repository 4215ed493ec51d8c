"""K1's L2 route against variant builds of its own source, on the card.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.ns_variants
        [--parent TREE] [name ...]

A developer's tool for A / B work on ``csrc/ns_chain.cuh``'s L2 route.
Each variant of :data:`VARIANTS` (all, or those named; none when
``--parent`` is given without names) is this tree's
``ns_chain.cu`` and ``ns_chain.cuh`` with a few text edits, each of which
must match exactly once, built alone with ``nvcc`` into a temporary
directory under ``_build/``; ``--parent`` adds the ``csrc/`` of another
tree as it stands (laid out as the L2 route was before it had its own
products: when its header has no ``kL2UDepth``, a scratch of 6 r ld floats
and (:data:`OLD_STAGE_FLOATS` + 3 r + 64) floats of shared memory).  Every
build runs K1 on the same Grams, first against ``ns_chain_plain`` (1e-4 of
max|plain|) and bit for bit against this tree's library in each option
set of :data:`CHECKS`, then
``loop_ms`` (:data:`LOOP` launches back to back over LOOP, median of 5)
of each option set of :data:`SETS`, the builds in turns for
:data:`ROUNDS` rounds, the order reversed every other round.  It prints
the card's name and power limit, one JSON line per check and one per set
(build -> the rounds' times).  The diagnostic variants (``no_products``,
``no_loads``, ``neither``) change what a launch computes: their outputs
are wrong by design and only their times mean anything.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

LOOP = 20
ROUNDS = 4
#: Shared-memory floats of a product stage on the L2 route before it had
#: its own products (128 x 36 and 16 x 36 floats: A's and B's tiles).
OLD_STAGE_FLOATS = (128 + 16) * 36
#: name -> (r, options) of the timed chains.
SETS = {
    "chain_mid_r256": (256, dict(iters=6, chain_mid=True)),
    "plain_r256": (256, dict(iters=10)),
    "chain_mid_r192": (192, dict(iters=6, chain_mid=True)),
    "chain_mid_r512": (512, dict(iters=6, chain_mid=True)),
}
#: name -> (r, Gram kind, options) of the bitwise checks: the timed sets,
#: and ``plain`` and ``refine`` at every width (``refine`` on the Gram of
#: a near-orthonormal panel, as its callers give it).
CHECKS = {**{name: (r, "well", kw) for name, (r, kw) in SETS.items()},
          **{f"plain_r{r}": (r, "well", dict(iters=10)) for r in (192, 512)},
          **{f"refine_r{r}": (r, "near_identity", dict(iters=4, refine=True))
             for r in (192, 256, 512)}}
_STAGE_CHECK = "        if (wkb < k0 + kL2UDepth && wke > k0) {"
_NO_STAGE = "        if (wkb < k0 + kL2UDepth && wke > k0 && false) {"
_FETCH_ARRIVE = "        l2_mbar_arrive_tx(bar, bytes);"
#: name -> the (old, new) text edits of ns_chain.cuh that make it.
VARIANTS = {
    # the stages' products skipped: what the loads and the rest cost
    "no_products": [(_STAGE_CHECK, _NO_STAGE)],
    # no copies (each stage's barrier completes with no bytes): what the
    # products and the rest cost
    "no_loads": [(_FETCH_ARRIVE, "        l2_mbar_arrive_tx(bar, 0);\n"
                                 "        return;")],
    "neither": [(_STAGE_CHECK, _NO_STAGE),
                (_FETCH_ARRIVE, "        l2_mbar_arrive_tx(bar, 0);\n"
                                "        return;")],
    "stages2": [("constexpr int kL2Stages = 3;",
                 "constexpr int kL2Stages = 2;")],
    "depth32": [("constexpr int kL2UDepth = 64;",
                 "constexpr int kL2UDepth = 32;")],
    # four stages of 32: the ring's bytes of three of 64 fit no more
    "depth32_stages4": [("constexpr int kL2UDepth = 64;",
                         "constexpr int kL2UDepth = 32;"),
                        ("constexpr int kL2Stages = 3;",
                         "constexpr int kL2Stages = 4;")],
}


def variant_header(src: str, edits) -> str:
    """``src`` with each (old, new) of ``edits`` applied; raises if an old
    text does not occur exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"the edit {old!r} matches {src.count(old)} "
                             "times, not once")
        src = src.replace(old, new)
    return src


def variant_layout(header: str, r: int, max_cluster: int):
    """The L2 layout a build of ``header`` checks for width r: from its
    own ring constants, or the older route's when it has none."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        L2_MAX_CLUSTER,
        L2_NORM_SLOTS,
        L2_RING_SLACK_FLOATS,
        NsLayout,
        _l2_ctas,
        _l2_ld,
    )

    ctas, ld = _l2_ctas(r, max_cluster), _l2_ld(r)

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             header).group(1))

    if "kL2UDepth" not in header:
        return NsLayout(0, "l2", ctas, 6 * r * ld,
                        (OLD_STAGE_FLOATS + 3 * r + 64) * 4)
    ring = const("kL2Stages") * const("kL2UDepth") * (const("kL2URows")
                                                      + 2 * const("kL2Tile"))
    return NsLayout(0, "l2", ctas, 11 * r * ld,
                    (L2_RING_SLACK_FLOATS + ring + 3 * r + 64
                     + L2_NORM_SLOTS * L2_MAX_CLUSTER) * 4)


def build_variants(csrc: Path, names, parent=None) -> dict:
    """name -> (header text, directory) of each variant's sources written
    into a fresh directory under ``_build/``, built in parallel into
    ``libns.so`` there; the caller removes the directories."""
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build

    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    base = (csrc / "ns_chain.cuh").read_text()
    trees = {name: (csrc, variant_header(base, VARIANTS[name]))
             for name in names}
    if parent is not None:
        pc = Path(parent) / "mixedprecisionblockqr_tpu_torch" / "csrc"
        trees["parent"] = (pc, (pc / "ns_chain.cuh").read_text())
    out, cmds = {}, []
    for name, (src, header) in trees.items():
        d = Path(tempfile.mkdtemp(dir=_build.BUILD_ROOT))
        shutil.copy(src / "ns_chain.cu", d)
        (d / "ns_chain.cuh").write_text(header)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(d / "libns.so"), str(d / "ns_chain.cu")])
        out[name] = (header, d)
    _build._run_all(cmds)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    names = args.names or ([] if args.parent else list(VARIANTS))
    if not torch.cuda.is_available():
        print("ns_variants: no CUDA device", file=sys.stderr)
        return 2
    from mixedprecisionblockqr_tpu_torch.ops.kernels import _build
    from mixedprecisionblockqr_tpu_torch.ops.kernels.ns import (
        _card_cluster,
        _launch_chain,
        ns_chain_plain,
        ns_layout,
    )
    from mixedprecisionblockqr_tpu_torch.utils.batched_probe import k1_stack
    from mixedprecisionblockqr_tpu_torch.utils.timing import cuda_time_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    G_of = {(kind, r): k1_stack(kind, 1, r, gen, dev)[0]
            for kind, r in sorted({(kind, r) for r, kind, _
                                   in CHECKS.values()})}
    built = build_variants(_build.CSRC, names, args.parent)
    try:
        builds = {"this": (None, None)}
        for name, (header, d) in built.items():
            lib = _build._declare_ns(ctypes.CDLL(str(d / "libns.so")))
            builds[name] = (lib, header)

        lays = {}  # parsed once: a launch's host time is what 256 reads

        def launch(name, r, kw, kind="well"):
            lib, header = builds[name]
            G = G_of[kind, r]
            if lib is not None and (name, r) not in lays:
                lays[name, r] = variant_layout(header, r,
                                               _card_cluster(G, r))
            lay = lays.get((name, r))
            return _launch_chain(G, kw["iters"], 0.0, kw.get("refine", False),
                                 kw.get("chain_mid", False), True, True,
                                 lib=lib, lay=lay)

        for sname, (r, kind, kw) in CHECKS.items():
            Xp, tp, _ = ns_chain_plain(G_of[kind, r], **kw)
            Xr, tr, _ = launch("this", r, kw, kind)
            for name in builds:
                X, t, _ = launch(name, r, kw, kind)
                torch.cuda.synchronize()
                err = max(float((X - Xp).abs().max()),
                          float((t - tp).abs().max()))
                lim = 1e-4 * max(float(Xp.abs().max()),
                                 float(tp.abs().max()))
                print(json.dumps({
                    "check": sname, "build": name, "err": err, "lim": lim,
                    "ok": err <= lim, "route": ns_layout(r).route,
                    "same_as_this": bool(torch.equal(X, Xr)
                                         and torch.equal(t, tr))}),
                      flush=True)
        times = {(s, n): [] for s in SETS for n in builds}
        order = list(builds)
        for rnd in range(ROUNDS):
            for name in order if rnd % 2 == 0 else order[::-1]:
                for sname, (r, kw) in SETS.items():
                    times[sname, name].append(cuda_time_ms(
                        lambda: [launch(name, r, kw) for _ in range(LOOP)],
                        warmup=1, iters=5) / LOOP)
        for sname in SETS:
            print(json.dumps({"set": sname, "loop_ms": {
                n: times[sname, n] for n in builds}}), flush=True)
    finally:
        for _, d in built.values():
            shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
