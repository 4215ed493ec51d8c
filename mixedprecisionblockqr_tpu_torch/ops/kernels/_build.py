"""Build and load the package's CUDA kernels (plain C interface, ctypes).

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` at
first use, one ``nvcc`` process per source, all started together, and
linked into one shared library in ``_build/<hash>/`` inside the package
(listed in ``.gitignore``).  The directory name is a hash of the sources and
the compile command, so an edited source builds anew and an unchanged one
loads the existing library.  Nothing is built at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("ns_chain.cu", "bgs_group.cu", "panel_qr.cu", "sketch_qrcp.cu",
           "ninv_chain.cu", "panel_factor.cu", "tiled_matmul.cu",
           "chol_rinv.cu", "givens.cu", "stack_gemm.cu")
HEADERS = ("ns_chain.cuh", "panel.cuh", "stack_gemm.h")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_lib: Optional[ctypes.CDLL] = None
#: Seconds the last build took (0.0 when the library was loaded as built).
build_seconds = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _declare_ns(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entries of ns_chain.cu (K1)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    chain = [ci] * 5  # ns.py::NsLayout (ns.py::_c_layout)
    lib.mpbqr_ns_chain.argtypes = [vp, vp, vp, vp, vp, ci, ci, cf, ci, ci,
                                   ci, ci, *chain, vp]
    lib.mpbqr_ns_chain.restype = ci
    lib.mpbqr_ns_chain_batched.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                           cf, ci, ci, ci, ci, *chain, vp]
    lib.mpbqr_ns_chain_batched.restype = ci
    lib.mpbqr_ns_chain_resident.argtypes = [ci, *chain, ctypes.POINTER(ci)]
    lib.mpbqr_ns_chain_resident.restype = ci
    return lib


def _declare_ninv(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entries of ninv_chain.cu (K4)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    chain = [ci] * 5  # ns.py::NsLayout (ns.py::_c_layout)
    lib.mpbqr_ninv_chain.argtypes = [vp, vp, vp, vp, ci, ci, *chain, vp]
    lib.mpbqr_ninv_chain.restype = ci
    lib.mpbqr_ninv_chain_batched.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                             *chain, vp]
    lib.mpbqr_ninv_chain_batched.restype = ci
    lib.mpbqr_ninv_chain_resident.argtypes = [ci, *chain,
                                              ctypes.POINTER(ci)]
    lib.mpbqr_ninv_chain_resident.restype = ci
    return lib


def _declare_panel(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entries of panel_factor.cu (K6)."""
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mpbqr_panel_factor.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                       ci, ci, vp]
    lib.mpbqr_panel_factor.restype = ci
    lib.mpbqr_panel_factor_wide_scratch_floats.argtypes = [ci, ci, ci]
    lib.mpbqr_panel_factor_wide_scratch_floats.restype = ll
    lib.mpbqr_panel_factor_wide.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                            vp, ci, vp]
    lib.mpbqr_panel_factor_wide.restype = ci
    lib.mpbqr_panel_factor_max_cluster.argtypes = [ci, ctypes.POINTER(ci)]
    lib.mpbqr_panel_factor_max_cluster.restype = ci
    lib.mpbqr_panel_factor_resident.argtypes = [ci, ci, ci,
                                                ctypes.POINTER(ci)]
    lib.mpbqr_panel_factor_resident.restype = ci
    lib.mpbqr_panel_factor_batched.argtypes = [vp, vp, vp, vp, vp, ci, ci,
                                               ci, ci, ci, ci, ci, vp]
    lib.mpbqr_panel_factor_batched.restype = ci
    lib.mpbqr_panel_factor_wide_batched_scratch_floats.argtypes = [ci, ci, ci,
                                                                   ci]
    lib.mpbqr_panel_factor_wide_batched_scratch_floats.restype = ll
    lib.mpbqr_panel_factor_wide_batched.argtypes = [vp, vp, vp, vp, vp, ci,
                                                    ci, ci, ci, vp, ci, vp]
    lib.mpbqr_panel_factor_wide_batched.restype = ci
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cf, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    chain = [ci] * 5  # ns.py::NsLayout (ns.py::_c_layout)
    _declare_ns(lib)
    lib.mpbqr_bgs_group_scratch_floats.argtypes = [ci, ci, ci]
    lib.mpbqr_bgs_group_scratch_floats.restype = ll
    lib.mpbqr_bgs_group_batched_scratch_floats.argtypes = [ci, ci, ci, ci]
    lib.mpbqr_bgs_group_batched_scratch_floats.restype = ll
    layout = [ci] * 10  # ns.py::GroupLayout.args(): products, then chain
    lib.mpbqr_bgs_group.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp, vp,
                                    ci, ci, ci, *layout, vp]
    lib.mpbqr_bgs_group.restype = ci
    # ns.py::GroupLayout.batched_args(): products, route, then chain
    lib.mpbqr_bgs_group_batched.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                            ci, vp, vp, ci, ci, ci,
                                            *layout[:5], ci, *layout[5:],
                                            vp]
    lib.mpbqr_bgs_group_batched.restype = ci
    lib.mpbqr_bgs_group_proj.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp,
                                         vp, ci, ci, ci, vp, vp, ci, ci, ci,
                                         *layout, ci, ci, vp]
    lib.mpbqr_bgs_group_proj.restype = ci
    lib.mpbqr_group_product.argtypes = [ci, ci, ci, ci, ci, vp, ci, ci, vp,
                                        ci, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.mpbqr_group_product.restype = ci
    lib.mpbqr_stack_product.argtypes = [ci, ci, ci, ci, ci, ci, vp, ci, ci,
                                        ll, ci, vp, ci, ll, ci, vp, ci, ll,
                                        ci, ci, ci, ci, vp]
    lib.mpbqr_stack_product.restype = ci
    lib.mpbqr_panel_qr_scratch_floats.argtypes = [ci, ci]
    lib.mpbqr_panel_qr_scratch_floats.restype = ll
    lib.mpbqr_panel_qr.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                   *layout, vp]
    lib.mpbqr_panel_qr.restype = ci
    lib.mpbqr_sketch_qrcp.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                      vp]
    lib.mpbqr_sketch_qrcp.restype = ci
    _declare_ninv(lib)
    lib.mpbqr_tri_combine.argtypes = [vp, vp, vp, vp, vp, ci, ci, *chain, vp]
    lib.mpbqr_tri_combine.restype = ci
    _declare_panel(lib)
    lib.mpbqr_tiled_matmul.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                       ci, vp]
    lib.mpbqr_tiled_matmul.restype = ci
    lib.mpbqr_chol_rinv.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.mpbqr_chol_rinv.restype = ci
    return _declare_givens(lib)


def _declare_givens(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entries of ``givens.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mpbqr_givens_fold_rows.argtypes = [vp, vp, ci, ci, ci, vp, vp, ci,
                                           vp]
    lib.mpbqr_givens_fold_rows.restype = ci
    lib.mpbqr_givens_chain.argtypes = [vp, vp, ci, vp, ci, ci, ci, vp, ci,
                                       vp]
    lib.mpbqr_givens_chain.restype = ci
    lib.mpbqr_givens_hessenberg.argtypes = [vp, ci, vp, ci, ci, vp, vp, ci,
                                            vp]
    lib.mpbqr_givens_hessenberg.restype = ci
    return lib


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")


#: Libraries of one source that :func:`instrumented_library` may build,
#: with the function that declares their C entries.
PARTIAL = {("givens.cu",): _declare_givens, ("ns_chain.cu",): _declare_ns,
           ("ninv_chain.cu",): _declare_ninv,
           ("panel_factor.cu",): _declare_panel}


def build(so: Path, flags=(), sources=SOURCES) -> None:
    """Compile ``sources`` with ``NVCC_FLAGS`` and ``flags``, in parallel,
    and link them into the shared library ``so``."""
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = [os.path.join(tmp, Path(src).stem + ".o") for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj,
                   str(CSRC / src)] for src, obj in zip(sources, objs)])
        lib_tmp = os.path.join(tmp, so.name)
        # -ldl: tiled_matmul.cu looks cuTensorMapEncodeTiled up in
        # libcuda at run time with dlsym (no link against it).
        _run_all([[nvcc, "-shared", "-o", lib_tmp, *objs, "-ldl"]])
        os.replace(lib_tmp, so)


@contextlib.contextmanager
def instrumented_library(flag: str, entry: Optional[str] = None,
                         nargs: int = 0, sources=SOURCES):
    """A second kernel library, built with the macro ``flag`` (``-D...``)
    from ``sources`` (all, or a key of ``PARTIAL``) into a temporary
    directory under ``_build/`` that is removed on exit, with their C
    entries declared and the instrumented build's extra entry ``entry``,
    if it has one (``nargs`` pointers -> CUDA error), too.  For the
    developer's probes; the library that :func:`library` loads is not
    touched."""
    sources = tuple(sources)
    declare = _declare if sources == SOURCES else PARTIAL[sources]
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        so = Path(tmp) / "libmpbqr_kernels.so"
        build(so, (flag,), sources)
        lib = declare(ctypes.CDLL(str(so)))
        if entry is not None:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * nargs
            fn.restype = ctypes.c_int
        yield lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so = BUILD_ROOT / _digest() / "libmpbqr_kernels.so"
    if not so.exists():
        t0 = time.perf_counter()
        build(so)
        build_seconds = time.perf_counter() - t0
    _lib = _declare(ctypes.CDLL(str(so)))
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
