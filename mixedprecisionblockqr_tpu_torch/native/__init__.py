"""Native (C++) host-side helpers of the port, its own copies of the JAX
package's ``native/`` sources: ``euroc_native`` wraps the Euroc Jacobian
parser (``euroc_parser.cpp``, same C ABI) with ctypes, built by ``g++`` at
first use into ``mixedprecisionblockqr_tpu_torch/_build/native/``
(``build.py``); ``qr_demo.cpp`` is a standalone C++ Householder QR with a
self-check (``make -C mixedprecisionblockqr_tpu_torch/native``).
``utils/euroc.py`` reads with numpy when the parser does not build."""
