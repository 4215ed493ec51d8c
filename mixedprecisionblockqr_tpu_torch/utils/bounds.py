"""The least time an NVIDIA H100 could take for each kernel's work.

    python3 -m mixedprecisionblockqr_tpu_torch.utils.bounds

prints one JSON line per kernel of the repository (K1-K9) at the shapes
``chip_smoke.py`` times it (K5, K8 and K9, not ported yet, at the shapes
named in their lines).  A bound is the larger of two times: the operations
the kernel does on these inputs over the peak rate for their type, and the
bytes it must move (each input read once, each output written once) over
the memory rate.  The peaks are the H100 SXM data sheet's (dense, 700 W).
This is arithmetic on shapes:
it needs no device and measures nothing.
"""

from __future__ import annotations

import json

PEAK_F32 = 67e12       # fp32 outside the tensor cores
PEAK_BF16 = 989e12     # bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound(f32_ops=0.0, bf16_ops=0.0, nbytes=0.0):
    """``{"bound_ms", "bound_by"}`` for the given work."""
    t_ops = f32_ops / PEAK_F32 + bf16_ops / PEAK_BF16
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def chain_products(iters, refine=False):
    """r x r products of one ``ns_chain``: three per iteration, two more
    for a refine chain's exact residual, one for t = X^T G."""
    return 3 * iters + (2 if refine else 0) + 1


#: r x r products of the shifted three-pass chain, with the t3 t2 t1 combine.
ROBUST_PRODUCTS = (chain_products(14) + chain_products(12)
                   + chain_products(4, True) + 2)


def ns_chain_bound(r, iters):
    return bound(f32_ops=chain_products(iters) * 2 * r ** 3,
                 nbytes=3 * r * r * 4)


def group_bound(m, r, iters, robust, bf16, proj_cols=0):
    """K2 (and K5 with ``proj_cols`` previous columns projected out on
    entry, in fp32) on an m x (g r) group: per panel the Gram(s), the
    chain(s), Q = P X and the projection of the group's later columns."""
    chain = tall = 0
    w = len(iters) * r
    for j, (it, rb) in enumerate(zip(iters, robust)):
        chain += (ROBUST_PRODUCTS if rb else chain_products(it)) * 2 * r ** 3
        tall += (6 if rb else 2) * 2 * m * r * r
        tall += 2 * 2 * m * r * (w - (j + 1) * r)
    proj = 2 * 2 * m * proj_cols * w
    nbytes = (2 * m * w + w * w + m * proj_cols + proj_cols * w) * 4
    if bf16:
        return bound(f32_ops=chain + proj, bf16_ops=tall, nbytes=nbytes)
    return bound(f32_ops=chain + tall + proj, nbytes=nbytes)


def panel_qr_bound(m, r):
    """K3, robust mode: three Grams, three tall products, three chains."""
    return bound(f32_ops=ROBUST_PRODUCTS * 2 * r ** 3 + 6 * 2 * m * r * r,
                 nbytes=(2 * m * r + r * r) * 4)


def ninv_chain_bound(r, iters):
    return bound(f32_ops=(2 * iters + 1) * 2 * r ** 3, nbytes=2 * r * r * 4)


def householder_panel_ops(m, w):
    """K6's column loop: per column the dots w^T [V | P] over the live
    rows, the rank-1 update of the columns to its right and T's column."""
    return sum(2 * (m - j) * w + 2 * (m - j) * (w - j) + j * j
               for j in range(w))


def panel_factor_bound(m, w):
    return bound(f32_ops=householder_panel_ops(m, w),
                 nbytes=(3 * m * w + w * w) * 4)


def sketch_bound(d, w, r):
    """K7: per selection step the pivot's coefficients over the sketch and
    the rank-1 downdate."""
    return bound(f32_ops=r * 4 * d * w, nbytes=(d * w + w) * 4)


def kernel_bounds():
    """Every kernel's bound at the shapes ``chip_smoke.py`` times (K5, K8,
    K9: the shapes in the ``shape`` field)."""
    head = (12, 6, 6, 6, 6, 6, 6, 10)
    return {
        "K1 ns_chain": {"shape": "r=128, 6 iterations (chain_mid)",
                        **ns_chain_bound(128, 6)},
        "K2 bgs_group_fused": {
            "shape": "2048 x 1024, g=8, bf16, robust last panel",
            **group_bound(2048, 128, head, (False,) * 7 + (True,), True)},
        "K3 panel_qr_fused": {"shape": "4096 x 128, robust",
                              **panel_qr_bound(4096, 128)},
        "K4 ninv_chain": {"shape": "r=128, 5 iterations",
                          **ninv_chain_bound(128, 5)},
        "K5 bgs_group_fused_proj": {
            "shape": "2048 x 1024, g=8, bf16, 1024 previous columns",
            **group_bound(2048, 128, head, (False,) * 7 + (True,), True,
                          proj_cols=1024)},
        "K6 panel_factor_fused": {"shape": "2048 x 128",
                                  **panel_factor_bound(2048, 128)},
        "K7 sketch_qrcp_ranks": {"shape": "136 x 2048, 128 pivots",
                                 **sketch_bound(136, 2048, 128)},
        "K8 tiled_matmul": {"shape": "2048 x 2048 x 2048 bf16",
                            **bound(bf16_ops=2 * 2048 ** 3,
                                    nbytes=3 * 2048 * 2048 * 2)},
        # Cholesky (2 r^3 / 3) and the triangular inverse (r^3 / 3)
        "K9 chol_rinv": {"shape": "r=128",
                         **bound(f32_ops=128 ** 3,
                                 nbytes=3 * 128 * 128 * 4)},
    }


def main() -> int:
    for name, row in kernel_bounds().items():
        print(json.dumps({"kernel": name, **row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
