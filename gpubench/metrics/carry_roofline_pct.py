"""carry_roofline_pct: the Benes carries' share of the HBM roofline (K5
``fine_gather_kernel``, K6 ``coarse_kernel``, K7 ``rows_gather_kernel`` of
``csrc/benes.cu``).  The bytes are the work of the problem: each of the two
carries (the dual into column order, a*x back into row order) reads and
writes one value a nonzero (8 B); carry slots beyond the nonzeros count
nothing."""

from gpubench.readers import roofline_pct

KERNELS = (r"\bfine_gather_kernel\b", r"\bcoarse_kernel\b", r"\brows_gather_kernel\b")


def bytes_per_iteration(m: int, n: int, nnz: int) -> int:
    return 2 * 8 * nnz


def read(ctx):
    return roofline_pct(ctx, KERNELS, bytes_per_iteration(**ctx.problem))
