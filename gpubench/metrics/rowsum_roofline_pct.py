"""rowsum_roofline_pct: the row segment-sum's share of the HBM roofline
(``window_sums`` and ``add_rows`` of ``csrc/segment_sum.cu``).  The bytes are
the work of the problem: per nonzero its a*x and the index that places it
(8 B), per row its sum (4 B)."""

from gpubench.readers import roofline_pct

KERNELS = (r"\bwindow_sums\b", r"\badd_rows\b")


def bytes_per_iteration(m: int, n: int, nnz: int) -> int:
    return 8 * nnz + 4 * m


def read(ctx):
    return roofline_pct(ctx, KERNELS, bytes_per_iteration(**ctx.problem))
