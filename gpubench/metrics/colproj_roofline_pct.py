"""colproj_roofline_pct: the column projection kernels' share of the HBM
roofline: K1's forms (``column_kernel``, ``wide_kernel``, ``clamp_kernel`` of
``csrc/fused_matching.cu``) and K3 (``panel_tiles_kernel`` of
``csrc/panel_matching.cu``).  The bytes are the work of the problem, not of
the program's layout: per nonzero its a, its c, the dual value it sees and
its a*x (16 B), per column its length (4 B); padding slots, ghost lanes and
carry slots count nothing."""

from gpubench.readers import roofline_pct

KERNELS = (r"\bcolumn_kernel\b", r"\bwide_kernel\b", r"\bclamp_kernel\b", r"\bpanel_tiles_kernel\b")


def bytes_per_iteration(m: int, n: int, nnz: int) -> int:
    return 16 * nnz + 4 * n


def read(ctx):
    return roofline_pct(ctx, KERNELS, bytes_per_iteration(**ctx.problem))
