"""torch_ops_ms: device ms an iteration of every operation on the card that is
not one of the port's own kernels (``csrc/*.cu``): the objective's glue, the
AGD step, the graph's buffer copies and the maximize calls' set-up.  Listed
only for cells whose projection is a port kernel: on the plain csc path the
projection's own torch ops could not be told from the glue by name."""

from gpubench.readers import ms_per_iteration

PORT_KERNELS = (r"\bcolumn_kernel\b", r"\bwide_kernel\b", r"\bclamp_kernel\b", r"\bpanel_tiles_kernel\b",
                r"\bfine_gather_kernel\b", r"\bfine_kernel\b", r"\bcoarse_kernel\b", r"\brows_gather_kernel\b",
                r"\bwindow_sums\b", r"\badd_rows\b")


def read(ctx):
    return ms_per_iteration(ctx, PORT_KERNELS, exclude=True)
