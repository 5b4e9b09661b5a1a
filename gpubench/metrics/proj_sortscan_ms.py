"""proj_sortscan_ms: device ms an iteration of the sort and scan kernels that
``projections/simplex.py::duchi_project`` runs (``torch.sort``'s kernels and
``torch.cumsum``'s), from the traced window."""

from gpubench.readers import ms_per_iteration

KERNELS = (r"(?i)sort", r"(?i)scan")


def read(ctx):
    return ms_per_iteration(ctx, KERNELS)
