"""Preprocessing (``dualip_tpu/preprocessing``): input validation and Jacobi
row preconditioning, on host numpy and ``CSCMatrix`` inputs."""

from dualip_tpu_torch.preprocessing.input_validation import (  # noqa: F401
    InputValidationError,
    check_correct_csc_construction,
    check_nan_or_inf,
    check_no_zero_row_or_col,
    check_projection_map,
    run_all_checks,
)
from dualip_tpu_torch.preprocessing.precondition import (  # noqa: F401
    jacobi_invert_precondition,
    jacobi_precondition,
)
