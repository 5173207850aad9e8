from mimo_tpu_torch.conjugate.families import (  # noqa: F401
    Family, diag_gaussian_family, diag_linear_family, gaussian_family,
    ilr_family, linear_family, product_family)
