from mimo_tpu_torch.conjugate.families import (  # noqa: F401
    Family, gaussian_family, ilr_family, linear_family, product_family)
