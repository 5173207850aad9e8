from mimo_tpu_torch.conjugate.families import (  # noqa: F401
    Family, gaussian_family)
