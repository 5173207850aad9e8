from mimo_tpu_torch.distributions import gating, niw, wishart  # noqa: F401
from mimo_tpu_torch.distributions.gating import (  # noqa: F401
    Dirichlet, StickBreaking)
from mimo_tpu_torch.distributions.niw import (  # noqa: F401
    NIW, GaussParams, GaussStats)
