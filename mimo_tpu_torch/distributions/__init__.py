from mimo_tpu_torch.distributions import (  # noqa: F401
    affine, gating, hierarchical, mng, mnw, ng, niw, tied_gibbs, wishart)
from mimo_tpu_torch.distributions.affine import (  # noqa: F401
    AffineStats, TiedAffine)
from mimo_tpu_torch.distributions.gating import (  # noqa: F401
    Dirichlet, StickBreaking)
from mimo_tpu_torch.distributions.hierarchical import HierTied  # noqa: F401
from mimo_tpu_torch.distributions.mng import (  # noqa: F401
    MNG, DiagLinGaussParams)
from mimo_tpu_torch.distributions.mnw import (  # noqa: F401
    MNW, LinGaussParams, LinGaussStats)
from mimo_tpu_torch.distributions.ng import (  # noqa: F401
    NG, DiagGaussParams, DiagGaussStats)
from mimo_tpu_torch.distributions.niw import (  # noqa: F401
    NIW, GaussParams, GaussStats)
