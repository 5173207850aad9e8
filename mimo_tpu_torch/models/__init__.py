from mimo_tpu_torch.models.gmm import GMM, BayesianGMM  # noqa: F401
from mimo_tpu_torch.models.hmix import BayesianMixtureOfMixtures  # noqa: F401
from mimo_tpu_torch.models.ilr import BayesianILR  # noqa: F401
from mimo_tpu_torch.models.mixture import (  # noqa: F401
    BayesianMixture, EMState, GibbsState, MFState)
