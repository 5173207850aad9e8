from mimo_tpu_torch.ops import (  # noqa: F401
    cuda_estep, cuda_gibbs, cuda_predict, family_estep, philox)
