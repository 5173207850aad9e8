from mimo_tpu_torch.ops import (  # noqa: F401
    cuda_diag_predict, cuda_estep, cuda_gibbs, cuda_hello, cuda_ilr_predict,
    cuda_predict, cuda_probes, family_estep, philox)
