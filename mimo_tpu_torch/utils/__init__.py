from mimo_tpu_torch.utils import data, linalg, sanitize, stats  # noqa: F401
