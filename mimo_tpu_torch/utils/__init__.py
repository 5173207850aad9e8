from mimo_tpu_torch.utils import linalg, sanitize, stats  # noqa: F401
