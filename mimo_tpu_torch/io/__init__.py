from mimo_tpu_torch.io.loader import MmapDataset, csv_to_bin, write_bin
from mimo_tpu_torch.io.stream import Prefetcher

__all__ = ['MmapDataset', 'Prefetcher', 'csv_to_bin', 'write_bin']
