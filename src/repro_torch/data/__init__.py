from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import DataConfig, batch_iterator, make_batch

__all__ = ["DataConfig", "PrefetchLoader", "batch_iterator", "make_batch"]
