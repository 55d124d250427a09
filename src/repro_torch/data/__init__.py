from repro_torch.data.synthetic import DataConfig, batch_iterator, make_batch

__all__ = ["DataConfig", "batch_iterator", "make_batch"]
