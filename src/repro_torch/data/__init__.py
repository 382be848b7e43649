from .pipeline import SyntheticTokenDataset, make_batch_iterator

__all__ = ["SyntheticTokenDataset", "make_batch_iterator"]
