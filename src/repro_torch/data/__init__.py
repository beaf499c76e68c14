from .synthetic import SyntheticLMStream, make_batch_iterator

__all__ = ["SyntheticLMStream", "make_batch_iterator"]
