from .pipeline import SyntheticLM, make_batch
