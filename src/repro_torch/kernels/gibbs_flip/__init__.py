from . import ops, ref
from .ops import gibbs_flip_core, gibbs_flip_max_k
from .ref import gibbs_flip_gram_ref, gibbs_flip_ref

__all__ = ["ops", "ref", "gibbs_flip_core", "gibbs_flip_gram_ref",
           "gibbs_flip_max_k", "gibbs_flip_ref"]
