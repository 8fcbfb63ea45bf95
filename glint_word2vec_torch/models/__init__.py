"""Subpackage of glint_word2vec_torch; mirrors the layout of glint_word2vec_tpu."""

from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.models.estimator import Word2Vec
from glint_word2vec_torch.models.compat import (
    ServerSideGlintWord2Vec,
    ServerSideGlintWord2VecModel,
)

__all__ = [
    "Word2VecModel",
    "Word2Vec",
    "ServerSideGlintWord2Vec",
    "ServerSideGlintWord2VecModel",
]
