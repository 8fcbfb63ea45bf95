"""glint_word2vec_torch — the PyTorch/CUDA port of glint_word2vec_tpu.

Skip-gram and CBOW word2vec, with a shared negative pool or per-pair negatives, trained
on one NVIDIA GPU, or the shared-pool skip-gram row-sharded over a mesh of them
(``parallel/``), through hand-written CUDA kernels (``csrc/sgns_shared.cu``, the fused
shared-pool skip-gram step; ``csrc/scatter_rows.cu``, the row scatter-add of the other
steps), with the JAX package as the reference it is held against. The package imports
torch and numpy, never jax.
"""

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.models.estimator import Word2Vec
from glint_word2vec_torch.models.word2vec import Word2VecModel

__all__ = ["Word2Vec", "Word2VecConfig", "Word2VecModel", "Vocabulary"]
