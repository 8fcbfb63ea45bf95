"""Word2Vec model ops, ported from ``glint_word2vec_tpu/models/word2vec.py``:
``transform``, ``transform_words``, ``norms``, ``find_synonyms`` (the exact arm),
``analogy``, ``save`` and ``load``.

The cosine scores are one matrix product on the device (the JAX package leaves it to
XLA; here it is ``torch.matmul``). The top-k keeps ``lax.top_k``'s order, which
``torch.topk`` does not promise: descending score, and among equal scores the lowest
row index first. Word queries exclude the query word itself; vector queries do not.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.train import checkpoint as ckpt


class Word2VecModel:
    """Trained word embeddings on one device."""

    def __init__(
        self,
        vocab: Vocabulary,
        syn0,
        syn1=None,
        config: Optional[Word2VecConfig] = None,
        train_state: Optional[ckpt.TrainState] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)

        def place(a) -> torch.Tensor:
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
            return t.to(self.device, torch.float32)

        syn0 = place(syn0)
        if syn0.shape[0] != vocab.size:
            raise ValueError(
                f"syn0 has {syn0.shape[0]} rows but vocabulary has {vocab.size} words")
        self.vocab = vocab
        self.config = config or Word2VecConfig(vector_size=int(syn0.shape[1]))
        self.train_state = train_state
        self.syn0 = syn0
        self.syn1 = place(syn1) if syn1 is not None else None
        self._norms: Optional[torch.Tensor] = None

    @property
    def vector_size(self) -> int:
        return int(self.syn0.shape[1])

    @property
    def num_words(self) -> int:
        return self.vocab.size

    def _index(self, word: str) -> int:
        idx = self.vocab.get(word)
        if idx < 0:
            raise KeyError(f"{word} not in vocabulary")
        return idx

    # -- transform ---------------------------------------------------------------------

    def transform(self, word: str) -> np.ndarray:
        """Vector of a single word; raises KeyError on OOV."""
        return self.syn0[self._index(word)].cpu().numpy()

    def transform_words(self, words: Iterable[str], batch_size: int = 10_000
                        ) -> Iterator[np.ndarray]:
        """Batched word -> vector stream (one gather per ``batch_size`` words)."""
        buf: List[int] = []
        for w in words:
            buf.append(self._index(w))
            if len(buf) >= batch_size:
                yield from self.syn0[torch.as_tensor(buf, device=self.device)].cpu().numpy()
                buf = []
        if buf:
            yield from self.syn0[torch.as_tensor(buf, device=self.device)].cpu().numpy()

    @property
    def norms(self) -> torch.Tensor:
        """Per-row Euclidean norms, computed once and cached."""
        if self._norms is None:
            self._norms = torch.linalg.vector_norm(self.syn0, dim=1)
        return self._norms

    # -- synonym / analogy search ----------------------------------------------------------

    def find_synonyms(self, query: Union[str, np.ndarray], num: int
                      ) -> List[Tuple[str, float]]:
        """Top-``num`` cosine-similar words. A word query excludes itself."""
        return self.find_synonyms_batch([query], num)[0]

    def find_synonyms_batch(
        self,
        queries: Sequence[Union[str, np.ndarray]],
        num: int,
        chunk: int = 128,
    ) -> List[List[Tuple[str, float]]]:
        """Batched :meth:`find_synonyms`: one cosine matrix per ``chunk`` queries."""
        norms = self.norms
        k = min(num + 1, self.num_words)
        out: List[List[Tuple[str, float]]] = []
        for lo in range(0, len(queries), chunk):
            part = queries[lo:lo + chunk]
            words: List[Optional[str]] = []
            rows = []
            for q in part:
                if isinstance(q, str):
                    words.append(q)
                    rows.append(self.syn0[self._index(q)])
                else:
                    words.append(None)
                    rows.append(torch.as_tensor(np.asarray(q, np.float32),
                                                device=self.device))
            scores, idxs = cosine_topk(self.syn0, norms, torch.stack(rows), k)
            for word, srow, irow in zip(words, scores.tolist(), idxs.tolist()):
                res = [(self.vocab.words[i], s) for i, s in zip(irow, srow)
                       if self.vocab.words[i] != word]
                out.append(res[:num])
        return out

    def analogy(self, a: str, b: str, c: str, num: int = 10) -> List[Tuple[str, float]]:
        """b − a + c, excluding the three query words."""
        va, vb, vc = self.transform(a), self.transform(b), self.transform(c)
        res = self.find_synonyms(vb - va + vc, num + 3)
        return [(w, s) for w, s in res if w not in (a, b, c)][:num]

    # -- persistence ---------------------------------------------------------------------

    def save(self, path: str) -> None:
        ckpt.save_model(
            path, self.vocab.words, self.vocab.counts, self.syn0.cpu().numpy(),
            self.syn1.cpu().numpy() if self.syn1 is not None else None,
            self.config, self.train_state)

    @classmethod
    def load(cls, path: str, verify: bool = True, device="cuda") -> "Word2VecModel":
        """Load a dense checkpoint written by either package (digests verified unless
        ``verify=False``). The config may carry knobs the port does not train with
        yet; they do not affect the model ops."""
        data = ckpt.load_model(path, verify=verify, check_ported=False)
        vocab = Vocabulary.from_words_and_counts(data["words"], data["counts"])
        return cls(vocab=vocab, syn0=data["syn0"], syn1=data["syn1"],
                   config=data["config"], train_state=data["train_state"],
                   device=device)


def cosine_topk(syn0: torch.Tensor, norms: torch.Tensor, queries: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cosine(rows, q) top-k for a [Q, D] query block: queries normalized, zero-norm
    rows score 0, ties broken toward the lowest row index (a stable descending
    sort, which is ``lax.top_k``'s order)."""
    q = queries / torch.clamp(torch.linalg.vector_norm(queries, dim=1, keepdim=True),
                              min=1e-12)
    dots = q @ syn0.T                                                  # [Q, V]
    cos = torch.where(norms[None, :] > 0,
                      dots / torch.clamp(norms[None, :], min=1e-12),
                      torch.zeros((), dtype=dots.dtype, device=dots.device))
    scores, idxs = torch.sort(cos, dim=1, descending=True, stable=True)
    return scores[:, :k], idxs[:, :k]
