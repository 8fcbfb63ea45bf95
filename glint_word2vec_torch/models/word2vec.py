"""Word2Vec model ops, ported from ``glint_word2vec_tpu/models/word2vec.py``: word and
sentence transforms, ``pull``, ``norms``, ``multiply``, ``find_synonyms`` (the exact
arm), ``analogy``, the exports (``get_vectors``, ``iter_vectors``, ``to_local``,
``export_word2vec`` in word2vec.c's text and binary formats), ``save``, ``load`` of
either checkpoint layout, ``load_latest`` and ``stop``, and the serving tier's entry to
an IVF index (``attach_ann``, ``find_synonyms_batch(ann=True)``; the index lives on the
host, :mod:`..serve.ann`). Every op runs on the model's device (the card unless
``device="cpu"``); after ``stop`` each raises.

Not ported: ``plan=``, which retargets a model onto a multi-device mesh (ROADMAP queue
A9); it is refused by name.

The cosine scores are one matrix product on the device (the JAX package leaves it to
XLA; here it is ``torch.matmul``). The top-k keeps ``lax.top_k``'s order, which
``torch.topk`` does not promise: descending score, and among equal scores the lowest
row index first. Word queries exclude the query word itself; vector queries do not.
"""

from __future__ import annotations

import io
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import ordered_pool_map
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.train import checkpoint as ckpt


def refuse_plan(plan) -> None:
    """Refuse a multi-device placement by name: the port runs on one device."""
    if plan is not None:
        raise NotImplementedError(
            "plan= places a model on a multi-device mesh; glint_word2vec_torch runs on "
            "one device, and multi-device placement is not ported yet (ROADMAP.md "
            "queue A9); pass plan=None")


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
        self._syn0: Optional[torch.Tensor] = syn0
        self._syn1 = place(syn1) if syn1 is not None else None
        self._norms: Optional[torch.Tensor] = None
        self._dim = int(syn0.shape[1])
        self._ann = None
        self._stopped = False

    @property
    def syn0(self) -> torch.Tensor:
        """Input embeddings [vocab_size, D] on the model's device."""
        self._check_alive()
        return self._syn0

    @property
    def syn1(self) -> Optional[torch.Tensor]:
        if self._syn1 is None:
            return None
        self._check_alive()
        return self._syn1

    @property
    def vector_size(self) -> int:
        return self._dim

    @property
    def num_words(self) -> int:
        return self.vocab.size

    def _check_alive(self) -> None:
        if self._stopped:
            raise RuntimeError("model has been stopped; its buffers were released")

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
        self._check_alive()
        buf: List[int] = []
        for w in words:
            buf.append(self._index(w))
            if len(buf) >= batch_size:
                yield from self.syn0[torch.as_tensor(buf, device=self.device)].cpu().numpy()
                buf = []
        if buf:
            yield from self.syn0[torch.as_tensor(buf, device=self.device)].cpu().numpy()

    def transform_sentences(self, sentences: Sequence[Sequence[str]],
                            batch_size: int = 10_000) -> np.ndarray:
        """Sentence -> mean of its in-vocabulary word vectors, float32 [S, D]: the
        ML transform. OOV words are dropped; a sentence with none maps to the zero
        vector. Segment sums in f32 over batches of ``batch_size`` sentences, one
        gather and one ``index_add_`` each."""
        syn0 = self.syn0
        out = np.zeros((len(sentences), self.vector_size), dtype=np.float32)
        for lo in range(0, len(sentences), batch_size):
            flat: List[int] = []
            seg: List[int] = []
            part = sentences[lo:lo + batch_size]
            for local, sent in enumerate(part):
                for w in sent:
                    i = self.vocab.get(w)
                    if i >= 0:
                        flat.append(i)
                        seg.append(local)
            if not flat:
                continue
            idx = torch.as_tensor(flat, dtype=torch.int64, device=self.device)
            seg_t = torch.as_tensor(seg, dtype=torch.int64, device=self.device)
            sums = torch.zeros((len(part), self.vector_size), dtype=torch.float32,
                               device=self.device).index_add_(0, seg_t, syn0[idx])
            counts = torch.bincount(seg_t, minlength=len(part)).to(torch.float32)
            means = sums / torch.clamp(counts, min=1.0)[:, None]
            out[lo:lo + len(part)] = means.cpu().numpy()
        return out

    # -- pull / norms / multiply -------------------------------------------------------

    def pull(self, indices: Sequence[int]) -> np.ndarray:
        """Rows by index (the parameter server's ``pull``)."""
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=self.device)
        return self.syn0[idx].cpu().numpy()

    @property
    def norms(self) -> torch.Tensor:
        """Per-row Euclidean norms, computed once and cached."""
        self._check_alive()
        if self._norms is None:
            self._norms = torch.linalg.vector_norm(self._syn0, dim=1)
        return self._norms

    def multiply(self, vector: np.ndarray) -> np.ndarray:
        """syn0 @ v, one matrix-vector product on the device (the parameter
        server's ``multiply``)."""
        v = torch.as_tensor(np.asarray(vector, np.float32), device=self.device)
        return (self.syn0 @ v).cpu().numpy()

    # -- ANN index attach (serving tier, serve/ann.py) ---------------------------------

    def attach_ann(self, index) -> None:
        """Attach a built :class:`~glint_word2vec_torch.serve.ann.IvfIndex` so
        :meth:`find_synonyms_batch` can serve the approximate arm (``ann=True``). The
        exact arm stays the ground truth; the index is never saved with the model (it
        is rebuilt from the matrix at load or publish time). An index whose row count
        differs from the vocabulary is refused: a stale index from an earlier publish
        would mis-rank silently."""
        self._check_alive()
        if index is not None:
            rows = getattr(index, "num_rows", None)
            if rows is not None and int(rows) != self.vocab.size:
                raise ValueError(
                    f"ANN index covers {rows} rows but the vocabulary has "
                    f"{self.vocab.size} words — a stale index from a "
                    f"previous publish (the vocabulary grew?); rebuild with "
                    f"serve.ann.build_ivf(model.syn0.cpu().numpy())")
        self._ann = index

    @property
    def ann(self):
        """The attached ANN index, or None."""
        return self._ann

    # -- synonym / analogy search ----------------------------------------------------------

    def find_synonyms(self, query: Union[str, np.ndarray], num: int
                      ) -> List[Tuple[str, float]]:
        """Top-``num`` cosine-similar words. A word query excludes itself."""
        return self.find_synonyms_batch([query], num)[0]

    find_synonyms_array = find_synonyms  # the ML layer's name

    def find_synonyms_batch(
        self,
        queries: Sequence[Union[str, np.ndarray]],
        num: int,
        chunk: int = 128,
        ann: bool = False,
        nprobe: Optional[int] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Batched :meth:`find_synonyms`: one cosine matrix per ``chunk`` queries on the
        model's device. ``ann=True`` routes the batch through the attached IVF index
        instead (:meth:`attach_ann`): the ``nprobe`` nearest cells on the host, the same
        result shape and self-exclusion, true cosine scores (only the candidate set is
        approximate)."""
        if ann:
            self._check_alive()
            if self._ann is None:
                raise RuntimeError(
                    "ann=True but no index attached — build one with "
                    "serve.ann.build_ivf(model.syn0.cpu().numpy()) and "
                    "model.attach_ann(index)")
            return self._find_synonyms_batch_ann(queries, num, nprobe)
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

    def _find_synonyms_batch_ann(
            self, queries: Sequence[Union[str, np.ndarray]], num: int,
            nprobe: Optional[int] = None) -> List[List[Tuple[str, float]]]:
        """The ANN arm of :meth:`find_synonyms_batch`: a host probe of the attached
        index. Word queries read their vector from the index (no device gather);
        vector queries are normalized by the index."""
        index = self._ann
        words: List[Optional[str]] = []
        rows: List[np.ndarray] = []
        for q in queries:
            if isinstance(q, str):
                words.append(q)
                rows.append(index.vector(self._index(q)))
            else:
                words.append(None)
                rows.append(np.asarray(q, np.float32))
        k = min(num + 1, self.num_words)
        scores, idxs = index.search(np.stack(rows), k, nprobe)
        out: List[List[Tuple[str, float]]] = []
        for word, srow, irow in zip(words, scores, idxs):
            res: List[Tuple[str, float]] = []
            for i, s in zip(irow, srow):
                if i < 0:
                    break  # fewer candidates than k in the probed cells
                w = self.vocab.words[int(i)]
                if w != word:
                    res.append((w, float(s)))
            out.append(res[:num])
        return out

    def analogy(self, a: str, b: str, c: str, num: int = 10) -> List[Tuple[str, float]]:
        """b − a + c, excluding the three query words."""
        va, vb, vc = self.transform(a), self.transform(b), self.transform(c)
        res = self.find_synonyms(vb - va + vc, num + 3)
        return [(w, s) for w, s in res if w not in (a, b, c)][:num]

    # -- exports -----------------------------------------------------------------------

    def get_vectors(self) -> Dict[str, np.ndarray]:
        """word -> vector for the whole vocabulary, on the host."""
        mat = self.syn0.cpu().numpy()
        return {w: mat[i] for i, w in enumerate(self.vocab.words)}

    def iter_vectors(self, batch_size: int = 10_000
                     ) -> Iterator[Tuple[str, np.ndarray]]:
        """(word, vector) pairs in row order, copied to the host ``batch_size`` rows
        at a time."""
        self._check_alive()
        for start in range(0, self.num_words, batch_size):
            stop = min(start + batch_size, self.num_words)
            block = self.syn0[start:stop].cpu().numpy()
            for i in range(stop - start):
                yield self.vocab.words[start + i], block[i]

    def to_local(self) -> Tuple[List[str], np.ndarray]:
        """(words, matrix) on the host."""
        return list(self.vocab.words), self.syn0.cpu().numpy()

    def export_word2vec(self, path: str, binary: bool = False, batch_size: int = 65536,
                        io_workers: Optional[int] = None) -> None:
        """Write word2vec.c's vectors file: ``"<vocab> <dim>\\n"``, then per word the
        word, a space, and either the space-joined ``repr(float(x))`` decimals and a
        newline (text) or dim little-endian float32s and a newline (binary). Rows come
        to the host ``batch_size`` at a time, on the calling thread; the bytes of
        ~4k-row sub-chunks are formatted on ``io_workers`` threads (default
        ``config.io_workers``) and written in order, so the file is the same at any
        worker count, and the same as the JAX package writes for the same matrix."""
        self._check_alive()
        if io_workers is None:
            io_workers = self.config.io_workers
        sub = max(1, min(batch_size, 4096))
        words = self.vocab.words

        def jobs():
            for start in range(0, self.num_words, batch_size):
                stop = min(start + batch_size, self.num_words)
                block = self.syn0[start:stop].cpu().numpy()
                for lo in range(start, stop, sub):
                    yield lo, block[lo - start:min(lo + sub, stop) - start]

        def format_chunk(job) -> bytes:
            lo, rows = job
            buf = io.BytesIO()
            if binary:
                raw = rows.astype("<f4")
                for i in range(rows.shape[0]):
                    buf.write(words[lo + i].encode())
                    buf.write(b" ")
                    buf.write(raw[i].tobytes())
                    buf.write(b"\n")
            else:
                for i in range(rows.shape[0]):
                    vec = " ".join(repr(float(x)) for x in rows[i])
                    buf.write(f"{words[lo + i]} {vec}\n".encode())
            return buf.getvalue()

        with open(path, "wb") as f:
            f.write(f"{self.num_words} {self.vector_size}\n".encode())
            for data in ordered_pool_map(format_chunk, jobs(), io_workers):
                f.write(data)

    # -- persistence ---------------------------------------------------------------------

    def save(self, path: str) -> None:
        syn1 = self.syn1
        ckpt.save_model(
            path, self.vocab.words, self.vocab.counts, self.syn0.cpu().numpy(),
            syn1.cpu().numpy() if syn1 is not None else None,
            self.config, self.train_state)

    @classmethod
    def load(cls, path: str, plan=None, verify: bool = True,
             io_workers: Optional[int] = None, device="cuda") -> "Word2VecModel":
        """Load a checkpoint written by either package, in the dense or the
        row-shards layout, onto one device (digests verified unless
        ``verify=False``; ``io_workers`` threads for hashing and reads, default the
        saved config's). The config may carry knobs the port does not train with
        yet; they do not affect the model ops."""
        refuse_plan(plan)
        device = resolve_device(device)
        data = ckpt.load_model(path, verify=verify, check_ported=False,
                               io_workers=io_workers)
        vocab = Vocabulary.from_words_and_counts(data["words"], data["counts"])
        return cls(vocab=vocab, syn0=data["syn0"], syn1=data["syn1"],
                   config=data["config"], train_state=data["train_state"],
                   device=device)

    @classmethod
    def load_latest(cls, directory: str, plan=None, reclaim: bool = False,
                    device="cuda") -> "Word2VecModel":
        """Load the newest checkpoint under ``directory`` that verifies. By default
        nothing in the directory is touched (safe beside a trainer that may still be
        saving; a torn swap's predecessor loads from its ``*.old-*`` path);
        ``reclaim=True``, when the writer is known dead, also cleans up the debris.
        The scan verified the winner, so the load does not hash it again."""
        refuse_plan(plan)
        return cls.load(ckpt.load_latest_valid(directory, reclaim=reclaim),
                        verify=False, device=device)

    def stop(self) -> None:
        """Release the device buffers. Idempotent; every op raises afterwards."""
        self._syn0 = self._syn1 = self._norms = self._ann = None
        self._stopped = True


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
