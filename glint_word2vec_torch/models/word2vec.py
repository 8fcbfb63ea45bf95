"""Word2Vec model ops, ported from ``glint_word2vec_tpu/models/word2vec.py``: word and
sentence transforms, ``pull``, ``norms``, ``multiply``, ``find_synonyms`` (the exact
arm), ``analogy``, the exports (``get_vectors``, ``iter_vectors``, ``to_local``,
``export_word2vec`` in word2vec.c's text and binary formats), ``save``, ``load`` of
either checkpoint layout, ``load_latest`` and ``stop``, and the serving tier's entry to
an IVF index (``attach_ann``, ``find_synonyms_batch(ann=True)``; the index lives on the
host, :mod:`..serve.ann`). Every op runs on the model's device (the card unless
``device="cpu"``); after ``stop`` each raises.

A mesh fit (``Word2Vec(...).fit(plan=...)``) ends on every rank with a
:class:`ShardedWord2VecModel`: the rank's row blocks, with the same ops, each a
collective every rank calls; its rows are never gathered unasked.
``Word2VecModel.load(path, plan=)`` places a checkpoint of either layout on a mesh the
same way, reading each rank's rows from the files (never the dense matrix).

The cosine scores are one matrix product on the device (the JAX package leaves it to
XLA; here it is ``torch.matmul``). The top-k keeps ``lax.top_k``'s order, which
``torch.topk`` does not promise: descending score, and among equal scores the lowest
row index first. Word queries exclude the query word itself; vector queries do not.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import ordered_pool_map
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.train import checkpoint as ckpt


def refuse_plan(plan) -> None:
    """A fit's or a resume's ``plan``: None (the config's mesh, one device by default)
    or a :class:`..parallel.mesh.MeshPlan` of the port."""
    from glint_word2vec_torch.parallel.mesh import MeshPlan

    if plan is not None and not isinstance(plan, MeshPlan):
        raise TypeError(f"plan must be a glint_word2vec_torch MeshPlan "
                        f"(parallel.mesh.make_mesh) or None, got {type(plan).__name__}")


class ShardedWord2VecModel:
    """A model on a mesh of ranks: the vocabulary, config, train state and this rank's
    padded row blocks (``params``: [Vs, Dp] each, ``Vs = Vp / num_model``; syn1 may be
    None) on ``plan``. What a mesh fit leaves on every rank (a column fit's model
    relaid to row blocks), and what :meth:`Word2VecModel.load` places on a mesh.

    The model ops are the JAX model's on its ``plan.embedding`` arrays, each a
    collective that every rank of the mesh calls with the same arguments (arguments are
    checked before the first collective, so a bad query raises on every rank alike);
    the data replicas of a row block compute over the model axis only, and each op
    returns the same answer on every rank:

    - ``pull``, ``transform``, ``transform_words``, ``transform_sentences``,
      ``iter_vectors``: the owning ranks' rows, one all_gather of the zero-filled
      blocks over the model axis a batch (each row taken from its owner: the bits are
      the checkpoint's);
    - ``norms`` (cached), ``multiply``: each rank's rows, one all_gather;
    - ``find_synonyms``, ``find_synonyms_batch`` (the exact arm): each rank takes the
      cosine over its rows, padded rows at −inf, keeps its top k, and one all_gather of
      (score, global index) pairs a chunk feeds the merge, a stable descending sort in
      rank order, so equal scores keep ``lax.top_k``'s lower index first; ``analogy``;
    - ``get_vectors``, ``to_local``, ``syn0``/``syn1`` (the dense [V, D] matrices on
      this rank's device): one all_gather a matrix, asked for by name;
    - ``export_word2vec``: rank 0 writes, streaming ``batch_size`` rows at a time
      gathered over the model axis, never the whole matrix at once;
    - ``save`` (a row-shards checkpoint, each rank writing its own rows), ``gather``
      (the explicit gather to a :class:`Word2VecModel`) and ``stop``.

    ``attach_ann`` keeps a host index on this rank; ``find_synonyms_batch(ann=True)``
    probes it with no collective (the serving tier builds it on rank 0)."""

    def __init__(self, vocab: Vocabulary, params, config: Word2VecConfig,
                 train_state: Optional[ckpt.TrainState], plan, device):
        self.vocab, self.params, self.config = vocab, params, config
        self.train_state, self.plan, self.device = train_state, plan, device
        self._dim = int(config.vector_size)
        self._vs = int(params[0].shape[0])
        self._lo = plan.model_index * self._vs
        self._norms: Optional[torch.Tensor] = None
        self._ann = None
        self._stopped = False

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

    def _block(self, i: int = 0) -> torch.Tensor:
        """This rank's real columns [Vs, D] of syn0 (``i=0``) or syn1, float32."""
        self._check_alive()
        return self.params[i][:, :self._dim].float()

    def _gather_model(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of every rank of this rank's model axis, stacked in rank order
        [num_model, ...] (one all_gather)."""
        from glint_word2vec_torch.parallel.distributed import COLLECTIVES
        from glint_word2vec_torch.parallel.mesh import MODEL_AXIS

        if self.plan.num_model == 1:
            return t[None]
        return COLLECTIVES.all_gather(t[None], self.plan.model_group, MODEL_AXIS)

    def _checked_indices(self, indices) -> np.ndarray:
        """Global row indices as int64, negatives counted from the end as a tensor
        index counts them; out of range raises IndexError before any collective."""
        idx = np.asarray(indices, np.int64).reshape(-1)
        V = self.vocab.size
        idx = np.where(idx < 0, idx + V, idx)
        if idx.size and (idx.min() < 0 or idx.max() >= V):
            raise IndexError(f"row index out of range for {V} rows")
        return idx

    def _rows(self, idx: np.ndarray, i: int = 0) -> torch.Tensor:
        """The rows ``idx`` (global, checked) of syn0 or syn1, [n, D] float32 on this
        rank's device: each rank contributes the rows it owns, zeros elsewhere, and each
        row is taken from its owner's part (bit for bit)."""
        blk = self._block(i)
        t = torch.as_tensor(idx, device=self.device)
        loc = t - self._lo
        own = (loc >= 0) & (loc < self._vs)
        mine = torch.where(own[:, None], blk[torch.where(own, loc, 0)],
                           torch.zeros((), dtype=blk.dtype, device=blk.device))
        every = self._gather_model(mine)                              # [M, n, D]
        return every[t // self._vs, torch.arange(t.shape[0], device=self.device)]

    @property
    def syn0(self) -> torch.Tensor:
        """The dense input embeddings [V, D] on this rank's device (one all_gather)."""
        return self._gather_model(self._block(0)).reshape(-1, self._dim)[:self.num_words]

    @property
    def syn1(self) -> Optional[torch.Tensor]:
        if self.params[1] is None:
            return None
        return self._gather_model(self._block(1)).reshape(-1, self._dim)[:self.num_words]

    # -- transform -----------------------------------------------------------------------

    def transform(self, word: str) -> np.ndarray:
        """Vector of a single word; raises KeyError on OOV."""
        return self.pull([self._index(word)])[0]

    def transform_words(self, words: Iterable[str], batch_size: int = 10_000
                        ) -> Iterator[np.ndarray]:
        """Batched word -> vector stream (one gather per ``batch_size`` words)."""
        self._check_alive()
        buf: List[int] = []
        for w in words:
            buf.append(self._index(w))
            if len(buf) >= batch_size:
                yield from self.pull(buf)
                buf = []
        if buf:
            yield from self.pull(buf)

    def transform_sentences(self, sentences: Sequence[Sequence[str]],
                            batch_size: int = 10_000) -> np.ndarray:
        """Sentence -> mean of its in-vocabulary word vectors, float32 [S, D], as
        :meth:`Word2VecModel.transform_sentences` computes it from the gathered rows
        (one gather a batch of ``batch_size`` sentences)."""
        self._check_alive()
        out = np.zeros((len(sentences), self.vector_size), dtype=np.float32)
        for lo in range(0, len(sentences), batch_size):
            part = sentences[lo:lo + batch_size]
            flat, seg = _sentence_indices(self.vocab, part)
            if not flat:
                continue
            rows = self._rows(np.asarray(flat, np.int64))
            out[lo:lo + len(part)] = _segment_means(rows, seg, len(part), self.device)
        return out

    # -- pull / norms / multiply -----------------------------------------------------------

    def pull(self, indices: Sequence[int]) -> np.ndarray:
        """Rows by index (the parameter server's ``pull``)."""
        return self._rows(self._checked_indices(indices)).cpu().numpy()

    def _norms_all(self) -> torch.Tensor:
        """Every row's norm [Vp] (padded rows 0), computed once and cached."""
        if self._norms is None:
            self._norms = self._gather_model(
                torch.linalg.vector_norm(self._block(0), dim=1)).reshape(-1)
        return self._norms

    @property
    def norms(self) -> torch.Tensor:
        """Per-row Euclidean norms [V], computed once and cached."""
        self._check_alive()
        return self._norms_all()[:self.num_words]

    def multiply(self, vector: np.ndarray) -> np.ndarray:
        """syn0 @ v: each rank's rows, gathered over the model axis."""
        v = torch.as_tensor(np.asarray(vector, np.float32), device=self.device)
        return self._gather_model(self._block(0) @ v).reshape(-1)[
            :self.num_words].cpu().numpy()

    # -- ANN index attach -----------------------------------------------------------------

    def attach_ann(self, index) -> None:
        """:meth:`Word2VecModel.attach_ann` on this rank (a host index)."""
        self._check_alive()
        if index is not None:
            rows = getattr(index, "num_rows", None)
            if rows is not None and int(rows) != self.vocab.size:
                raise ValueError(
                    f"ANN index covers {rows} rows but the vocabulary has "
                    f"{self.vocab.size} words — a stale index from a "
                    f"previous publish (the vocabulary grew?); rebuild it")
        self._ann = index

    @property
    def ann(self):
        return self._ann

    # -- synonym / analogy search -----------------------------------------------------------

    def find_synonyms(self, query: Union[str, np.ndarray], num: int
                      ) -> List[Tuple[str, float]]:
        """Top-``num`` cosine-similar words. A word query excludes itself."""
        return self.find_synonyms_batch([query], num)[0]

    find_synonyms_array = find_synonyms

    def find_synonyms_batch(
        self,
        queries: Sequence[Union[str, np.ndarray]],
        num: int,
        chunk: int = 128,
        ann: bool = False,
        nprobe: Optional[int] = None,
    ) -> List[List[Tuple[str, float]]]:
        """:meth:`Word2VecModel.find_synonyms_batch` over the row blocks: per chunk of
        queries one gather of the word queries' rows, the local cosine top-k on each
        rank and one all_gather of the candidates (the class docstring has the merge).
        ``ann=True`` probes the attached host index, as on one device."""
        self._check_alive()
        if ann:
            if self._ann is None:
                raise RuntimeError("ann=True but no index attached — build one and "
                                   "model.attach_ann(index)")
            return Word2VecModel._find_synonyms_batch_ann(self, queries, num, nprobe)
        ids = [self._index(q) if isinstance(q, str) else None for q in queries]
        norms = self._norms_all()
        k = min(num + 1, self.num_words)
        out: List[List[Tuple[str, float]]] = []
        for lo in range(0, len(queries), chunk):
            part, pids = queries[lo:lo + chunk], ids[lo:lo + chunk]
            words = [q if isinstance(q, str) else None for q in part]
            widx = [i for i in pids if i is not None]
            wrows = iter(self._rows(np.asarray(widx, np.int64)) if widx else ())
            rows = [next(wrows) if i is not None
                    else torch.as_tensor(np.asarray(q, np.float32), device=self.device)
                    for q, i in zip(part, pids)]
            scores, idxs = self._topk(torch.stack(rows), norms, k)
            for word, srow, irow in zip(words, scores.tolist(), idxs.tolist()):
                res = [(self.vocab.words[i], s) for i, s in zip(irow, srow)
                       if self.vocab.words[i] != word]
                out.append(res[:num])
        return out

    def _topk(self, queries: torch.Tensor, norms: torch.Tensor, k: int):
        """The cosine top-k of a [Q, D] query block over every rank's rows: each rank's
        :func:`cosine_topk` of its own rows (padded rows at −inf), one all_gather of
        the [Q, k'] candidates, and a stable descending sort of them in rank order."""
        blk = self._block(0)
        mine = norms[self._lo:self._lo + self._vs]
        kl = min(k, self._vs)
        valid = self.num_words - self._lo  # this rank's real rows
        scores, idxs = cosine_topk(blk, mine, queries, kl, valid_rows=valid)
        # float64 holds both the f32 scores and the indices exactly
        both = torch.stack([scores.double(), (idxs + self._lo).double()])  # [2, Q, k']
        every = self._gather_model(both)                                 # [M, 2, Q, k']
        cand = every.permute(1, 2, 0, 3).reshape(2, queries.shape[0], -1)
        order = torch.sort(cand[0], dim=1, descending=True, stable=True).indices[:, :k]
        return (torch.gather(cand[0], 1, order).to(scores.dtype),
                torch.gather(cand[1], 1, order).to(torch.int64))

    def analogy(self, a: str, b: str, c: str, num: int = 10) -> List[Tuple[str, float]]:
        """b − a + c, excluding the three query words."""
        va, vb, vc = self.transform(a), self.transform(b), self.transform(c)
        res = self.find_synonyms(vb - va + vc, num + 3)
        return [(w, s) for w, s in res if w not in (a, b, c)][:num]

    # -- exports ----------------------------------------------------------------------------

    def get_vectors(self) -> Dict[str, np.ndarray]:
        """word -> vector for the whole vocabulary, on the host."""
        mat = self.syn0.cpu().numpy()
        return {w: mat[i] for i, w in enumerate(self.vocab.words)}

    def iter_vectors(self, batch_size: int = 10_000
                     ) -> Iterator[Tuple[str, np.ndarray]]:
        """(word, vector) pairs in row order, ``batch_size`` rows gathered at a time."""
        self._check_alive()
        for start in range(0, self.num_words, batch_size):
            stop = min(start + batch_size, self.num_words)
            block = self._rows(np.arange(start, stop, dtype=np.int64)).cpu().numpy()
            for i in range(stop - start):
                yield self.vocab.words[start + i], block[i]

    def to_local(self) -> Tuple[List[str], np.ndarray]:
        """(words, matrix) on the host."""
        return list(self.vocab.words), self.syn0.cpu().numpy()

    def export_word2vec(self, path: str, binary: bool = False, batch_size: int = 65536,
                        io_workers: Optional[int] = None) -> None:
        """:meth:`Word2VecModel.export_word2vec`, the same bytes: every rank gathers
        the ``batch_size``-row blocks in order, and rank 0 formats and writes them."""
        self._check_alive()

        def fetch(start: int, stop: int) -> np.ndarray:
            return self._rows(np.arange(start, stop, dtype=np.int64)).cpu().numpy()

        _write_word2vec(path, self.vocab.words, self.vector_size, fetch, binary,
                        batch_size, self.config.io_workers if io_workers is None
                        else io_workers, write=self.plan.rank == 0)

    # -- persistence ------------------------------------------------------------------------

    def save(self, path: str) -> None:
        """A row-shards checkpoint, each rank writing its own rows."""
        self._check_alive()
        ckpt.save_model_sharded(
            path, self.vocab.words, self.vocab.counts, self.params[0], self.params[1],
            self.config, self.train_state, plan=self.plan, vocab_size=self.vocab.size,
            vector_size=self.config.vector_size)

    def gather(self) -> "Word2VecModel":
        """Every rank's rows gathered over the model axis (one all_gather a matrix);
        the dense model on this rank's device."""
        return Word2VecModel(self.vocab, self.syn0, self.syn1, self.config,
                             self.train_state, device=self.device)

    def stop(self) -> None:
        """Release the row blocks. Idempotent; every op raises afterwards."""
        self.params = (None, None)
        self._norms = self._ann = None
        self._stopped = True

    @classmethod
    def load(cls, path: str, plan, verify: bool = True,
             io_workers: Optional[int] = None, device="cuda") -> "ShardedWord2VecModel":
        """This rank's row blocks of a checkpoint of either layout, on ``plan``
        (a mesh other than the writer's too): a row-shards checkpoint streams the
        block's rows from its memory-mapped shard files
        (:func:`..train.checkpoint.load_params_into_plan`), a dense one reads them from
        its memory-mapped matrices (:func:`..train.checkpoint
        .load_dense_rows_into_plan`); neither reads the whole matrix, and neither runs
        the dense :func:`..train.checkpoint.load_model`. Every rank reads its own rows
        (``verify``: each checks the digests); no collective."""
        from glint_word2vec_torch.parallel.mesh import pad_vocab_for_sharding

        device = resolve_device(device)
        header = ckpt.load_model_header(path, check_ported=False)
        vocab = Vocabulary.from_words_and_counts(header["words"], header["counts"])
        Vp = pad_vocab_for_sharding(vocab.size, plan.num_model)
        if header["layout"] == "row-shards":
            params = ckpt.load_params_into_plan(
                path, plan, Vp, header["vector_size"], verify=verify,
                io_workers=io_workers, device=device)
        else:
            params = ckpt.load_dense_rows_into_plan(path, plan, Vp, verify=verify,
                                                    io_workers=io_workers, device=device)
        return cls(vocab, params, header["config"], header["train_state"], plan, device)


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
            part = sentences[lo:lo + batch_size]
            flat, seg = _sentence_indices(self.vocab, part)
            if not flat:
                continue
            idx = torch.as_tensor(flat, dtype=torch.int64, device=self.device)
            out[lo:lo + len(part)] = _segment_means(syn0[idx], seg, len(part),
                                                    self.device)
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
        _write_word2vec(path, self.vocab.words, self.vector_size,
                        lambda start, stop: self.syn0[start:stop].cpu().numpy(), binary,
                        batch_size, self.config.io_workers if io_workers is None
                        else io_workers)

    # -- persistence ---------------------------------------------------------------------

    def save(self, path: str) -> None:
        syn1 = self.syn1
        ckpt.save_model(
            path, self.vocab.words, self.vocab.counts, self.syn0.cpu().numpy(),
            syn1.cpu().numpy() if syn1 is not None else None,
            self.config, self.train_state)

    @classmethod
    def load(cls, path: str, plan=None, verify: bool = True,
             io_workers: Optional[int] = None, device="cuda"):
        """Load a checkpoint written by either package, in the dense or the
        row-shards layout, onto one device (digests verified unless
        ``verify=False``; ``io_workers`` threads for hashing and reads, default the
        saved config's). The config may carry knobs the port does not train with
        yet; they do not affect the model ops. ``plan`` (a :class:`..parallel.mesh
        .MeshPlan` of several ranks; every rank calls ``load`` alike) places it on the
        mesh instead: a :class:`ShardedWord2VecModel` of this rank's rows, read from
        the files, on any mesh shape (:meth:`ShardedWord2VecModel.load`); a plan of one
        rank loads onto the one device."""
        refuse_plan(plan)
        if plan is not None and plan.size > 1:
            return ShardedWord2VecModel.load(path, plan, verify=verify,
                                             io_workers=io_workers, device=device)
        device = resolve_device(device)
        header = ckpt.load_model_header(path, check_ported=False)
        # the vocabulary's index (Python, ~0.3 s at 1M words) builds while the
        # matrices are read and hashed (hashlib lets go of the GIL)
        with ThreadPoolExecutor(1) as pool:
            vocab = pool.submit(Vocabulary.from_words_and_counts, header["words"],
                                header["counts"])
            data = ckpt.load_model(path, header=header, verify=verify,
                                   io_workers=io_workers, device=device)
            vocab = vocab.result()
        return cls(vocab=vocab, syn0=data["syn0"], syn1=data["syn1"],
                   config=data["config"], train_state=data["train_state"],
                   device=device)

    @classmethod
    def load_latest(cls, directory: str, plan=None, reclaim: bool = False,
                    device="cuda"):
        """Load the newest checkpoint under ``directory`` that verifies. By default
        nothing in the directory is touched (safe beside a trainer that may still be
        saving; a torn swap's predecessor loads from its ``*.old-*`` path);
        ``reclaim=True``, when the writer is known dead, also cleans up the debris.
        The scan verified the winner, so the load does not hash it again. ``plan``: as
        in :meth:`load`; rank 0 scans and broadcasts its choice over the world, so
        every rank loads the same checkpoint."""
        refuse_plan(plan)
        if plan is not None and plan.size > 1:
            from glint_word2vec_torch.parallel import distributed

            path = (ckpt.load_latest_valid(directory, reclaim=reclaim)
                    if plan.rank == 0 else None)
            path = distributed.COLLECTIVES.broadcast_object(
                path, distributed.host_group())
            return cls.load(path, plan=plan, verify=False, device=device)
        return cls.load(ckpt.load_latest_valid(directory, reclaim=reclaim),
                        verify=False, device=device)

    def stop(self) -> None:
        """Release the device buffers. Idempotent; every op raises afterwards."""
        self._syn0 = self._syn1 = self._norms = self._ann = None
        self._stopped = True


def cosine_topk(syn0: torch.Tensor, norms: torch.Tensor, queries: torch.Tensor,
                k: int, valid_rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cosine(rows, q) top-k for a [Q, D] query block: queries normalized, zero-norm
    rows score 0, ties broken toward the lowest row index (a stable descending
    sort, which is ``lax.top_k``'s order). ``valid_rows``: rows from this one on are
    padding, scored −inf (the JAX model's mask of its sharding padding)."""
    q = queries / torch.clamp(torch.linalg.vector_norm(queries, dim=1, keepdim=True),
                              min=1e-12)
    dots = q @ syn0.T                                                  # [Q, V]
    cos = torch.where(norms[None, :] > 0,
                      dots / torch.clamp(norms[None, :], min=1e-12),
                      torch.zeros((), dtype=dots.dtype, device=dots.device))
    if valid_rows is not None and valid_rows < cos.shape[1]:
        pad = torch.arange(cos.shape[1], device=cos.device) >= valid_rows
        cos = cos.masked_fill(pad[None, :], float("-inf"))
    scores, idxs = torch.sort(cos, dim=1, descending=True, stable=True)
    return scores[:, :k], idxs[:, :k]


def _sentence_indices(vocab: Vocabulary, part: Sequence[Sequence[str]]):
    """The in-vocabulary word ids of a batch of sentences, flattened, and each one's
    sentence within the batch."""
    flat: List[int] = []
    seg: List[int] = []
    for local, sent in enumerate(part):
        for w in sent:
            i = vocab.get(w)
            if i >= 0:
                flat.append(i)
                seg.append(local)
    return flat, seg


def _segment_means(rows: torch.Tensor, seg: List[int], n: int, device) -> np.ndarray:
    """Each of ``n`` sentences' mean of its ``rows`` ([len(seg), D] float32): one
    ``index_add_`` of the rows and one count, on the host as [n, D]."""
    seg_t = torch.as_tensor(seg, dtype=torch.int64, device=device)
    sums = torch.zeros((n, rows.shape[1]), dtype=torch.float32,
                       device=device).index_add_(0, seg_t, rows)
    counts = torch.bincount(seg_t, minlength=n).to(torch.float32)
    return (sums / torch.clamp(counts, min=1.0)[:, None]).cpu().numpy()


def _write_word2vec(path: str, words: Sequence[str], dim: int, fetch, binary: bool,
                    batch_size: int, io_workers: int, write: bool = True) -> None:
    """word2vec.c's vectors file from ``fetch(start, stop)`` (the host rows [start,
    stop), called ``batch_size`` rows at a time in order on the calling thread): the
    header, then each word's row as text or little-endian float32, formatted in
    ~4k-row sub-chunks on ``io_workers`` threads and written in order. ``write=False``
    fetches every block and writes nothing (a rank of a mesh that is not the writer
    still takes part in the gathers)."""
    V = len(words)
    sub = max(1, min(batch_size, 4096))
    if not write:
        for start in range(0, V, batch_size):
            fetch(start, min(start + batch_size, V))
        return

    def jobs():
        for start in range(0, V, batch_size):
            stop = min(start + batch_size, V)
            block = fetch(start, stop)
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
        f.write(f"{V} {dim}\n".encode())
        for data in ordered_pool_map(format_chunk, jobs(), io_workers):
            f.write(data)
