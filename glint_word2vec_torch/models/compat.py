"""The reference's Spark-style names, setters, defaults and model ops, ported from
``glint_word2vec_tpu/models/compat.py``, so that a user of the reference can port call
sites mechanically:

    w2v = (ServerSideGlintWord2Vec(device="cuda")
           .setVectorSize(100).setWindowSize(5).setNumIterations(3).setSeed(1))
    model = w2v.fit(sentences)            # sentences: list of token lists
    model.findSynonyms("wien", 10)
    model.save(path); ServerSideGlintWord2VecModel.load(path)

The setters map onto :class:`..config.Word2VecConfig` as they do in the JAX package
(``to_config`` gives the same config for the same chain and device count). Differences
by design, as there: there are no parameter servers, so ``setParameterServerHost``/
``setParameterServerConfig`` warn and are ignored; ``setNumParameterServers`` maps to
the model axis's size, capped by the devices the port sees; the reference's Akka
payload cap only warns. The port trains on one device, so a chain whose config lands
on a knob the port refuses (``setNumParameterServers(n)`` with n > 1 on a machine with
several cards) fails at ``fit`` with that knob's ``NotImplementedError``.
"""

from __future__ import annotations

import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.device import resolve_device
from glint_word2vec_torch.models.estimator import Word2Vec
from glint_word2vec_torch.models.word2vec import Word2VecModel

_MAX_MESSAGE_FLOATS = 10_000  # the reference's Akka budget, advisory here


def _device_count(device: torch.device) -> int:
    """The devices of the model axis's kind: the visible cards, or 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


class ServerSideGlintWord2Vec:
    """Builder-style estimator with the reference's knob names and defaults."""

    def __init__(self, device="cuda"):
        self._device = resolve_device(device)
        self._vector_size = 100
        self._learning_rate = 0.01875
        self._num_partitions = 1
        self._num_iterations = 1
        self._min_count = 5
        self._max_sentence_length = 1000
        self._window = 5
        self._batch_size = 50
        self._n = 5
        self._subsample_ratio = 0.0  # reference default 1e-6 behaves as off (no-op bug)
        self._num_parameter_servers = 5
        self._parameter_server_host = ""
        self._parameter_server_config: Dict = {}
        self._unigram_table_size = 100_000_000
        self._seed = 0
        self._device_batch_set = False  # did the user touch batchSize/numPartitions?
        self._input_col = "sentence"
        self._output_col = "vector"

    # -- setters ---------------------------------------------------------------------

    def setVectorSize(self, value: int) -> "ServerSideGlintWord2Vec":
        self._vector_size = int(value)
        return self

    def setLearningRate(self, value: float) -> "ServerSideGlintWord2Vec":
        self._learning_rate = float(value)
        return self

    setStepSize = setLearningRate  # the ML layer's name

    def setNumPartitions(self, value: int) -> "ServerSideGlintWord2Vec":
        self._num_partitions = int(value)
        self._device_batch_set = True
        return self

    def setNumIterations(self, value: int) -> "ServerSideGlintWord2Vec":
        self._num_iterations = int(value)
        return self

    setMaxIter = setNumIterations  # the ML layer's name

    def setSeed(self, value: int) -> "ServerSideGlintWord2Vec":
        self._seed = int(value)
        return self

    def setWindowSize(self, value: int) -> "ServerSideGlintWord2Vec":
        self._window = int(value)
        self._check_payload_constraint()
        return self

    def setMinCount(self, value: int) -> "ServerSideGlintWord2Vec":
        self._min_count = int(value)
        return self

    def setMaxSentenceLength(self, value: int) -> "ServerSideGlintWord2Vec":
        self._max_sentence_length = int(value)
        return self

    def setBatchSize(self, value: int) -> "ServerSideGlintWord2Vec":
        self._batch_size = int(value)
        self._device_batch_set = True
        self._check_payload_constraint()
        return self

    def setN(self, value: int) -> "ServerSideGlintWord2Vec":
        self._n = int(value)
        self._check_payload_constraint()
        return self

    def setSubsampleRatio(self, value: float) -> "ServerSideGlintWord2Vec":
        if value > 0:
            warnings.warn(
                "the reference's subsampling is a silent no-op at ANY setting "
                "(Int/Long division bug, see data/pipeline.py) — here "
                f"setSubsampleRatio({value}) actually subsamples, so results "
                "will differ from a reference run with the same setting; pass "
                "0.0 for behavior-faithful (no-op) parity", stacklevel=2)
        self._subsample_ratio = float(value)
        return self

    def setNumParameterServers(self, value: int) -> "ServerSideGlintWord2Vec":
        self._num_parameter_servers = int(value)
        return self

    def setParameterServerHost(self, value: str) -> "ServerSideGlintWord2Vec":
        if value:
            warnings.warn("parameterServerHost is ignored: there are no parameter "
                          "servers (the model lives on the device)", stacklevel=2)
        self._parameter_server_host = value
        return self

    def setParameterServerConfig(self, value: Dict) -> "ServerSideGlintWord2Vec":
        if value:
            warnings.warn("parameterServerConfig is ignored: there is no Akka "
                          "transport to configure", stacklevel=2)
        self._parameter_server_config = dict(value)
        return self

    def setUnigramTableSize(self, value: int) -> "ServerSideGlintWord2Vec":
        self._unigram_table_size = int(value)
        return self

    def setInputCol(self, value: str) -> "ServerSideGlintWord2Vec":
        self._input_col = value
        return self

    def setOutputCol(self, value: str) -> "ServerSideGlintWord2Vec":
        self._output_col = value
        return self

    def _check_payload_constraint(self) -> None:
        # the reference errors here because Akka caps payloads; with no RPC the
        # combination is legal, so parity stops at a warning
        if self._batch_size * self._n * self._window > _MAX_MESSAGE_FLOATS:
            warnings.warn(
                f"batchSize*n*window = {self._batch_size * self._n * self._window} "
                f"> {_MAX_MESSAGE_FLOATS} would be rejected by the reference (Akka "
                "payload cap); harmless here", stacklevel=3)

    # -- fit ---------------------------------------------------------------------------

    def to_config(self) -> Word2VecConfig:
        """The config of this chain, as the JAX package maps it. Knobs the port does
        not train with are kept (refused at :meth:`fit`), so the config is the JAX
        package's at the same device count."""
        kwargs = {}
        if self._device_batch_set:
            # the reference trains batchSize pairs per partition, numPartitions
            # partitions at once: the faithful device batch is their product
            pairs = max(self._batch_size * self._num_partitions, 1)
            kwargs["pairs_per_batch"] = pairs
            if pairs < 1024:
                warnings.warn(
                    f"batchSize*numPartitions = {pairs} maps to pairs_per_batch={pairs}"
                    ": tiny device batches waste the device (default 8192); this "
                    "mapping is faithful to the reference semantics, not fast",
                    stacklevel=2)
        return Word2VecConfig(
            vector_size=self._vector_size,
            learning_rate=self._learning_rate,
            num_partitions=self._num_partitions,
            num_iterations=self._num_iterations,
            min_count=self._min_count,
            max_sentence_length=self._max_sentence_length,
            window=self._window,
            batch_size=self._batch_size,
            negatives=self._n,
            subsample_ratio=self._subsample_ratio,
            # drop-in parity: the reference runs any of these configs, so the compat
            # surface warns instead of refusing the duplicate-overload region
            allow_unstable=True,
            # the reference samples n negatives per pair: the per-pair path
            negative_pool=0,
            num_model_shards=min(self._num_parameter_servers,
                                 _device_count(self._device)),
            unigram_table_size=self._unigram_table_size,
            seed=self._seed,
            check_ported=False,
            **kwargs,
        )

    def fit(self, sentences: Iterable[Sequence[str]]) -> "ServerSideGlintWord2VecModel":
        """sentences: token sequences, or dicts holding one under inputCol."""
        sentences = [s[self._input_col] if isinstance(s, dict) else s for s in sentences]
        config = self.to_config()
        config._refuse_unported()
        model = Word2Vec(config, device=self._device).fit(sentences)
        return ServerSideGlintWord2VecModel(model, self._input_col, self._output_col)


class ServerSideGlintWord2VecModel:
    """Model wrapper with the reference's op names."""

    def __init__(self, model: Word2VecModel, input_col: str = "sentence",
                 output_col: str = "vector"):
        self._model = model
        self._input_col = input_col
        self._output_col = output_col

    @property
    def inner(self) -> Word2VecModel:
        return self._model

    def getVectors(self) -> Dict[str, np.ndarray]:
        return self._model.get_vectors()

    def transform(self, data):
        """Word -> vector for a string; sentence-average vectors for sequences or
        dicts of tokens; a vector per word for a flat iterable of words."""
        if isinstance(data, str):
            return self._model.transform(data)
        rows = list(data)
        if rows and isinstance(rows[0], dict):
            vecs = self._model.transform_sentences([r[self._input_col] for r in rows])
            return [{**r, self._output_col: vecs[i]} for i, r in enumerate(rows)]
        if rows and isinstance(rows[0], (list, tuple)):
            return self._model.transform_sentences(rows)
        return list(self._model.transform_words(rows))

    def findSynonyms(self, query, num: int) -> List[Tuple[str, float]]:
        return self._model.find_synonyms(query, num)

    findSynonymsArray = findSynonyms

    def analogy(self, a: str, b: str, c: str, num: int = 10):
        return self._model.analogy(a, b, c, num)

    def toLocal(self) -> Tuple[List[str], np.ndarray]:
        return self._model.to_local()

    def save(self, path: str) -> None:
        self._model.save(path)

    @classmethod
    def load(cls, path: str, parameterServerHost: str = "",
             parameterServerConfig: Optional[Dict] = None,
             device="cuda") -> "ServerSideGlintWord2VecModel":
        """Signature parity with the reference's load overloads; the parameter-server
        arguments are accepted and ignored."""
        if parameterServerHost or parameterServerConfig:
            warnings.warn("parameter-server arguments are ignored on load", stacklevel=2)
        return cls(Word2VecModel.load(path, device=device))

    def stop(self, terminateOtherClients: bool = False) -> None:
        del terminateOtherClients  # signature parity
        self._model.stop()
