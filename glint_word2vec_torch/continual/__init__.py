"""Continual training, ported from ``glint_word2vec_tpu/continual/``: fits that never
stop, as a train -> publish -> serve loop.

- :mod:`.extend`: vocabulary extension on a checkpoint (identity-prefix growth, seeded
  new rows, per-shard growth for row-shards, the ``vocab_lineage`` chain);
- :mod:`.stream`: the append-only corpus (fingerprinted segments, the persisted
  cursor, the delta encode that reuses cached encodes of old segments);
- :mod:`.loop`: :class:`~glint_word2vec_torch.continual.loop.ContinualRunner`, the
  watch -> extend -> fit -> publish loop, whose atomic publishes the serving tier's
  watcher reloads.

CLI: ``python -m glint_word2vec_torch.continual_run`` (one JSON line; ``--smoke`` is the
end-to-end drill). Extension is host work; the increments' fits run on the card.
"""

from glint_word2vec_torch.continual.extend import (
    VocabDelta,
    compute_vocab_delta,
    extend_checkpoint,
    extended_vocabulary,
    grow_arrays,
    lineage_fingerprints,
    seed_new_rows,
)
from glint_word2vec_torch.continual.loop import ContinualRunner
from glint_word2vec_torch.continual.stream import (
    ConcatCorpus,
    CorpusStream,
    StreamCursor,
    encode_delta,
    segment_fingerprint,
)

__all__ = [
    "VocabDelta",
    "compute_vocab_delta",
    "extended_vocabulary",
    "extend_checkpoint",
    "grow_arrays",
    "seed_new_rows",
    "lineage_fingerprints",
    "ContinualRunner",
    "ConcatCorpus",
    "CorpusStream",
    "StreamCursor",
    "encode_delta",
    "segment_fingerprint",
]
