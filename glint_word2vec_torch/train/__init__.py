"""Subpackage of glint_word2vec_torch; mirrors the layout of glint_word2vec_tpu. It
exports the training supervisor (:mod:`.supervisor`); the trainer, checkpoints and
fault plan are imported from their modules."""

from glint_word2vec_torch.train.supervisor import (
    MITIGATE_ENV,
    PEER_ABORT_EXIT,
    AttemptResult,
    BeaconBoard,
    PeerDeathError,
    SupervisorVerdict,
    TrainingSupervisor,
)

__all__ = [
    "MITIGATE_ENV",
    "PEER_ABORT_EXIT",
    "AttemptResult",
    "BeaconBoard",
    "PeerDeathError",
    "SupervisorVerdict",
    "TrainingSupervisor",
]
