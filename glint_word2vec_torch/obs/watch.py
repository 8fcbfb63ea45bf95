"""Finite-blowup watchdog, ported from ``glint_word2vec_tpu/obs/watch.py``.

The non-finite guard fires only once the parameters reach NaN or infinity, and the
measured large-vocabulary collapse never does: purity falls 0.99 -> 0.14 through a
finite norm blowup. This watchdog reads the health probe's channels (:mod:`.probe`) at
the heartbeat cadence and fires, per matrix, on either signature:

- ``frac_over``: the fraction of rows past ``norm_watch_threshold`` reaches
  ``norm_watch_frac``;
- ``max_norm``: one row reaches ``norm_watch_max``.

Policies (``config.norm_watch``): ``warn`` logs (the trainer also emits a telemetry
record per firing); ``recover`` returns the reason to the trainer, which runs the
recovery ladder (snapshot rollback, lr backoff, ``max_row_norm`` engaged, under
``max_recoveries``); ``halt`` raises :class:`NormBlowupError`. The reasons and
diagnostics are the JAX package's strings.
"""

from __future__ import annotations

import logging
from typing import Optional

from glint_word2vec_torch.train.faults import NormBlowupError

logger = logging.getLogger("glint_word2vec_torch")


class NormWatchdog:
    """Stateful checker over successive probe channel dicts (one trainer)."""

    def __init__(self, policy: str, threshold: float, max_norm: float, frac: float):
        if policy not in ("off", "warn", "recover", "halt"):
            raise ValueError(f"norm_watch policy must be 'off', 'warn', 'recover', or "
                             f"'halt' but got {policy!r}")
        self.policy = policy
        self.threshold = threshold
        self.max_norm = max_norm
        self.frac = frac
        self.fires = 0
        self.last_reason: Optional[str] = None

    def would_fire(self, channels: dict) -> Optional[str]:
        """The firing reason for one channel dict, or None; touches no state and
        applies no policy (the trainer also asks it to keep a flagged state out of the
        snapshot ring)."""
        reasons = []
        for name in ("syn0", "syn1"):
            ch = channels.get(name) or {}
            mx = ch.get("max_norm", 0.0)
            fo = ch.get("frac_over", 0.0)
            if fo >= self.frac:
                reasons.append(f"{name}: {fo:.2%} of rows exceed norm "
                               f"{self.threshold:g} (limit {self.frac:.2%})")
            if mx >= self.max_norm:
                reasons.append(f"{name}: max row norm {mx:.3g} >= {self.max_norm:g}")
        return "; ".join(reasons) if reasons else None

    def check(self, channels: dict, step: int) -> Optional[str]:
        """Evaluate one probe result: the firing reason (also :attr:`last_reason`) or
        None; raises under ``halt``."""
        if self.policy == "off":
            return None
        reason = self.would_fire(channels)
        if reason is None:
            return None
        self.fires += 1
        self.last_reason = reason
        diag = (
            f"finite norm blowup at global step {step}: {reason}. This is the measured "
            f"large-vocab collapse channel (EVAL.md round-5 ladder: purity 0.99 -> 0.14 "
            f"with NO NaN, so nonfinite_policy never fires). Measured mitigations, in "
            f"order: grow negative_pool (keep load B*n/P <= ~160 at large vocab), lower "
            f"subsample_ratio (~1e-4), lower the learning rate, or "
            f"duplicate_scaling=True")
        if self.policy == "halt":
            raise NormBlowupError(diag)
        if self.policy == "recover":
            logger.warning("norm watchdog (firing %d) at step %d: %s — recovering",
                           self.fires, step, reason)
            return reason
        if self.fires == 1:
            logger.warning("norm watchdog: %s", diag)
        else:
            logger.warning("norm watchdog (firing %d) at step %d: %s", self.fires,
                           step, reason)
        return reason
