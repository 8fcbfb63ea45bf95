"""graftlint over the port: the repo-invariant static lint of ``tools/graftlint``
carried over to ``glint_word2vec_torch/`` and ``chip_smoke.py``, with each JAX rule
rewritten for its torch counterpart (rules.py; R3 guards what a CUDA graph captures)
and the lock rules bound to the port's :mod:`glint_word2vec_torch.lockcheck`
(concurrency.py). It imports neither jax, the JAX package nor ``tools/``.

Run::

    python -m glint_word2vec_torch.graftlint [--json] [--json-out F]
        [--baseline F | --no-baseline]

It exits 0 when no finding is left unsuppressed and the suppression inventory matches
``baseline.json``; ``--json`` prints the report as one line on stdout, the human summary
goes to stderr.
"""

from glint_word2vec_torch.graftlint.engine import (  # noqa: F401  (public surface)
    Finding, LintReport, check_baseline, lint_repo, lint_text, suppressed_inventory)
from glint_word2vec_torch.graftlint.rules import ALL_RULES  # noqa: F401
