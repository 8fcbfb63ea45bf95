"""Greedy counterexample minimization (ddmin over the non-default knob set), ported
from ``tools/graftcheck/shrink.py`` as it stands.

``predicate(kwargs) -> Optional[str]`` returns the finding key a candidate
reproduces (or None); shrinking drops knobs while the SAME key reproduces —
dropping to a *different* refusal is not the same counterexample. Knobs are
tried in sorted order and passes repeat to a fixpoint, so the result is
deterministic and minimal w.r.t. single-knob removal (the refusal matrices
are conjunctions over ≤3 knobs, where 1-minimality IS global minimality)."""

from __future__ import annotations

from typing import Callable, Dict, Optional


def shrink(kwargs: Dict, predicate: Callable[[Dict], Optional[str]],
           target_key: str, max_passes: int = 5) -> Dict:
    cur = dict(kwargs)
    for _ in range(max_passes):
        changed = False
        for name in sorted(cur):
            trial = {k: v for k, v in cur.items() if k != name}
            if predicate(trial) == target_key:
                cur = trial
                changed = True
        if not changed:
            break
    return cur
