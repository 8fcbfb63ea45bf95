"""graftcheck over the port, ported from ``tools/graftcheck/``: an executing model
checker over the knob lattice of :class:`glint_word2vec_torch.config.Word2VecConfig`.

It enumerates the 96-knob lattice from a declarative registry and runs each candidate
through four contracts:

(a) construction/dispatch refusal parity — construct the config, then build a real
    ``Trainer`` (on the probe's device) against a fixed probe vocabulary and a
    one-device plan, and assert no combination construction accepted is refused at
    dispatch (refusals that depend on the run-time environment are classified and
    exempt);
(b) serialization fixpoints — ``from_dict(to_dict(c))`` reaches a fixpoint under both
    ``auto_markers`` modes, through a JSON round trip, and AUTO-ness survives;
(c) ``replace()`` re-resolution parity — a knob flip through ``replace()`` equals
    fresh construction from the auto-marker dict with the flip applied;
(d) checkpoint-normalization monotonicity — every documented old-dict normalization
    gives a config that constructs cleanly.

Violations shrink to minimal (≤3-knob) counterexamples. The expected refusal
signatures, the port's ``unported`` refusal of ``use_pallas`` among them, live in this
package's own ``baseline.json``, with a drift gate in both directions. On the fields
the two packages share, the refusals and their normalized messages are the JAX
package's (the port copies its validators). ``python -m
glint_word2vec_torch.graftcheck`` prints exactly one JSON line on stdout; ``--smoke``
runs the thinned lattice, the full sweep executes at least 1,000 configs.
"""
