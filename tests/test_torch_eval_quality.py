"""The port's quality harness (``python -m glint_word2vec_torch.eval_quality``) against
the JAX package's tool (``tools/eval_quality.py``, imported as
``tests/test_eval_harness.py`` imports it).

The generator writes the same bytes; the cases of ``tests/test_eval_harness.py`` hold
for the port's scorers; on the same seeded embeddings the port's ``evaluate``,
``evaluate_analogies`` and ``_evaluate_analogies_v1`` (torch, on the CPU here) give the
JAX scorers' purity@10 and analogy accuracies, their margins and mean cosines within
1e-5 (compared unrounded), and the same serving-index channels; a tiny end-to-end run
of the harness writes its row to ``--runs-out`` and leaves the repo's
``EVAL_RUNS.jsonl`` as it was; the A/Bs the port cannot run yet are refused by name."""

import hashlib
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from glint_word2vec_torch import eval_quality as tq

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import eval_quality as eq  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5  # margins and mean cosines: f32 sums of up to 8M products in two orders


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("seed,v_raw", [(3, 2000), (42, eq.V_RAW)])
def test_generator_writes_the_same_bytes(tmp_path, seed, v_raw):
    a, b = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    eq.generate_corpus(a, 300_000, seed, v_raw)
    tq.generate_corpus(b, 300_000, seed, v_raw)
    assert os.path.getsize(a) > 1_000_000
    assert _sha(a) == _sha(b)


def test_constants_match():
    for name in ("T_TOPICS", "STOPWORDS", "LAMBDA", "SENT_LEN", "V_RAW", "GEN_VERSION",
                 "REL_SENT_FRAC", "FAMILIES", "ROLE_WORDS", "REL_LAMBDA_ENTITY",
                 "REL_LAMBDA_ROLE", "N_ENTITIES"):
        assert getattr(tq, name) == getattr(eq, name), name
    assert list(tq.word_names(500)) == list(eq.word_names(500))
    assert tq.relation_names() == eq.relation_names()
    assert tq.family_names() == eq.family_names()


# -- the cases of tests/test_eval_harness.py, on the port -------------------------------


def _index_for(fams):
    words = []
    for f in fams:
        words.extend(f["a"])
        words.extend(f["b"])
    return {w: i for i, w in enumerate(words)}


def _relational(rng, index, fams, D, noise=0.0):
    """b = a + the family's offset (a tiny per-b jitter), plus ``noise``."""
    emb = np.zeros((len(index), D), np.float32)
    for f in fams:
        offset = rng.standard_normal(D).astype(np.float32)
        for i, a in enumerate(f["a"]):
            base = rng.standard_normal(D).astype(np.float32)
            emb[index[a]] = base
            for k in range(f["nb_per_a"]):
                emb[index[f["b"][i * f["nb_per_a"] + k]]] = base + offset * (1.0 + 0.001 * k)
    return emb + noise * rng.standard_normal(emb.shape).astype(np.float32)


def test_family_names_layout():
    fams = tq.family_names()
    assert [f["key"] for f in fams] == ["freq", "many", "rare"]
    many = fams[1]
    assert many["nb_per_a"] == 2
    assert len(many["b"]) == 2 * len(many["a"])
    all_names = [w for f in fams for k in ("a", "b", "ra", "rb") for w in f[k]]
    assert len(set(all_names)) == len(all_names)
    assert not any(w.startswith(("t", "s_")) for w in all_names)


def test_analogy_scorer_perfect_geometry_scores_one():
    fams = tq.family_names()
    index = _index_for(fams)
    emb = _relational(np.random.default_rng(0), index, fams, 32)
    out = tq.evaluate_analogies(index, emb, device="cpu")
    assert out["gen_version"] == tq.GEN_VERSION
    for key in ("freq", "many", "rare"):
        assert out[f"analogy_{key}_accuracy_at_1"] == 1.0, out
    assert out["analogy_accuracy_at_1"] == 1.0


def test_analogy_scorer_random_geometry_scores_zero():
    index = _index_for(tq.family_names())
    emb = np.random.default_rng(1).standard_normal((len(index), 16)).astype(np.float32)
    assert tq.evaluate_analogies(index, emb, device="cpu")["analogy_accuracy_at_1"] < 0.1


def _v1(rng, D=16, noise=0.0):
    ea, eb, _, _ = tq.relation_names()
    index = {w: i for i, w in enumerate(ea + eb)}
    offset = rng.standard_normal(D).astype(np.float32)
    emb = np.zeros((len(index), D), np.float32)
    for a, b in zip(ea, eb):
        base = rng.standard_normal(D).astype(np.float32)
        emb[index[a]] = base
        emb[index[b]] = base + offset
    return index, emb + noise * rng.standard_normal(emb.shape).astype(np.float32)


def test_v1_rescore_fallback():
    index, emb = _v1(np.random.default_rng(2))
    out = tq.evaluate_analogies(index, emb, device="cpu")
    assert out["gen_version"] == 1
    assert out["analogy_accuracy_at_1"] == 1.0


def test_generator_plants_all_families(tmp_path):
    path = str(tmp_path / "c.txt")
    tq.generate_corpus(path, n_words=700_000, seed=3, v_raw=2000)
    counts = Counter()
    with open(path) as f:
        for line in f:
            counts.update(line.split())
    fams = tq.family_names()
    occ = {f["key"]: sum(counts[w] for w in f["a"] + f["b"]) for f in fams}
    assert occ["freq"] > occ["many"] > occ["rare"] > 0, occ
    assert sum(counts[w] for w in fams[0]["ra"] + fams[0]["rb"]) > 0
    total = sum(counts.values())
    rel_tokens = sum(occ.values()) + sum(
        counts[w] for f in fams for w in f["ra"] + f["rb"])
    assert rel_tokens / total < 3 * tq.REL_SENT_FRAC


# -- the scorers against the JAX tool's -------------------------------------------------


@pytest.fixture
def unrounded(monkeypatch):
    """Both modules' ``round`` made the identity, so the scorers' numbers compare
    before their 4-decimal rounding."""
    for mod in (eq, tq):
        monkeypatch.setattr(mod, "round", lambda x, n=None: x, raising=False)


def _topic_vocab(rng, v=3000, D=16):
    """A few thousand topic words plus every family word, the topic words placed near
    their topic's centroid (the purity is neither 0 nor 1) and the families in noisy
    relational geometry (the accuracies are neither)."""
    words = list(tq.word_names(v))
    fams = tq.family_names()
    fam_words = [w for f in fams for k in ("a", "b", "ra", "rb") for w in f[k]]
    index = {w: i for i, w in enumerate(words + fam_words)}
    topics = tq.topic_of(np.arange(v))
    centroids = rng.standard_normal((tq.T_TOPICS, D)).astype(np.float32)
    emb = rng.standard_normal((len(index), D)).astype(np.float32) * 1.5
    emb[:v] += np.where(topics[:, None] >= 0, centroids[topics], 0.0)
    rel = _relational(rng, {w: i for i, w in enumerate(w for f in fams
                                                        for w in f["a"] + f["b"])},
                      fams, D, noise=0.6)
    ab = [w for f in fams for w in f["a"] + f["b"]]
    emb[[index[w] for w in ab]] = rel
    return words + fam_words, index, emb


def test_evaluate_matches_jax(unrounded):
    words, index, emb = _topic_vocab(np.random.default_rng(5))
    want = eq.evaluate(words, emb.copy(), index)
    got = tq.evaluate(words, emb.copy(), index, device="cpu")
    assert set(got) == set(want)
    assert 0.1 < got["purity_at_10"] < 0.95, got
    assert 0.05 < got["analogy_accuracy_at_1"] < 0.95, got
    for k, w in want.items():
        if k == "ann_build_s":
            continue
        if "margin" in k or "cosine" in k:
            assert got[k] == pytest.approx(w, abs=ATOL), k
        elif k.startswith("purity"):
            # the same neighbours: equal hit counts (each package's f32 mean of them
            # may round its last bit differently)
            hits = 10 * want["probes"]
            assert round(got[k] * hits) == round(w * hits), (k, got[k], w)
        else:
            assert got[k] == w, (k, got[k], w)


def test_evaluate_rows_match_jax():
    """The rows as the tools write them (rounded to 4 decimals): equal purity@10 and
    analogy accuracies."""
    words, index, emb = _topic_vocab(np.random.default_rng(5))
    want = eq.evaluate(words, emb.copy(), index)
    got = tq.evaluate(words, emb.copy(), index, device="cpu")
    for k in want:
        if k.startswith("purity") or "accuracy" in k:
            assert got[k] == want[k], (k, got[k], want[k])


def test_evaluate_analogies_match_jax(unrounded):
    fams = tq.family_names()
    index = _index_for(fams)
    for noise in (0.3, 0.8):
        emb = _relational(np.random.default_rng(6), index, fams, 16, noise)
        want = eq.evaluate_analogies(index, emb)
        got = tq.evaluate_analogies(index, emb, device="cpu")
        assert set(got) == set(want)
        for k, w in want.items():
            if "cosine" in k:
                assert got[k] == pytest.approx(w, abs=ATOL), k
            else:
                assert got[k] == w, (k, got[k], w)


def test_evaluate_analogies_v1_match_jax(unrounded):
    index, emb = _v1(np.random.default_rng(8), noise=0.7)
    want = eq._evaluate_analogies_v1(index, emb)
    got = tq._evaluate_analogies_v1(index, emb, device="cpu")
    assert 0.05 < got["analogy_accuracy_at_1"] < 0.95, got
    assert set(got) == set(want)
    for k, w in want.items():
        if "cosine" in k:
            assert got[k] == pytest.approx(w, abs=ATOL), k
        else:
            assert got[k] == w, (k, got[k], w)


def test_evaluate_flags_divergence():
    words, index, emb = _topic_vocab(np.random.default_rng(9), v=500)
    emb[3, 1] = np.nan
    assert tq.evaluate(words, emb, index, device="cpu") == eq.evaluate(words, emb, index)


def test_scorers_default_to_the_card():
    """Without ``device`` the scorers run on the card, and with no card they raise
    instead of using the CPU."""
    if torch.cuda.is_available():
        return
    index = _index_for(tq.family_names())
    emb = np.ones((len(index), 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tq.evaluate_analogies(index, emb)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tq.evaluate(list(index), emb, index)


# -- the harness --------------------------------------------------------------------------


def test_driver_end_to_end_on_the_cpu(tmp_path):
    """token file -> TokenFileCorpus -> vocabulary -> encode cache -> Word2Vec.fit on
    the CPU -> the port's scorers: one JSON line, the same row in --runs-out, nothing
    appended to the repo's EVAL_RUNS.jsonl."""
    runs = os.path.join(REPO, "EVAL_RUNS.jsonl")
    before = _sha(runs)
    rows = tmp_path / "rows.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.eval_quality", "--words", "200000",
         "--dim", "16", "--iters", "1", "--device", "cpu", "--out",
         str(tmp_path / "out"), "--runs-out", str(rows)],
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"},
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert [json.loads(line) for line in open(rows)] == [row]
    assert _sha(runs) == before
    assert row["package"] == "torch" and row["device"] == "cpu" and row["card"] is None
    assert row["corpus_words"] == 200_000 and row["dim"] == 16
    assert row["negative_pool"] == 512 and row["pairs_per_batch"] == 65536
    assert row["run"]["steps"] > 0 and row["run"]["feed_backend"] in ("native", "numpy")
    for k in ("purity_at_10", "cosine_margin", "purity_at_10_random_baseline",
              "ann_recall_at_10", "gen_version"):
        assert k in row, k
    assert (tmp_path / "out" / "syn0.npy").exists()
    # --rescore scores the saved arrays again, through the same scorers
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.eval_quality", "--rescore",
         "--device", "cpu", "--out", str(tmp_path / "out"), "--runs-out", str(rows)],
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"},
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    again = json.loads(proc.stdout)
    assert again["rescored"] and again["purity_at_10"] == row["purity_at_10"]
    assert _sha(runs) == before


def test_harness_continual_ab_on_the_cpu(tmp_path, capsys):
    """--continual-ab at a toy size: a base fit, one ContinualRunner increment over a
    tail with new word types, two rows (pre, post) in --runs-out and none in the repo's
    EVAL_RUNS.jsonl; the vocabulary sizes equal the JAX package's host-only vocabulary
    pass over the same generated files."""
    from glint_word2vec_tpu.continual.extend import compute_vocab_delta
    from glint_word2vec_tpu.data.corpus import TokenFileCorpus
    from glint_word2vec_tpu.data.vocab import build_vocab, count_words

    runs = os.path.join(REPO, "EVAL_RUNS.jsonl")
    before = _sha(runs)
    rows, out = tmp_path / "rows.jsonl", tmp_path / "out"
    tq.main(["--continual-ab", "--words", "200000", "--vocab", "3000", "--dim", "16",
             "--iters", "1", "--batch", "4096", "--pool", "64",
             "--continual-new-types", "200", "--continual-lr-rewarm", "0.5",
             "--device", "cpu", "--out", str(out), "--runs-out", str(rows)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "continual_ab" and _sha(runs) == before
    pre, post = [json.loads(line) for line in open(rows)]
    assert (pre["continual_ab_arm"], post["continual_ab_arm"]) == ("pre", "post")
    assert res["arms"] == [pre, post]
    assert post["continual_lr_rewarm"] == 0.5 and post["continual_tail_words"] == 50_000
    assert post["run"]["global_step"] > post["run"]["global_step_start"] > 0
    base = build_vocab(TokenFileCorpus(tq.corpus_file(str(out), 200000, 3000, 42)), 5)
    tail = count_words(TokenFileCorpus(str(out / "continual" / "stream" / "seg-001.txt")))
    delta = compute_vocab_delta(base, tail, 5)
    assert res["vocab_base"] == base.size
    assert res["new_words"] == delta.num_new > 0
    assert res["vocab_grown"] == base.size + delta.num_new
    for row in (pre, post):
        assert 0.0 <= row["purity_at_10"] <= 1.0 and np.isfinite(row["cosine_margin"])


def test_harness_localsgd_ab_on_a_gloo_world(tmp_path):
    """--localsgd-ab at a toy size on the CPU: two ranks on a (2, 1) mesh train the
    synchronous and the sync_every=4 arms of the same corpus and seed; rank 0 prints
    the verdict line and writes one row per arm."""
    rows, out = tmp_path / "rows.jsonl", tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.eval_quality", "--localsgd-ab",
         "--sync-every", "4", "--words", "200000", "--vocab", "3000", "--dim", "16",
         "--iters", "1", "--batch", "4096", "--pool", "64", "--device", "cpu",
         "--out", str(out), "--runs-out", str(rows)],
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["metric"] == "localsgd_ab" and res["mesh"] == [2, 1]
    assert res["sync_every"] == 4 and isinstance(res["staleness_ok"], bool)
    sync, local = [json.loads(line) for line in open(rows)]
    assert (sync["localsgd_ab_arm"], local["localsgd_ab_arm"]) == ("sync", "local")
    assert (sync["sync_every"], local["sync_every"]) == (1, 4)
    assert res["arms"] == [sync, local]
    for row in (sync, local):
        assert row["step_lowering"] == "shard_map" and row["run"]["steps"] > 0
        assert 0.0 <= row["purity_at_10"] <= 1.0
    assert res["purity_delta"] == round(local["purity_at_10"] - sync["purity_at_10"], 4)


def test_continual_tail_words_alone_is_accepted(tmp_path):
    """As in the JAX tool, a --continual-* knob without --continual-ab is accepted (and
    changes nothing of a plain run)."""
    ap, args = tq.parse_args(["--continual-tail-words", "1000", "--out", str(tmp_path)])
    tq._refuse_unported(ap, args)
    assert args.continual_tail_words == 1000 and not args.continual_ab
    assert (args.continual_new_types, args.continual_lr_rewarm,
            args.continual_iterations) == (2000, 1.0, 1)


@pytest.mark.parametrize("argv,names", [
    (["--localsgd-ab", "--sync-every", "3"], ("--sync-every", "divide")),
    (["--localsgd-ab", "--ranks", "1"], ("--localsgd-ab", "ranks")),
    (["--idle-share", "--device", "cpu"], ("--idle-share",)),
])
def test_driver_refuses_by_name(tmp_path, capsys, argv, names):
    with pytest.raises(SystemExit) as e:
        tq.main(argv + ["--out", str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    for name in names:
        assert name in err, err
    assert not os.listdir(tmp_path)
