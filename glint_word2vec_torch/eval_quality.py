"""Training quality at text8 scale, ported from ``tools/eval_quality.py``.

Generates a corpus at text8's scale (17M words, ~70k words after ``min_count``) from a
fully specified generative topic model, trains on it through the port's ingest path
(token file -> :class:`..data.corpus.TokenFileCorpus` -> streaming vocabulary pass ->
``encode_corpus`` (memory-mapped) -> ``Word2Vec.fit``), on the card unless
``--device cpu``, and scores the embedding against the generator's ground truth.
Prints one JSON line on stdout (progress goes to stderr) and appends the same row to
``--runs-out`` (default ``<--out>/eval_runs.jsonl``).

Generative model (deterministic given ``--seed``; :func:`generate_corpus` writes the
same bytes as the JAX package's tool, which the tests hold it to):
    - V_raw word types with Zipf marginals p(r) ~ 1/(r+10)^1.05 (text8-like head/tail)
    - the S most frequent types are topic-neutral "stopwords"
    - every other type r belongs to topic (r mod T); names encode the topic
      ("t017_w000421"), so the ground truth travels with the corpus file
    - each sentence draws one topic z; every word is, with prob lambda, drawn from the
      renormalized marginals of topic z's own words, else from the global marginals
    - a small share of sentences are relation sentences of three entity families
      (the analogy probe)

Metrics (ground truth = the name prefix; a random embedding scores ~1/T):
    - purity@10: fraction of a word's 10 cosine-nearest content neighbours sharing its
      topic, averaged over 2,000 mid-frequency probe words
    - margin: mean within-topic cosine minus mean cross-topic cosine over the probes
    - analogy accuracy@1 per relation family
The scorers (:func:`evaluate`, :func:`evaluate_analogies`) run the normalised product
and the top-k on an explicit device and copy back only the small results; they draw
the JAX tool's probes, content sample and queries from the same seeds.

Usage:
    python -m glint_word2vec_torch.eval_quality [--words 17000000] [--out DIR]
        [--corpus existing.txt] [--dim 100] [--iters 3] [--device cpu]
        [--runs-out FILE] [--idle-share]

``--continual-ab`` is the forgetting gate: a base fit, one continual increment
(``continual.ContinualRunner``) over a drifted tail of the generator with new word
types, and the base vocabulary's rows scored before and after (two rows,
``continual_ab_arm`` pre and post). ``--localsgd-ab`` is the local-SGD staleness gate:
two arms on a mesh with a data axis, ``sync_every=1`` and ``--sync-every``, one row each
(``localsgd_ab_arm`` sync and local) and a verdict (the local arm's purity@10 more than
0.03 below the synchronous arm's fails). The port runs one rank a device, so the harness
starts ``--ranks`` copies of itself (a gloo world meeting through a file store beside
``--out``; on one card the ranks share it, their collectives staged through host
memory), each fitting its rows; rank 0 gathers the model, scores it and prints the line.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

T_TOPICS = 128
STOPWORDS = 200
LAMBDA = 0.72
SENT_LEN = 35
V_RAW = 90_000   # raw types; min_count=5 trims the tail to ~text8's ~70k

# Relational structure, the synthetic analog of the toy corpus's country/capital
# pairs: entity pair members co-occur with a topic's words; a-words also co-occur with
# a role-A word set, b-words with role-B, so the embedding must place
# b_i - a_i ~ roleB - roleA, which the reference's analogy gate (wien - österreich +
# deutschland ~ berlin) measures, here at 90k-vocab scale with accuracy@1.
#
# v2: the v1 gate saturated (every 90k run scored acc@1 = 1.000). v2 has three
# relation families, each with its own role-word sets (the family offsets differ, so
# cross-family confusion is possible), a 15x lower relation-sentence rate
# (0.06 -> 0.004), a 1:many family, and a rare family:
#   freq: 40 one-to-one pairs, 60% of relation sentences
#   many: 32 a-entities x 2 b-entities each (1:many), 32%
#   rare: 24 one-to-one pairs, 8% (~23 sentences per pair at 60M words: an
#         undertraining probe)
GEN_VERSION = 2
REL_SENT_FRAC = 0.004  # fraction of sentences that are relation sentences (v1: 0.06)
FAMILIES = (
    {"key": "freq", "na": 40, "nb_per_a": 1, "weight": 0.60},
    {"key": "many", "na": 32, "nb_per_a": 2, "weight": 0.32},
    {"key": "rare", "na": 24, "nb_per_a": 1, "weight": 0.08},
)
ROLE_WORDS = 60        # per role set (each family has its own A and B sets)
REL_LAMBDA_ENTITY = 0.06  # slots holding the entity word itself
REL_LAMBDA_ROLE = 0.10    # slots drawn from the role word set; rest: topic/noise

# the v1 layout (kept so --rescore still scores v1 models)
N_ENTITIES = 96


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def topic_of(rank: np.ndarray) -> np.ndarray:
    """Ground-truth topic of a word rank; stopwords get -1."""
    return np.where(rank < STOPWORDS, -1, rank % T_TOPICS)


def word_names(v: int) -> np.ndarray:
    ranks = np.arange(v)
    topics = topic_of(ranks)
    return np.asarray([
        f"s_w{r:06d}" if t < 0 else f"t{t:03d}_w{r:06d}"
        for r, t in zip(ranks, topics)])


def relation_names():
    """v1 entity/role word types (kept for --rescore of v1 models)."""
    ea = [f"ea_{i:03d}" for i in range(N_ENTITIES)]
    eb = [f"eb_{i:03d}" for i in range(N_ENTITIES)]
    ra = [f"ra_w{i:03d}" for i in range(ROLE_WORDS)]
    rb = [f"rb_w{i:03d}" for i in range(ROLE_WORDS)]
    return ea, eb, ra, rb


def family_names():
    """v2 per-family entity/role word types, appended after the V_RAW topic
    types in family order: a-entities, b-entities (a-major: b's of a-entity i
    are indices i*nb_per_a .. i*nb_per_a+nb_per_a-1), role-A, role-B."""
    fams = []
    for f_idx, fam in enumerate(FAMILIES):
        nb = fam["na"] * fam["nb_per_a"]
        fams.append({
            "key": fam["key"],
            "a": [f"f{f_idx}a_{i:03d}" for i in range(fam["na"])],
            "b": [f"f{f_idx}b_{i:03d}" for i in range(nb)],
            "ra": [f"r{f_idx}a_w{i:03d}" for i in range(ROLE_WORDS)],
            "rb": [f"r{f_idx}b_w{i:03d}" for i in range(ROLE_WORDS)],
            "nb_per_a": fam["nb_per_a"],
        })
    return fams


def generate_corpus(path: str, n_words: int, seed: int, v_raw: int = V_RAW) -> None:
    """Write the topic-model corpus as a token file, one sentence per line
    (v2 relation structure — see the constants block).

    A REL_SENT_FRAC fraction of sentences are relation sentences: one family
    drawn by weight, one of its entity words (a_i, or one of a_i's b's) + that
    family's role-set draws + the entity's topic words + noise."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(v_raw) + 10.0) ** 1.05
    p /= p.sum()
    names = word_names(v_raw)
    fams = family_names()
    all_names = np.concatenate(
        [names] + [np.asarray(f[k]) for f in fams for k in ("a", "b", "ra", "rb")])
    topics = topic_of(np.arange(v_raw))
    topic_words = [np.where(topics == z)[0] for z in range(T_TOPICS)]
    topic_probs = [p[w] / p[w].sum() for w in topic_words]
    # id layout mirrors all_names: per family, a / b / role-A / role-B blocks
    base = v_raw
    fam_ids = []
    fam_off = []
    for f_idx, f in enumerate(fams):
        ids = {"a": base + np.arange(len(f["a"]))}
        base += len(f["a"])
        ids["b"] = base + np.arange(len(f["b"]))
        base += len(f["b"])
        ids["ra"] = base + np.arange(ROLE_WORDS)
        base += ROLE_WORDS
        ids["rb"] = base + np.arange(ROLE_WORDS)
        base += ROLE_WORDS
        fam_ids.append(ids)
        # family topic offset: a-entity i of family f sits in topic
        # (17*f + i) mod T — distinct families' entities spread over topics
        fam_off.append(17 * f_idx)
    weights = np.asarray([f["weight"] for f in FAMILIES], np.float64)
    weights /= weights.sum()

    n_sents = n_words // SENT_LEN
    t0 = time.perf_counter()
    with open(path, "w", encoding="utf-8") as f:
        block = 20_000
        for start in range(0, n_sents, block):
            nb = min(block, n_sents - start)
            z = rng.integers(0, T_TOPICS, nb)
            words = np.empty((nb, SENT_LEN), np.int32)
            # global (stopword/noise) draws for every slot, then overwrite the
            # topic-bound slots per topic group
            words[:] = rng.choice(v_raw, size=(nb, SENT_LEN), p=p)
            from_topic = rng.random((nb, SENT_LEN)) < LAMBDA
            # relation sentences: family by weight, entity within family,
            # side a/b 50:50 (b: uniform over the a-entity's b's); the topic is
            # forced to the entity's own topic
            is_rel = rng.random(nb) < REL_SENT_FRAC
            fam_draw = rng.choice(len(FAMILIES), size=nb, p=weights)
            ent_word = np.zeros(nb, np.int32)
            for f_idx, (fam, ids) in enumerate(zip(FAMILIES, fam_ids)):
                rows = np.where(is_rel & (fam_draw == f_idx))[0]
                if not rows.size:
                    continue
                ai = rng.integers(0, fam["na"], rows.size)
                side_b = rng.random(rows.size) < 0.5
                bk = ai * fam["nb_per_a"] + rng.integers(
                    0, fam["nb_per_a"], rows.size)
                ent_word[rows] = np.where(side_b, ids["b"][bk], ids["a"][ai])
                z[rows] = (fam_off[f_idx] + ai) % T_TOPICS
                # role draws happen below against the row's family sets
            for zz in np.unique(z):
                rows = np.where(z == zz)[0]
                m = from_topic[rows]
                words[np.repeat(rows, m.sum(1)),
                      np.concatenate([np.where(r)[0] for r in m])] = rng.choice(
                    topic_words[zz], size=int(m.sum()), p=topic_probs[zz])
            # overwrite entity/role slots of relation sentences
            rel_rows = np.where(is_rel)[0]
            if rel_rows.size:
                u = rng.random((rel_rows.size, SENT_LEN))
                ent_slot = u < REL_LAMBDA_ENTITY
                role_slot = (u >= REL_LAMBDA_ENTITY) & (
                    u < REL_LAMBDA_ENTITY + REL_LAMBDA_ROLE)
                # the entity's side decides the role set: a-side rows draw from
                # the family's role-A set, b-side from role-B
                rw = np.empty((rel_rows.size, SENT_LEN), np.int32)
                for f_idx, ids in enumerate(fam_ids):
                    sub = np.where(fam_draw[rel_rows] == f_idx)[0]
                    if not sub.size:
                        continue
                    on_b = np.isin(ent_word[rel_rows[sub]], ids["b"])
                    draw = rng.integers(0, ROLE_WORDS, (sub.size, SENT_LEN))
                    rw[sub] = np.where(on_b[:, None], ids["rb"][draw],
                                       ids["ra"][draw])
                sub = words[rel_rows]
                sub = np.where(ent_slot, ent_word[rel_rows, None], sub)
                sub = np.where(role_slot, rw, sub)
                words[rel_rows] = sub
            lines = [" ".join(all_names[row]) for row in words]
            f.write("\n".join(lines) + "\n")
    n_pairs = sum(f["na"] * f["nb_per_a"] for f in FAMILIES)
    log(f"corpus v{GEN_VERSION}: {n_sents:,} sentences / "
        f"{n_sents * SENT_LEN:,} words ({REL_SENT_FRAC:.1%} relation sentences, "
        f"{n_pairs} entity pairs over {len(FAMILIES)} families) "
        f"written in {time.perf_counter() - t0:.1f}s -> {path}")



def _unit_rows(m):
    """Rows scaled to unit L2 norm (zero rows stay zero), as the JAX scorers scale
    them."""
    import torch
    return m / torch.clamp(torch.linalg.norm(m, dim=1, keepdim=True), min=1e-12)


def evaluate(words, emb: np.ndarray, index=None, device="cuda") -> dict:
    """Topic purity@10 and cosine margin over 2,000 mid-frequency probe words, with a
    random-embedding baseline for scale, the serving index's recall channels, and the
    analogy scores. The [probes, content] similarities, their top-10 and the masked
    means run on ``device`` (the card unless ``"cpu"``); only scalars come back."""
    import torch

    from glint_word2vec_torch.device import resolve_device
    dev = resolve_device(device)
    # entity/role types (f#a_/f#b_/r#a_/r#b_) carry no topic: excluded from purity
    is_topic_word = np.asarray(
        [w.startswith(("t", "s_")) and "_w" in w for w in words])
    ranks_in_vocab = np.asarray(
        [int(w.split("_w")[1]) if ok else -1
         for w, ok in zip(words, is_topic_word)])
    topics = np.where(is_topic_word, topic_of(ranks_in_vocab), -1)
    content = np.where(topics >= 0)[0]
    if content.size > 250_000:
        # a fixed 250k-content sample keeps the neighbour statistics intact
        content = np.sort(np.random.default_rng(3).choice(
            content, size=250_000, replace=False))
    # mid-frequency probes: skip the hottest 2k (near-uniform co-occurrence) and the
    # rarest tail (too few updates); small vocabularies fall back to all content
    lo = min(2000, content.size // 4)
    hi = max(30000, lo + 1)
    probe_pool = content[(content >= lo) & (content < hi)]
    if probe_pool.size == 0:
        probe_pool = content
    rng = np.random.default_rng(0)
    probes = rng.choice(probe_pool, size=min(2000, probe_pool.size), replace=False)
    # each probe's position within content (probes are drawn from content)
    self_pos = torch.from_numpy(np.searchsorted(content, probes)).to(dev)
    t_probes = torch.from_numpy(topics[probes]).to(dev)
    t_content = torch.from_numpy(topics[content]).to(dev)

    def purity(e):
        q = _unit_rows(torch.from_numpy(np.ascontiguousarray(e[probes])).to(dev))
        base = _unit_rows(torch.from_numpy(np.ascontiguousarray(e[content])).to(dev))
        sims = q @ base.T                                   # [P, C]: stays on device
        rows = torch.arange(sims.shape[0], device=dev)
        sims[rows, self_pos] = -torch.inf
        top = torch.topk(sims, 10, dim=1).indices           # [P, 10]
        pur = (t_content[top] == t_probes[:, None]).float().mean()
        sub = sims[:, :4000]
        same = t_content[None, :4000] == t_probes[:, None]
        finite = torch.isfinite(sub)
        sub0 = torch.where(finite, sub, 0.0)
        within = (sub0 * (same & finite)).sum() / torch.clamp((same & finite).sum(), min=1)
        cross = (sub0 * (~same & finite)).sum() / torch.clamp((~same & finite).sum(),
                                                              min=1)
        return float(pur), float(within - cross)

    if np.isnan(emb).any():
        return {"diverged": True, "nan_rows": int(np.isnan(emb).any(axis=1).sum())}
    # finite-overflow telemetry: a slow-burn instability can wreck the geometry without
    # reaching NaN; the scale tells a blowup from undertraining
    row_max = np.abs(emb).max(axis=1)
    rows_inf = int(np.isinf(row_max).sum())
    if rows_inf:
        # saturated to inf: mask the blown entries out of the scoring (an inf row would
        # NaN every cosine it touches) and keep the row strict JSON
        emb = np.where(np.isfinite(emb), emb, 0.0).astype(emb.dtype, copy=False)
    abs_max = float(np.minimum(row_max.max(), np.finfo(np.float32).max))
    blown = int((row_max > 100.0).sum())
    # the row-norm channels the trainer's health probe reports (obs/probe.py), on the
    # final embedding (threshold 100 = the config's norm_watch_threshold)
    row_norm = np.linalg.norm(emb.astype(np.float64), axis=1)
    fmax = float(np.finfo(np.float32).max)
    norm_channels = {
        "row_norm_max": round(float(min(row_norm.max(), fmax)), 3),
        "row_norm_p99": round(float(min(np.percentile(row_norm, 99), fmax)), 3),
        "row_norm_mean": round(float(min(row_norm.mean(), fmax)), 4),
        "rows_norm_over_100": int((row_norm > 100.0).sum()),
    }
    pur, margin = purity(emb)
    rnd = np.random.default_rng(1).standard_normal(emb.shape, dtype=np.float32)
    pur0, margin0 = purity(rnd)
    # serving-index health: the IVF index built as a publish builds it (serve/ann.py,
    # host numpy, the JAX package's index bit for bit) and its oracle-checked
    # recall@10, with the int8 and PQ arms (floors off: this is the measurement). A
    # failed build must not cost the quality row.
    ann_channels = {}
    try:
        from glint_word2vec_torch.serve.ann import build_ivf
        t_ann = time.perf_counter()
        ivf = build_ivf(emb, seed=0, recall_queries=256, recall_k=10)
        ann_channels = {
            "ann_recall_at_10": ivf.stats.get("recall_at_10"),
            "ann_centroids": ivf.stats["centroids"],
            "ann_nprobe": ivf.stats["nprobe"],
            "ann_build_s": round(time.perf_counter() - t_ann, 2),
            "ann_index_bytes": ivf.stats.get("index_bytes"),
        }
        for quant in ("int8", "pq"):
            try:
                qix = build_ivf(emb, seed=0, recall_queries=256, recall_k=10,
                                quant=quant, recall_floor=0.0)
                ann_channels[f"ann_{quant}_recall_at_10"] = qix.stats.get("recall_at_10")
                ann_channels[f"ann_{quant}_index_bytes"] = qix.stats.get("index_bytes")
            except Exception as e:  # noqa: BLE001 (an additive channel)
                log(f"ann {quant} channel skipped: {type(e).__name__}: {e}")
    except Exception as e:  # noqa: BLE001 (index health is additive)
        log(f"ann recall channel skipped: {type(e).__name__}: {e}")
    out = {
        "purity_at_10": round(pur, 4),
        "emb_abs_max": round(abs_max, 3),
        "rows_inf": rows_inf,
        "rows_abs_over_100": blown,
        **norm_channels,
        **ann_channels,
        "purity_at_10_random_baseline": round(pur0, 4),
        "cosine_margin": round(margin, 4),
        "cosine_margin_random_baseline": round(margin0, 4),
        "probes": int(probes.size),
        "topics": T_TOPICS,
    }
    if index is None:
        index = {w: i for i, w in enumerate(words)}
    out.update(evaluate_analogies(index, emb, device=dev))
    return out


def _analogy(en, a_i, b_ik, a_j, b_j_set):
    """Accuracy@1 and the mean cosine to the best correct answer of the queries
    v = b_ik - a_i + a_j over the unit rows ``en``; ``b_j_set`` [n_q, nb] holds every
    correct answer of a_j. The query words are excluded, as the reference's
    findSynonyms excludes the query."""
    import torch
    v = _unit_rows(en[b_ik] - en[a_i] + en[a_j])
    sims = v @ en.T                       # [n_q, V]: stays on device
    rows = torch.arange(sims.shape[0], device=sims.device)
    cos_correct = sims.gather(1, b_j_set).max(dim=1).values
    for cols in (a_i, b_ik, a_j):
        sims[rows, cols] = -torch.inf
    top1 = sims.argmax(dim=1)
    hit = (top1[:, None] == b_j_set).any(dim=1)
    return float(hit.float().mean()), float(cos_correct.mean())


def evaluate_analogies(index, emb: np.ndarray, device="cuda") -> dict:
    """The reference's analogy gate run over the generator's entity pairs: for
    a-entities (i, j), query v = b_i - a_i + a_j and check that the cosine-nearest word
    over the full vocabulary (query words excluded) is one of a_j's b-entities. Scored
    per family (freq / many / rare) and as their mean; a v1 model falls back to
    :func:`_evaluate_analogies_v1`. The [queries, V] similarities stay on
    ``device``."""
    import torch

    from glint_word2vec_torch.device import resolve_device
    dev = resolve_device(device)
    fams = family_names()
    if fams[0]["a"][0] not in index and relation_names()[0][0] in index:
        return _evaluate_analogies_v1(index, emb, device=dev)

    en = _unit_rows(torch.from_numpy(np.ascontiguousarray(emb)).to(dev))

    def ids(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    rng = np.random.default_rng(7)
    out = {}
    accs, total_pairs, total_q = [], 0, 0
    for fam in fams:
        ia = np.asarray([index.get(w, -1) for w in fam["a"]])
        ib = np.asarray([index.get(w, -1) for w in fam["b"]])
        nb = fam["nb_per_a"]
        ok_a = (ia >= 0) & (ib.reshape(-1, nb) >= 0).all(axis=1)
        a_ids = ia[ok_a]
        b_sets = ib.reshape(-1, nb)[ok_a]     # [na_ok, nb]
        n = a_ids.size
        total_pairs += int((ib >= 0).sum())
        if n < 4:
            out[f"analogy_{fam['key']}_pairs"] = int(n)
            continue
        n_q = min(256, n * (n - 1) * nb)
        qi = rng.integers(0, n, n_q)
        qk = rng.integers(0, nb, n_q)
        qj = rng.integers(0, n - 1, n_q)
        qj = np.where(qj >= qi, qj + 1, qj)   # j != i
        acc, cos_mean = _analogy(en, ids(a_ids[qi]), ids(b_sets[qi, qk]),
                                 ids(a_ids[qj]), ids(b_sets[qj]))
        out[f"analogy_{fam['key']}_accuracy_at_1"] = round(acc, 4)
        out[f"analogy_{fam['key']}_mean_cosine"] = round(cos_mean, 4)
        accs.append(acc)
        total_q += n_q
    if accs:
        out["analogy_accuracy_at_1"] = round(float(np.mean(accs)), 4)
    out["analogy_pairs_in_vocab"] = total_pairs
    out["analogy_queries"] = total_q
    out["gen_version"] = GEN_VERSION
    return out


def _evaluate_analogies_v1(index, emb: np.ndarray, device="cuda") -> dict:
    """v1 single-relation scoring, kept so --rescore scores v1 models."""
    import torch

    from glint_word2vec_torch.device import resolve_device
    dev = resolve_device(device)
    ea, eb, _, _ = relation_names()
    ia = np.asarray([index.get(w, -1) for w in ea])
    ib = np.asarray([index.get(w, -1) for w in eb])
    ok = (ia >= 0) & (ib >= 0)
    ia, ib = ia[ok], ib[ok]
    n = ia.size
    if n < 4:
        return {"analogy_pairs_in_vocab": int(n)}
    rng = np.random.default_rng(7)
    n_q = min(512, n * (n - 1))
    qi = rng.integers(0, n, n_q)
    qj = rng.integers(0, n - 1, n_q)
    qj = np.where(qj >= qi, qj + 1, qj)       # j != i

    def ids(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    en = _unit_rows(torch.from_numpy(np.ascontiguousarray(emb)).to(dev))
    acc, cos_mean = _analogy(en, ids(ia[qi]), ids(ib[qi]), ids(ia[qj]),
                             ids(ib[qj])[:, None])
    return {
        "analogy_pairs_in_vocab": int(n),
        "analogy_queries": int(n_q),
        "analogy_accuracy_at_1": round(acc, 4),
        "analogy_mean_cosine_to_answer": round(cos_mean, 4),
        "gen_version": 1,
    }


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, for every row a run
    on the card writes (``None`` on the CPU)."""
    import torch
    if torch.device(device).type != "cuda":
        return None
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read (no nvidia-smi)"


def _kernel_counts() -> dict:
    """The hand-written kernels' launch counters (they count on CUDA tensors only)."""
    from glint_word2vec_torch.ops import fused_sgns, scatter
    f, s = fused_sgns.fused_sgns_shared_step, scatter.scatter_add_rows_
    return {"sgns_shared_step": f.launches, "sgns_shared_step_bf16": f.bf16_launches,
            "scatter_add_rows": s.launches, "scatter_add_rows_bf16": s.bf16_launches}


def _reset_kernel_counts() -> None:
    from glint_word2vec_torch.ops import fused_sgns, scatter
    for fn in (fused_sgns.fused_sgns_shared_step, scatter.scatter_add_rows_):
        fn.launches = 0
        fn.bf16_launches = 0


def _run_stats(est, busy_s) -> dict:
    """What the fit did on the device: its steps and chunks, the kernels' launches, the
    host's dispatch and feed waits, the seconds of each stage, and with ``busy_s`` (the
    profiled kernels' union) the device's idle share over ``Trainer.fit``."""
    tr = est.trainer
    out = {"steps": int(tr.global_step),
           "steps_per_dispatch": tr.config.steps_per_dispatch,
           "chunks": tr.chunks_run, "graph_captures": tr.graph_captures,
           "graph_replays": tr.graph_replays, "pairs_trained": float(tr.pairs_trained),
           "feed_backend": tr.feed_backend, "fit_s": tr.fit_time,
           "host_wait_s": tr.host_wait_time, "dispatch_s": tr.dispatch_time,
           "prologue_s": tr.prologue_time, **est.timings,
           "launches": _kernel_counts()}
    if busy_s is not None:
        out["kernel_busy_s"] = busy_s
        out["device_idle_share"] = 1.0 - busy_s / tr.fit_time
    return out


def _refuse_unported(ap, args) -> None:
    """The JAX tool's checks of the local-SGD A/B's knobs, with its messages."""
    if args.localsgd_ab and (args.sync_every <= 1 or 32 % args.sync_every):
        ap.error("--sync-every must be > 1 and divide "
                 f"steps_per_dispatch=32 (got {args.sync_every})")
    if args.localsgd_ab and args.ranks < 2:
        ap.error(f"--localsgd-ab needs >= 2 ranks for a data axis (have {args.ranks})")


def _launch_ranks(argv, args) -> int:
    """Start ``--ranks`` copies of this harness, one a rank of a gloo world meeting
    through a file store under ``--out``; print rank 0's result line. Returns the
    first non-zero exit code, or 0."""
    os.makedirs(args.out, exist_ok=True)
    store = os.path.join(args.out, f".localsgd-store-{os.getpid()}")
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "2"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "glint_word2vec_torch.eval_quality", *argv,
         "--rank", str(r), "--store", store],
        stdout=subprocess.PIPE, text=True, env=env) for r in range(args.ranks)]
    outs = [p.communicate()[0] for p in procs]
    if os.path.exists(store):
        os.unlink(store)
    rcs = [p.returncode for p in procs]
    lines = outs[0].strip().splitlines()
    if lines:
        print(lines[-1])
    return next((rc for rc in rcs if rc), 0)


def corpus_file(out: str, words: int, v_raw: int, seed: int) -> str:
    """Where the harness writes (and reuses) the generated corpus under ``out``. The
    name carries the generator's tunable constants: a retune without a version bump
    must not reuse a stale corpus while the row records the new constants."""
    return os.path.join(out, f"corpus_{_gen_tag()}_{words}_{v_raw}_{seed}.txt")


def encode_dir(out: str, words: int, v_raw: int, min_count: int) -> str:
    """The encode cache the harness's fits read the generated corpus from."""
    return os.path.join(out, f"encoded_{_gen_tag()}_{words}_{v_raw}_{min_count}")


def _gen_tag() -> str:
    return (f"v{GEN_VERSION}-{REL_SENT_FRAC:g}-{REL_LAMBDA_ENTITY:g}"
            f"-{REL_LAMBDA_ROLE:g}")


def arm_config(args, **stab) -> dict:
    """The estimator's knobs for one arm of the harness (``args`` from
    :func:`parse_args`): the tool's fixed window, negatives and dispatch, and
    ``allow_unstable``, since the suite measures the divergence boundary and must be
    allowed to train configurations the trainer would refuse."""
    return dict(
        vector_size=args.dim, min_count=args.min_count, window=5, negatives=5,
        negative_pool=args.pool, pairs_per_batch=args.batch, steps_per_dispatch=32,
        num_iterations=args.iters,
        learning_rate=args.lr if args.lr is not None else 0.025,
        subsample_ratio=args.subsample, seed=args.seed, param_dtype=args.param_dtype,
        compute_dtype=args.param_dtype, logits_dtype=args.logits_dtype or "float32",
        allow_unstable=True, device_pairgen=args.device_pairgen, cbow=args.cbow, **stab)


def parse_args(argv=None):
    """The harness's parser and its parsed arguments."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--words", type=int, default=17_000_000)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "glint_eval_corpus"),
                    help="where the corpus, its encode cache, syn0.npy and "
                         "vocab_words.txt go")
    ap.add_argument("--runs-out", default=None,
                    help="append each result row here (default <--out>/eval_runs.jsonl)")
    ap.add_argument("--device", default="cuda",
                    help="where the fit and the scorers run: the card unless 'cpu'")
    ap.add_argument("--idle-share", action="store_true",
                    help="profile the fit (torch.profiler, the card's activity only) and "
                         "record the device's idle share over Trainer.fit")
    ap.add_argument("--corpus", default=None,
                    help="existing token file (e.g. a real text8); skips generation AND "
                         "the ground-truth quality metrics")
    ap.add_argument("--dim", type=int, default=100)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--logits-dtype", default=None,
                    help="negative-logit chain dtype; defaults to float32")
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--vocab", type=int, default=V_RAW,
                    help="raw word types in the generator (before min_count)")
    ap.add_argument("--min-count", type=int, default=5)
    ap.add_argument("--subsample", type=float, default=1e-4)
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate; default 0.025. --rescore rows record it only "
                         "when given explicitly (the saved model's lr is unknowable)")
    ap.add_argument("--device-pairgen", action="store_true",
                    help="use the on-device pair generator feed")
    ap.add_argument("--cbow", action="store_true", help="train the CBOW variant")
    ap.add_argument("--rescore", action="store_true",
                    help="skip training: score the syn0.npy + vocab_words.txt already "
                         "saved under --out")
    ap.add_argument("--pool", type=int, default=512,
                    help="shared negative pool. Scale it with the batch: every pool row "
                         "absorbs all pairs' negative gradients x negatives/pool (see "
                         "EVAL.md: B=64k/P=64 NaNs at 17M words, P>=512 holds at 60M)")
    ap.add_argument("--max-row-norm", type=float, default=0.0,
                    help="per-touched-row L2 clamp on the update path (0=off)")
    ap.add_argument("--update-clip", type=float, default=0.0,
                    help="per-row L2 ceiling on each pair's update rows (0=off)")
    ap.add_argument("--row-l2", type=float, default=0.0,
                    help="touched-row weight decay (0=off)")
    ap.add_argument("--norm-watch", default="off",
                    choices=["off", "warn", "recover", "halt"],
                    help="finite-blowup watchdog policy for the trained run")
    # the continual forgetting gate: a base fit, ONE continual increment over a
    # drifted tail (new word types, shifted frequencies), and the ORIGINAL vocabulary's
    # purity/analogy before and after (two rows)
    ap.add_argument("--continual-ab", action="store_true",
                    help="base fit -> one continual increment on a drifted tail -> "
                         "score the ORIGINAL vocab pre/post; one row per arm "
                         "(continual_ab_arm=pre/post)")
    ap.add_argument("--continual-tail-words", type=int, default=None,
                    help="drift-tail size in words (default: --words // 4)")
    ap.add_argument("--continual-new-types", type=int, default=2000,
                    help="extra raw word types in the tail generator (ranks past "
                         "--vocab become NEW words)")
    ap.add_argument("--continual-lr-rewarm", type=float, default=1.0,
                    help="continual_lr_rewarm for the increment")
    ap.add_argument("--continual-iterations", type=int, default=1,
                    help="continual_iterations for the increment")
    # the hot-row parity gate: hot_rows changes the rounding order (f32 slab sums, one
    # flush per chunk), so it is judged by this A/B: two arms on the same corpus and
    # seed, the hot arm failing when its purity@10 drops more than 0.02 below the
    # classic arm's
    ap.add_argument("--hotrow-ab", action="store_true",
                    help="train TWO arms on the identical corpus/seed, per-step scatters "
                         "and hot_rows=--hot-rows, one row each (hotrow_ab_arm="
                         "classic/hot) plus a parity verdict (purity drop > 0.02 "
                         "absolute fails)")
    ap.add_argument("--hot-rows", type=int, default=4096,
                    help="hot_rows for the hot arm of --hotrow-ab")
    ap.add_argument("--hot-flush-every", type=int, default=0,
                    help="hot_flush_every for the hot arm (0 = once per dispatch chunk)")
    # the local-SGD staleness gate: two shard_map arms on the same corpus and seed on
    # a mesh with a data axis, sync_every=1 and --sync-every, the local arm failing
    # when its purity@10 drops more than 0.03 below the synchronous arm's
    ap.add_argument("--localsgd-ab", action="store_true",
                    help="train TWO shard_map arms on the identical corpus/seed, "
                         "sync_every=1 and sync_every=--sync-every, on a data-parallel "
                         "mesh of --ranks ranks, one row each (localsgd_ab_arm="
                         "sync/local) plus a staleness verdict (purity drop > 0.03 "
                         "absolute fails)")
    ap.add_argument("--sync-every", type=int, default=8,
                    help="sync_every for the local arm of --localsgd-ab (must divide "
                         "steps_per_dispatch=32)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="--localsgd-ab's world: one rank a device (on one card the "
                         "ranks share it); the mesh is max(2, ranks // 4) data shards")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stab-ab", action="store_true",
                    help="train TWO arms on the identical corpus/seed, the unmitigated "
                         "baseline (all stabilizers and the watchdog off) and the "
                         "stabilized arm (the --max-row-norm/--update-clip/--row-l2/"
                         "--norm-watch knobs; max_row_norm=100 + norm_watch=recover when "
                         "none is given), one row each")
    return ap, ap.parse_args(argv)


def continual_ab(args, sents, cache_dir: str, device, provenance: dict,
                 append_rows) -> dict:
    """The forgetting gate: a base fit on the generated corpus, saved as a
    checkpoint; one ``ContinualRunner`` increment over a tail drawn with
    ``--continual-new-types`` more raw types (the ranks past ``--vocab`` are new words,
    and every surviving word's frequency shifts); the post arm scored over the base
    vocabulary's rows ``[:v_base]``, which the identity-prefix contract keeps at the
    same words. Appends one row per arm (``continual_ab_arm`` pre and post) and
    returns the summary."""
    import shutil

    from glint_word2vec_torch import Word2Vec, Word2VecModel
    from glint_word2vec_torch.continual import ContinualRunner

    knobs = dict(continual_lr_rewarm=args.continual_lr_rewarm,
                 continual_iterations=args.continual_iterations)
    est = Word2Vec(device=device, **arm_config(args, **knobs))
    _reset_kernel_counts()
    t0 = time.perf_counter()
    model = est.fit(sents, encode_cache_dir=cache_dir)
    base_s = round(time.perf_counter() - t0, 1)
    words_base = list(model.vocab.words)
    index_base = dict(model.vocab.index)
    v_base = model.num_words
    log(f"continual-ab base: vocab {v_base:,} in {base_s}s")
    tail_words = args.continual_tail_words or args.words // 4
    common = {
        "metric": "topic_recovery_at_text8_scale",
        "corpus_words": args.words, "vocab_raw": args.vocab, "vocab_size": v_base,
        "dim": args.dim, "iterations": args.iters, "param_dtype": args.param_dtype,
        "logits_dtype": args.logits_dtype or "float32",
        "pairs_per_batch": args.batch, "negative_pool": args.pool,
        "subsample_ratio": args.subsample, "min_count": args.min_count,
        "learning_rate": args.lr if args.lr is not None else 0.025,
        "rel_sent_frac": REL_SENT_FRAC, "rel_lambda_entity": REL_LAMBDA_ENTITY,
        "rel_lambda_role": REL_LAMBDA_ROLE, "continual_tail_words": tail_words,
        "continual_new_types": args.continual_new_types, **knobs, **provenance}
    row_pre = {**common, "continual_ab_arm": "pre", "train_seconds_total": base_s,
               "run": _run_stats(est, None)}
    row_pre.update(evaluate(words_base, model.syn0.float().cpu().numpy(), index_base,
                            device=device))

    croot = os.path.join(args.out, "continual")
    shutil.rmtree(croot, ignore_errors=True)
    ckpath = os.path.join(croot, "publish", "ck")
    model.save(ckpath)
    model.stop()
    del model, est
    stream_dir = os.path.join(croot, "stream")
    os.makedirs(stream_dir, exist_ok=True)
    # the drifted tail: the extra raw types past --vocab are new words (their names
    # carry their topics, so the ground truth travels with them)
    generate_corpus(os.path.join(stream_dir, "seg-001.txt"), tail_words,
                    args.seed + 1000, args.vocab + args.continual_new_types)
    _reset_kernel_counts()
    with ContinualRunner(ckpath, stream_dir, os.path.join(croot, "work"),
                         config_overrides=dict(allow_unstable=True, **knobs),
                         device=device) as runner:
        inc = runner.run_once()
    log(f"continual-ab increment: {inc}")
    post = Word2VecModel.load(ckpath, device=device)
    row_post = {**common, "continual_ab_arm": "post",
                "continual_new_words": inc["new_words"],
                "continual_vocab_size": inc["vocab_size"],
                "train_seconds_total": inc["train_seconds"],
                "run": {**inc["trainer"], "seconds": inc["seconds"],
                        "launches": _kernel_counts()}}
    # scored over the ORIGINAL vocabulary's rows only
    row_post.update(evaluate(words_base, post.syn0[:v_base].float().cpu().numpy(),
                             index_base, device=device))
    post.stop()
    append_rows(row_pre, row_post)
    delta = None
    if "purity_at_10" in row_pre and "purity_at_10" in row_post:
        delta = round(row_post["purity_at_10"] - row_pre["purity_at_10"], 4)
    return {"metric": "continual_ab", "purity_delta": delta,
            "purity_pre": row_pre.get("purity_at_10"),
            "purity_post": row_post.get("purity_at_10"),
            "analogy_pre": row_pre.get("analogy_accuracy_at_1"),
            "analogy_post": row_post.get("analogy_accuracy_at_1"),
            "vocab_base": v_base, "vocab_grown": inc["vocab_size"],
            "new_words": inc["new_words"], "arms": [row_pre, row_post]}


def main(argv=None):
    ap, args = parse_args(argv)
    _refuse_unported(ap, args)
    if args.localsgd_ab and args.rank is None:
        sys.exit(_launch_ranks(sys.argv[1:] if argv is None else list(argv), args))

    import torch

    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.data.corpus import TokenFileCorpus
    from glint_word2vec_torch.device import resolve_device
    from glint_word2vec_torch.train.faults import NonFiniteParamsError, NormBlowupError

    device = resolve_device(args.device)
    if args.idle_share and device.type != "cuda":
        ap.error("--idle-share profiles the card; it has no meaning with --device cpu")
    plan, lead = None, True
    if args.localsgd_ab:
        from glint_word2vec_torch.parallel import distributed
        from glint_word2vec_torch.parallel.mesh import make_mesh
        # gloo on the CPU, and when the ranks outnumber the cards (they share one)
        shared = device.type != "cuda" or args.ranks > torch.cuda.device_count()
        if device.type == "cuda" and not shared:
            device = torch.device("cuda", args.rank)
        distributed.initialize(init_method=f"file://{args.store}",
                               num_processes=args.ranks, process_id=args.rank,
                               backend="gloo" if shared else "nccl", device=device)
        plan = make_mesh(max(2, args.ranks // 4))
        lead = args.rank == 0
    card = card_line(device)
    lr = args.lr if args.lr is not None else 0.025
    os.makedirs(args.out, exist_ok=True)
    runs_out = args.runs_out or os.path.join(args.out, "eval_runs.jsonl")
    provenance = {"package": "torch", "device": str(device), "card": card}

    def append_rows(*rows) -> None:
        with open(runs_out, "a", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")

    if args.rescore:
        emb = np.load(os.path.join(args.out, "syn0.npy"))
        with open(os.path.join(args.out, "vocab_words.txt")) as f:
            words = f.read().splitlines()
        if not any(w.startswith(("t0", "t1", "s_")) and "_w" in w for w in words[:1000]):
            ap.error("--rescore needs a model trained on the synthetic ground-truth "
                     "corpus (vocab_words.txt has no t###_w##### names)")
        result = {"metric": "topic_recovery_at_text8_scale", "rescored": True,
                  "corpus_words": args.words, "vocab_raw": args.vocab,
                  "vocab_size": len(words), "dim": int(emb.shape[1]),
                  "iterations": args.iters, "param_dtype": args.param_dtype,
                  "logits_dtype": args.logits_dtype or "float32",
                  "pairs_per_batch": args.batch, "negative_pool": args.pool,
                  "subsample_ratio": args.subsample,
                  "device_pairgen": bool(args.device_pairgen),
                  "cbow": bool(args.cbow), "min_count": args.min_count,
                  "rel_sent_frac": REL_SENT_FRAC,
                  "rel_lambda_entity": REL_LAMBDA_ENTITY,
                  "rel_lambda_role": REL_LAMBDA_ROLE,
                  **({"learning_rate": args.lr} if args.lr is not None else {}),
                  **provenance}
        result.update(evaluate(words, emb.astype(np.float32), device=device))
        print(json.dumps(result))
        append_rows(result)
        return
    if args.corpus:
        corpus_path = args.corpus
        cache_dir = os.path.join(args.out, f"encoded_ext_{args.words}_{args.min_count}")
    else:
        corpus_path = corpus_file(args.out, args.words, args.vocab, args.seed)
        if not lead:
            pass  # rank 0 writes it
        elif not os.path.exists(corpus_path):
            generate_corpus(corpus_path, args.words, args.seed, args.vocab)
        else:
            log(f"reusing corpus at {corpus_path}")
        cache_dir = encode_dir(args.out, args.words, args.vocab, args.min_count)
    if plan is not None:
        distributed.COLLECTIVES.barrier(distributed.host_group())  # the corpus is written
        cache_dir += f".rank{args.rank}"  # each rank encodes into its own cache
    sents = TokenFileCorpus(corpus_path)

    def run_arm(stab: dict, save_arrays: bool, arm: str = "",
                arm_field: str = "stab_ab_arm"):
        """Train one configuration and score it; appends the row (ground-truth corpora
        only) with the requested stabilizer knobs, the engaged end state and what the
        fit did on the device, and returns it. On the A/B's mesh every rank fits its
        rows and rank 0 alone gathers the model (explicitly), scores it and writes."""
        est = Word2Vec(device=device, **arm_config(args, **stab))
        common = {"metric": "topic_recovery_at_text8_scale",
                  "corpus_words": args.words, "vocab_raw": args.vocab,
                  "dim": args.dim, "iterations": args.iters,
                  "pairs_per_batch": args.batch, "negative_pool": args.pool,
                  "subsample_ratio": args.subsample, "min_count": args.min_count,
                  "learning_rate": lr}
        _reset_kernel_counts()
        t0 = time.perf_counter()
        try:
            if args.idle_share:
                from glint_word2vec_torch.stepprof import kernel_busy_s
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    model = est.fit(sents, encode_cache_dir=cache_dir)
                    torch.cuda.synchronize()
                busy = kernel_busy_s(prof)
            else:
                model = est.fit(sents, encode_cache_dir=cache_dir, plan=plan)
                busy = None
            if plan is not None:
                model = model.gather()
        except (NonFiniteParamsError, NormBlowupError) as e:
            # an unmitigated arm may halt mid-run (that is the measurement: the
            # boundary); the divergence is a row, not the end of the other arm
            log(f"arm {arm or 'run'} diverged: {type(e).__name__}: {str(e)[:160]}")
            result = {**common, "diverged": type(e).__name__, **stab,
                      **({arm_field: arm} if arm else {}), **provenance}
            if not args.corpus and lead:
                append_rows(result)
            return result
        train_s = time.perf_counter() - t0
        log(f"trained{f' [{arm}]' if arm else ''}: vocab {model.num_words:,}, "
            f"d={args.dim}, {args.iters} iters in {train_s:.0f}s (incl. vocab+encode "
            "passes)")
        if not lead:
            return {}
        syn0 = model.syn0.float().cpu().numpy()
        if save_arrays:
            np.save(os.path.join(args.out, "syn0.npy"), syn0)
            with open(os.path.join(args.out, "vocab_words.txt"), "w") as f:
                f.write("\n".join(model.vocab.words))
        result = {
            **common,
            "vocab_size": model.num_words,
            "train_seconds_total": round(train_s, 1),
            "param_dtype": args.param_dtype,
            "logits_dtype": args.logits_dtype or "float32",
            "device_pairgen": bool(args.device_pairgen),
            "cbow": bool(args.cbow),
            # the generator's constants (rows compare only within one set)
            "rel_sent_frac": REL_SENT_FRAC,
            "rel_lambda_entity": REL_LAMBDA_ENTITY,
            "rel_lambda_role": REL_LAMBDA_ROLE,
            # the requested knobs and the engaged end state (a recovery may have
            # backed lr off or engaged the clamp)
            **stab,
            **(est.last_run_stats or {}),
            **({arm_field: arm} if arm else {}),
            **provenance,
            "run": _run_stats(est, busy),
        }
        if not args.corpus:
            t_score = time.perf_counter()
            result.update(evaluate(model.vocab.words, syn0, model.vocab.index,
                                   device=device))
            result["run"]["score_s"] = time.perf_counter() - t_score
            # only ground-truth (synthetic corpus) runs qualify as stability evidence
            append_rows(result)
        return result

    if args.continual_ab:
        if args.corpus:
            ap.error("--continual-ab needs the synthetic ground-truth corpus (external "
                     "corpora have no labels to score forgetting against)")
        print(json.dumps(continual_ab(args, sents, cache_dir, device, provenance,
                                      append_rows)))
        return

    if args.localsgd_ab:
        log(f"localsgd-ab mesh: {plan.num_data}x{plan.num_model}, "
            f"sync_every={args.sync_every}, {args.ranks} ranks")
        r_sync = run_arm(dict(step_lowering="shard_map", sync_every=1),
                         save_arrays=False, arm="sync", arm_field="localsgd_ab_arm")
        r_local = run_arm(dict(step_lowering="shard_map", sync_every=args.sync_every),
                          save_arrays=True, arm="local", arm_field="localsgd_ab_arm")
        distributed.shutdown()
        if not lead:
            return
        delta = analogy_delta = None
        if "purity_at_10" in r_sync and "purity_at_10" in r_local:
            delta = round(r_local["purity_at_10"] - r_sync["purity_at_10"], 4)
        if "analogy_accuracy_at_1" in r_sync and "analogy_accuracy_at_1" in r_local:
            analogy_delta = round(r_local["analogy_accuracy_at_1"]
                                  - r_sync["analogy_accuracy_at_1"], 4)
        print(json.dumps({
            "metric": "localsgd_ab", "sync_every": args.sync_every,
            "mesh": [plan.num_data, plan.num_model], "purity_delta": delta,
            "analogy_delta": analogy_delta,
            "staleness_ok": (delta is not None and delta >= -0.03),
            "staleness_rule": "local purity_at_10 >= sync - 0.03 absolute",
            "arms": [r_sync, r_local]}))
        return

    if args.hotrow_ab:
        r_classic = run_arm(dict(hot_rows=0), save_arrays=False, arm="classic",
                            arm_field="hotrow_ab_arm")
        r_hot = run_arm(dict(hot_rows=args.hot_rows, hot_flush_every=args.hot_flush_every),
                        save_arrays=True, arm="hot", arm_field="hotrow_ab_arm")
        delta = analogy_delta = None
        if "purity_at_10" in r_classic and "purity_at_10" in r_hot:
            delta = round(r_hot["purity_at_10"] - r_classic["purity_at_10"], 4)
        if "analogy_accuracy_at_1" in r_classic and "analogy_accuracy_at_1" in r_hot:
            analogy_delta = round(r_hot["analogy_accuracy_at_1"]
                                  - r_classic["analogy_accuracy_at_1"], 4)
        print(json.dumps({
            "metric": "hotrow_ab", "hot_rows": args.hot_rows,
            "hot_flush_every": args.hot_flush_every, "purity_delta": delta,
            "analogy_delta": analogy_delta,
            "parity_ok": (delta is not None and delta >= -0.02),
            "parity_rule": "hot purity_at_10 >= classic - 0.02 absolute",
            "arms": [r_classic, r_hot]}))
        return

    stab = dict(max_row_norm=args.max_row_norm, update_clip=args.update_clip,
                row_l2=args.row_l2, norm_watch=args.norm_watch)
    if args.stab_ab:
        if not (args.max_row_norm or args.update_clip or args.row_l2
                or args.norm_watch != "off"):
            # the default stabilized arm: the clamp at the watchdog threshold and the
            # full recovery ladder
            stab = dict(max_row_norm=100.0, update_clip=0.0, row_l2=0.0,
                        norm_watch="recover")
        # the unmitigated arm is unmitigated: no stabilizers, no watchdog, no
        # non-finite guard (a run that NaNs trains to the end and scores, its
        # non-finite rows masked out of purity and counted in rows_inf)
        off = dict(max_row_norm=0.0, update_clip=0.0, row_l2=0.0, norm_watch="off",
                   nonfinite_policy="none")
        r_off = run_arm(off, save_arrays=False, arm="unmitigated")
        r_stab = run_arm(stab, save_arrays=True, arm="stabilized")
        delta = None
        if "purity_at_10" in r_off and "purity_at_10" in r_stab:
            delta = round(r_stab["purity_at_10"] - r_off["purity_at_10"], 4)
        print(json.dumps({"metric": "stabilizer_ab", "purity_delta": delta,
                          "arms": [r_off, r_stab]}))
        return
    print(json.dumps(run_arm(stab, save_arrays=True)))


if __name__ == "__main__":
    main()
