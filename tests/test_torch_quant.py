"""The port's quantized IVF arms (glint_word2vec_torch/serve/quant.py and ann.py) on
the CPU: the cases of tests/test_quant.py but the fleet's, each on the port with
``device="cpu"``, and the shard-native build held against the JAX package's.

Row-shards checkpoints are written by the JAX package's ``save_model_sharded`` (the
port reads that layout; its own multi-process writer is ROADMAP queue A9).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.train.checkpoint import save_model_sharded

from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.obs.statusd import serve_prometheus_text
from glint_word2vec_torch.serve import (
    EmbeddingService,
    Int8Storage,
    RecallFloorError,
    build_ivf,
    build_ivf_from_shards,
)
from glint_word2vec_torch.serve.ann import (
    RECALL_FLOORS,
    _normalize_rows,
    resolve_recall_floor,
)
from glint_word2vec_torch.serve.quant import auto_pq_m
from glint_word2vec_torch.train.checkpoint import ShardedMatrixReader


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


CPU = "cpu"


def clustered_matrix(v=3000, d=32, clusters=40, seed=0, noise=0.35):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((clusters, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    return (cents[rng.integers(0, clusters, v)]
            + noise * rng.standard_normal((v, d)).astype(np.float32)
            / np.sqrt(d))


def make_model(v=3000, d=32, seed=0):
    m = clustered_matrix(v, d, seed=seed)
    vocab = Vocabulary.from_words_and_counts(
        [f"w{i}" for i in range(v)], np.ones(v, np.int64))
    return Word2VecModel(vocab, m, device=CPU)


def _save_shards(tmp_path, matrix, name="ck", **cfg):
    """A row-shards checkpoint around a raw matrix (no syn1: serving never reads it),
    written by the JAX package."""
    v, d = matrix.shape
    ck = str(tmp_path / name)
    save_model_sharded(ck, [f"w{i}" for i in range(v)], np.ones(v, np.int64),
                       jnp.asarray(matrix), None,
                       JConfig(vector_size=d, min_count=1, **cfg))
    return ck


# -- quantized storage encodings --------------------------------------------------------


def test_int8_encode_roundtrip_and_zero_rows():
    rows = _normalize_rows(clustered_matrix(v=64, d=32, seed=3))[0]
    rows[5] = 0.0
    codes, scales = Int8Storage.encode(rows)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    deq = codes.astype(np.float32) * scales[:, None]
    assert np.max(np.abs(deq - rows)) <= np.max(np.abs(rows)) / 254 + 1e-7
    assert not codes[5].any() and scales[5] == 1.0


def test_quant_builds_are_deterministic():
    m = clustered_matrix(v=400, d=24, seed=7)
    for quant in ("int8", "pq"):
        a = build_ivf(m, seed=4, quant=quant, measure_recall=False, recall_floor=0.0)
        b = build_ivf(m, seed=4, quant=quant, measure_recall=False, recall_floor=0.0)
        np.testing.assert_array_equal(a._centroids, b._centroids)
        np.testing.assert_array_equal(a._ids, b._ids)
        np.testing.assert_array_equal(a._storage._codes, b._storage._codes)


def test_int8_full_probe_with_rerank_matches_exact_oracle():
    m = clustered_matrix(v=600, d=32, seed=1)
    ix = build_ivf(m, seed=0, quant="int8", measure_recall=False, recall_floor=0.0)
    normed = _normalize_rows(m)[0]
    q = normed[:8]
    s, i = ix.search(q, 5, nprobe=ix.num_centroids)
    exact = q @ normed.T
    for r in range(q.shape[0]):
        want = np.argsort(-exact[r], kind="stable")[:5]
        np.testing.assert_array_equal(i[r], want)
        np.testing.assert_allclose(s[r], exact[r][want], rtol=1e-5)


def test_pq_recall_floor_passes_on_clustered_geometry():
    m = clustered_matrix(v=3000, d=32, seed=2)
    ix = build_ivf(m, seed=0, quant="pq")  # the AUTO floor 0.95 gates this
    assert ix.quant == "pq"
    assert ix.stats["recall_at_10"] >= RECALL_FLOORS["pq"]
    assert ix.stats["recall_floor"] == RECALL_FLOORS["pq"]
    assert ix.stats["pq_m"] == auto_pq_m(32)
    assert ix.stats["rerank"] >= 100


def test_footprint_byte_math_and_stats():
    v, d = 2000, 32
    m = clustered_matrix(v=v, d=d, seed=5)
    f32 = build_ivf(m, seed=0, measure_recall=False)
    i8 = build_ivf(m, seed=0, quant="int8", measure_recall=False, recall_floor=0.0)
    pq = build_ivf(m, seed=0, quant="pq", measure_recall=False, recall_floor=0.0)
    assert i8._storage.nbytes == v * d + v * 4
    mm = pq._storage.m
    assert pq._storage.nbytes == v * mm * 2 + mm * 256 * pq._storage.dsub * 4
    assert i8._storage.nbytes < 0.30 * f32._storage.nbytes
    for ix in (f32, i8, pq):
        assert ix.stats["index_bytes"] == ix.index_bytes
        assert ix.stats["bytes_per_vector"] == round(ix.index_bytes / v, 2)
    assert pq.index_bytes < i8.index_bytes < f32.index_bytes


def test_quant_vector_is_exact_and_keep_rows_false_drops_source():
    m = clustered_matrix(v=500, d=16, seed=6)
    normed = _normalize_rows(m)[0]
    ix = build_ivf(m, seed=0, quant="pq", measure_recall=False, recall_floor=0.0)
    np.testing.assert_allclose(ix.vector(17), normed[17], rtol=1e-5)
    codes_only = build_ivf(m, seed=0, quant="pq", recall_floor=0.0, keep_rows=False)
    assert codes_only._row_fetch is None
    assert isinstance(codes_only.stats["recall_at_10"], float)
    with pytest.raises(RuntimeError, match="keep_rows"):
        codes_only.measure_recall(np.arange(8))
    assert codes_only.vector(17).shape == normed[17].shape


# -- recall gating ----------------------------------------------------------------------


def test_resolve_recall_floor_auto_and_explicit():
    assert resolve_recall_floor(-1.0, "int8") == RECALL_FLOORS["int8"]
    assert resolve_recall_floor(None, "pq") == RECALL_FLOORS["pq"]
    assert resolve_recall_floor(-1.0, "f32") == 0.0
    assert resolve_recall_floor(0.5, "pq") == 0.5
    assert resolve_recall_floor(0.0, "int8") == 0.0


def test_recall_floor_refuses_adversarial_matrix():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((2500, 48)).astype(np.float32)
    with pytest.raises(RecallFloorError) as ei:
        build_ivf(m, seed=0, quant="pq", rerank=-1)
    err = ei.value
    assert err.quant == "pq"
    assert err.measured < err.floor == RECALL_FLOORS["pq"]
    assert "explicit recall_floor to override" in str(err)
    ix = build_ivf(m, seed=0, quant="pq", rerank=-1, recall_floor=0.0)
    assert ix.stats["recall_at_10"] == err.measured


# -- search semantics across all three arms ---------------------------------------------


@pytest.mark.parametrize("quant", ["f32", "int8", "pq"])
def test_tiny_cell_probing_covers_k_all_arms(quant):
    m = clustered_matrix(v=30, d=8, clusters=5, seed=0)
    ix = build_ivf(m, seed=0, quant=quant, measure_recall=False, recall_floor=0.0)
    s, i = ix.search(m[:4], 6, nprobe=1)
    assert (i >= 0).all() and np.isfinite(s).all()
    for r in range(4):
        assert len(set(i[r].tolist())) == 6


@pytest.mark.parametrize("quant", ["f32", "int8", "pq"])
def test_sub_k_fill_semantics_all_arms(quant):
    m = clustered_matrix(v=6, d=8, clusters=2, seed=1)
    ix = build_ivf(m, seed=0, quant=quant, measure_recall=False, recall_floor=0.0)
    s, i = ix.search(m[:2], 10, nprobe=ix.num_centroids)
    assert (i[:, :6] >= 0).all()
    assert (i[:, 6:] == -1).all()
    assert np.isneginf(s[:, 6:]).all()


@pytest.mark.parametrize("quant", ["int8", "pq"])
def test_zero_norm_rows_never_surface_quant(quant):
    m = clustered_matrix(v=200, d=16, seed=8)
    dead = [3, 77, 150]
    m[dead] = 0.0
    ix = build_ivf(m, seed=0, quant=quant, measure_recall=False, recall_floor=0.0)
    _, i = ix.search(m[:5], 8, nprobe=ix.num_centroids)
    assert not (np.isin(i, dead)).any()


def test_oov_raises_keyerror_through_quant_service():
    model = make_model(v=300, d=16)
    ix = build_ivf(model.syn0.cpu().numpy(), seed=0, quant="int8",
                   measure_recall=False, recall_floor=0.0)
    svc = EmbeddingService(model=model, ann_index=ix)
    try:
        assert len(svc.synonyms("w0", 5)) == 5
        with pytest.raises(KeyError, match="not in vocabulary"):
            svc.synonyms("nope", 5)
    finally:
        svc.close()


# -- shard-native build -----------------------------------------------------------------


def test_shard_native_build_matches_in_memory(tmp_path):
    m = clustered_matrix(v=500, d=24, seed=9)
    ck = _save_shards(tmp_path, m)
    for quant in ("int8", "pq"):
        mem = build_ivf(m, seed=0, quant=quant, recall_floor=0.0)
        shd = build_ivf_from_shards(ck, quant=quant, seed=0, recall_floor=0.0,
                                    block_rows=64)
        assert shd.stats["build"] == "shard-native"
        np.testing.assert_array_equal(mem._centroids, shd._centroids)
        np.testing.assert_array_equal(mem._ids, shd._ids)
        np.testing.assert_array_equal(mem._storage._codes, shd._storage._codes)
        if quant == "int8":
            np.testing.assert_array_equal(mem._storage._scales, shd._storage._scales)
        assert shd.stats["recall_at_10"] == mem.stats["recall_at_10"]
        np.testing.assert_allclose(shd.vector(11), _normalize_rows(m)[0][11],
                                   rtol=1e-5)


@pytest.mark.parametrize("quant", ["int8", "pq"])
def test_shard_native_build_matches_the_jax_package(tmp_path, quant):
    """Below ``train_sample`` rows the k-means sample is every row: the port's
    shard-native build equals the JAX package's bit for bit."""
    from glint_word2vec_tpu.serve import build_ivf_from_shards as jax_from_shards
    m = clustered_matrix(v=700, d=24, seed=24)
    ck = _save_shards(tmp_path, m)
    kw = dict(quant=quant, seed=3, recall_floor=0.0, block_rows=100)
    mine, ref = build_ivf_from_shards(ck, **kw), jax_from_shards(ck, **kw)
    for name in ("_centroids", "_offsets", "_ids", "_row_pos"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    np.testing.assert_array_equal(mine._storage._codes, ref._storage._codes)
    assert mine.stats["recall_at_10"] == ref.stats["recall_at_10"]


@pytest.mark.parametrize("quant", ["int8", "pq"])
def test_shard_native_build_equals_in_memory_past_the_sample(tmp_path, quant):
    """Past ``train_sample`` rows the k-means sample is a seeded draw, and its order
    seeds the centroids. The port's shard-native build keeps the in-memory build's
    order, so its codes equal the in-memory build's, in both packages; the JAX
    package's shard-native build sorts the sample and differs from its own in-memory
    build (ROADMAP.md queue C)."""
    from glint_word2vec_tpu.serve import build_ivf as jax_build_ivf
    from glint_word2vec_tpu.serve import build_ivf_from_shards as jax_from_shards
    m = clustered_matrix(v=1500, d=24, seed=25)
    ck = _save_shards(tmp_path, m)
    kw = dict(quant=quant, seed=0, recall_floor=0.0, train_sample=300)
    shd = build_ivf_from_shards(ck, block_rows=128, **kw)
    mem, ref_mem = build_ivf(m, **kw), jax_build_ivf(m, **kw)
    for ix in (mem, ref_mem):
        np.testing.assert_array_equal(shd._centroids, ix._centroids)
        np.testing.assert_array_equal(shd._ids, ix._ids)
        np.testing.assert_array_equal(shd._storage._codes, ix._storage._codes)
    assert shd.stats["recall_at_10"] == mem.stats["recall_at_10"]
    ref_shd = jax_from_shards(ck, block_rows=128, **kw)
    assert not np.array_equal(ref_shd._centroids, ref_mem._centroids)


def test_shard_native_build_is_structurally_dense_free(tmp_path, monkeypatch):
    m = clustered_matrix(v=420, d=16, seed=10)
    ck = _save_shards(tmp_path, m)
    block_rows = 50
    real_read = ShardedMatrixReader.read

    def bounded_read(self, start, stop, workers=1):
        assert stop - start <= block_rows, f"unbounded read [{start}, {stop})"
        return real_read(self, start, stop, workers)

    def forbidden(self, *a, **kw):
        raise AssertionError("dense read_all() inside shard-native build")

    monkeypatch.setattr(ShardedMatrixReader, "read_all", forbidden)
    monkeypatch.setattr(ShardedMatrixReader, "read", bounded_read)
    ix = build_ivf_from_shards(ck, quant="int8", seed=0, recall_floor=0.0,
                               block_rows=block_rows, train_sample=64,
                               measure_recall=False)
    assert ix.num_rows == 420
    monkeypatch.setattr(ShardedMatrixReader, "read", real_read)
    ix2 = build_ivf_from_shards(ck, quant="int8", seed=0, recall_floor=0.0,
                                block_rows=block_rows, train_sample=64,
                                recall_queries=32)
    assert ix2.stats["recall_at_10"] > 0


def test_shard_native_refuses_f32(tmp_path):
    ck = _save_shards(tmp_path, clustered_matrix(v=50, d=8, seed=11))
    with pytest.raises(ValueError, match="dense \\[V, D\\] float32"):
        build_ivf_from_shards(ck, quant="f32")


def test_shard_native_recall_gate_fires(tmp_path):
    rng = np.random.default_rng(1)
    ck = _save_shards(tmp_path, rng.standard_normal((800, 16)).astype(np.float32))
    with pytest.raises(RecallFloorError):
        build_ivf_from_shards(ck, quant="pq", seed=0, rerank=-1)


def test_save_row_shards_is_read_by_both_packages(tmp_path):
    """The port's one-writer row-shards checkpoint (``checkpoint.save_row_shards``,
    which servebench's shard-native leg writes): the JAX package's and the port's
    loaders read it (digests verified), and both shard-native builds equal the
    in-memory one."""
    from glint_word2vec_tpu.models.word2vec import Word2VecModel as JModel
    from glint_word2vec_tpu.serve import build_ivf_from_shards as jax_from_shards

    from glint_word2vec_torch.train.checkpoint import save_row_shards
    m = clustered_matrix(v=700, d=16, seed=26).astype(np.float32)
    ck = str(tmp_path / "ck")
    save_row_shards(ck, [f"w{i}" for i in range(700)], np.ones(700, np.int64), m,
                    Word2VecConfig(vector_size=16, min_count=1), rows_per_shard=256)
    assert sorted(p.name for p in (tmp_path / "ck" / "syn0.shards").iterdir()) == [
        "rows-0000000000-0000000256.npy", "rows-0000000256-0000000512.npy",
        "rows-0000000512-0000000700.npy"]
    np.testing.assert_array_equal(Word2VecModel.load(ck, device=CPU).syn0.numpy(), m)
    np.testing.assert_array_equal(np.asarray(JModel.load(ck).syn0), m)
    mem = build_ivf(m, quant="int8", seed=0, recall_floor=0.0)
    for build in (build_ivf_from_shards, jax_from_shards):
        shd = build(ck, quant="int8", seed=0, recall_floor=0.0)
        np.testing.assert_array_equal(shd._storage._codes, mem._storage._codes)


# -- EmbeddingService integration -------------------------------------------------------


def test_service_quant_knob_from_checkpoint_config(tmp_path):
    m = clustered_matrix(v=300, d=16, seed=12)
    ck = _save_shards(tmp_path, m, serve_ann_quant="int8", serve_ann_recall_floor=0.0)
    svc = EmbeddingService(checkpoint=ck, ann=True, device=CPU)
    try:
        ann = svc.info()["ann"]
        assert ann["quant"] == "int8"
        assert "index_bytes" in ann and "bytes_per_vector" in ann
        assert len(svc.synonyms("w0", 5)) == 5
    finally:
        svc.close()


def test_service_shard_native_build_and_ctor_override(tmp_path):
    ck = _save_shards(tmp_path, clustered_matrix(v=300, d=16, seed=13))
    svc = EmbeddingService(checkpoint=ck, ann=True, ann_from_shards=True,
                           ann_quant="pq", ann_recall_floor=0.0, device=CPU)
    try:
        ann = svc.info()["ann"]
        assert ann["quant"] == "pq" and ann["build"] == "shard-native"
        assert len(svc.synonyms("w3", 5)) == 5
    finally:
        svc.close()
    with pytest.raises(ValueError, match="shard"):
        EmbeddingService(model=make_model(50, 16), ann=True, ann_from_shards=True)


def test_densify_guard_names_shard_native_migration(tmp_path):
    ck = _save_shards(tmp_path, clustered_matrix(v=300, d=16, seed=14))
    with pytest.raises(RuntimeError) as ei:
        EmbeddingService(checkpoint=ck, ann=True, ann_quant="int8",
                         ann_recall_floor=0.0, ann_max_densify_bytes=1, device=CPU)
    msg = str(ei.value)
    assert "shard-native" in msg and "ann_from_shards" in msg
    svc = EmbeddingService(checkpoint=ck, ann=True, ann_from_shards=True,
                           ann_quant="int8", ann_recall_floor=0.0,
                           ann_max_densify_bytes=1, device=CPU)
    try:
        assert svc.info()["ann"]["quant"] == "int8"
    finally:
        svc.close()


def test_service_vgrew_reload_keeps_quant_arm_and_remeasures(tmp_path):
    """A vocabulary-grown publish (written here by the port's continual extend, per
    shard) hot-reloads into a rebuild at the SAME quant arm with recall re-measured on
    the grown matrix."""
    from glint_word2vec_torch.continual.extend import extend_checkpoint
    m = clustered_matrix(v=300, d=16, seed=15)
    ck = _save_shards(tmp_path, m)
    svc = EmbeddingService(checkpoint=ck, ann=True, ann_quant="int8",
                           ann_recall_floor=0.0, device=CPU)
    try:
        before = svc.info()["ann"]
        assert before["quant"] == "int8" and before["rows"] == 300
        rep = extend_checkpoint(ck, {"brandnew0": 20, "brandnew1": 20}, min_count=1)
        svc.reload_now()
        after = svc.info()["ann"]
        assert after["quant"] == "int8"
        assert after["rows"] == rep["new_vocab_size"] == 302
        assert isinstance(after["recall_at_10"], float)
        assert svc.stats()["vocab_change_reloads"] == 1
        s = svc.synonyms("brandnew0", 3)
        assert len(s) == 3 and all(np.isfinite(x) for _, x in s)
    finally:
        svc.close()


# -- observability ----------------------------------------------------------------------


def test_statusd_renders_index_footprint_gauges():
    snap = {"status": "serving", "submitted": 1, "completed": 1,
            "ann": {"recall_at_10": 0.97, "nprobe": 4, "centroids": 32,
                    "index_bytes": 123456, "bytes_per_vector": 36.5}}
    text = serve_prometheus_text(snap)
    assert "glint_serve_index_bytes 123456" in text
    assert "glint_serve_ann_bytes_per_vector 36.5" in text
