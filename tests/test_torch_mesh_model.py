"""A model on a mesh in the port (glint_word2vec_torch/models/word2vec.py
``ShardedWord2VecModel``, ``Word2VecModel.load(plan=)``, ``load_latest(plan=)``) on gloo
worlds of 2 and 4 ranks on the CPU, against the port's one-device model and the JAX
package's model on the same mesh shape (its ``load(plan=)`` on its host CPU devices);
and ``serve_checkpoint --mesh`` (a JSON-lines front end on rank 0 and its followers)
against one process.

The checkpoints are made here from a seed through numpy: a dense one and a row-shards
one of 50 words (not a multiple of the meshes' model axes, so padded rows exist), with
two pairs of equal rows (one pair inside a row block, one across blocks) so that tied
scores meet the merge.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_mesh_worker import REPO, SYN_WORDS, check_world, one_torch_thread, spawn_world
from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.vocab import Vocabulary as TVocab
from glint_word2vec_torch.models.word2vec import Word2VecModel as TModel
from glint_word2vec_torch.train import checkpoint as tckpt

V, D = 50, 8
WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
SHAPES = [s for shapes in WORLDS.values() for s in shapes]
CKS = ("dense", "shards")
CASES = [(s, ck) for s in SHAPES for ck in CKS]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    yield from one_torch_thread()


def _matrices():
    rng = np.random.default_rng(17)
    syn0 = rng.standard_normal((V, D)).astype(np.float32)
    syn0[6] = syn0[5]          # a tie inside one row block
    syn0[40] = syn0[10]        # a tie across row blocks
    syn0[20] = 0.0             # a zero-norm row (scores 0)
    syn1 = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
    return syn0, syn1


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_model")
    words = [f"w{i}" for i in range(V)]
    counts = np.arange(2 * V, V, -1, dtype=np.int64)
    syn0, syn1 = _matrices()
    cfg = TConfig(vector_size=D, min_count=1)
    vocab = TVocab.from_words_and_counts(words, counts)
    dense = str(tmp / "dense")
    TModel(vocab, syn0, syn1, cfg, device="cpu").save(dense)
    shards = str(tmp / "shards")
    tckpt.save_model_sharded(shards, words, counts, syn0, syn1, cfg, vocab_size=V,
                             vector_size=D)
    latest = tmp / "latest"
    latest.mkdir()
    tckpt.save_model_sharded(str(latest / "ck"), words, counts, syn0, syn1, cfg,
                             vocab_size=V, vector_size=D)
    return {"dense": dense, "shards": shards, "latest_dir": str(latest), "tmp": tmp}


@pytest.fixture(scope="module")
def worlds(checkpoints):
    out = {}
    for world, shapes in WORLDS.items():
        res = spawn_world("model", world, checkpoints["tmp"] / f"w{world}", {
            "shapes": shapes, "latest_dir": checkpoints["latest_dir"],
            "checkpoints": {k: checkpoints[k] for k in CKS}})
        check_world(res)
        for shape in shapes:
            out[shape] = (res, checkpoints["tmp"] / f"w{world}" / "world-model")
    return out


def _one(checkpoints, name):
    return TModel.load(checkpoints[name], device="cpu")


def _ids(case):
    (nd, nm), ck = case
    return f"{nd}x{nm}-{ck}"


def _lists(got, want, tol=1e-6):
    """Two synonym lists: the same words in the same order, scores within ``tol``."""
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=tol,
                               rtol=0)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_mesh_load_streams_rows_and_pull_is_exact(worlds, checkpoints, case):
    """``load(plan=)`` of either layout is a ShardedWord2VecModel on every rank (the
    ranks ran with the dense ``load_model`` replaced by a function that raises), and
    ``pull`` of every row equals the one-device model's bit for bit on every rank."""
    (nd, nm), ck = case
    res, _ = worlds[(nd, nm)]
    want = _one(checkpoints, ck).pull(list(range(V)))
    for r in range(nd * nm):
        assert res[r]["meta"][f"{nd}x{nm}/{ck}/type"] == "ShardedWord2VecModel"
        np.testing.assert_array_equal(res[r]["arrays"][f"{nd}x{nm}/{ck}/pull"], want)
        np.testing.assert_array_equal(res[r]["arrays"][f"{nd}x{nm}/{ck}/pull_neg"],
                                      want[[-1, 0]])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_ops_equal_the_one_device_model(worlds, checkpoints, case):
    """Every op of the sharded model against the one-device model: the gathers
    (transform, transform_words, transform_sentences, iter_vectors, to_local, syn0,
    get_vectors) bit for bit, norms within 1e-6 and multiply within 1e-5 (atol; rtol
    1e-6), the synonym and analogy lists equal (ties included) with scores within
    1e-6, and OOV a KeyError."""
    (nd, nm), ck = case
    res, _ = worlds[(nd, nm)]
    one = _one(checkpoints, ck)
    words = one.vocab.words[:SYN_WORDS]
    tag = f"{nd}x{nm}/{ck}"
    a, meta = res[0]["arrays"], res[0]["meta"]
    np.testing.assert_array_equal(a[f"{tag}/transform"], one.transform(words[3]))
    np.testing.assert_array_equal(a[f"{tag}/words"],
                                  np.stack(list(one.transform_words(words, 5))))
    np.testing.assert_array_equal(a[f"{tag}/sentences"], one.transform_sentences(
        [words[:3], ["nope"], words[2:9]], batch_size=2))
    np.testing.assert_array_equal(a[f"{tag}/iter"],
                                  np.stack([v for _, v in one.iter_vectors(7)]))
    np.testing.assert_array_equal(a[f"{tag}/local"], one.to_local()[1])
    np.testing.assert_array_equal(a[f"{tag}/syn0"], one.syn0.numpy())
    assert meta[f"{tag}/vectors_equal"]
    np.testing.assert_allclose(a[f"{tag}/norms"], one.norms.numpy(), atol=1e-6, rtol=0)
    vec = np.random.default_rng(5).standard_normal(D).astype(np.float32)
    np.testing.assert_allclose(a[f"{tag}/multiply"], one.multiply(vec), atol=1e-5,
                               rtol=1e-6)
    for got, want in zip(meta[f"{tag}/syn"], one.find_synonyms_batch(words, 5)):
        _lists(got, want)
    _lists(meta[f"{tag}/syn_vec"], one.find_synonyms(vec, 6))
    _lists(meta[f"{tag}/analogy"], one.analogy(words[0], words[1], words[2], 4))
    assert meta[f"{tag}/oov"] == "KeyError"
    for r in range(1, nd * nm):
        assert res[r]["meta"][f"{tag}/syn"] == meta[f"{tag}/syn"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_synonyms_match_the_jax_model_on_the_same_mesh(worlds, checkpoints,
                                                              case):
    """``find_synonyms`` on the sharded model equals the JAX model loaded onto the same
    mesh shape: the same lists (ties in ``lax.top_k``'s order), scores within 1e-6;
    padded rows never surface, even when every row is asked for."""
    from glint_word2vec_tpu.models.word2vec import Word2VecModel as JModel
    from glint_word2vec_tpu.parallel.mesh import make_mesh as j_make_mesh

    (nd, nm), ck = case
    res, _ = worlds[(nd, nm)]
    jm = JModel.load(checkpoints[ck], plan=j_make_mesh(nd, nm))
    meta = res[0]["meta"]
    tag = f"{nd}x{nm}/{ck}"
    words = jm.vocab.words[:SYN_WORDS]
    for got, want in zip(meta[f"{tag}/syn"], jm.find_synonyms_batch(words, 5)):
        _lists(got, want)
    syn_all = meta[f"{tag}/syn_all"]
    assert len(syn_all) == V and all(w in jm.vocab.words for w, _ in syn_all)
    _lists(syn_all, jm.find_synonyms(np.asarray(jm.syn0[0]), V))
    np.testing.assert_array_equal(res[0]["arrays"][f"{tag}/pull"],
                                  jm.pull(list(range(V))))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_exports_are_the_one_device_bytes(worlds, checkpoints, case, tmp_path):
    """``export_word2vec`` on the mesh (rank 0 writes, the blocks gathered in turn)
    writes the one-device export's bytes, binary and text."""
    (nd, nm), ck = case
    _, out = worlds[(nd, nm)]
    one = _one(checkpoints, ck)
    for ext, binary in (("bin", True), ("txt", False)):
        want = tmp_path / f"one.{ext}"
        one.export_word2vec(str(want), binary=binary)
        got = out / f"export-{nd}x{nm}-{ck}.{ext}"
        assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stopped_sharded_model_raises_and_load_latest_places_on_the_mesh(worlds,
                                                                        checkpoints,
                                                                        shape):
    """After ``stop`` every op raises the one-device model's RuntimeError (never a
    NotImplementedError); ``load_latest(plan=)`` loads the directory's newest onto the
    mesh, every rank the same checkpoint."""
    nd, nm = shape
    res, _ = worlds[shape]
    one = TModel.load_latest(checkpoints["latest_dir"], device="cpu")
    for r in range(nd * nm):
        meta = res[r]["meta"]
        for ck in CKS:
            assert meta[f"{nd}x{nm}/{ck}/after_stop"] == ["RuntimeError"] * 4
        np.testing.assert_array_equal(res[r]["arrays"][f"{nd}x{nm}/latest/pull"],
                                      one.pull(list(range(V))))
        for got, want in zip(meta[f"{nd}x{nm}/latest/syn"],
                             one.find_synonyms_batch(one.vocab.words[:SYN_WORDS], 5)):
            _lists(got, want)


# -- serve_checkpoint --mesh ---------------------------------------------------------------


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                GLINT_DISABLE_NATIVE="1")


class _MeshServer:
    """``python -m glint_word2vec_torch.serve_checkpoint CK --mesh ... --device cpu``
    as a child process (rank 0; it starts its followers)."""

    def __init__(self, path, *extra, errfile):
        self._errf = open(errfile, "w")
        self.errfile = errfile
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "glint_word2vec_torch.serve_checkpoint", path,
             "--device", "cpu", *extra], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._errf, text=True, env=_env(), cwd=str(REPO))
        line = self.proc.stdout.readline()
        try:
            self.ready = json.loads(line)
        except json.JSONDecodeError:
            self._errf.flush()
            raise AssertionError("server died at startup; stderr tail:\n"
                                 + open(errfile).read()[-3000:]) from None

    def ask(self, **req):
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())

    def followers(self):
        """The child processes (thread group leaders: a kernel may list a child's
        threads as children too)."""
        pid = self.proc.pid
        out = set()
        for c in Path(f"/proc/{pid}/task/{pid}/children").read_text().split():
            status = Path(f"/proc/{c}/status").read_text()
            out.add(int(next(x.split()[1] for x in status.splitlines()
                             if x.startswith("Tgid:"))))
        return sorted(out)

    def wait(self, timeout=60):
        rc = self.proc.wait(timeout=timeout)
        self._errf.close()
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._errf.close()


def _save_shards(path, seed):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V)]
    syn0 = rng.standard_normal((V, D)).astype(np.float32)
    syn1 = rng.standard_normal((V, D)).astype(np.float32)
    tckpt.save_model_sharded(str(path), words, np.arange(2 * V, V, -1), syn0, syn1,
                             TConfig(vector_size=D, min_count=1), vocab_size=V,
                             vector_size=D)


def _gone(pid, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        st = Path(f"/proc/{pid}/stat")
        if st.exists() and st.read_text().split()[2] == "Z":
            return True
        time.sleep(0.1)
    return False


def test_serve_checkpoint_mesh_answers_reloads_and_stops_as_one_process(tmp_path):
    """The port of tests/test_mode_b_serving.py::test_serving_row_shards_onto_own_mesh:
    a row-shards checkpoint served by ``--mesh 1x2`` (two ranks, each loading its rows)
    answers ``synonyms``, ``synonyms_batch`` and ``vector`` as one process does; an
    explicit reload of a newer publish lands on both ranks (the answers become the new
    model's, whose rows both ranks hold halves of); SIGTERM to rank 0 ends both ranks
    and rank 0 exits 0."""
    ck = tmp_path / "ck"
    _save_shards(ck, 1)
    srv = _MeshServer(str(ck), "--mesh", "1x2", errfile=str(tmp_path / "err"))
    try:
        assert srv.ready == {"ready": True, "num_words": V, "vector_size": D}
        followers = srv.followers()
        assert len(followers) == 1
        one = TModel.load(str(ck), device="cpu")
        words = one.vocab.words[:SYN_WORDS]
        for w in words:
            _lists([tuple(x) for x in srv.ask(op="synonyms", word=w, num=5)["synonyms"]],
                   one.find_synonyms(w, 5))
        got = srv.ask(op="synonyms_batch", words=words, num=4)["synonyms"]
        for g, want in zip(got, one.find_synonyms_batch(words, 4)):
            _lists([tuple(x) for x in g], want)
        np.testing.assert_array_equal(srv.ask(op="vector", word="w7")["vector"],
                                      one.transform("w7"))
        assert srv.ask(op="synonyms", word="nope", num=3)["error_type"] == "KeyError"
        _save_shards(ck, 2)
        assert srv.ask(op="reload") == {"reloaded": True, "num_words": V}
        new = TModel.load(str(ck), device="cpu")
        for w in words:
            _lists([tuple(x) for x in srv.ask(op="synonyms", word=w, num=5)["synonyms"]],
                   new.find_synonyms(w, 5))
        st = srv.ask(op="stats")
        assert st["reloads"] == 1 and st["models_released"] == 1
        srv.proc.send_signal(signal.SIGTERM)
        assert srv.wait() == 0
        assert all(_gone(p) for p in followers)
    finally:
        srv.kill()


def test_serve_checkpoint_mesh_ends_when_a_follower_dies(tmp_path):
    """A follower that dies ends rank 0 with a non-zero exit and a message naming it:
    the mesh does not serve on alone."""
    ck = tmp_path / "ck"
    _save_shards(ck, 3)
    srv = _MeshServer(str(ck), "--mesh", "1x2", errfile=str(tmp_path / "err"))
    try:
        assert srv.ask(op="info")["num_words"] == V
        os.kill(srv.followers()[0], signal.SIGKILL)
        rc = srv.wait(timeout=60)
        assert rc not in (0, None)
        assert "follower rank 1" in Path(srv.errfile).read_text()
    finally:
        srv.kill()


def test_serve_checkpoint_mesh_serves_the_ann_arm_from_rank_0(tmp_path):
    """``--mesh 1x2 --ann``: rank 0 builds the IVF index from the checkpoint's files and
    answers from it (no collective); ``quit`` ends both ranks with exit 0."""
    ck = tmp_path / "ck"
    _save_shards(ck, 4)
    srv = _MeshServer(str(ck), "--mesh", "1x2", "--ann", errfile=str(tmp_path / "err"))
    try:
        got = srv.ask(op="synonyms", word="w0", num=5)["synonyms"]
        assert len(got) == 5 and "w0" not in [w for w, _ in got]
        assert srv.ask(op="stats")["ann"]["centroids"] >= 1
        assert srv.ask(op="quit") == {"bye": True}
        assert srv.wait() == 0
    finally:
        srv.kill()
