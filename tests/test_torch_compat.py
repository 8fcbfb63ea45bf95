"""The Spark-style compat layer of the port against the JAX package's: a setter chain
maps to the same config (at the same device count), and fit / transform /
findSynonyms / save / load / stop work on the CPU. A chain that lands on a knob the
port does not train with fails at fit with that knob's NotImplementedError."""

import warnings

import jax
import numpy as np
import pytest

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch.models import ServerSideGlintWord2Vec as TW2V
from glint_word2vec_torch.models import ServerSideGlintWord2VecModel as TModel
from glint_word2vec_torch.models import compat as tcompat
from glint_word2vec_tpu.models import ServerSideGlintWord2Vec as JW2V


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


def _chains():
    return {
        "default": lambda c: c,
        "full": lambda c: (c.setVectorSize(64).setStepSize(0.02).setNumPartitions(2)
                           .setMaxIter(3).setSeed(9).setWindowSize(3).setMinCount(1)
                           .setMaxSentenceLength(100).setBatchSize(600).setN(4)
                           .setSubsampleRatio(1e-3).setNumParameterServers(2)
                           .setUnigramTableSize(1000).setInputCol("s")
                           .setOutputCol("v").setParameterServerHost("ps:1")
                           .setParameterServerConfig({"a": 1})),
        "ml_names": lambda c: (c.setLearningRate(0.05).setNumIterations(2)
                               .setBatchSize(10).setNumParameterServers(1)),
    }


@pytest.mark.parametrize("chain", list(_chains()))
def test_setter_chain_maps_to_the_same_config(chain, monkeypatch):
    n_dev = len(jax.devices())
    monkeypatch.setattr(tcompat, "_device_count", lambda device: n_dev)
    build = _chains()[chain]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = build(TW2V(device="cpu")).to_config()
        j = build(JW2V()).to_config()
    assert t.to_dict() == j.to_dict()
    assert t.to_dict(auto_markers=False) == j.to_dict(auto_markers=False)


def test_refused_knob_fails_at_fit(monkeypatch):
    """Three parameter servers map to a mesh of three model shards, which a world of
    one cannot hold: the fit raises, naming the knob (every step form runs on a mesh,
    but one rank is one device and the port never falls back to fewer)."""
    monkeypatch.setattr(tcompat, "_device_count", lambda device: 4)
    est = TW2V(device="cpu").setNumParameterServers(3).setMinCount(1)
    assert est.to_config().num_model_shards == 3  # the mapping itself is kept
    with pytest.raises(ValueError, match="num_model_shards.*this world has 1"):
        est.fit([["a", "b", "c"]] * 10)


def _topic_corpus(n=300, seed=0):
    rng = np.random.default_rng(seed)
    topics = [["a", "b", "c", "d"], ["x", "y", "z", "w"]]
    return [list(rng.choice(topics[i % 2], size=12)) for i in range(n)]


def test_fit_transform_find_save_load_on_cpu(tmp_path):
    sents = _topic_corpus()
    est = (TW2V(device="cpu").setVectorSize(16).setMinCount(1).setWindowSize(3)
           .setNumIterations(3).setSeed(2).setLearningRate(0.02).setBatchSize(64)
           .setNumPartitions(2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = est.fit([{"sentence": s} for s in sents])
    cfg = model.inner.config
    assert cfg.negative_pool == 0 and cfg.num_model_shards == 1
    assert cfg.pairs_per_batch == 128
    v = model.transform("a")
    assert v.shape == (16,) and np.isfinite(v).all()
    rows = model.transform([{"sentence": ["a", "b"], "id": 1}])
    assert rows[0]["id"] == 1 and rows[0]["vector"].shape == (16,)
    np.testing.assert_allclose(model.transform([["a", "b"]])[0],
                               (model.transform("a") + model.transform("b")) / 2,
                               atol=1e-6)
    assert len(model.transform(["a", "x"])) == 2
    syn = model.findSynonyms("a", 3)
    assert len(syn) == 3 and all(w != "a" for w, _ in syn)
    assert model.findSynonymsArray(v, 2)[0][0] == "a"
    assert set(model.getVectors()) == set("abcdxyzw")
    words, mat = model.toLocal()
    assert mat.shape == (8, 16) and len(words) == 8
    assert len(model.analogy("a", "b", "x", 2)) == 2
    model.save(str(tmp_path / "m"))
    with pytest.warns(UserWarning):
        back = TModel.load(str(tmp_path / "m"), parameterServerHost="ps", device="cpu")
    np.testing.assert_array_equal(back.transform("a"), v)
    back.stop(terminateOtherClients=True)
    with pytest.raises(RuntimeError, match="stopped"):
        back.findSynonyms("a", 3)
