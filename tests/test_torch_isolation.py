"""The port stands alone: it imports neither jax, the JAX package, ml_dtypes nor the
repo's ``tools/``, its entry points run on the card unless told otherwise (and never fall
back silently), and knobs it has not implemented are refused by name."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from glint_word2vec_torch import Word2Vec, Word2VecConfig, Word2VecModel
from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
# the card's machine has no ml_dtypes: bf16 crosses as float32 (exact), cast by torch;
# the repo's tools/ import the JAX package (the port keeps its own copies)
FORBIDDEN = ("jax", "jaxlib", "glint_word2vec_tpu", "ml_dtypes", "tools")


def _port_files():
    files = sorted((REPO / "glint_word2vec_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_import_leaves_jax_out():
    code = ("import sys, glint_word2vec_torch, glint_word2vec_torch.ops.fused_sgns, "
            "glint_word2vec_torch.ops.scatter, glint_word2vec_torch.scatterprobe, "
            "glint_word2vec_torch.stepprof, glint_word2vec_torch.interop, "
            "glint_word2vec_torch.data.native, glint_word2vec_torch.data.corpus, "
            "glint_word2vec_torch.data.ingest_native, glint_word2vec_torch.train.faults, "
            "glint_word2vec_torch.ops.pairgen, glint_word2vec_torch.models.compat, "
            "glint_word2vec_torch.ops.cbow_banded, glint_word2vec_torch.obs, "
            "glint_word2vec_torch.obs.probe, glint_word2vec_torch.obs.watch, "
            "glint_word2vec_torch.obs.schema, glint_word2vec_torch.obs.sink, "
            "glint_word2vec_torch.obs.spans, glint_word2vec_torch.obs.phases, "
            "glint_word2vec_torch.obs.blackbox, glint_word2vec_torch.obs.statusd, "
            "glint_word2vec_torch.obs.trace, glint_word2vec_torch.lockcheck, "
            "glint_word2vec_torch.serve, glint_word2vec_torch.serve_checkpoint, "
            "glint_word2vec_torch.servebench, glint_word2vec_torch.train, "
            "glint_word2vec_torch.train.supervisor, glint_word2vec_torch.train_run, "
            "glint_word2vec_torch.eval_quality, glint_word2vec_torch.serve.fleet, "
            "glint_word2vec_torch.obs.slo, glint_word2vec_torch.obs.collect, "
            "glint_word2vec_torch.obs_collect, glint_word2vec_torch.fleet_run, "
            "glint_word2vec_torch.chaos_run, glint_word2vec_torch.stepaudit, "
            "glint_word2vec_torch.train.syncsites, glint_word2vec_torch.continual, "
            "glint_word2vec_torch.continual.extend, glint_word2vec_torch.continual.stream, "
            "glint_word2vec_torch.continual.loop, glint_word2vec_torch.continual_run, "
            "glint_word2vec_torch.parallel.distributed, glint_word2vec_torch.parallel.mesh, "
            "glint_word2vec_torch.ops.sgns_shard\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr


def test_native_code_is_the_ports_own():
    """The port builds its C++ from its own sources into its own ``_build/``, and a
    process that loads both libraries maps nothing of the JAX package."""
    code = ("from glint_word2vec_torch.data import native, ingest_native\n"
            "assert native.native_available() and ingest_native.ingest_available()\n"
            "print(native.loaded_library())\n"
            "print(ingest_native.loaded_library())\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('glint_word2vec_tpu' in maps)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300, cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    *libs, mapped = r.stdout.split()
    port = REPO / "glint_word2vec_torch"
    for lib in libs:
        assert Path(lib).parent == port / "_build", lib
    assert mapped == "False"
    from glint_word2vec_torch.data import ingest_native, native
    for src in (native._SRC, ingest_native._SRC):
        assert src.parent == port / "native" and src.exists()
        assert native.library_path(src, "c++17").parent == port / "_build"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_default_to_the_card(tmp_path):
    vocab = Vocabulary.from_words_and_counts(["a", "b", "c"], [5, 4, 3])
    cfg = Word2VecConfig(vector_size=8, pairs_per_batch=4096)
    if torch.cuda.is_available():
        assert Trainer(cfg, vocab).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Word2Vec(vector_size=8, pairs_per_batch=4096)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, vocab)
    model = Word2VecModel(vocab, np.ones((3, 8), np.float32), device="cpu")
    model.save(str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Word2VecModel.load(str(tmp_path / "m"))


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    """Without ``device`` the interop helper places the parameters on the card, so
    with no GPU visible it raises resolve_device's error instead of using the CPU."""
    from glint_word2vec_torch import interop

    a = np.ones((4, 8), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.params_from_numpy(a, a)
    assert interop.params_from_numpy(a, a, device="cpu").syn0.device.type == "cpu"


def test_prng_helpers_take_no_default_device():
    from glint_word2vec_torch.ops import prng

    for fn, args in ((prng.hash_bits, (1, 0, 2, (3,))), (prng.uniform01, (1, 0, 2, (3,))),
                     (prng.randint_mod, (1, 0, 2, (3,), 7))):
        with pytest.raises(TypeError):
            fn(*args)
        assert fn(*args, "cpu").device.type == "cpu"


@pytest.mark.parametrize("knob,value", [
    ("use_pallas", True), ("embedding_partition", "cols"),
])
def test_unported_knobs_are_refused_by_name(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        Word2VecConfig(pairs_per_batch=8192, **{knob: value})
    d = Word2VecConfig(pairs_per_batch=8192).to_dict()
    d.update({knob: value})
    assert getattr(Word2VecConfig.from_dict(d, check_ported=False), knob) == value


@pytest.mark.parametrize("knob,value", [
    ("cbow_update", "banded"), ("max_row_norm", 10.0), ("update_clip", 0.5),
    ("row_l2", 1e-4), ("duplicate_scaling", True), ("fused_logits", True),
    ("param_dtype", "bfloat16"), ("compute_dtype", "bfloat16"),
    ("logits_dtype", "bfloat16"), ("hot_rows", 8), ("profile_dir", "/x"),
    ("telemetry_path", "/x"), ("norm_watch", "warn"), ("norm_watch", "recover"),
    ("norm_watch", "halt"), ("nonfinite_policy", "rollback"), ("status_port", 8123),
    ("checkpoint_on_preempt", True), ("serve_max_batch", 8), ("serve_ann_quant", "pq"),
    ("serve_fleet_hedge_ms", 5.0), ("serve_fleet_replicas", 2), ("serve_fleet_probe_s", 1.0),
    ("sync_every", 2), ("sharded_checkpoint", True), ("peer_beacon_s", 1.0),
    ("num_model_shards", 2), ("step_lowering", "shard_map"), ("num_data_shards", 2),
    ("mesh_shape", (2, 1)),
])
def test_ported_knobs_are_accepted(knob, value):
    """Banded CBOW, the stabilizers, duplicate scaling, the bf16 dtypes, the step
    restructurings, the runtime layer's knobs and the serving tier's (the fleet's among
    them) are ported: accepted by the config and carried through to_dict/from_dict with
    the port's checks on."""
    # banded needs CBOW, local SGD the shard_map lowering
    extra = {"cbow_update": {"cbow": True},
             "sync_every": {"step_lowering": "shard_map"}}.get(knob, {})
    cfg = Word2VecConfig(pairs_per_batch=8192, **{knob: value}, **extra)
    assert getattr(Word2VecConfig.from_dict(cfg.to_dict()), knob) == value


@pytest.mark.parametrize("kw", [
    {"pairs_per_batch": 512}, {"pairs_per_batch": 8192, "negative_pool": 0},
    {"pairs_per_batch": 512, "negative_pool": 64}, {"pairs_per_batch": 4096},
    {"pairs_per_batch": 512, "cbow": True}, {"pairs_per_batch": 8192, "cbow": True},
    {"pairs_per_batch": 8192, "cbow": True, "negative_pool": 0},
    {"pairs_per_batch": 65536, "negatives": 10},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_per_pair_pool_is_refused(kw):
    """The per-pair and per-example paths are ported: a pool that resolves to 0 is
    accepted now, and every pool resolves as the JAX package resolves it."""
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    cfg = Word2VecConfig(**kw)
    assert cfg.negative_pool == JConfig(**kw).negative_pool
    assert cfg.to_dict() == JConfig(**kw).to_dict()


@pytest.mark.parametrize("kw", [
    {"cbow_update": "banded"}, {"cbow_update": "rows"},
    {"cbow": True, "cbow_update": "banded", "negative_pool": 0},
])
def test_cbow_validation_matches_the_jax_package(kw):
    """The JAX package's CBOW checks run in the port too: configs it refuses with a
    ValueError are refused so here (checkpoint readers included)."""
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    with pytest.raises(ValueError):
        JConfig(**kw)
    with pytest.raises(ValueError):
        Word2VecConfig(**kw, check_ported=False)


def test_config_key_set_matches_the_jax_package():
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    for kw in ({}, {"pairs_per_batch": 65536, "subsample_ratio": 1e-4}):
        assert Word2VecConfig(**kw).to_dict() == JConfig(**kw).to_dict()
        assert (Word2VecConfig(**kw).to_dict(auto_markers=False)
                == JConfig(**kw).to_dict(auto_markers=False))
