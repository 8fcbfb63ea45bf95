"""The port stands alone: it imports neither jax nor the JAX package, its entry points
run on the card unless told otherwise (and never fall back silently), and knobs it has
not implemented are refused by name."""

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
FORBIDDEN = ("jax", "jaxlib", "glint_word2vec_tpu")


def _port_files():
    files = sorted((REPO / "glint_word2vec_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_import_leaves_jax_out():
    code = ("import sys, glint_word2vec_torch, glint_word2vec_torch.ops.fused_sgns, "
            "glint_word2vec_torch.interop\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr


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


@pytest.mark.parametrize("knob,value", [
    ("cbow", True), ("use_pallas", True), ("param_dtype", "bfloat16"),
    ("hot_rows", 8), ("max_row_norm", 10.0), ("num_model_shards", 2),
    ("step_lowering", "shard_map"), ("telemetry_path", "/x"), ("norm_watch", "warn"),
    ("nonfinite_policy", "rollback"), ("serve_ann_quant", "pq"), ("mesh_shape", (2, 1)),
])
def test_unported_knobs_are_refused_by_name(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        Word2VecConfig(pairs_per_batch=8192, **{knob: value})
    d = Word2VecConfig(pairs_per_batch=8192).to_dict()
    d[knob] = value
    assert getattr(Word2VecConfig.from_dict(d, check_ported=False), knob) == value


def test_per_pair_pool_is_refused():
    with pytest.raises(NotImplementedError, match="per-pair"):
        Word2VecConfig(pairs_per_batch=512)
    with pytest.raises(NotImplementedError, match="per-pair"):
        Word2VecConfig(pairs_per_batch=8192, negative_pool=0)
    assert Word2VecConfig(pairs_per_batch=512, negative_pool=64).negative_pool == 64


def test_config_key_set_matches_the_jax_package():
    from glint_word2vec_tpu.config import Word2VecConfig as JConfig
    for kw in ({}, {"pairs_per_batch": 65536, "subsample_ratio": 1e-4}):
        assert Word2VecConfig(**kw).to_dict() == JConfig(**kw).to_dict()
        assert (Word2VecConfig(**kw).to_dict(auto_markers=False)
                == JConfig(**kw).to_dict(auto_markers=False))
