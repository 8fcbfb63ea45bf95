"""The serving tier on the card, held against the same service on the CPU.

Marked ``cuda``: they need an NVIDIA GPU and skip elsewhere. The exact arm runs on the
card (one matrix product and one sort per batch); the IVF arm is host numpy in both, so
its lists must be equal; the exact lists may differ only where two scores tie within
1e-6 (the batched product's summation order on the card is not the CPU's), with
scores within 1e-5. chip_smoke.py's phase 11 drives the same path at V=1,000,000.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from glint_word2vec_torch.data.vocab import Vocabulary
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.serve import EmbeddingService

REPO = Path(__file__).resolve().parent.parent
TIE, ATOL = 1e-6, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the service's exact arm runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _matrix(v, d, seed):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((64, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    return (cents[rng.integers(0, 64, v)]
            + 0.35 * rng.standard_normal((v, d)).astype(np.float32) / np.sqrt(d))


def _vocab(v):
    return Vocabulary.from_words_and_counts([f"w{i}" for i in range(v)],
                                            np.ones(v, np.int64))


def _agree(got, want):
    """Scores within ATOL position by position; words equal except at a tie."""
    assert len(got) == len(want)
    for i, ((wg, sg), (ww, sw)) in enumerate(zip(got, want)):
        assert abs(sg - sw) <= ATOL, (i, got, want)
        if wg != ww:
            assert i == len(want) - 1 or any(
                abs(sw - want[j][1]) <= TIE for j in (i - 1, i + 1)
                if 0 <= j < len(want)), (i, got, want)


@pytest.mark.cuda
def test_checkpoint_streams_to_the_card(cuda, tmp_path, monkeypatch):
    """A dense load onto the card streams each matrix through the pinned staging
    buffers as it hashes it: the same rows as the host load, at a block size that
    leaves a short last block, and a damaged matrix is refused by digest."""
    from glint_word2vec_torch.train import checkpoint as ckpt
    monkeypatch.setattr(ckpt, "_READ_BLOCK", 4096)
    v, d = 3001, 37
    m = _matrix(v, d, 2)
    Word2VecModel(_vocab(v), m, m[::-1].copy(), device="cpu").save(str(tmp_path / "ck"))
    host = Word2VecModel.load(str(tmp_path / "ck"), device="cpu")
    card = Word2VecModel.load(str(tmp_path / "ck"))
    assert card.syn0.device.type == "cuda" and card.syn0.dtype == torch.float32
    assert torch.equal(card.syn0.cpu(), host.syn0)
    assert torch.equal(card.syn1.cpu(), host.syn1)
    with open(tmp_path / "ck" / "syn0.npy", "r+b") as f:
        f.seek(4096 + 3)
        b = f.read(1)
        f.seek(4096 + 3)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ckpt.CheckpointCorruptError, match="syn0.npy"):
        Word2VecModel.load(str(tmp_path / "ck"))


@pytest.mark.cuda
@pytest.mark.parametrize("ann", [False, True], ids=["exact", "ann"])
def test_service_on_the_card_agrees_with_the_cpu(cuda, ann):
    v, d = 20000, 64
    m = _matrix(v, d, 1)
    words = [f"w{i}" for i in range(0, v, 97)]
    queries = words + [m[3] * 2.0, m[5] - m[6]]
    out = {}
    for dev in ("cpu", "cuda"):
        model = Word2VecModel(_vocab(v), m, device=dev)
        svc = EmbeddingService(model=model, ann=ann)
        try:
            out[dev] = svc.synonyms_batch(queries, 10)
            assert svc.stats()["batches"] < svc.stats()["submitted"]
        finally:
            svc.close()
        assert model.syn0.device.type == dev
        model.stop()
    if ann:  # the index is host numpy on both: the same lists
        assert out["cuda"] == out["cpu"]
    for got, want in zip(out["cuda"], out["cpu"]):
        _agree(got, want)


@pytest.mark.cuda
def test_checkpoint_service_defaults_to_the_card_and_hot_reloads(cuda, tmp_path):
    v, d = 5000, 32
    ck = str(tmp_path / "ck")
    Word2VecModel(_vocab(v), _matrix(v, d, 2), device="cpu").save(ck)
    svc = EmbeddingService(checkpoint=ck, ann=False, watch=True, reload_poll_s=0.05)
    try:
        with svc._handle.lease() as (model, _):
            assert model.syn0.device.type == "cuda"
        first = svc.synonyms("w1", 10)
        Word2VecModel(_vocab(v), _matrix(v, d, 3), device="cpu").save(ck)
        deadline = time.monotonic() + 10
        while svc.stats()["reloads"] < 1 and time.monotonic() < deadline:
            assert len(svc.synonyms("w1", 10)) == 10
            time.sleep(0.01)
        st = svc.stats()
        assert st["reloads"] == 1 and st["models_released"] == 1
        want = Word2VecModel.load(ck, device="cpu").find_synonyms("w1", 10)
        _agree(svc.synonyms("w1", 10), want)
        assert first != want
    finally:
        svc.close()


@pytest.mark.cuda
def test_cli_serves_from_the_card_by_default(cuda, tmp_path):
    v, d = 3000, 32
    ck = str(tmp_path / "ck")
    model = Word2VecModel(_vocab(v), _matrix(v, d, 4), device="cpu")
    model.save(ck)
    want = model.find_synonyms("w7", 5)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    reqs = [{"op": "synonyms", "word": "w7", "num": 5}, {"op": "stats"},
            {"op": "quit"}]
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.serve_checkpoint",
                        ck], input="".join(json.dumps(q) + "\n" for q in reqs),
                       capture_output=True, text=True, env=env, cwd=str(REPO),
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = [json.loads(x) for x in r.stdout.splitlines()]
    assert out[0]["ready"] and out[-1] == {"bye": True}
    assert out[2]["device"].startswith("cuda")
    _agree([tuple(x) for x in out[1]["synonyms"]], want)
