"""The port's lock discipline (glint_word2vec_torch/lockcheck.py): the port's own
graftlint (``glint_word2vec_torch/graftlint``) runs its concurrency rules R9-R11 over the
port, and the rank order is checked at run time under ``GLINT_LOCKCHECK=1`` through a
served query, a hot reload and a fit.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from glint_word2vec_torch.graftlint import concurrency, engine

from _torch_mesh_worker import one_torch_thread
from glint_word2vec_torch import lockcheck


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


REPO = Path(__file__).resolve().parent.parent
PORT = "glint_word2vec_torch/"


def _findings(rule, root=str(REPO)):
    if getattr(rule, "repo_rule", False):
        out = rule.check_repo(root)
    else:
        out = engine.lint_repo(root, rules=[rule]).findings
    return [f for f in out if not f.suppressed]


@pytest.mark.parametrize("rule", [concurrency.R9LockOrder, concurrency.R10HandlerSafety,
                                  concurrency.R11SharedMutable],
                         ids=["R9", "R10", "R11"])
def test_concurrency_rules_pass_on_the_port(rule):
    found = _findings(rule())
    assert not found, "\n".join(f"{f.path}:{f.line} {f.message}" for f in found)


def test_r9_scans_the_port(tmp_path):
    """The rule reads the port's registry and sites: a raw lock added to a copy of the
    port, and a registry entry whose site moved, are findings."""
    shutil.copytree(REPO / "glint_word2vec_torch", tmp_path / "glint_word2vec_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sink = tmp_path / "glint_word2vec_torch" / "obs" / "sink.py"
    sink.write_text(sink.read_text() + "\nimport threading\n_extra = threading.Lock()\n")
    lc = tmp_path / "glint_word2vec_torch" / "lockcheck.py"
    lc.write_text(lc.read_text().replace(
        '"glint_word2vec_torch/ops/kernels.py:<module>"',
        '"glint_word2vec_torch/ops/old_kernels.py:<module>"'))
    msgs = [f.message for f in _findings(concurrency.R9LockOrder(), str(tmp_path))]
    assert any("raw threading.Lock()" in m for m in msgs), msgs
    assert any("'ops.kernels.build'" in m and "registered at" in m for m in msgs), msgs


def test_every_lock_of_the_port_is_registered():
    """No raw threading primitive in the port outside the registry itself (but for a
    line carrying R9's reviewed suppression: racecheck's zero-cost probe compares the
    factories with the raw primitives), and each registered site constructs its lock
    through the factory."""
    raw = []
    for path in sorted((REPO / "glint_word2vec_torch").rglob("*.py")):
        if path.name == "lockcheck.py" and path.parent.name == "glint_word2vec_torch":
            continue
        lines = path.read_text().splitlines()
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("Lock", "RLock", "Condition")
                    and "graftlint: disable=R9 --" not in lines[node.lineno - 1]):
                raw.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert raw == []
    for name, entry in lockcheck.LOCK_TABLE.items():
        path = REPO / entry["site"].split(":")[0]
        assert f'"{name}"' in path.read_text(), (name, entry["site"])


def test_lock_table_matches_the_jax_package():
    """The shared entries keep the JAX package's ranks and kinds (the fleet's and the
    SLO tracker's among them); the port adds the CUDA kernels' build lock and the mesh
    service's announcement lock (serve/mesh.py), and names servebench's by its
    module."""
    from glint_word2vec_tpu.lockcheck import LOCK_TABLE as JAX_TABLE
    mine = lockcheck.LOCK_TABLE
    shared = set(mine) & set(JAX_TABLE)
    assert shared == {"data.native.load", "data.ingest_native.load", "serve.handle",
                      "serve.batcher.cv", "obs.phases", "obs.spans", "obs.blackbox",
                      "obs.sink", "fleet.router", "fleet.breaker",
                      "fleet.replica.pending", "fleet.replica.write", "obs.slo"}
    for name in shared:
        assert (mine[name]["rank"], mine[name]["kind"]) == (
            JAX_TABLE[name]["rank"], JAX_TABLE[name]["kind"]), name
        assert mine[name]["site"] == JAX_TABLE[name]["site"].replace(
            "glint_word2vec_tpu/", PORT), name
    assert set(mine) - shared == {"ops.kernels.build", "servebench.tickets",
                                  "serve.mesh"}
    assert mine["servebench.tickets"]["rank"] == JAX_TABLE["tools.servebench.tickets"][
        "rank"]
    assert set(JAX_TABLE) - shared == {"tools.servebench.tickets"}
    ranks = [e["rank"] for e in mine.values()]
    assert len(set(ranks)) == len(ranks)


def test_factories_off_are_raw_and_on_are_checked():
    state = (lockcheck._STATE.enabled, lockcheck._STATE.perturb)
    try:
        lockcheck.configure(enabled=False)
        assert type(lockcheck.make_lock("serve.handle")) is type(threading.Lock())
        assert type(lockcheck.make_rlock("obs.sink")) is type(threading.RLock())
        assert isinstance(lockcheck.make_condition("serve.batcher.cv"),
                          threading.Condition)
        lockcheck.configure(enabled=True, perturb=0.0)
        before = lockcheck.wrappers_allocated()
        lock = lockcheck.make_lock("ops.kernels.build")
        with lock:
            assert lock.locked()
        assert lockcheck.wrappers_allocated() == before + 1
        with pytest.raises(KeyError, match="not in lockcheck.LOCK_TABLE"):
            lockcheck.make_lock("no.such.lock")
        with pytest.raises(ValueError, match="registered as kind"):
            lockcheck.make_rlock("serve.handle")
    finally:
        lockcheck.configure(enabled=state[0], perturb=state[1])


_DRIVE = r"""
import json, sys, tempfile, threading, time
import numpy as np
from glint_word2vec_torch import lockcheck
from glint_word2vec_torch.config import Word2VecConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import Vocabulary, build_vocab
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.serve import EmbeddingService
from glint_word2vec_torch.train.trainer import Trainer

assert lockcheck.enabled()
tmp = tempfile.mkdtemp()
rng = np.random.default_rng(0)
sents = [[f"w{j}" for j in rng.integers(0, 40, 12)] for _ in range(120)]
vocab = build_vocab(sents, min_count=1)
cfg = Word2VecConfig(vector_size=16, min_count=1, pairs_per_batch=128, window=2,
                     negatives=3, negative_pool=8, steps_per_dispatch=2,
                     telemetry_path=tmp + "/run.jsonl", heartbeat_every_steps=2)
tr = Trainer(cfg, vocab, device="cpu")
tr.fit(encode_sentences(sents, vocab, 1000))
ck = tmp + "/ck"
tr.save_checkpoint(ck)
svc = EmbeddingService(checkpoint=ck, ann=True, watch=True, reload_poll_s=0.05,
                       telemetry_path=tmp + "/serve.jsonl", device="cpu")
errors = []

def client(i):
    for _ in range(40):
        try:
            svc.synonyms(f"w{(i * 7) % 40}", 5)
        except Exception as e:
            errors.append(repr(e))

threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
for t in threads:
    t.start()
tr.fit(encode_sentences(sents, vocab, 1000))
tr.save_checkpoint(ck)
deadline = time.monotonic() + 20
while svc.stats()["reloads"] < 1 and time.monotonic() < deadline:
    time.sleep(0.02)
for t in threads:
    t.join()
reloads = svc.stats()["reloads"]
leaked = svc.close()
print(json.dumps({"report": lockcheck.report(), "errors": errors, "reloads": reloads,
                  "leaked": leaked}))
"""


def test_rank_order_holds_at_run_time_through_serving_and_a_reload(tmp_path):
    env = dict(os.environ, GLINT_LOCKCHECK="1", GLINT_LOCKCHECK_PERTURB="0.05",
               GLINT_LOCKCHECK_SEED="3",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _DRIVE], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    rep = out["report"]
    assert out["errors"] == [] and out["reloads"] >= 1 and out["leaked"] == 0
    assert rep["enabled"] and rep["inversions"] == []
    assert rep["acquisitions"] > 0 and rep["perturb_yields"] > 0
    assert rep["wrappers_allocated"] >= 6
    ranks = {n: e["rank"] for n, e in lockcheck.LOCK_TABLE.items()}
    for edge in rep["edges"]:
        outer, inner = edge.split("->")
        assert ranks[outer] < ranks[inner], edge
