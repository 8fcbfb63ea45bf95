"""Rank processes of the port's multi-process tests (tests/test_torch_shard_step.py,
test_torch_sharded_fit.py, test_torch_sharded_ckpt.py), and the helper that spawns
them.

A test module spawns one world a world size in a module-scoped fixture
(:func:`spawn_world`): W copies of this file, each a rank of a gloo world that meets
through a ``file://`` store under the test's temporary directory (no TCP port, so
parallel test workers never collide). A rank runs one scenario, which runs all of that
module's cases, and writes its results to ``<out>/r<rank>.npz`` (arrays) and
``<out>/r<rank>.json`` (everything else); the test process then compares them with
the JAX package and with the port's single-process functions. Ranks import torch and
the port only, with one intra-op thread each (several ranks share the host's cores).

    python tests/_torch_mesh_worker.py SCENARIO RANK WORLD STORE OUTDIR [ARGS_JSON]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
NEG = 3
STAB = dict(max_row_norm=5.0, update_clip=0.05, row_l2=1e-3)
RANK_TIMEOUT_S = 30.0  # a collective that waits longer on a peer raises


# -- inputs shared by the ranks and the test process (numpy only) -------------------------


def step_inputs(seed: int, nd: int, k: int, dtype=np.float32, V=128, D=32, B=64,
                P=8) -> dict:
    """Step inputs from a seed: full parameters, ``[k, B]`` batch leaves, negatives
    ``[k, nd·P]`` (a window's data shards each take a disjoint ``[k, P]`` slice; the
    synchronous step reads the first P of each row) and alpha."""
    rng = np.random.default_rng(seed)
    return dict(
        syn0=rng.standard_normal((V, D)).astype(dtype),
        syn1=(rng.standard_normal((V, D)) * 0.1).astype(dtype),
        centers=rng.integers(0, V, (k, B)), contexts=rng.integers(0, V, (k, B)),
        mask=(rng.random((k, B)) < 0.9).astype(np.float32),
        negatives=rng.integers(0, V, (k, nd * P)), alpha=0.025, P=P)


def fit_corpus(seed: int = 0, n: int = 201):
    """Sentences of 3 to 39 tokens over 64 words, an odd count: the ranks' streams
    end at different rounds."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(64)]
    lens = rng.integers(3, 40, n)
    return [[words[j] for j in rng.integers(0, 64, L)] for L in lens]


FIT_KNOBS = dict(vector_size=16, min_count=1, pairs_per_batch=128, num_iterations=2,
                 window=3, negatives=3, negative_pool=16, steps_per_dispatch=2, seed=7,
                 subsample_ratio=0.0, pad_vector_to_lanes=False,
                 heartbeat_every_steps=10)


RUNNER_KNOBS = dict(vector_size=8, min_count=1, window=2, pairs_per_batch=64,
                    num_iterations=1, subsample_ratio=0.0, seed=1, prefetch_chunks=0,
                    steps_per_dispatch=2, negative_pool=16, shard_input=False)


def write_segment(directory: Path, name: str, seed: int, words: int) -> None:
    """One corpus segment of the continual stream: 80 sentences of 10 tokens over
    ``words`` words."""
    rng = np.random.default_rng(seed)
    Path(directory).mkdir(parents=True, exist_ok=True)
    with open(Path(directory) / name, "w", encoding="utf-8") as f:
        for _ in range(80):
            f.write(" ".join(f"w{i}" for i in rng.integers(0, words, 10)) + "\n")


def run_continual(root: Path, plan=None, between=None) -> dict:
    """A continual runner over a two-segment stream: the base fit over ``seg-000``,
    then one increment over ``seg-001`` (which adds words). ``between`` writes the
    second segment (on a mesh: rank 0, then every rank past a barrier)."""
    from glint_word2vec_torch.continual.loop import ContinualRunner

    write = between or (lambda: write_segment(root / "stream", "seg-001.txt", 2, 18))
    runner = ContinualRunner(str(root / "publish" / "ck"), str(root / "stream"),
                             str(root / "work"), plan=plan, config_overrides=RUNNER_KNOBS,
                             device="cpu")
    base = runner.ensure_base()
    write()
    inc = runner.run_once()
    return {"base": base["vocab_size"], "grown": inc["vocab_size"],
            "new_words": inc["new_words"], "step": inc["trainer"]["global_step"]}


def fit_params(V: int, D: int = 16, seed: int = 3):
    """The fits' starting parameters (injected, so every package and world starts
    alike)."""
    rng = np.random.default_rng(seed)
    return ((rng.random((V, D), dtype=np.float32) - 0.5) / D,
            (rng.standard_normal((V, D)) * 0.01).astype(np.float32))


# -- the spawning side -------------------------------------------------------------------


def one_torch_thread():
    """The body of the test modules' autouse fixture: the test process's own steps are
    tiny, and a pool of intra-op threads in each of several pytest workers
    oversubscribes the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spawn_world(scenario: str, world: int, tmp: Path, args: dict = None,
                timeout_s: float = 120.0, rank_env: dict = None) -> list:
    """Run ``scenario`` in a world of ``world`` ranks; returns each rank's
    ``{"rc", "arrays", "meta", "stderr"}`` in rank order. Kills every rank at
    ``timeout_s``. ``rank_env``: extra environment by rank."""
    out = Path(tmp) / f"world-{scenario}"
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    # the numpy feed (bit-identical to the native one): ranks never race a g++ build
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", GLINT_DISABLE_NATIVE="1")
    procs = []
    for r in range(world):
        e = dict(env, **((rank_env or {}).get(r, {})))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, scenario, str(r), str(world), str(store),
             str(out), json.dumps(args or {})],
            env=e, cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    deadline = time.monotonic() + timeout_s
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, err) in enumerate(zip(procs, errs)):
        npz, js = out / f"r{r}.npz", out / f"r{r}.json"
        results.append({
            "rc": p.returncode, "stderr": err,
            "arrays": dict(np.load(npz)) if npz.exists() else {},
            "meta": json.loads(js.read_text()) if js.exists() else {}})
    return results


def check_world(results: list) -> None:
    """Fail with every rank's error tail when a rank did not exit cleanly."""
    bad = [(r, x["rc"], x["stderr"][-3000:]) for r, x in enumerate(results)
           if x["rc"] != 0]
    assert not bad, "\n".join(f"rank {r} rc={rc}:\n{err}" for r, rc, err in bad)


def assemble(results: list, key: str, nm: int) -> np.ndarray:
    """The full matrix of ``key`` from the row blocks of data replica 0 (ranks
    0..nm-1, in model order)."""
    return np.concatenate([results[r]["arrays"][key] for r in range(nm)])


# -- the rank side -----------------------------------------------------------------------


def _carve_step(plan, inp, i, torch):
    return {name: torch.as_tensor(plan.carve(inp[name][i], plan.batch))
            for name in ("centers", "contexts", "mask")}


def _scenario_steps(ctx) -> None:
    """The step cases at every mesh shape of this world: three synchronous steps in
    f32 (stabilizers off and on, the fused chain off and on), one step built with and
    without ``sync_every=1``, and a two-step local-SGD window in float64 (stabilizers
    off and on), each rank's row blocks saved, with the collective counts."""
    import torch
    from glint_word2vec_torch.ops.sgns import EmbeddingPair, Stabilizers
    from glint_word2vec_torch.ops.sgns_shard import make_sharded_sgns_step
    from glint_word2vec_torch.parallel.distributed import COLLECTIVES
    from glint_word2vec_torch.parallel.mesh import make_mesh, shard_params

    for nd, nm in ctx.args["shapes"]:
        plan = make_mesh(nd, nm)
        tag = f"{nd}x{nm}"
        ctx.meta[f"{tag}/place"] = [plan.data_index, plan.model_index]
        for variant, (stab, fused) in {"plain": (None, False), "stab": (STAB, False),
                                       "fused": (None, True)}.items():
            inp = step_inputs(11, nd, 3)
            params = EmbeddingPair(*shard_params((inp["syn0"], inp["syn1"]), plan))
            step = make_sharded_sgns_step(
                plan, NEG, stabilizers=Stabilizers(**stab) if stab else None,
                fused=fused)
            COLLECTIVES.reset()
            losses = []
            for i in range(3):
                m = step(params, _carve_step(plan, inp, i, torch),
                         torch.as_tensor(inp["negatives"][i, :inp["P"]]), inp["alpha"])
                losses.append([float(m.loss), float(m.mean_f_pos), float(m.pairs)])
            ctx.meta[f"{tag}/{variant}/counts"] = {
                f"{op}/{axis}": n for (op, axis), n in COLLECTIVES.counts.items()}
            ctx.meta[f"{tag}/{variant}/metrics"] = losses
            ctx.arrays[f"{tag}/{variant}/syn0"] = params.syn0.numpy()
            ctx.arrays[f"{tag}/{variant}/syn1"] = params.syn1.numpy()
        # sync_every=1 is the synchronous step itself
        outs = []
        for knob in ({}, {"sync_every": 1}):
            inp = step_inputs(11, nd, 1)
            params = EmbeddingPair(*shard_params((inp["syn0"], inp["syn1"]), plan))
            make_sharded_sgns_step(plan, NEG, **knob)(
                params, _carve_step(plan, inp, 0, torch),
                torch.as_tensor(inp["negatives"][0, :inp["P"]]), inp["alpha"])
            outs.append(params)
        ctx.meta[f"{tag}/sync1_identical"] = bool(
            torch.equal(outs[0].syn0, outs[1].syn0) and torch.equal(outs[0].syn1,
                                                                    outs[1].syn1))
        for variant, stab in (("plain", None), ("stab", STAB)):
            inp = step_inputs(5, nd, 2, dtype=np.float64)
            params = EmbeddingPair(*shard_params((inp["syn0"], inp["syn1"]), plan))
            window = make_sharded_sgns_step(
                plan, NEG, stabilizers=Stabilizers(**stab) if stab else None,
                sync_every=2)
            batch = {name: torch.as_tensor(plan.carve(inp[name], plan.batch_stacked))
                     for name in ("centers", "contexts", "mask")}
            negs = torch.as_tensor(plan.carve(inp["negatives"], plan.batch_stacked))
            COLLECTIVES.reset()
            m = window(params, batch, negs, torch.full((2,), inp["alpha"],
                                                       dtype=torch.float64))
            ctx.meta[f"{tag}/window_{variant}/counts"] = {
                f"{op}/{axis}": n for (op, axis), n in COLLECTIVES.counts.items()}
            ctx.meta[f"{tag}/window_{variant}/pairs"] = m.pairs.tolist()
            ctx.arrays[f"{tag}/window_{variant}/syn0"] = params.syn0.numpy()
            ctx.arrays[f"{tag}/window_{variant}/syn1"] = params.syn1.numpy()


def _record_rounds(trainer, rounds: list) -> None:
    """Keep a copy of every round's global chunk the trainer runs."""
    run = trainer._run_chunk

    def recording(chunk):
        a = chunk["arrays"]
        rounds.append({"centers": np.array(a["centers"]),
                       "contexts": np.array(a["contexts"]),
                       "reals": np.array(a["reals"]), "alphas": np.array(a["alphas"]),
                       "real": int(chunk["real"])})
        return run(chunk)

    trainer._run_chunk = recording


def _save_rounds(ctx, name: str, rounds: list) -> None:
    for key in ("centers", "contexts", "reals", "alphas"):
        ctx.arrays[f"{name}/rounds/{key}"] = np.stack([r[key] for r in rounds])
    ctx.meta[f"{name}/rounds/real"] = [r["real"] for r in rounds]


class _Stop(Exception):
    pass


def _stop_after_first_save(trainer) -> None:
    save = trainer.save_checkpoint

    def save_once(path):
        save(path)
        raise _Stop()

    trainer.save_checkpoint = save_once


def _diverge_feed(trainer) -> None:
    """Nudge the first alpha of the replicated feed's first chunk on this rank: a feed
    that differs across ranks, as a nondeterministic host pipeline would make."""
    stream = trainer._chunk_stream

    def diverged(*a, **kw):
        for i, chunk in enumerate(stream(*a, **kw)):
            if i == 0:
                chunk["arrays"]["alphas"][0] += 1e-3
            yield chunk

    trainer._chunk_stream = diverged


def _mesh_fit(ctx, plan, name: str, record: bool = True, checkpoint: str = None,
              every: int = None, interrupt: bool = False, diverge: bool = False,
              **knobs):
    """One fit of the shared corpus on ``plan`` from the injected start parameters;
    saves this rank's row blocks (and the rounds it ran) under ``name``, with the
    world allgathers the fit issued. ``diverge``: this rank's replicated feed differs
    from its peers' (:func:`_diverge_feed`)."""
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.parallel.distributed import COLLECTIVES
    from glint_word2vec_torch.train.trainer import Trainer

    sents = fit_corpus()
    vocab = build_vocab(sents, 1)
    cfg = Word2VecConfig(**dict(FIT_KNOBS, **knobs))
    t = Trainer(cfg, vocab, params=fit_params(vocab.size), device="cpu",
                feed_backend="numpy", plan=plan)
    rounds: list = []
    if record:
        _record_rounds(t, rounds)
    if interrupt:
        _stop_after_first_save(t)
    if diverge:
        _diverge_feed(t)
    COLLECTIVES.reset()
    try:
        t.fit(encode_sentences(sents, vocab, cfg.max_sentence_length),
              checkpoint_path=checkpoint, checkpoint_every_steps=every)
    except _Stop:
        ctx.meta[f"{name}/stopped_at"] = int(t.global_step)
    except RuntimeError as e:
        if not knobs.get("feed_consistency_check"):
            raise
        ctx.meta[f"{name}/error"] = str(e)
    ctx.meta[f"{name}/world_gathers"] = COLLECTIVES.counts[("all_gather", "world")]
    ctx.meta[f"{name}/chunks_run"] = int(t.chunks_run)
    if record:
        _save_rounds(ctx, name, rounds)
    ctx.arrays[f"{name}/syn0"] = t.params.syn0.numpy()
    ctx.arrays[f"{name}/syn1"] = t.params.syn1.numpy()
    ctx.meta[f"{name}/global_step"] = int(t.global_step)
    ctx.meta[f"{name}/pairs_trained"] = float(t.pairs_trained)
    return t


def _scenario_fit(ctx) -> None:
    """Fits on a (2, 2) mesh of four ranks: the sharded-input feed, the replicated
    feed (``shard_input=False``), local SGD (``sync_every=2``), the sharded feed under
    ``feed_consistency_check``, and the replicated one with rank 1's feed diverged."""
    from glint_word2vec_torch.parallel.mesh import make_mesh

    plan = make_mesh(2, 2)
    ctx.meta["place"] = [plan.data_index, plan.model_index]
    _mesh_fit(ctx, plan, "sharded")
    _mesh_fit(ctx, plan, "replicated", shard_input=False)
    _mesh_fit(ctx, plan, "localsgd", record=False, step_lowering="shard_map",
              sync_every=2)
    _mesh_fit(ctx, plan, "checked", record=False, feed_consistency_check=True)
    _mesh_fit(ctx, plan, "diverged", record=False, diverge=ctx.rank == 1,
              shard_input=False, feed_consistency_check=True)


def _scenario_ckpt(ctx) -> None:
    """Row-shards checkpoints on a (1, 2) mesh: a finished fit's save, a JAX-written
    checkpoint streamed in, the elastic 2 -> 1 interruption and 1 -> 2 resume, the
    same-world resume of a sharded-input fit, ``Word2Vec(...).fit(plan=...)`` and
    the continual runner on the mesh."""
    from glint_word2vec_torch import Word2Vec
    from glint_word2vec_torch.parallel.mesh import make_mesh, pad_vocab_for_sharding
    from glint_word2vec_torch.train.checkpoint import load_params_into_plan

    d = Path(ctx.args["dir"])
    plan = make_mesh(1, 2)
    ctx.meta["place"] = [plan.data_index, plan.model_index]
    # (a) a finished sharded-input fit, saved as row shards at its end
    _mesh_fit(ctx, plan, "full", record=False, checkpoint=str(d / "ck_full"))
    # (b) the JAX package's row-shards checkpoint, streamed onto this mesh
    jv = ctx.args["jax_vocab"]
    got = load_params_into_plan(str(d / "ck_jax"), plan, pad_vocab_for_sharding(jv, 2),
                                ctx.args["jax_dim"], verify=True)
    ctx.arrays["jax/syn0"], ctx.arrays["jax/syn1"] = got.syn0.numpy(), got.syn1.numpy()
    # (c) 2 -> 1: a replicated-feed fit stopped right after its first checkpoint
    _mesh_fit(ctx, plan, "e21", record=False, checkpoint=str(d / "ck_e21"), every=12,
              interrupt=True, shard_input=False)
    # (d) 1 -> 2: a one-process row-shards checkpoint resumed on this mesh
    sents = fit_corpus()
    m = Word2Vec.resume(str(d / "ck_e12"), sents, plan=plan, device="cpu",
                        config_overrides=dict(shard_input=False))
    ctx.arrays["e12/syn0"], ctx.arrays["e12/syn1"] = (m.params[0].numpy(),
                                                      m.params[1].numpy())
    ctx.meta["e12/global_step"] = int(m.train_state.global_step)
    # (e) the same world resumes a sharded-input fit from its shard_progress
    _mesh_fit(ctx, plan, "stopped", record=False, checkpoint=str(d / "ck_sp"),
              every=12, interrupt=True)
    with open(d / "ck_sp" / "metadata.json", encoding="utf-8") as f:
        meta = json.load(f)  # before the resume's own saves replace it
    ctx.meta["sp/state"] = meta["train_state"]
    ctx.meta["sp/format_version"] = meta["format_version"]
    m = Word2Vec.resume(str(d / "ck_sp"), sents, plan=plan, device="cpu")
    ctx.arrays["resumed/syn0"], ctx.arrays["resumed/syn1"] = (m.params[0].numpy(),
                                                              m.params[1].numpy())
    # (f) the estimator end to end: a sharded model, saved and gathered
    est = Word2Vec(device="cpu", **dict(FIT_KNOBS, num_iterations=1))
    sm = est.fit(sents, plan=plan)
    ctx.meta["estimator/type"] = type(sm).__name__
    try:
        sm.find_synonyms("w1", 3)
        ctx.meta["estimator/refused"] = ""
    except NotImplementedError as e:
        ctx.meta["estimator/refused"] = str(e)
    sm.save(str(d / "ck_est"))
    dense = sm.gather()
    ctx.meta["estimator/synonyms"] = [[w, float(s)] for w, s in
                                      dense.find_synonyms("w1", 3)]
    ctx.arrays["estimator/syn0"] = dense.syn0.numpy()
    # (g) the continual runner on the mesh: rank 0 decides and writes, every rank fits
    from glint_word2vec_torch.parallel import distributed
    from glint_word2vec_torch.train.checkpoint import load_model

    root = d / "continual"

    def second_segment():
        if ctx.rank == 0:
            write_segment(root / "stream", "seg-001.txt", 2, 18)
        distributed.COLLECTIVES.barrier(distributed.host_group())

    if ctx.rank == 0:
        write_segment(root / "stream", "seg-000.txt", 1, 12)
    distributed.COLLECTIVES.barrier(distributed.host_group())
    ctx.meta["continual"] = run_continual(root, plan, second_segment)
    distributed.COLLECTIVES.barrier(distributed.host_group())
    got = load_model(str(root / "publish" / "ck"))
    ctx.arrays["continual/syn0"], ctx.arrays["continual/syn1"] = got["syn0"], got["syn1"]


def _scenario_beacon(ctx) -> None:
    """Rank 1 dies mid-fit (killed at the end of the round reaching step 6); rank 0,
    with peer beacons on, must raise PeerDeathError, not hang."""
    from glint_word2vec_torch.parallel.mesh import make_mesh
    from glint_word2vec_torch.train import faults

    plan = make_mesh(2, 1)
    if ctx.rank == 1:
        faults.configure(crash_at_step=6)
        crash = faults.crash_at_step

        def crash_and_note(step):
            if step >= 6:
                Path(ctx.out, "died").write_text(str(time.time()))
            crash(step)

        faults.crash_at_step = crash_and_note
    t0 = time.time()
    try:
        _mesh_fit(ctx, plan, "fit", record=False,
                  checkpoint=str(Path(ctx.args["dir"]) / "ck_beacon"), every=1000,
                  peer_beacon_s=0.2, num_iterations=4)
        ctx.meta["error"] = ""
    except Exception as e:  # the finding under test
        ctx.meta["error"] = type(e).__name__
        ctx.meta["message"] = str(e)[:500]
    ctx.meta["t_start"], ctx.meta["t_end"] = t0, time.time()


def _scenario_dist(ctx) -> None:
    """The collective interface on its own: the allgather of a round,
    local_sgd_delta_merge, broadcast_object, the barrier, and the mesh's groups."""
    import torch
    from glint_word2vec_torch.parallel import distributed
    from glint_word2vec_torch.parallel.mesh import make_mesh

    C = distributed.COLLECTIVES
    C.reset()
    r = ctx.rank
    tree = {"pairs": np.full((2, 3), r, np.int32), "alive": np.asarray([r], np.int32),
            "clock": np.asarray([1.5 * r], np.float64)}
    g = distributed.allgather(tree)
    for k, v in g.items():
        ctx.arrays[f"gather/{k}"] = v
    start = (torch.zeros(4, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64))
    local = (start[0] + r + 1, start[1] * (r + 2))
    distributed.local_sgd_delta_merge(start, local, None, ctx.world, axis="world")
    ctx.arrays["merge/0"], ctx.arrays["merge/1"] = local[0].numpy(), local[1].numpy()
    ctx.meta["broadcast"] = C.broadcast_object({"from": r}, None)
    C.barrier()
    plan = make_mesh(ctx.world // 2, 2) if ctx.world % 2 == 0 else make_mesh(1)
    x = torch.full((1,), float(r))
    C.all_reduce(x, plan.model_group, "model")
    ctx.meta["model_sum"] = float(x)
    ctx.meta["place"] = [plan.data_index, plan.model_index]
    ctx.meta["counts"] = {f"{op}/{ax}": n for (op, ax), n in C.counts.items()}
    ctx.meta["staged_calls"] = C.staged_calls


SCENARIOS = {"dist": _scenario_dist, "steps": _scenario_steps, "fit": _scenario_fit, "ckpt": _scenario_ckpt,
             "beacon": _scenario_beacon}


class _Ctx:
    def __init__(self, rank, world, out, args):
        self.rank, self.world, self.out, self.args = rank, world, out, args
        self.arrays: dict = {}
        self.meta: dict = {}


def main(argv) -> int:
    scenario, rank, world, store, out = argv[:5]
    args = json.loads(argv[5]) if len(argv) > 5 else {}
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from glint_word2vec_torch.parallel import distributed

    distributed.initialize(init_method=f"file://{store}", num_processes=world,
                           process_id=rank, device="cpu", timeout_s=RANK_TIMEOUT_S)
    ctx = _Ctx(rank, world, out, args)
    SCENARIOS[scenario](ctx)
    np.savez(Path(out) / f"r{rank}.npz", **ctx.arrays)
    Path(out, f"r{rank}.json").write_text(json.dumps(ctx.meta))
    if scenario != "beacon":
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except BaseException:
        traceback.print_exc()
        rc = 1
    sys.stderr.flush()
    # a dead peer can leave the process group's threads blocked: exit without them
    os._exit(rc)
