"""The port's runtime layer (``glint_word2vec_torch/obs``) against the JAX package's.

- The health probe's channels on random and blown-up matrices, float32 and bfloat16,
  with zero padding rows, against ``glint_word2vec_tpu.obs.probe.make_health_probe``:
  ``max_norm``/``mean_norm`` within 1e-6 relative (a float32 reduction in another
  order), ``frac_over`` and ``finite`` exact, ``p99_norm`` the same bucket (the port
  rounds the bucket edge once, XLA's float32 ``exp2`` is a few ulps off it: 1e-6
  relative); and against a float64 NumPy oracle.
- ``NormWatchdog``: the same channel sequences give the same reasons, firings and
  raises.
- The schema catalogue is the JAX package's; the sink, the tracer and the phase
  histograms behave as the JAX package's; the port's run log and blackbox dump
  validate under both packages' validators.
- A telemetry fit is observe-only (parameters bit-identical to the plain fit) and its
  heartbeats' norms match the JAX trainer's on the same toy; a probe, a snapshot and a
  save on a hot-row fit never see a pending slab.
- ``python -m glint_word2vec_torch.telemetry_run --smoke --device cpu`` (the port of
  ``tools/telemetry_run.py``, whose counterpart is ``tests/test_obs.py``'s
  ``test_telemetry_run_smoke``): one JSON line, a schema-valid run log (under both
  packages' validators) and a Chrome trace with the required spans."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glint_word2vec_torch.config import Word2VecConfig as TConfig
from glint_word2vec_torch.data.pipeline import encode_sentences
from glint_word2vec_torch.data.vocab import build_vocab as t_build_vocab
from glint_word2vec_torch.obs import phases as tphases
from glint_word2vec_torch.obs import probe as tprobe
from glint_word2vec_torch.obs import schema as tschema
from glint_word2vec_torch.obs.sink import TelemetrySink
from glint_word2vec_torch.obs.spans import Tracer
from glint_word2vec_torch.obs.watch import NormWatchdog as TWatch
from glint_word2vec_torch.train import faults as tfaults
from glint_word2vec_torch.train.trainer import Trainer as TTrainer
from glint_word2vec_tpu.config import Word2VecConfig as JConfig
from glint_word2vec_tpu.data.vocab import build_vocab as j_build_vocab
from glint_word2vec_tpu.obs import phases as jphases
from glint_word2vec_tpu.obs import schema as jschema
from glint_word2vec_tpu.obs.probe import make_health_probe, stats_to_channels
from glint_word2vec_tpu.obs.watch import NormWatchdog as JWatch
from glint_word2vec_tpu.ops.sgns import EmbeddingPair as JPair
from glint_word2vec_tpu.train import faults as jfaults
from glint_word2vec_tpu.train.trainer import Trainer as JTrainer


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The toy's tensors are tiny: one intra-op thread runs them several times faster
    than a pool, and a pool oversubscribes the cores when pytest runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the probe ----------------------------------------------------------------------------


def _matrices(case: str, seed: int = 0, V: int = 3000, Vp: int = 3072, D: int = 64):
    """Two [Vp, D] float32 matrices with zero padding rows past V: random (norms ~2 and
    ~0.8), blown up (a twentieth of syn0's rows x300 and a few x3e4), or with a NaN."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.25, (Vp, D)).astype(np.float32)
    b = rng.normal(0, 0.1, (Vp, D)).astype(np.float32)
    a[V:] = 0
    b[V:] = 0
    if case == "blown":
        hot = rng.choice(V, V // 20, replace=False)
        a[hot] *= 300.0
        a[hot[:3]] *= 100.0
        b[:V // 7] *= 40.0
    if case == "nan":
        a[5, 3] = np.nan
    return a, b, V


def _jax_channels(a, b, V, thr, bf16):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    p = JPair(jnp.asarray(a).astype(dt), jnp.asarray(b).astype(dt))
    return stats_to_channels(jax.device_get(make_health_probe(V, thr)(p)))


def _bucket(x: float) -> int:
    return int(round(np.log2(x) * 4))


def _assert_channels(got, want, rtol=1e-6):
    assert got["finite"] == want["finite"]
    for name in ("syn0", "syn1"):
        g, w = got[name], want[name]
        if not want["finite"] and name == "syn0":
            continue  # a NaN row: the channels are NaN in both
        np.testing.assert_allclose(g["max_norm"], w["max_norm"], rtol=rtol)
        np.testing.assert_allclose(g["mean_norm"], w["mean_norm"], rtol=rtol)
        assert g["frac_over"] == w["frac_over"]
        assert _bucket(g["p99_norm"]) == _bucket(w["p99_norm"])
        np.testing.assert_allclose(g["p99_norm"], w["p99_norm"], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "blown", "nan"])
def test_probe_matches_jax(dtype, case):
    a, b, V = _matrices(case)
    bf16 = dtype == "bfloat16"
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
    if bf16:  # the JAX side reads the same bf16 values
        a, b = ta.float().numpy(), tb.float().numpy()
    for thr in (1.0, 100.0):
        got = tprobe.stats_to_channels(tprobe.health_stats((ta, tb), V, thr))
        _assert_channels(got, _jax_channels(a, b, V, thr, bf16))
    if case == "blown":
        assert got["syn0"]["frac_over"] == pytest.approx(0.05, abs=1e-3)


def test_probe_matches_float64_oracle():
    a, b, V = _matrices("blown", seed=3, V=5000, Vp=5008, D=100)
    stats = tprobe.stats_to_channels(tprobe.health_stats(
        (torch.from_numpy(a), torch.from_numpy(b)), V, 100.0))
    for name, m in (("syn0", a), ("syn1", b)):
        norms = np.sqrt((m[:V].astype(np.float64) ** 2).sum(1))
        got = stats[name]
        np.testing.assert_allclose(got["max_norm"], norms.max(), rtol=1e-6)
        np.testing.assert_allclose(got["mean_norm"], norms.mean(), rtol=1e-6)
        assert got["frac_over"] == np.float32(np.float32((norms > 100.0).sum()) / V)
        idx = np.clip(np.floor((np.log2(np.maximum(norms, 2.0 ** -12)) + 12) * 4), 0, 127)
        k = int(np.argmax(np.cumsum(np.bincount(idx.astype(int), minlength=128))
                          >= -(-V * 99 // 100)))
        assert got["p99_norm"] == np.float32(2.0 ** ((k + 1) / 4 - 12))


def test_probe_fetches_once(monkeypatch):
    """One ``.cpu()`` for the whole probe on finite parameters; the exact check (a
    second read) only runs when a padded row's norm is not finite, and an overflowing
    square alone does not make the state non-finite."""
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    a, b, V = _matrices("random")
    tprobe.health_stats((torch.from_numpy(a), torch.from_numpy(b)), V, 100.0)
    assert calls == [(10,)]
    a[7, :] = 3e20  # finite entries whose squares overflow float32
    stats = tprobe.health_stats((torch.from_numpy(a), torch.from_numpy(b)), V, 100.0)
    assert stats.finite
    assert _jax_channels(a, b, V, 100.0, False)["finite"]


# -- the watchdog ----------------------------------------------------------------------------


def _ch(mx0, fo0, mx1=1.0, fo1=0.0):
    return {"finite": True, "syn0": {"max_norm": mx0, "frac_over": fo0},
            "syn1": {"max_norm": mx1, "frac_over": fo1}}


SEQ = [_ch(5.0, 0.0), _ch(150.0, 0.005), _ch(150.0, 0.02), _ch(1500.0, 0.0),
       _ch(2e4, 0.5, 3e3, 0.2), _ch(1.0, 0.0), {"finite": True}, _ch(999.9, 0.00999)]


@pytest.mark.parametrize("policy", ["off", "warn", "recover", "halt"])
def test_watchdog_matches_jax(policy):
    t, j = TWatch(policy, 100.0, 1000.0, 0.01), JWatch(policy, 100.0, 1000.0, 0.01)
    for step, ch in enumerate(SEQ):
        assert t.would_fire(ch) == j.would_fire(ch)
        try:
            want = j.check(ch, step)
        except jfaults.NormBlowupError as e:
            with pytest.raises(tfaults.NormBlowupError) as got:
                t.check(ch, step)
            assert str(got.value) == str(e)
            continue
        assert t.check(ch, step) == want
        assert (t.fires, t.last_reason) == (j.fires, j.last_reason)
    with pytest.raises(ValueError, match="norm_watch policy"):
        TWatch("loud", 1.0, 1.0, 1.0)


# -- schema, sink, spans, phases ------------------------------------------------------------


def test_schema_catalogue_is_the_jax_packages():
    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert tschema.KINDS == jschema.KINDS
    assert tschema.KINDS_OPTIONAL == jschema.KINDS_OPTIONAL
    assert tschema._COMMON == jschema._COMMON
    assert tschema.BLACKBOX_FIELDS == jschema.BLACKBOX_FIELDS
    bad = [{"schema": 1, "kind": "heartbeat", "t": 1.0}, {"kind": "x"}, [],
           {"schema": 2, "kind": "run_end", "t": 0}]
    for rec in bad:
        assert tschema.validate_record(rec) == jschema.validate_record(rec)


def test_sink_rotates_and_sanitizes(tmp_path):
    p = str(tmp_path / "run.jsonl")
    sink = TelemetrySink(p, rotate_bytes=2000, keep=2)
    for i in range(200):
        sink.emit("watchdog", step=i, policy="warn", reason="r" * 50,
                  channels={"syn0": {"max_norm": float("inf"), "mean_norm": float("nan")}})
    sink.close()
    assert sorted(os.listdir(tmp_path)) == ["run.jsonl", "run.jsonl.1", "run.jsonl.2"]
    for name in os.listdir(tmp_path):
        for schema in (tschema, jschema):
            assert schema.validate_file(str(tmp_path / name))["ok"]
        assert os.path.getsize(tmp_path / name) <= 2100
    rec = json.loads(open(p).readline())
    assert rec["channels"]["syn0"] == {"max_norm": None, "mean_norm": None}


def test_phases_match_jax():
    t, j = tphases.PhaseAccumulator(True), jphases.PhaseAccumulator(True)
    durations = [1e-7, 3e-6, 0.0004, 0.02, 0.02, 1.7, 90.0, 0.5, 1e-3]
    snaps = []
    for i, d in enumerate(durations):
        phase = tphases.PHASES[i % 4]
        t.add(phase, d)
        j.add(phase, d)
        if i == 4:
            snaps = (t.raw_snapshot(), j.raw_snapshot())
    assert t.summary() == j.summary()
    assert t.delta(snaps[0]) == j.delta(snaps[1])
    assert [tphases.bucket_index(d) for d in durations] == [
        jphases.bucket_index(d) for d in durations]


def test_tracer_exports_and_closes_its_source(tmp_path):
    tr = Tracer(enabled=True)
    closed = []

    def src():
        try:
            yield from range(5)
        finally:
            closed.append(True)

    it = tr.wrap_iter("producer", src())
    assert next(it) == 0 and next(it) == 1
    it.close()
    assert closed == [True]
    with tr.span("dispatch", step=3):
        pass
    n = tr.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.load(open(tmp_path / "t.json"))
    assert n == 3 and [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == [
        "producer", "producer", "dispatch"]
    assert tr.span_summary()["producer"]["count"] == 2
    assert Tracer().span("x").__class__.__name__ == "_NoopSpan"


# -- fits ----------------------------------------------------------------------------------


def _sents():
    rng = np.random.default_rng(0)
    return [[f"w{i}" for i in rng.integers(0, 30, 20)] for _ in range(250)]


TOY = dict(vector_size=8, pairs_per_batch=128, window=3, num_iterations=2,
           steps_per_dispatch=2, heartbeat_every_steps=2, subsample_ratio=0.0,
           prefetch_chunks=0, seed=1)


def _port(sents, init=None, **knobs):
    vocab = t_build_vocab(sents, 1)
    t = TTrainer(TConfig(**{**TOY, **knobs}), vocab, params=init, device="cpu")
    return t, encode_sentences(sents, vocab, 1000)


def _init(V):
    r = np.random.default_rng(3)
    return (r.uniform(-0.05, 0.05, (V, 8)).astype(np.float32),
            r.normal(0, 0.05, (V, 8)).astype(np.float32))


def test_telemetry_fit_is_observe_only_and_matches_jax(tmp_path):
    """The run log validates under both validators with run_start (clock anchor),
    heartbeats (norms, recoveries, lr_scale, phases), one publish record per checkpoint
    save and run_end (spans); the trace
    loads with the trainer's spans; a clean run leaves no blackbox dump; parameters
    are bit-identical to the plain fit's; the heartbeats' norms are the JAX trainer's
    on the same toy."""
    sents = _sents()
    V = t_build_vocab(sents, 1).size
    log = str(tmp_path / "run.jsonl")
    on, enc = _port(sents, _init(V), telemetry_path=log, norm_watch="warn",
                    checkpoint_on_preempt=True)
    on.fit(enc, checkpoint_path=str(tmp_path / "ck"), checkpoint_every_steps=8)
    off, _ = _port(sents, _init(V))
    off.fit(enc)
    assert torch.equal(on.params.syn0, off.params.syn0)
    assert torch.equal(on.params.syn1, off.params.syn1)
    for schema in (tschema, jschema):
        summary = schema.validate_file(log)
        assert summary["ok"], summary["errors"]
    recs = [json.loads(line) for line in open(log)]
    # every checkpoint save writes its publish record (the serving tier's join key)
    saves = recs[-1]["spans"]["checkpoint_save"]["count"]
    assert saves > 0
    assert summary["kinds"] == {"run_start": 1, "heartbeat": len(on.heartbeats),
                                "publish": saves, "run_end": 1}
    assert {"wall_ns", "mono_ns"} <= recs[0].keys() and recs[0]["mesh"] == [1, 1]
    hbs = [r for r in recs if r["kind"] == "heartbeat"]
    assert all({"norms", "recoveries", "lr_scale", "phases"} <= h.keys() for h in hbs)
    assert recs[-1]["status"] == "ok"
    spans = recs[-1]["spans"]
    assert {"producer", "dispatch", "health_probe", "device_block",
            "checkpoint_save"} <= spans.keys()
    trace = json.load(open(log + ".trace.json"))
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"} >= {
        "producer", "dispatch", "health_probe"}
    assert not os.path.exists(log + ".blackbox.json")
    assert on.last_run_stats["watchdog_fires"] == 0 and "phases" in on.last_run_stats

    jt = JTrainer(JConfig(**TOY, telemetry_path=str(tmp_path / "j.jsonl")),
                  j_build_vocab(sents, 1),
                  params=JPair(*(jnp.asarray(x) for x in _init(V))))
    jt.fit(enc)
    jh = list(jt.heartbeats)
    assert [h.global_step for h in on.heartbeats] == [h.global_step for h in jh]
    for got, want in zip(on.heartbeats, jh):
        _assert_channels(got.norms, want.norms, rtol=1e-5)


def test_halt_dump_validates_under_both(tmp_path):
    """A finite blowup under norm_watch="halt": the watchdog record lands before the
    NormBlowupError, run_end says "error", and the flight recorder's dump carries the
    exception and validates under both packages' validators."""
    log = str(tmp_path / "run.jsonl")
    tfaults.configure(scale_params_at_step=6)
    t, enc = _port(_sents(), telemetry_path=log, norm_watch="halt")
    with pytest.raises(tfaults.NormBlowupError, match="finite norm blowup"):
        t.fit(enc)
    kinds = [json.loads(line)["kind"] for line in open(log)]
    assert kinds[-2:] == ["watchdog", "run_end"]
    for schema in (tschema, jschema):
        assert schema.validate_file(log)["ok"]
        assert schema.validate_blackbox_file(log + ".blackbox.json")["ok"]
    doc = json.load(open(log + ".blackbox.json"))
    assert doc["cause"]["type"] == "NormBlowupError"
    assert doc["events"][-1]["kind"] == "run_end" and doc["dispatches"]
    assert doc["status"]["status"] == "idle"


def test_hot_rows_never_pending_at_a_probe_snapshot_or_save(tmp_path):
    """Hot-row slabs flush at every chunk's end: the probe, a snapshot and a save
    never see a pending slab (the slabs are zero at each)."""
    t, enc = _port(_sents(), hot_rows=8, steps_per_dispatch=4,
                   nonfinite_policy="rollback", telemetry_path=str(tmp_path / "r.jsonl"))
    seen = []

    def watch(fn, name):
        def wrapped(*a, **kw):
            seen.append((name, not any(bool(s.any()) for s in t._slabs)))
            return fn(*a, **kw)
        return wrapped

    t._health_stats = watch(t._health_stats, "probe")
    t._copy_params = watch(t._copy_params, "snapshot")
    t.save_checkpoint = watch(t.save_checkpoint, "save")
    real_step = t._step_fn

    def step_fn():  # the slabs do fill inside a chunk
        step = real_step()

        def run(*a):
            out = step(*a)
            seen.append(("step", not any(bool(s.any()) for s in t._slabs)))
            return out
        return run

    t._step_fn = step_fn
    t.fit(enc, checkpoint_path=str(tmp_path / "ck"), checkpoint_every_steps=8)
    names = {n for n, _ in seen}
    assert {"probe", "snapshot", "save", "step"} <= names
    assert all(clean for n, clean in seen if n != "step")
    assert not all(clean for n, clean in seen if n == "step")


def test_profile_dir_writes_a_trace(tmp_path):
    t, enc = _port(_sents(), profile_dir=str(tmp_path / "prof"), profile_steps=4,
                   num_iterations=1)
    t.fit(enc)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith("trace-")
    doc = json.load(open(tmp_path / "prof" / files[0]))
    assert doc["traceEvents"]
    assert t._profiler is None


def test_telemetry_run_smoke(tmp_path):
    """The scripted telemetry fit as a subprocess on the CPU: one JSON line, the run log
    schema-valid, the trace with the producer, dispatch, probe and checkpoint spans (the
    staging span is the card's: the port stages chunks only to a card), no dump, and no
    kernel launch counted (the wrappers count on the card only)."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "glint_word2vec_torch.telemetry_run", "--smoke",
         "--device", "cpu", "--out", str(tmp_path / "art")],
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1"), cwd=repo,
        capture_output=True, timeout=500, text=True)
    assert proc.returncode == 0, proc.stdout[-1000:] + proc.stderr[-1000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["ok"] and res["schema_valid"] and res["device"] == "cpu"
    assert res["missing_spans"] == []
    assert {"producer", "dispatch", "health_probe", "checkpoint_save"} <= set(res["spans"])
    assert "stage_put" not in res["spans"]
    assert res["blackbox_absent"] and res["steps"] > 0
    assert set(res["launches"].values()) == {0}
    assert jschema.validate_file(res["run_log"])["ok"]
    assert os.path.exists(res["trace"])
