"""The port's run-log tools (``glint_word2vec_torch.telemetry_tail``,
``glint_word2vec_torch.run_report``) on the CPU, held against the JAX package's
``tools/telemetry_tail.py`` and ``tools/run_report.py``.

Ported from ``tests/test_run_tools.py`` (the tail's summary, one JSON line, a truncated
log flagged, the flight recorder folded in), each on a run log the port's trainer wrote;
then ``--follow`` and a record of an unknown kind. Cross-package: the two tools fold
the same log, written by the port's fit and by the JAX package's, into equal JSON
(every field: the fold is a function of the records)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from _torch_mesh_worker import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import run_report as jax_report  # noqa: E402

from glint_word2vec_torch import run_report as port_report  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


def _sents():
    rng = np.random.default_rng(0)
    return [[f"w{i}" for i in rng.integers(0, 30, 20)] for _ in range(250)]


TOY = dict(vector_size=8, pairs_per_batch=128, window=3, num_iterations=2,
           steps_per_dispatch=2, heartbeat_every_steps=2, subsample_ratio=0.0,
           prefetch_chunks=0, seed=1)


@pytest.fixture(scope="module")
def run_log(tmp_path_factory):
    """One telemetry-on toy fit of the port on the CPU; returns the sink's path."""
    from glint_word2vec_torch.config import Word2VecConfig
    from glint_word2vec_torch.data.pipeline import encode_sentences
    from glint_word2vec_torch.data.vocab import build_vocab
    from glint_word2vec_torch.train.trainer import Trainer
    path = str(tmp_path_factory.mktemp("telemetry") / "run.jsonl")
    sents = _sents()
    vocab = build_vocab(sents, min_count=1)
    cfg = Word2VecConfig(**TOY, telemetry_path=path, norm_watch="warn")
    Trainer(cfg, vocab, device="cpu").fit(encode_sentences(sents, vocab, 1000))
    return path


@pytest.fixture(scope="module")
def jax_run_log(tmp_path_factory):
    """The same toy fit through the JAX package's trainer."""
    from glint_word2vec_tpu.config import Word2VecConfig
    from glint_word2vec_tpu.data.pipeline import encode_sentences
    from glint_word2vec_tpu.data.vocab import build_vocab
    from glint_word2vec_tpu.train.trainer import Trainer
    path = str(tmp_path_factory.mktemp("jax_telemetry") / "run.jsonl")
    sents = _sents()
    vocab = build_vocab(sents, min_count=1)
    cfg = Word2VecConfig(**TOY, telemetry_path=path, norm_watch="warn")
    Trainer(cfg, vocab).fit(encode_sentences(sents, vocab, 1000))
    return path


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", f"glint_word2vec_torch.{module}",
                           *args], cwd=REPO, capture_output=True, text=True,
                          env=env, timeout=300)


def _truncated(src, dst):
    with open(src) as f, open(dst, "w") as out:
        for line in f:
            if json.loads(line)["kind"] != "run_end":
                out.write(line)
    return dst


def _sigterm_dump(path, recorder):
    rec = recorder(path)
    rec.begin_run("r1")
    rec.dump(recorder.signal_cause(15))
    return path


# -- telemetry_tail --------------------------------------------------------------------


def test_telemetry_tail_summarizes(run_log):
    proc = _run("telemetry_tail", run_log, "--last", "5")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "pairs/s: median" in out
    assert "run_start=1" in out and "run_end=1" in out
    assert "phase dispatch" in out  # the attribution windows render
    assert "status ok" in out


def test_telemetry_tail_names_unknown_kinds(run_log, tmp_path):
    """A record of a kind the catalogue does not know (the schema grows by addition)
    is printed by its kind, and counted in the summary."""
    path = str(tmp_path / "grown.jsonl")
    with open(run_log) as f, open(path, "w") as out:
        out.write(f.read())
        out.write(json.dumps({"schema": 1, "kind": "from_the_future", "t": 1.0,
                              "novel": 7}) + "\n")
    proc = _run("telemetry_tail", path, "--last", "1")
    assert proc.returncode == 0, proc.stderr
    first = proc.stdout.splitlines()[0]
    assert first.startswith("from_the_future") and '"novel": 7' in first
    assert "from_the_future=1" in proc.stdout


def test_telemetry_tail_follows_appended_records(run_log, tmp_path):
    """--follow prints each complete record appended to the last file, and the summary
    again on SIGINT (exit 0)."""
    import signal
    path = str(tmp_path / "live.jsonl")
    with open(run_log) as f, open(path, "w") as out:
        out.write(f.read())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "glint_word2vec_torch.telemetry_tail",
                             path, "--follow", "--poll", "0.05"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while "following" not in proc.stderr.readline():
            assert time.monotonic() < deadline and proc.poll() is None
        with open(path, "a") as out:
            out.write(json.dumps({"schema": 1, "kind": "watchdog", "t": 2.0, "step": 99,
                                  "policy": "warn", "reason": "appended"}) + "\n")
        deadline = time.monotonic() + 60
        seen = ""
        while "appended" not in seen:
            assert time.monotonic() < deadline and proc.poll() is None
            seen = proc.stdout.readline()
        assert seen.startswith("WATCH step 99")
    finally:
        proc.send_signal(signal.SIGINT)
        out_rest, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    assert "watchdog=1" in out_rest


# -- run_report ------------------------------------------------------------------------


def test_run_report_one_json_line(run_log):
    proc = _run("run_report", run_log)
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, "exactly one stdout line"
    rep = json.loads(lines[0])
    assert rep["ok"] and rep["status"] == "ok" and rep["schema_valid"]
    assert rep["heartbeats"] >= 1
    assert rep["pairs_per_sec"]["median"] > 0
    assert rep["phases"]["dispatch"]["count"] > 0
    assert rep["norms"]["syn0"]["max"] > 0
    assert rep["lr_scale_final"] == 1.0


def test_run_report_flags_truncated_log(run_log, tmp_path):
    """A log with no run_end is the crash signature: the report says 'truncated' and
    exits nonzero, so a remote caller can alarm on it."""
    truncated = _truncated(run_log, str(tmp_path / "trunc.jsonl"))
    proc = _run("run_report", truncated)
    assert proc.returncode == 1
    rep = json.loads(proc.stdout.strip())
    assert rep["status"] == "truncated" and not rep["ok"]
    # steps and phases still rebuilt from the heartbeat windows
    assert rep["steps"] > 0
    assert rep["phases"].get("dispatch", {}).get("count", 0) > 0


def test_run_report_folds_blackbox(run_log, tmp_path):
    """--blackbox validates and embeds the dump's terminal cause."""
    from glint_word2vec_torch.obs.blackbox import FlightRecorder
    dump = _sigterm_dump(str(tmp_path / "x.blackbox.json"), FlightRecorder)
    proc = _run("run_report", run_log, "--blackbox", dump)
    rep = json.loads(proc.stdout.strip())
    assert rep["blackbox"]["valid"]
    assert rep["blackbox"]["cause"]["signal"] == "SIGTERM"


def test_run_report_folds_eval_runs(run_log, tmp_path):
    rows = tmp_path / "eval_runs.jsonl"
    rows.write_text("".join(json.dumps({"purity": p, "words": 10, "extra": 1}) + "\n"
                            for p in (0.5, 0.75, 0.9)))
    rep = port_report.summarize([run_log], eval_runs=str(rows), eval_last=2)
    assert rep["eval"] == [{"purity": 0.75, "words": 10}, {"purity": 0.9, "words": 10}]
    assert rep == jax_report.summarize([run_log], eval_runs=str(rows), eval_last=2)


# -- the two packages' reports on one log ----------------------------------------------


@pytest.mark.parametrize("shape", ["whole", "truncated", "blackbox"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_run_report_equals_the_jax_tool(writer, shape, run_log, jax_run_log, tmp_path):
    """The port's report and the JAX tool's are equal JSON on one log, whichever
    package's fit wrote it: whole, truncated (phases rebuilt from the windows) and with
    a flight-recorder dump folded in."""
    from glint_word2vec_torch.obs.blackbox import FlightRecorder
    log = run_log if writer == "port" else jax_run_log
    kw = {}
    if shape == "truncated":
        log = _truncated(log, str(tmp_path / "trunc.jsonl"))
    elif shape == "blackbox":
        kw["blackbox"] = _sigterm_dump(str(tmp_path / "x.blackbox.json"), FlightRecorder)
    got = port_report.summarize([log], **kw)
    want = jax_report.summarize([log], **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["ok"] == (shape != "truncated")


def test_fleet_report_equals_the_jax_tool(run_log, jax_run_log, tmp_path):
    """Fleet mode over both packages' logs, one of them with a dump beside it."""
    import shutil

    from glint_word2vec_torch.obs.blackbox import FlightRecorder
    port_log = str(tmp_path / "port.jsonl")
    jax_log = str(tmp_path / "jax.jsonl")
    shutil.copy(run_log, port_log)
    _truncated(jax_run_log, jax_log)
    _sigterm_dump(jax_log + ".blackbox.json", FlightRecorder)
    got = port_report.summarize_fleet([port_log, jax_log])
    assert got == jax_report.summarize_fleet([port_log, jax_log])
    assert got["ok"] and got["processes"]["jax"]["dumped"]
