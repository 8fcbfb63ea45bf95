"""The transfer-contract audit (``python -m glint_word2vec_torch.stepaudit``) on the CPU.

Ported from ``tests/test_stepaudit.py``: every single-device step variant of the port
passes the four contracts as carried over to one device (in place, no undeclared host
read or transfer, no float64 creep and no dense float32 [V, D] in bf16 mode, and, on the
card, the expected graph captures), the recovery ladder restores and engages its clamp
once, and the audit demonstrably catches each kind of violation: a host read injected in
the chunk body or the prologue, a parameter matrix replaced out of place, a float64
intermediate, a dense float32 upcast in bf16 mode, a host-to-device copy of the hash
PRNG's base (the blocking copy an earlier change of the port removed), a declared site
doing more than it declares (a transfer where the site only reads, a float64 or a
[V, D] output inside it), and, on the card only, a staging copy from pageable memory
and a recovery that does not recapture the chunk graphs. The audit compares nothing
with the JAX package (whose contracts are about a compiled XLA module), so this file
does not import it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from glint_word2vec_torch import stepaudit
from glint_word2vec_torch.ops.sgns import EmbeddingPair
from glint_word2vec_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this file runs: its fits and services are tiny, and
    they share the host with the other test files' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _audit(variant="shared"):
    return stepaudit.audit_variant(variant, stepaudit.smoke_geometry(), CPU)


def test_stepaudit_smoke_all_variants():
    """The CLI end to end: one JSON line, every variant passing every contract it can
    check on the CPU, the declared syncs per chunk reported, (d) null here."""
    # one intra-op thread: the audit's tensors are small, and it runs beside the other
    # test files' workers
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "glint_word2vec_torch.stepaudit",
                        "--smoke", "--device", "cpu"], capture_output=True, text=True,
                       env=env, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["ok"] and res["device"] == "cpu"
    assert tuple(res["variants"]) == stepaudit.VARIANTS
    for name, v in res["variants"].items():
        assert v["in_place"]["ok"] and v["in_place"]["storage_stable"], (name, v)
        assert v["in_place"]["peak_over_start_bytes"] is None
        t = v["transfers"]
        assert t["ok"] and t["undeclared_count"] == 0, (name, t)
        assert t["misplaced_count"] == 0 and t["blocking_h2d"] == 0, (name, t)
        assert t["declared_syncs_per_chunk"] > 0, (name, t)
        assert {"heartbeat", "probe", "stage"} <= set(t["declared"]), (name, t)
        assert t["witness"] is None
        assert v["dtype"]["f64_free"], (name, v["dtype"])
        assert v["recompile"] is None
        assert v["chunks"] >= 2 and v["short_last_chunk"], (name, v)
    bf16 = res["variants"]["shared_bf16_chain"]["dtype"]
    assert bf16["dense_f32_vd_free"] is True
    assert res["variants"]["shared"]["dtype"]["dense_f32_vd_free"] is None
    assert res["variants"]["shared"]["step_form"] == "shared_fused"
    assert res["variants"]["shared_stab"]["step_form"] == "shared_scatter"
    rr = res["recover_rebuild"]
    assert rr["ok"] and rr["recoveries"] == 1 and rr["restores"] == 1, rr
    assert rr["step_form_before"] == "shared_fused"
    assert rr["step_form_after"] == "shared_scatter"
    assert rr["recaptures"] is None


_BODY, _PROLOGUE = Trainer._chunk_body, Trainer._prologue


def _inject_read(kind):
    def item_in_body(self, steps, wm):
        out = _BODY(self, steps, wm)
        self._inputs["alphas"][0].item()
        return out

    def tolist_in_prologue(self, chunk):
        _PROLOGUE(self, chunk)
        self._inputs["alphas"].tolist()

    def nonzero_in_prologue(self, chunk):
        _PROLOGUE(self, chunk)
        self._inputs["negatives"].nonzero()

    fn = locals()[kind]
    return ("_chunk_body" if kind.endswith("body") else "_prologue"), fn, kind


@pytest.mark.parametrize("kind", ["item_in_body", "tolist_in_prologue",
                                  "nonzero_in_prologue"])
def test_audit_catches_an_undeclared_host_read(monkeypatch, kind):
    attr, fn, where = _inject_read(kind)
    monkeypatch.setattr(Trainer, attr, fn)
    res = _audit()
    t = res["transfers"]
    assert not t["ok"] and not res["ok"]
    assert t["undeclared_count"] >= res["chunks"]
    assert all(where in u for u in t["undeclared"]), t["undeclared"]
    # one broken contract does not mask the others
    assert res["in_place"]["ok"] and res["dtype"]["ok"]


def test_audit_catches_a_blocking_copy_of_the_prng_base(monkeypatch):
    """The hash PRNG's base made on the device from a Python int: a host-to-device copy
    per draw, which on the card blocks until everything queued has run."""
    from glint_word2vec_torch.ops import prng

    def hash_bits(seed, stream, counter, shape, device):
        n = 1
        for d in shape:
            n *= d
        s = ((int(seed) & prng._M32) * prng._GOLDEN) & prng._M32
        t = (stream * 0x7FEB352D + 0x68E31DA4) & prng._M32
        c = torch.tensor(int(counter) & prng._M32, dtype=torch.int64, device=device)
        base = prng.mix32(c ^ prng._mix32_host(s ^ t))
        return prng.mix32(torch.arange(n, dtype=torch.int64, device=device) ^ base
                          ).reshape(shape)

    monkeypatch.setattr(prng, "hash_bits", hash_bits)
    res = _audit()
    t = res["transfers"]
    assert not t["ok"]
    assert any(u.startswith("transfer lift_fresh") and "hash_bits" in u
               for u in t["undeclared"]), t["undeclared"]


def test_audit_catches_parameters_replaced_out_of_place(monkeypatch):
    def body(self, steps, wm):
        out = _BODY(self, steps, wm)
        self.params = EmbeddingPair(self.params.syn0 * 1.0, self.params.syn1)
        return out

    monkeypatch.setattr(Trainer, "_chunk_body", body)
    res = _audit()
    ip = res["in_place"]
    assert not ip["ok"] and not ip["storage_stable"] and not res["ok"]
    assert any(o.startswith("aten.mul") and "test_torch_stepaudit.py" in o
               for o in ip["out_of_place"]), ip
    assert res["transfers"]["ok"] and res["dtype"]["ok"]


def test_audit_catches_a_float64_intermediate(monkeypatch):
    def body(self, steps, wm):
        out = _BODY(self, steps, wm)
        self._audit_f64 = self.params.syn0.double().sum(dim=1)
        return out

    monkeypatch.setattr(Trainer, "_chunk_body", body)
    res = _audit()
    d = res["dtype"]
    assert not d["ok"] and not d["f64_free"] and not res["ok"]
    assert any("float64" in f and "test_torch_stepaudit.py" in f for f in d["f64"]), d
    assert res["transfers"]["ok"]


def test_audit_catches_a_dense_float32_upcast_in_bf16(monkeypatch):
    def body(self, steps, wm):
        out = _BODY(self, steps, wm)
        self._audit_f32 = self.params.syn1.float().abs().amax()
        return out

    monkeypatch.setattr(Trainer, "_chunk_body", body)
    res = _audit("shared_bf16_chain")
    d = res["dtype"]
    assert not d["ok"] and d["dense_f32_vd_free"] is False and d["f64_free"]
    assert any("float32" in f and "test_torch_stepaudit.py" in f
               for f in d["dense_f32"]), d
    clean = _audit("shared")  # the f32 variant owns its f32 matrices
    assert clean["dtype"]["ok"] and clean["dtype"]["dense_f32_vd_free"] is None


def _event(site, kind, blocking=False):
    return {"kind": kind, "op": "op", "site": site, "blocking": blocking,
            "where": "here", "thread": "MainThread"}


@pytest.mark.parametrize("events,ok", [
    ([_event("stage", "transfer"), _event("heartbeat", "read"),
      _event("fit_end", "sync")], True),
    ([_event("stage", "transfer", blocking=True)], False),
    ([_event("stage", "read")], False),
    ([_event("heartbeat", "transfer")], False),
    ([_event("probe", "transfer", blocking=True)], False),
], ids=["declared", "blocking_stage_copy", "read_in_stage", "copy_in_heartbeat",
        "blocking_copy_in_probe"])
def test_transfers_report_holds_each_site_to_what_it_declares(events, ok):
    """A declared site does not turn off (b): ``stage`` may only copy to the device,
    from pinned memory and non-blocking, and every other site may only read or wait."""
    rec = SimpleNamespace(events=events, device=CPU)
    t = stepaudit._transfers_report(rec, 2, None)
    assert t["ok"] is ok and t["undeclared_count"] == 0, t
    assert t["misplaced_count"] == (0 if ok else 1), t
    assert t["blocking_h2d"] == sum(e["blocking"] for e in events
                                    if e["kind"] == "transfer")


_HEALTH = Trainer._health_stats


def _inject_in_probe(kind):
    """The probe's declared site, made to do what it does not declare."""
    def transfer(self):
        with self.sync_sites("probe", blocking=True):
            self._audit_extra = torch.tensor([1.0, 2.0, 3.0])

    def f64(self):
        with self.sync_sites("probe", blocking=True):
            self._audit_extra = torch.zeros(64, dtype=torch.float64)

    def out_of_place(self):
        with self.sync_sites("probe", blocking=True):
            self._audit_extra = self.params.syn0 * 1.0

    extra = locals()[kind]

    def health_stats(self):
        out = _HEALTH(self)
        extra(self)
        return out

    return health_stats


@pytest.mark.parametrize("kind", ["transfer", "f64", "out_of_place"])
def test_audit_checks_inside_declared_sites(monkeypatch, kind):
    """Inside a declared site the audit still holds the site to (b), (c) and (a)'s
    output check: only the parameter copies (snapshot, checkpoint) are exempt."""
    monkeypatch.setattr(Trainer, "_health_stats", _inject_in_probe(kind))
    res = _audit()
    assert not res["ok"], res
    t, d, ip = res["transfers"], res["dtype"], res["in_place"]
    assert t["undeclared_count"] == 0, t
    if kind == "transfer":
        assert not t["ok"] and any(m.startswith("transfer lift_fresh in probe")
                                   for m in t["misplaced"]), t
        assert d["ok"] and ip["ok"]
    elif kind == "f64":
        assert not d["ok"] and any("float64" in f and "test_torch_stepaudit.py" in f
                                   for f in d["f64"]), d
        assert t["ok"] and ip["ok"]
    else:
        assert not ip["ok"] and ip["storage_stable"], ip
        assert any(o.startswith("aten.mul") for o in ip["out_of_place"]), ip
        assert t["ok"] and d["ok"]


def test_audit_variant_in_process_banded():
    """One in-process audit, so that a contract failure debugs without a subprocess:
    banded CBOW on the token-block feed, with its settled pair counts at the fit's end
    as a declared site."""
    res = _audit("cbow_banded")
    assert res["ok"], res
    assert res["step_form"] == "cbow_banded"
    assert "fit_end" in res["transfers"]["declared"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_audit_catches_a_pageable_staging_copy(cuda, monkeypatch):
    """The chunk's arrays copied to the card from pageable memory and blocking, inside
    the declared ``stage`` site: the copies are counted as blocking and fail (b)."""
    def pageable(self, chunk):
        with self.sync_sites("stage"):
            arrays = {name: torch.from_numpy(a).to(self.device)
                      for name, a in chunk["arrays"].items()}
        return {name: t if t.is_floating_point() else t.long()
                for name, t in arrays.items()}

    monkeypatch.setattr(Trainer, "_stage", lambda self, chunks: iter(chunks))
    monkeypatch.setattr(Trainer, "_device_arrays", pageable)
    res = stepaudit.audit_variant("shared", stepaudit.smoke_geometry("cuda"), cuda)
    t = res["transfers"]
    assert not t["ok"] and not res["ok"], t
    assert t["blocking_h2d"] >= res["chunks"] and t["undeclared_count"] == 0, t
    assert all(m.startswith("blocking transfer _to_copy in stage")
               for m in t["misplaced"]), t


@pytest.mark.cuda
def test_audit_catches_a_recovery_without_a_recapture(cuda, monkeypatch):
    """A graph key that forgets the parameters' identity and the stabilizers: after the
    restore the twin captured before it replays on the blown pair. The recovery audit
    finds fewer recaptures than twins used after the restore (only a twin first used
    after it is captured)."""
    ok = stepaudit.audit_recover_rebuild(stepaudit.smoke_geometry(), cuda)
    assert ok["ok"] and ok["recaptures"] == ok["expected_recaptures"] >= 1, ok
    monkeypatch.setattr(Trainer, "_graph_key",
                        lambda self, with_metrics: ("frozen", bool(with_metrics)))
    res = stepaudit.audit_recover_rebuild(stepaudit.smoke_geometry(), cuda)
    assert res["recoveries"] == 1 and res["captures_before"] >= 1
    assert res["recaptures"] < res["expected_recaptures"] and not res["ok"], res
