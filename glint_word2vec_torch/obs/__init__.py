"""The in-process runtime layer, ported from ``glint_word2vec_tpu/obs/``; every layer
is off by default and free when off:

- :mod:`.probe`: the health probe (finiteness and per-matrix row-norm channels);
- :mod:`.watch`: the finite-blowup watchdog (``config.norm_watch``);
- :mod:`.sink` and :mod:`.schema`: the schema-versioned JSONL run log and its
  validators (one catalogue with the JAX package's);
- :mod:`.spans`: host trace spans, exported as Chrome-trace JSON;
- :mod:`.phases`: per-phase log2 duration histograms;
- :mod:`.blackbox`: the flight recorder, dumped on fit death;
- :mod:`.statusd`: the read-only live status endpoint (``config.status_port``), with
  the serving tier's ``glint_serve_*`` renderer;
- :mod:`.trace`: cross-process trace ids and spans, and the trainer's ``publish``
  record's signature;
- :mod:`.slo`: the fleet's availability and latency objectives and their burn rates;
- :mod:`.collect`: the offline merge of a fleet's sinks and dumps into one timeline.
"""

from glint_word2vec_torch.obs.blackbox import FlightRecorder
from glint_word2vec_torch.obs.collect import collect, export_perfetto
from glint_word2vec_torch.obs.phases import PhaseAccumulator
from glint_word2vec_torch.obs.probe import HealthStats, health_stats, stats_to_channels
from glint_word2vec_torch.obs.schema import (
    SCHEMA_VERSION,
    validate_blackbox,
    validate_blackbox_file,
    validate_file,
    validate_record,
)
from glint_word2vec_torch.obs.sink import TelemetrySink
from glint_word2vec_torch.obs.slo import SloObjectives, SloTracker
from glint_word2vec_torch.obs.spans import Tracer, default_tracer
from glint_word2vec_torch.obs.statusd import (StatusServer, fleet_prometheus_text,
                                              prometheus_text, serve_prometheus_text)
from glint_word2vec_torch.obs.watch import NormWatchdog

__all__ = [
    "HealthStats", "health_stats", "stats_to_channels",
    "SCHEMA_VERSION", "validate_file", "validate_record",
    "validate_blackbox", "validate_blackbox_file",
    "TelemetrySink", "Tracer", "default_tracer", "NormWatchdog",
    "FlightRecorder", "PhaseAccumulator", "StatusServer", "prometheus_text",
    "serve_prometheus_text", "fleet_prometheus_text",
    "SloObjectives", "SloTracker", "collect", "export_perfetto",
]
