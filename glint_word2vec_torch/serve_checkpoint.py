"""Serve a checkpoint from its own process over JSON lines, ported from
``tools/serve_checkpoint.py``:

    python -m glint_word2vec_torch.serve_checkpoint CHECKPOINT [--ann] [--nprobe N]
        [--watch] [--status-port P] [--telemetry PATH] [--process-name NAME]
        [--device cuda|cpu]

A thin client of :class:`~glint_word2vec_torch.serve.EmbeddingService`: the model is
loaded onto ``--device`` (the card by default; no fallback to the CPU), queries ride
the request batcher, ``--ann`` serves the IVF arm built at load time, ``--watch``
hot-reloads on the trainer's publish signal. ``--mesh`` (a multi-device mesh) is
refused: the port serves from one device (ROADMAP.md queue A9).

The protocol is the JAX package's, unchanged. One request object per line on stdin,
one response object per line on stdout; the first line out is
``{"ready": true, "num_words": V, "vector_size": D}``:

    {"op": "synonyms", "word": "berlin", "num": 10}
    {"op": "synonyms_batch", "words": ["berlin", "wien"], "num": 10}
    {"op": "synonyms_vec", "vector": [...], "num": 10}
    {"op": "vector", "word": "berlin"}
    {"op": "reload"}        # pick up a newer checkpoint at the same path
    {"op": "info"}
    {"op": "stats"}         # the serving tier's gauges, publish_sig included
    {"op": "quit"}

A request's ``"id"`` is echoed on its response. Errors are machine-readable:
``{"error": "...", "error_type": "ServerOverloaded", "retry_after_s": 0.12}``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m glint_word2vec_torch.serve_checkpoint",
        description="Serve a checkpoint's model ops over JSON lines on stdin/stdout.")
    ap.add_argument("checkpoint")
    ap.add_argument("--mesh", default=None,
                    help="refused: multi-device serving is not ported")
    ap.add_argument("--ann", action="store_true",
                    help="serve synonym queries from the IVF index (built at load and "
                         "reload time; the exact arm is the default)")
    ap.add_argument("--nprobe", type=int, default=0,
                    help="IVF cells probed per query (0 = the config's or auto)")
    ap.add_argument("--watch", action="store_true",
                    help="hot-reload on the trainer's checkpoint publish signal")
    ap.add_argument("--status-port", type=int, default=0,
                    help="> 0: serve glint_serve_* gauges on 127.0.0.1:<port> "
                         "(/status.json, /metrics, /healthz)")
    ap.add_argument("--telemetry", default="",
                    help="write serve_* telemetry records to this JSONL path; also "
                         "arms the flight recorder (<path>.blackbox.json on death) "
                         "and trace spans")
    ap.add_argument("--process-name", default="",
                    help="track label of this process's telemetry (default "
                         "serve-<pid>)")
    ap.add_argument("--device", default="cuda",
                    help="where the model lives and the exact arm runs (default the "
                         "card; 'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: serving from a multi-device mesh is not ported to "
            "glint_word2vec_torch yet (ROADMAP.md queue A9); the port serves from one "
            "device")

    from glint_word2vec_torch.obs.blackbox import FlightRecorder
    from glint_word2vec_torch.serve import EmbeddingService

    service = EmbeddingService(
        checkpoint=args.checkpoint, ann=args.ann, nprobe=args.nprobe or None,
        watch=args.watch, telemetry_path=args.telemetry,
        status_port=args.status_port, process_name=args.process_name,
        device=args.device)

    if args.telemetry:
        # SIGTERM dumps <telemetry>.blackbox.json with a serve-scoped cause, then
        # restores the prior disposition and re-raises, so the exit status stays -15
        prev_handler = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            # include_stats=False: the handler may have interrupted the main thread
            # inside the batcher's non-reentrant condition; a stats snapshot here
            # would deadlock the dump
            service.dump_blackbox(FlightRecorder.signal_cause(signum),
                                  include_stats=False)
            signal.signal(signal.SIGTERM,
                          prev_handler if callable(prev_handler) else signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_sigterm)

    def out(obj, req=None):
        if req is not None and "id" in req:
            obj = {**obj, "id": req["id"]}
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    info = service.info()
    out({"ready": True, "num_words": info["num_words"],
         "vector_size": info["vector_size"]})
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            req = None
            try:
                req = json.loads(line)
                op = req["op"]
                trace = req.get("trace")
                if op == "synonyms":
                    res = service.synonyms(req["word"], int(req.get("num", 10)),
                                           trace=trace)
                    out({"synonyms": [[w, s] for w, s in res]}, req)
                elif op == "synonyms_vec":
                    import numpy as np
                    vec = np.asarray(req["vector"], np.float32)
                    res = service.synonyms(vec, int(req.get("num", 10)))
                    out({"synonyms": [[w, s] for w, s in res]}, req)
                elif op == "synonyms_batch":
                    res = service.synonyms_batch(list(req["words"]),
                                                 int(req.get("num", 10)), trace=trace)
                    out({"synonyms": [[[w, s] for w, s in row] for row in res]}, req)
                elif op == "vector":
                    out({"vector": service.vector(req["word"]).tolist()}, req)
                elif op == "reload":
                    model = service.reload_now()
                    out({"reloaded": True, "num_words": model.num_words}, req)
                elif op == "info":
                    i = service.info()
                    out({"num_words": i["num_words"], "vector_size": i["vector_size"],
                         "iteration": i["iteration"], "finished": i["finished"]}, req)
                elif op == "stats":
                    out(service.stats(), req)
                elif op == "quit":
                    out({"bye": True}, req)
                    break
                else:
                    out({"error": f"unknown op {op!r}", "error_type": "ValueError"},
                        req)
            except Exception as e:  # noqa: BLE001 — protocol errors go to the client
                err = {"error": f"{type(e).__name__}: {e}",
                       "error_type": type(e).__name__}
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    err["retry_after_s"] = retry_after
                out(err, req)
    except BaseException as e:
        # a fatal serve-loop error (per-request ones were answered above) leaves the
        # same dump a dying trainer does
        service.dump_blackbox(FlightRecorder.exception_cause(e))
        raise
    finally:
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
