"""Serve a checkpoint from its own process over JSON lines, ported from
``tools/serve_checkpoint.py``:

    python -m glint_word2vec_torch.serve_checkpoint CHECKPOINT [--mesh DxM] [--ann]
        [--nprobe N] [--watch] [--status-port P] [--telemetry PATH]
        [--process-name NAME] [--device cuda|cpu]

A thin client of :class:`~glint_word2vec_torch.serve.EmbeddingService`: the model is
loaded onto ``--device`` (the card by default; no fallback to the CPU), queries ride
the request batcher, ``--ann`` serves the IVF arm built at load time, ``--watch``
hot-reloads on the trainer's publish signal.

``--mesh DxM`` serves from a (data, model) mesh of D·M ranks, each holding its rows of
the checkpoint (read from its files, never a dense copy): this process is rank 0 and
keeps the JSON-lines front end, and starts its D·M − 1 followers itself (the same
module with the hidden ``--rank``/``--store``), which join one ``torch.distributed``
world through a file store in a temporary directory and run the ops rank 0 announces
(:mod:`.serve.mesh`). Rank r runs on ``cuda:r % device_count`` over NCCL when the
ranks have a card each, and over gloo when they share cards (or on the CPU with
``--device cpu``). A reload is decided on rank 0 and lands on every rank before the
next op. SIGTERM to rank 0 ends every rank with exit 0; a follower that dies ends
rank 0 at once with a non-zero exit and a message on stderr: a mesh never serves with
a rank missing.

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
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m glint_word2vec_torch.serve_checkpoint",
        description="Serve a checkpoint's model ops over JSON lines on stdin/stdout.")
    ap.add_argument("checkpoint")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL, e.g. 1x2: serve from a mesh of that many ranks, "
                         "each loading its rows of the checkpoint (no dense copy); "
                         "this process is rank 0 and starts the others")
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
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.mesh:
        if args.rank is not None:
            ap.error("--rank is a mesh follower's option (with --mesh)")
        return _serve(args)
    try:
        mesh = tuple(int(x) for x in args.mesh.lower().split("x"))
        if len(mesh) != 2 or min(mesh) < 1:
            raise ValueError
    except ValueError:
        ap.error(f"--mesh wants DATAxMODEL (e.g. 1x2), got {args.mesh!r}")
    if args.rank is not None:
        return _follower(args, mesh)
    return _serve_mesh(args, mesh)


class _Terminated(Exception):
    """SIGTERM on a mesh's rank 0: leave the serve loop and shut the mesh down."""


def _serve(args, plan=None, device=None, on_close=None) -> int:
    """The JSON-lines front end over an :class:`EmbeddingService` (on ``plan``, as a
    mesh's rank 0, when given). ``on_close`` runs before the service closes."""
    from glint_word2vec_torch.obs.blackbox import FlightRecorder
    from glint_word2vec_torch.serve import EmbeddingService

    service = EmbeddingService(
        checkpoint=args.checkpoint, plan=plan, ann=args.ann,
        nprobe=args.nprobe or None, watch=args.watch, telemetry_path=args.telemetry,
        status_port=args.status_port, process_name=args.process_name,
        device=device or args.device)

    if plan is not None:
        # a mesh's rank 0: SIGTERM leaves the loop, and the shutdown below ends every
        # rank with exit 0 (after the flight recorder's dump, with telemetry)
        def _on_sigterm(signum, frame):
            if args.telemetry:
                service.dump_blackbox(FlightRecorder.signal_cause(signum),
                                      include_stats=False)
            raise _Terminated()

        signal.signal(signal.SIGTERM, _on_sigterm)
    elif args.telemetry:
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

    try:
        info = service.info()
        out({"ready": True, "num_words": info["num_words"],
             "vector_size": info["vector_size"]})
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
            except _Terminated:
                raise
            except Exception as e:  # noqa: BLE001 — protocol errors go to the client
                err = {"error": f"{type(e).__name__}: {e}",
                       "error_type": type(e).__name__}
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    err["retry_after_s"] = retry_after
                out(err, req)
    except _Terminated:
        pass
    except BaseException as e:
        # a fatal serve-loop error (per-request ones were answered above) leaves the
        # same dump a dying trainer does
        service.dump_blackbox(FlightRecorder.exception_cause(e))
        raise
    finally:
        if plan is not None:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)  # the shutdown runs to its end
        if on_close is not None:
            on_close()
        service.close()
    return 0


# a mesh service waits on its clients, not on a deadline: its collectives time out
# after this long (a dead rank ends the mesh through the follower watch and the
# parent watch instead)
SERVE_TIMEOUT_S = 7 * 24 * 3600.0


def _join(args, mesh, rank: int, store: str):
    """Join the mesh service's world as ``rank``; (plan, device)."""
    import torch

    from glint_word2vec_torch.device import resolve_device
    from glint_word2vec_torch.parallel import distributed
    from glint_word2vec_torch.parallel.mesh import make_mesh

    device = resolve_device(args.device)
    world = mesh[0] * mesh[1]
    shared = device.type != "cuda" or world > torch.cuda.device_count()
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    distributed.initialize(init_method=f"file://{store}", num_processes=world,
                           process_id=rank, backend="gloo" if shared else "nccl",
                           device=device, timeout_s=SERVE_TIMEOUT_S)
    return make_mesh(*mesh), device


def _serve_mesh(args, mesh) -> int:
    """Rank 0 of ``--mesh``: start the followers, watch them, serve, shut down."""
    import shutil
    import subprocess
    import tempfile
    import threading

    from glint_word2vec_torch.parallel import distributed

    world = mesh[0] * mesh[1]
    tmp = tempfile.mkdtemp(prefix="glint-serve-mesh-")
    store = os.path.join(tmp, "store")
    followers = [subprocess.Popen(
        [sys.executable, "-m", "glint_word2vec_torch.serve_checkpoint",
         args.checkpoint, "--mesh", args.mesh, "--device", args.device,
         "--rank", str(r), "--store", store],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL) for r in range(1, world)]
    closing = threading.Event()

    def watch():
        # a mesh never serves with a rank missing: a follower's death ends rank 0
        while not closing.wait(0.2):
            for r, p in enumerate(followers, 1):
                rc = p.poll()
                if rc is not None and not closing.is_set():
                    sys.stderr.write(
                        f"serve_checkpoint --mesh {args.mesh}: follower rank {r} "
                        f"exited with code {rc}; the mesh stops (it never serves with "
                        f"a rank missing)\n")
                    sys.stderr.flush()
                    for q in followers:
                        if q.poll() is None:
                            q.kill()
                    os._exit(3)

    threading.Thread(target=watch, name="glint-serve-followers", daemon=True).start()
    rcs: list = []
    try:
        plan, device = _join(args, mesh, 0, store)
        rc = _serve(args, plan, device, on_close=closing.set)
        rcs = [p.wait(timeout=120) for p in followers]
        distributed.shutdown()
    finally:
        closing.set()
        for p in followers:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return rc or next((c for c in rcs if c), 0)


def _follower(args, mesh) -> int:
    """A follower rank of ``--mesh``: join, run what rank 0 announces until it ends
    the mesh, exit 0. SIGTERM is left to rank 0 (its shutdown ends this rank); the
    death of rank 0 ends this rank."""
    import threading

    from glint_word2vec_torch.serve.mesh import follow

    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    parent = os.getppid()

    def watch_parent():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(4)

    threading.Thread(target=watch_parent, name="glint-serve-parent",
                     daemon=True).start()
    plan, device = _join(args, mesh, args.rank, args.store)
    follow(plan, device)
    sys.stdout.flush()
    sys.stderr.flush()
    # the world's threads may still wait on the departed front end: exit without them
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
