"""CLI entry point: ``python -m veles_tpu_torch <workflow> [<config>] [flags]``.

Port of ``veles_tpu/__main__.py`` (ref: veles/__main__.py::Main +
scripts/velescli.py [H], SURVEY §2.1, §3.1):

- ``<workflow>`` is a Python file or a dotted module (e.g.
  ``veles_tpu_torch.samples.mnist``) exposing ``run(load, main)``;
- ``<config>`` is a Python file executed against the port's ``root``;
- any argument of the form ``root.a.b=value`` overrides a config leaf
  (before or after the flags);
- ``--random-seed`` seeds every named PRNG stream; ``-s/--snapshot``
  resumes from a snapshot file or ``auto``;
- ``-d/--device`` is ``cuda`` (the default: the card, raising without
  one) or ``cpu``.

- ``--distributed --coordinator-address HOST:PORT --num-processes N
  --process-id R`` joins a data-parallel run of N processes (one a
  card; gloo when ranks share a card or run on the CPU);
- ``--optimize GENERATIONS[:POPULATION[:WORKERS]]`` runs the genetic
  optimizer over the config's ``Tune`` leaves instead of one training
  run (``genetics.optimize_cli``), its workers on ``-d``'s device.

- ``--serve PORT`` (``--serve-batch N``) serves the trained forward
  chain over HTTP after the run (``restful_api.RESTfulAPI`` with the
  loader's normalizer, through the micro-batcher when N > 0), or an LM
  workflow's token continuation (``restful_api.serve_lm``, with
  ``--serve-slots``, ``--serve-prefix-cache``, ``--serve-prefill-chunk``,
  ``--serve-spec-k``, ``--serve-paged-kv`` and ``--serve-megastep``
  for its engine, ``--serve-replicas R`` and ``--serve-router
  metrics|round_robin`` for R engine replicas behind the router, and
  ``--serve-health``, ``--serve-hedge SECONDS`` and ``--serve-retries
  N`` for the router's resilience layer),
  prints ``SERVING http://127.0.0.1:<port>/predict`` and blocks until
  interrupted; ``--fault-plan FILE`` arms a JSON fault
  plan (``serving/faults.py``) at the served engine's, batcher's and
  server's sites; an LM workflow's server also takes ``--serve-trace
  off|errors|all|sample:P`` (``--serve-trace-last N``: the flight
  recorder's size), ``--serve-telemetry [SECONDS]`` and ``--serve-slo
  FILE|default`` (``serving/{tracing,timeseries,slo}.py``: ``GET
  /trace.json``, ``/ledger.json``, ``/timeseries.json``, ``/slo.json``).
- ``--web-status PORT`` serves the live dashboard (``web_status``; 0:
  any free port) and prints ``WEBSTATUS http://<host>:<port>/``;
  ``--web-status-url URL`` reports this process's rows to another
  dashboard instead; ``--events-file FILE`` appends structured log
  events as JSON lines and ``--events-mongo ADDR`` sends them to
  MongoDB (it needs ``pymongo``: without it the CLI exits 2 naming it).

The parser takes every flag of the reference, so any reference command
line parses.  The flags whose machinery is not ported yet (the fleet's
resilience and deploy flags, and tensor-parallel serving's) raise
NotImplementedError naming their ROADMAP item before anything is
trained.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

def build_argparser():
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="the PyTorch/CUDA port of the dataflow ML framework")
    parser.add_argument("workflow",
                        help="workflow .py file or dotted module with "
                             "run(load, main)")
    parser.add_argument("config", nargs="?", default=None,
                        help="config .py file executed against `root`")
    parser.add_argument("overrides", nargs="*", metavar="root.a.b=value",
                        help="config leaf overrides")
    parser.add_argument("--random-seed", type=int, default=None,
                        help="seed every named PRNG stream")
    parser.add_argument("-s", "--snapshot", default=None,
                        help="resume from this snapshot file, or 'auto' "
                             "for the latest snapshot in the workflow's "
                             "snapshot directory (a fresh run if none)")
    parser.add_argument("-d", "--device", default=None,
                        choices=("cuda", "cpu"),
                        help="where to run (default: the CUDA card; "
                             "without one the run raises)")
    parser.add_argument("--epoch-scan", type=int, default=0, nargs="?",
                        const=1, metavar="CHUNK",
                        help="train through the epoch-scan driver: a "
                             "captured step replayed a minibatch, the "
                             "metrics read every CHUNK epochs (bare flag: "
                             "1); snapshot granularity = CHUNK epochs")
    parser.add_argument("--stream-window", type=int, default=0,
                        metavar="MINIBATCHES",
                        help="stream the dataset through device memory "
                             "in windows of this many minibatches, the "
                             "next window staged while the card trains "
                             "(implies --epoch-scan)")
    parser.add_argument("--stage-ahead", type=int, default=1,
                        metavar="N",
                        help="with --stream-window: windows staged ahead "
                             "(default 1, double buffering)")
    parser.add_argument("--no-fused", action="store_true",
                        help="run the unit graph without the fused step")
    parser.add_argument("--precision", default=None,
                        choices=("float32", "default", "bfloat16"),
                        help="matmul/conv precision mode "
                             "(ops.functional.set_matmul_precision)")
    parser.add_argument("--distributed", action="store_true",
                        help="join a multi-process data-parallel run "
                             "(torch.distributed: NCCL when every rank "
                             "has a card of its own, else gloo)")
    parser.add_argument("--coordinator-address", default=None,
                        metavar="HOST:PORT",
                        help="rank 0's TCP store (with --distributed)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--snapshot-dir", default=None,
                        help="enable periodic snapshotting into this dir")
    parser.add_argument("--snapshot-interval", type=int, default=1)
    parser.add_argument("--snapshot-compression", default="gz",
                        choices=("", "gz", "bz2", "xz"))
    parser.add_argument("--snapshot-keep-last", type=int, default=0,
                        help="retain only the newest N epoch snapshots "
                             "(0 keeps all; *_current always survives)")
    parser.add_argument("--result-file", default=None,
                        help="write a JSON run summary here")
    parser.add_argument("--dump-config", action="store_true",
                        help="print the effective config tree and exit")
    parser.add_argument("--graph", default=None, metavar="FILE.dot",
                        help="write the unit graph as graphviz dot")
    parser.add_argument("--no-stats", action="store_true",
                        help="skip the per-unit run-time table")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler Chrome trace of the "
                             "run to DIR/trace.json")
    parser.add_argument("--optimize", default=None, metavar="GENERATIONS",
                        help="genetic hyperparameter search over the "
                             "config's Tune leaves: GENERATIONS[:POPULATION"
                             "[:WORKERS]] (workers on --device)")
    parser.add_argument("--list-units", action="store_true",
                        help="list registered unit classes and exit")

    class _Version(argparse.Action):
        def __call__(self, parser, *unused_a, **unused_k):
            import veles_tpu_torch
            print("veles_tpu_torch %s" % veles_tpu_torch.__version__)
            parser.exit()

    parser.add_argument("--version", action=_Version, nargs=0,
                        help="print the framework version and exit")
    parser.add_argument("--events-file", default=None, metavar="FILE",
                        help="append structured log events (JSON lines) "
                             "to FILE")
    parser.add_argument("--events-mongo", default=None, metavar="ADDR",
                        help="stream structured log events to MongoDB at "
                             "ADDR (mongodb://...; requires pymongo)")
    parser.add_argument("--evaluate", action="store_true",
                        help="evaluation only: one pass over every set "
                             "with weight updates gated off (pair with "
                             "--snapshot)")
    parser.add_argument("--web-status", type=int, default=None,
                        metavar="PORT",
                        help="serve the live dashboard (0: any free port; "
                             "prints WEBSTATUS <url>): a row a process, "
                             "the epoch metrics, the graph at "
                             "/graph/<row>.svg, /metrics")
    parser.add_argument("--web-status-url", default=None, metavar="URL",
                        help="report this process's rows to another "
                             "dashboard instead of serving one (the other "
                             "ranks of a distributed run)")
    parser.add_argument("--web-status-host", default="127.0.0.1",
                        metavar="HOST",
                        help="interface --web-status binds (0.0.0.0 so "
                             "other hosts' ranks can POST /report)")
    parser.add_argument("--serve", type=int, default=None, metavar="PORT",
                        help="after training, serve the forward chain "
                             "(or an LM workflow's token continuation) "
                             "over HTTP on PORT (0: any free port)")
    parser.add_argument("--serve-batch", type=int, default=0, metavar="N",
                        help="with --serve: coalesce concurrent requests "
                             "into batches of up to N (0: one forward a "
                             "request)")
    for flag, help_ in _SERVE_FLAGS:
        parser.add_argument(flag, type=int, default=0, help=help_)
    parser.add_argument("--serve-attn-kernel", default="off",
                        choices=("off", "auto", "force"),
                        help="parsed for the reference's command lines; "
                             "the port's engine has one attention route, "
                             "the card's kernels, whatever this says")
    parser.add_argument("--serve-trace", default="off", metavar="MODE",
                        help="with --serve on an LM workflow: request "
                             "tracing (serving/tracing.py) — "
                             "off|errors|all|sample:P; GET /trace.json "
                             "exports the flight recorder as Chrome-"
                             "trace/Perfetto JSON and GET /ledger.json "
                             "the per-op cost ledger (default: off)")
    parser.add_argument("--serve-trace-last", type=int, default=256,
                        metavar="N",
                        help="with --serve-trace: the flight recorder's "
                             "size in requests (default 256)")
    parser.add_argument("--serve-telemetry", type=float, default=0.0,
                        nargs="?", const=1.0, metavar="SECONDS",
                        help="with --serve-slots: sample the serving "
                             "metrics and the runtime gauges every "
                             "SECONDS (bare flag: 1) into bounded "
                             "time series, GET /timeseries.json"
                             "?window=S (default: off)")
    parser.add_argument("--serve-slo", default=None, metavar="FILE",
                        help="with --serve-slots: SLO objectives from a "
                             "JSON file ('default': the stock set) as "
                             "multi-window burn rates over the "
                             "telemetry (implied at 1 s), GET /slo.json")
    parser.add_argument("--serve-replicas", type=int, default=1,
                        metavar="R",
                        help="with --serve-slots: R engine replicas, each "
                             "on its own device (round robin over the "
                             "visible cards, or the CPU with -d cpu), "
                             "behind the router; /metrics gains "
                             "{replica=} rows")
    parser.add_argument("--serve-router", default="metrics",
                        choices=("metrics", "round_robin"),
                        help="with --serve-replicas: placement policy — "
                             "'metrics' (default) weighs each replica's "
                             "live queue depth, resident KV pages and "
                             "TTFT/decode-step EWMAs; 'round_robin' "
                             "ignores them")
    parser.add_argument("--serve-health", action="store_true",
                        help="with --serve-slots: background health "
                             "prober per replica (staleness watch on "
                             "busy replicas, synthetic 1-token probe "
                             "on idle ones) that auto-quarantines a "
                             "failing replica via the router's drain "
                             "path and re-admits it after a cooldown "
                             "(half-open circuit breaker; "
                             "replica_health_state / "
                             "circuit_open_total on /metrics)")
    parser.add_argument("--serve-hedge", type=float, default=0.0,
                        metavar="SECONDS",
                        help="with --serve-slots: duplicate a request "
                             "still outstanding past SECONDS on a "
                             "second replica — first complete wins, "
                             "the loser is cancelled (greedy replicas "
                             "are bit-identical, so hedging moves "
                             "tail latency, never output); negative = "
                             "dynamic threshold (1.5x the live "
                             "latency p95); 0 = off (default)")
    parser.add_argument("--serve-retries", type=int, default=0,
                        metavar="N",
                        help="with --serve-slots: re-place a request "
                             "whose replica FAULTED (engine error — "
                             "not 429/503 sheds, not client errors) "
                             "on a different replica up to N times "
                             "with exponential jittered backoff; "
                             "0 = off (default, the fault fails to "
                             "the client)")
    # the rest of the reference's --serve-* flags, with their types and
    # defaults (not ported yet: each raises naming its ROADMAP item)
    for flag, kind, default, _ in _SERVE_UNPORTED:
        if kind is bool:
            parser.add_argument(flag, action="store_true",
                                help="(not ported yet)")
        else:
            parser.add_argument(flag, type=kind, default=default,
                                help="(not ported yet)")
    parser.add_argument("--fault-plan", default=None, metavar="FILE",
                        help="with --serve: arm the deterministic fault-"
                             "injection sites from a JSON plan "
                             "(serving/faults.py: injected dispatch "
                             "errors, latency, freezes, transient HTTP "
                             "errors); every site is a no-op without it")
    return parser


#: the LM engine's serving flags (ints, default 0), with their help
_SERVE_FLAGS = (
    ("--serve-slots", "with --serve on an LM workflow: decode up to N "
     "requests side by side in the paged engine's slots (greedy ones; "
     "sampled requests take the direct path); 0: every request "
     "decodes alone"),
    ("--serve-prefix-cache", "with --serve-slots: keep N prompt chunks "
     "in the radix prefix cache"),
    ("--serve-prefill-chunk", "with --serve-slots: the prompt chunk and "
     "KV page, in tokens (0: the largest divisor of max_len up to 32)"),
    ("--serve-spec-k", "with --serve-slots: prompt-lookup speculative "
     "decoding, up to K draft tokens a dispatch"),
    ("--serve-paged-kv", "with --serve-slots: the KV pool's pages (0 or "
     "-1: every slot's full span; the port's engine is paged only)"),
    ("--serve-megastep", "with --serve-slots: K decode iterations a "
     "fused dispatch (0 or 1: one a dispatch)"),
)

_DEPLOY = "Queue 1, item 9(c) (fleet deploy and the model manager)"
#: the reference's serving flags not ported yet: (flag, type, default,
#: ROADMAP item)
_SERVE_UNPORTED = (
    ("--serve-tp", int, 0, "Queue 1, item 4"),
    ("--serve-model-dir", str, None, _DEPLOY),
    ("--serve-canary", int, 1, _DEPLOY),
    ("--serve-publish-interval", float, 5.0, _DEPLOY),
    ("--serve-canary-watch", float, 2.0, _DEPLOY),
    ("--serve-no-auto-rollback", bool, False, _DEPLOY),
)


def refuse_unported(args):
    """NotImplementedError naming the ROADMAP item of the first flag
    given that is not ported yet (before anything is built)."""
    unported = [(flag[2:].replace("-", "_"), default, item)
                for flag, _, default, item in _SERVE_UNPORTED]
    for dest, default, item in unported:
        if getattr(args, dest) != default:
            raise NotImplementedError(
                "--%s is not ported yet: ROADMAP %s"
                % (dest.replace("_", "-"), item))


def load_workflow_module(spec):
    """Import the workflow module from a file path or dotted name."""
    if spec.endswith(".py") or os.path.sep in spec:
        name = os.path.splitext(os.path.basename(spec))[0]
        mod_spec = importlib.util.spec_from_file_location(name, spec)
        if mod_spec is None:
            raise ImportError("cannot load workflow file %r" % spec)
        module = importlib.util.module_from_spec(mod_spec)
        sys.modules[name] = module
        mod_spec.loader.exec_module(module)
        return module
    return importlib.import_module(spec)


def exec_config_file(path):
    """Execute a config file against the port's root (reference
    semantics)."""
    from veles_tpu_torch.config import root, Tune
    namespace = {"root": root, "Tune": Tune, "__file__": path}
    with open(path, "r", encoding="utf-8") as f:
        code = compile(f.read(), path, "exec")
    exec(code, namespace)


def main(argv=None):
    """Parse ``argv`` and run; returns the exit code.  The last run's
    workflow and launcher are kept as ``main.workflow`` and
    ``main.launcher`` for callers in the same process."""
    parser = build_argparser()
    # positionals that trail optionals are collected by hand
    # ("prog wf --flag x root.a.b=1"): argparse rejects them otherwise
    args, extra = parser.parse_known_args(argv)
    bad = [t for t in extra if t.startswith("-") or "=" not in t]
    if bad:
        parser.error("unrecognized arguments: %s" % " ".join(bad))
    args.overrides = list(args.overrides) + extra
    refuse_unported(args)

    if args.list_units:
        from veles_tpu_torch.units import UnitRegistry
        import veles_tpu_torch.ops  # noqa: F401 — populate the registry
        for name in sorted(UnitRegistry.units):
            print(name)
        return 0

    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root, parse_override
    from veles_tpu_torch.launcher import Launcher

    if args.events_file or args.events_mongo:
        from veles_tpu_torch.logger import setup_logging
        try:
            setup_logging(events_file=args.events_file,
                          events_mongo=args.events_mongo)
        except (RuntimeError, OSError) as e:
            # no pymongo, an unreachable server or an unwritable file
            parser.error(str(e))

    if args.random_seed is not None:
        prng.seed_all(args.random_seed)
    if args.precision:
        from veles_tpu_torch.ops import functional as F
        F.set_matmul_precision(args.precision)

    # overrides swallowed into `config` when no config file is given
    overrides = list(args.overrides)
    if args.config and "=" in args.config and not os.path.exists(args.config):
        overrides.insert(0, args.config)
        args.config = None
    if args.config:
        exec_config_file(args.config)
    for token in overrides:
        parse_override(token)

    if args.dump_config:
        root.print_()
        return 0

    module = load_workflow_module(args.workflow)
    if not hasattr(module, "run"):
        raise SystemExit("workflow module %r has no run(load, main)"
                         % args.workflow)
    if args.optimize and args.evaluate:
        parser.error("--optimize cannot be combined with --evaluate (the "
                     "GA drives its own training runs)")
    if args.optimize:
        from veles_tpu_torch.genetics import optimize_cli
        return optimize_cli(module, args)
    holder = {}

    def _servable(wf):
        """True when --serve will find a serving surface after training:
        an LM trainer (token continuation) or a forward chain."""
        return _is_lm(wf) or bool(getattr(wf, "forwards", None))

    def load(workflow_cls, **kwargs):
        if args.snapshot_dir:
            # flags win over a config file's snapshotter section, key by
            # key
            cfg_snap = dict(kwargs.get("snapshotter_config") or {})
            cfg_snap.update({
                "directory": args.snapshot_dir,
                "interval": args.snapshot_interval,
                "compression": args.snapshot_compression,
            })
            if args.snapshot_keep_last:
                cfg_snap["keep_last"] = args.snapshot_keep_last
            kwargs["snapshotter_config"] = cfg_snap
        kwargs.setdefault("fused", not args.no_fused)
        wf = workflow_cls(None, **kwargs)
        holder["workflow"] = wf
        return wf

    def main_():
        wf = holder["workflow"]
        if args.graph:
            wf.generate_graph(args.graph)
        if args.serve is not None and not _servable(wf):
            # fail before launcher.boot(): an unservable workflow is
            # knowable before the training run, not only after it
            parser.error("--serve: workflow %r has no forward chain or "
                         "LM trainer to serve" % wf.name)
        if args.web_status is not None or args.web_status_url:
            from veles_tpu_torch.web_status import attach_web_status
            status = attach_web_status(
                wf, port=args.web_status or 0,
                report_url=args.web_status_url,
                host=args.web_status_host)
            if status is not None:
                print("WEBSTATUS http://%s:%d/"
                      % (args.web_status_host, status.port), flush=True)
        launcher = Launcher(
            wf, snapshot=args.snapshot, stats=not args.no_stats,
            profile=args.profile, evaluate=args.evaluate,
            epoch_scan=args.epoch_scan, stream_window=args.stream_window,
            stage_ahead=args.stage_ahead,
            device=None if args.device == "cuda" else args.device,
            distributed=args.distributed,
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes, process_id=args.process_id)
        holder["launcher"] = launcher
        launcher.boot()

    module.run(load, main_)
    main.workflow = holder.get("workflow")
    main.launcher = launcher = holder.get("launcher")
    if launcher is not None and args.result_file:
        with open(args.result_file, "w", encoding="utf-8") as f:
            json.dump(launcher.result_summary(), f, indent=2, default=str)
    if launcher is not None and args.serve is not None:
        serve(launcher.workflow, args.serve, args.serve_batch, args)
    return 0


def _is_lm(wf):
    """True for a transformer-trainer workflow (served by serve_lm)."""
    return getattr(wf, "trainer", None) is not None and \
        hasattr(wf.trainer, "n_heads")


def serve(wf, port, batch=0, args=None):
    """Serve a trained workflow until interrupted (the ``--serve`` tail
    of a run): an LM workflow's token continuation through
    ``serve_lm`` with the ``--serve-*`` engine, fleet, trace, telemetry
    and SLO flags of ``args``, else its forward chain, with ``--fault-plan``'s
    plan armed.  In a
    distributed run only process 0 serves (one endpoint, as one process
    writes snapshots)."""
    import torch.distributed as dist
    from veles_tpu_torch import restful_api
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    plan = None
    if args is not None and args.fault_plan:
        from veles_tpu_torch.serving import FaultPlan
        plan = FaultPlan.from_file(args.fault_plan)
    if _is_lm(wf):
        kw = {"fault_plan": plan}
        if args is not None:
            kw.update(slots=args.serve_slots,
                      prefix_cache=args.serve_prefix_cache,
                      prefill_chunk=args.serve_prefill_chunk,
                      spec_k=args.serve_spec_k,
                      paged_kv=(True if args.serve_paged_kv <= 0
                                else args.serve_paged_kv),
                      megastep=args.serve_megastep,
                      replicas=args.serve_replicas,
                      router=args.serve_router,
                      health=args.serve_health,
                      hedge=args.serve_hedge,
                      retries=args.serve_retries,
                      trace=args.serve_trace,
                      trace_last=args.serve_trace_last,
                      telemetry=args.serve_telemetry,
                      slo=(True if args.serve_slo == "default"
                           else args.serve_slo))
        api = restful_api.serve_lm(wf, port=port, **kw)
    else:
        api = restful_api.RESTfulAPI(
            wf, normalizer=getattr(wf.loader, "normalizer", None),
            faults=plan)
        if batch > 0:
            # enable_batching forwards the plan: its batcher.* sites
            # arm beside http.request
            api.enable_batching(max_batch=batch)
        api.start(port=port)
    # parseable by wrappers and tests; flushed before blocking
    print("SERVING http://127.0.0.1:%d/predict" % api.port, flush=True)
    try:
        _wait_for_interrupt()
    except KeyboardInterrupt:
        pass
    finally:
        api.stop()


def _wait_for_interrupt():
    """Block until SIGINT (a KeyboardInterrupt)."""
    import threading
    threading.Event().wait()


def _run_process():
    """The process entry: ``main`` and, when it joined a distributed
    run, leaving it (an in-process caller of ``main`` stays joined, as
    the reference's ``jax.distributed`` does, and may call
    ``parallel.shutdown`` itself)."""
    try:
        return main()
    finally:
        from veles_tpu_torch import parallel
        parallel.shutdown()


if __name__ == "__main__":
    sys.exit(_run_process())
