"""``python -m veles_tpu_torch.forge_cli`` — the forge command line.

Port of ``veles_tpu/forge_cli.py``.  Subcommands wrap the library
functions one-to-one:

    pack      SNAPSHOT OUT.tar.gz [--name N] [--artifact FILE.veles] ...
    publish   PACKAGE STORE_DIR
    list      STORE_DIR_OR_URL
    fetch     STORE_DIR_OR_URL NAME OUT_DIR
    upload    PACKAGE URL
    serve     STORE_DIR [--port P]

STORE arguments accept a local directory or an ``http(s)://`` URL of a
running :class:`veles_tpu_torch.forge_server.ForgeServer`.
"""

from __future__ import annotations

import argparse
import json
import sys


def _is_url(store):
    return store.startswith("http://") or store.startswith("https://")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.forge_cli",
        description="model-package store (pack / publish / fetch / serve)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pack", help="package a snapshot (+ artifact)")
    p.add_argument("snapshot")
    p.add_argument("out")
    p.add_argument("--name", default=None)
    p.add_argument("--author", default=None)
    p.add_argument("--description", default="")
    p.add_argument("--artifact", default=None,
                   help="export artifact to bundle")
    p.add_argument("--metric", action="append", default=[],
                   metavar="KEY=VALUE")

    p = sub.add_parser("publish", help="copy a package into a local store")
    p.add_argument("package")
    p.add_argument("store")

    p = sub.add_parser("list", help="list packages in a store")
    p.add_argument("store")

    p = sub.add_parser("fetch", help="download + unpack one package")
    p.add_argument("store")
    p.add_argument("name")
    p.add_argument("out_dir")

    p = sub.add_parser("upload", help="upload a package to a forge server")
    p.add_argument("package")
    p.add_argument("url")

    p = sub.add_parser("serve", help="run the HTTP store server")
    p.add_argument("store")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8190)
    return parser


def main(argv=None):
    from veles_tpu_torch import forge, forge_server
    args = build_parser().parse_args(argv)

    if args.cmd == "pack":
        metrics = {}
        for kv in args.metric:
            key, eq, value = kv.partition("=")
            if not eq or not key:
                build_parser().error("--metric needs KEY=VALUE, got %r"
                                     % kv)
            try:
                metrics[key] = float(value)
            except ValueError:
                metrics[key] = value
        path = forge.pack(args.snapshot, args.out, name=args.name,
                          author=args.author, description=args.description,
                          artifact_path=args.artifact, metrics=metrics)
        print(path)
    elif args.cmd == "publish":
        if _is_url(args.store):
            # URL store: publish IS upload (a literal local directory
            # named "http:/..." would silently swallow the package)
            print(json.dumps(forge_server.upload(args.package,
                                                 args.store),
                             default=str))
        else:
            print(forge.publish(args.package, args.store))
    elif args.cmd == "list":
        import os
        if _is_url(args.store):
            entries = forge_server.list_remote(args.store)
        else:
            # same shape as the remote listing: (basename, manifest)
            entries = [(os.path.basename(p), m)
                       for p, m in forge.list_store(args.store)]
        print(json.dumps(entries, indent=2, default=str))
    elif args.cmd == "fetch":
        if _is_url(args.store):
            manifest, snap = forge_server.fetch_remote(
                args.store, args.name, args.out_dir)
        else:
            manifest, snap = forge.fetch(args.store, args.name,
                                         args.out_dir)
        print(json.dumps({"manifest": manifest, "snapshot": snap},
                         indent=2, default=str))
    elif args.cmd == "upload":
        print(json.dumps(forge_server.upload(args.package, args.url),
                         default=str))
    elif args.cmd == "serve":
        if _is_url(args.store):
            build_parser().error("serve needs a local store directory, "
                                 "not a URL")
        server = forge_server.ForgeServer(args.store, host=args.host,
                                          port=args.port).start()
        print("FORGE http://%s:%d" % (args.host, server.port), flush=True)
        import threading
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
