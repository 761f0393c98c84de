"""``rs object`` — the object-store façade's CLI (docs/STORE.md).

    rs object put BUCKET KEY --in FILE [--root DIR] [--k K --p P]
                  [--w 8|16] [--stripe-kb N]
    rs object get BUCKET KEY [--out FILE]
    rs object rm BUCKET KEY
    rs object ls BUCKET [--prefix P] [--limit N] [--cursor TOK] [--json]
    rs object stat BUCKET [KEY] [--json]
    rs object compact BUCKET [--force] [--json]
    rs object openbench [--puts N --keys N ...]   (open-cost A/B)

Every subcommand takes ``--device`` (default cuda; ``cpu`` runs the plain
PyTorch path; with no GPU and no ``--device`` the command fails).
``--root`` defaults to ``$RS_STORE_ROOT`` or ``./rs_store_root``.  The
shape flags apply only when the bucket is created (first put); an
existing bucket's manifest wins.  ``stat`` without a KEY prints the
bucket-level report (objects, live/dead bytes, per-archive accounting,
pending compactions).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _root(args) -> str:
    return (args.root or os.environ.get("RS_STORE_ROOT")
            or "rs_store_root")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rs object",
        description="Object-store façade: millions of small objects "
        "packed into shared erasure-coded stripe archives "
        "(docs/STORE.md).",
    )
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "openbench":
        # Its own argparse surface (bench flags, capture path) — the
        # open-cost A/B harness, docs/STORE.md "Index snapshots".
        from .openbench import main as _openbench_main

        return _openbench_main(argv[1:])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(sp, key=True):
        sp.add_argument("bucket", help="bucket name")
        if key:
            sp.add_argument("key", help="object key")
        sp.add_argument("--root", default=None,
                        help="store root (default $RS_STORE_ROOT or "
                        "./rs_store_root)")
        sp.add_argument("--device", default=None,
                        help="where the bucket's GEMMs run (default cuda; "
                        "cpu runs the plain PyTorch path)")

    sp = sub.add_parser("put", help="store one object from a file")
    common(sp)
    sp.add_argument("--in", dest="infile", required=True, metavar="FILE",
                    help="payload file ('-' reads stdin)")
    sp.add_argument("--k", type=int, default=None,
                    help="stripe natives at bucket creation "
                    "(default $RS_STORE_K or 4)")
    sp.add_argument("--p", type=int, default=None,
                    help="stripe parities at bucket creation "
                    "(default $RS_STORE_P or 2)")
    sp.add_argument("--w", type=int, default=None, choices=(8, 16),
                    help="symbol width at bucket creation (default 8)")
    sp.add_argument("--stripe-kb", type=int, default=None,
                    help="stripe seal threshold in KiB at bucket "
                    "creation (default RS_STORE_STRIPE_BYTES)")
    sp.add_argument("--json", action="store_true")

    sp = sub.add_parser("get", help="read one object")
    common(sp)
    sp.add_argument("--out", default="-", metavar="FILE",
                    help="output file (default '-' = stdout)")

    sp = sub.add_parser("rm", help="delete one object (tombstone + "
                        "delete-as-update zeroing)")
    common(sp)
    sp.add_argument("--json", action="store_true")

    sp = sub.add_parser("ls", help="list live objects")
    common(sp, key=False)
    sp.add_argument("--prefix", default="",
                    help="only keys starting with this prefix")
    sp.add_argument("--limit", type=int, default=0,
                    help="page size (0 = everything in one listing); "
                    "a truncated page prints its resume cursor")
    sp.add_argument("--cursor", default=None,
                    help="resume token from a previous page's 'next'")
    sp.add_argument("--json", action="store_true")

    sp = sub.add_parser("stat", help="object index entry, or the "
                        "bucket report without KEY")
    common(sp, key=False)
    sp.add_argument("key", nargs="?", default=None, help="object key")
    sp.add_argument("--json", action="store_true")

    sp = sub.add_parser("compact", help="rewrite live objects out of "
                        "dead-heavy archives, retire them")
    common(sp, key=False)
    sp.add_argument("--force", action="store_true",
                    help="compact any sealed archive with dead bytes, "
                    "RS_STORE_COMPACT_DEAD_FRAC regardless")
    sp.add_argument("--json", action="store_true")

    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)

    from .. import api
    from ..update import SimulatedCrash
    from . import ObjectNotFound, ObjectStoreError, RangeReadError

    root = _root(args)
    try:
        if args.cmd == "put":
            if args.infile == "-":
                data = sys.stdin.buffer.read()
            else:
                with open(args.infile, "rb") as fp:
                    data = fp.read()
            loc = api.put_object(
                root, args.bucket, args.key, data,
                k=args.k, p=args.p, w=args.w,
                stripe_bytes=(args.stripe_kb * 1024
                              if args.stripe_kb else None), device=args.device,
            )
            if args.json:
                print(json.dumps({"key": args.key, **loc}))
            else:
                print(f"rs object: put {args.key!r} -> {loc['arc']} "
                      f"[{loc['at']}, {loc['at'] + loc['len']}) "
                      f"({loc['len']} bytes)", file=sys.stderr)
        elif args.cmd == "get":
            data = api.get_object(root, args.bucket, args.key, device=args.device)
            if args.out == "-":
                sys.stdout.buffer.write(data)
                sys.stdout.buffer.flush()
            else:
                with open(args.out, "wb") as fp:
                    fp.write(data)
        elif args.cmd == "rm":
            out = api.delete_object(root, args.bucket, args.key, device=args.device)
            if args.json:
                print(json.dumps(out))
            else:
                print(f"rs object: deleted {args.key!r} "
                      f"({out['bytes']} bytes tombstoned)",
                      file=sys.stderr)
        elif args.cmd == "ls":
            if args.limit or args.cursor:
                page = api.list_objects_page(
                    root, args.bucket, prefix=args.prefix,
                    limit=max(0, args.limit), cursor=args.cursor, device=args.device)
                if args.json:
                    print(json.dumps(page))
                else:
                    for o in page["objects"]:
                        print(f"{o['bytes']:>12}  {o['arc']}  "
                              f"{o['key']}")
                    if page["truncated"]:
                        print(f"rs object: more keys follow — resume "
                              f"with --cursor {page['next']}",
                              file=sys.stderr)
            else:
                objs = api.list_objects(root, args.bucket,
                                        prefix=args.prefix, device=args.device)
                if args.json:
                    print(json.dumps(objs))
                else:
                    for o in objs:
                        print(f"{o['bytes']:>12}  {o['arc']}  "
                              f"{o['key']}")
        elif args.cmd == "stat":
            if args.key is None:
                from . import open_bucket

                doc = open_bucket(root, args.bucket, device=args.device).stats()
            else:
                doc = api.stat_object(root, args.bucket, args.key, device=args.device)
            print(json.dumps(doc, indent=None if args.json else 2,
                             sort_keys=True))
        elif args.cmd == "compact":
            out = api.compact_bucket(root, args.bucket,
                                     force=args.force, device=args.device)
            if args.json:
                print(json.dumps(out))
            else:
                print(f"rs object: compacted {args.bucket!r}: retired "
                      f"{out['archives_retired'] or 'nothing'}, moved "
                      f"{out['objects_moved']} objects "
                      f"({out['bytes_moved']} bytes)", file=sys.stderr)
    except SimulatedCrash:
        raise  # RS_UPDATE_CRASH stops the process dead, as a power cut would
    except ObjectNotFound as e:
        print(f"rs object: {e}", file=sys.stderr)
        return 3
    except (ObjectStoreError, RangeReadError, OSError, ValueError,
            RuntimeError) as e:
        print(f"rs object: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
