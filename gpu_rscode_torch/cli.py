"""Command line, flag-compatible with the reference ``RS`` tool.

Encode ``-k <k> -n <n> -e <file> [more files]``; decode ``-d -i <file> -c
<conf> [-o <out>]``; ``-h`` prints usage.  Upper- and lower-case flags are
both accepted, and ``-i/-c/-o`` are valid only after ``-d`` (``-i`` also
with ``--repair`` and ``--scrub``), as in the reference.  Performance flags as in the reference: ``-s`` (pipeline depth)
and ``-p`` (segment-size hint, p x 128 KiB).  Extensions: ``--width
8|16``, ``--checksum`` (encode: CRC32 lines in .METADATA; decode verifies
them), ``--no-verify``, ``--generator``, ``--segment-bytes``,
``--strategy`` (``xor``, ``ring`` and the native host codec ``cpu``
included; the ``update`` and ``append`` subcommands take it too),
``--quiet`` (no timing
report) and ``--device``.  Extra files after the flags of an encode go
through :func:`.api.encode_fleet`.  The resilience reads: ``-d -i <file>
--auto [more archives]`` (:func:`.api.auto_decode_file`, or
:func:`.api.decode_fleet` for several), ``-d -i <file> --locate``
(:func:`.api.locate_decode_file`), ``--repair -i <file> [more archives]``
(:func:`.api.repair_file` / :func:`.api.repair_fleet`) and ``--scrub -i
<file> [--syndrome]`` (:func:`.api.scan_file`: one JSON line, exit 1 when
the archive is not decodable).  ``--layout row|interleaved`` picks the
encode's chunk layout.  The subcommands ``update`` and ``append``
(:func:`.api.update_file`, :func:`.api.update_file_many` with ``--edits``,
:func:`.api.append_file`, :func:`.api.recover_archive` with ``--recover``)
patch an archive in place.  The subcommand ``object``
(:mod:`.store.cli`: ``put``, ``get``, ``rm``, ``ls``, ``stat``,
``compact``, ``openbench``) runs the object store.  The subcommands
``serve`` (:mod:`.serve.daemon`), ``loadgen`` (:mod:`.serve.loadgen`),
``slo`` (:mod:`.obs.slo`), ``health`` (:mod:`.obs.health`) and
``serve-metrics`` (:mod:`.obs.serve`) run the serving daemon and its
observability planes.  ``--faults SPEC`` activates the deterministic fault
plane (:mod:`.resilience.faults`) around the operation; the subcommands
``chaos`` (:mod:`.resilience.chaos`) and ``maint``
(:mod:`.maint.controller`) run the chaos harness and the
background-maintenance loop.

``--device`` defaults to CUDA; without a GPU the command fails unless
``--device cpu`` or ``--strategy cpu`` is given.
"""

from __future__ import annotations

import getopt
import json
import os
import sys
from contextlib import nullcontext

from .utils.timing import PhaseTimer

_USAGE = """Usage: python -m gpu_rscode_torch
[-h]: show usage information
Encode: [-k|-K nativeBlockNum] [-n|-N totalBlockNum] [-e|-E fileName]
        (extra positional files after the flags encode a whole batch
        through one shared write-behind lane: file j+1 reads/dispatches
        while file j's writes drain)
Decode: [-d|-D] [-i|-I originalFileName] [-c|-C config] [-o|-O output]
For encoding, the -k, -n, and -e options are all necessary.
For decoding, the -d, -i, and -c options are all necessary.
If -o is not set, the original file name is used as the output file name.
Performance-tuning options:
[-p|-P]: per-dispatch segment-size hint (p * 128 KiB per segment)
[-s|-S]: pipeline depth (segments in flight, default 2)
Extensions: [--generator vandermonde|cauchy]
            [--strategy auto|cuda|bitplane|table|xor|ring|cpu] (auto: the
            CUDA kernel on a GPU, bitplane on the CPU, unless a measured
            decision in the schedule store says otherwise; xor =
            bit-sliced XOR chains with Paar CSE, ring = polynomial-ring
            lowering, both w 8 and 16 only; cpu = the native host codec,
            w 8 only, needs no GPU)
            [--segment-bytes N] [--quiet] (no timing report)
            [--checksum]  (encode: record per-chunk CRC32 in .METADATA)
            [--no-verify] (decode: skip checksum verification)
            [--width 8|16] (encode: GF symbol width; 16 = wide-symbol
            extension recorded in .METADATA, decode auto-detects)
            [--layout row|interleaved] (encode: chunk layout; interleaved
            = append-mode extension — file symbol s lives in row s%k,
            so rs append only touches the tail column block; recorded
            in .METADATA, decode auto-detects)
            [--auto] (decode without -c: discover healthy chunks, skip
            corrupt ones via CRC32, pick a decodable subset.  Extra
            positional archives after the flags decode a whole batch
            through one shared write-behind lane)
            [--locate] (decode without -c OR CRCs: error-LOCATING decode
            — parity-check syndromes find silent bitrot in up to
            floor((p - missing)/2) chunks per symbol column, patch it,
            then reconstruct; damage past that bound fails loudly
            instead of fabricating bytes.  RS_LOCATE=auto|off|force
            tunes the --auto escalation ladder)
            [--repair] (with -i: rebuild every lost/corrupt chunk in place,
            parity included; refreshes CRC lines.  Extra positional files
            after the flags repair a whole fleet: all survivor-matrix
            inversions run in one batched device dispatch)
            [--scrub]  (with -i: read-only health report as one JSON line)
            [--syndrome] (with --scrub: add the error-locating pre-check
            — syndromes attribute silent bitrot to its chunk index with
            no CRCs, reported as state "silent_bitrot")
            [--device DEVICE] (default cuda; cpu runs the plain PyTorch
            path; with no GPU and no --device the command fails)
            [--faults SPEC] (deterministic fault injection at the IO
            boundaries, e.g. 'read:ioerror@p=0.02;write:torn@after=1MiB';
            seeded by RS_FAULTS_SEED.  RS_RETRY_* tune the retry policy)
Subcommands: update ARCHIVE --at OFF --in DELTA [--recover] [--json]
            (delta-parity partial-stripe update: overwrite a byte range
            of the archived file in place — parity' = parity XOR E*delta,
            only the touched segment columns move; crash-atomic via the
            undo journal + metadata generation; per-chunk CRCs fixed by
            seekable crc32-combine.  --recover resolves a torn op's
            journal and exits; --edits FILE coalesces a batch of
            OFFSET:PAYLOADFILE / append:PAYLOADFILE records into
            group-committed window groups of up to RS_UPDATE_GROUP_WINDOW
            edits — one journal fsync chain + one metadata commit per
            group, each group all-or-nothing)
            append ARCHIVE --in DATA [--json]
            (append-mode encoding: grow the archive without touching
            cold segments — unbounded on interleaved-layout archives,
            slack-bounded on row-layout ones; torn appends roll back at
            the next open)
            object put|get|rm|ls|stat|compact BUCKET [KEY] [--root D]
            [--device DEVICE] (object store: many small objects packed
            into shared erasure-coded stripe archives — a durable object
            index, windowed range reads with degraded decode, tombstone
            + zeroing deletes, all-or-nothing compaction)
            serve [--root D] [--port P] [--device DEVICE] ...
            (resident multi-tenant daemon: POST /encode /decode /scrub
            /update /append, PUT/GET/DELETE /o/<bucket>/<key>, admission
            control, cross-request batching, graceful drain on SIGTERM)
            loadgen --spawn|--url URL [--device DEVICE] ...
            (open-loop load generator for rs serve: per-tenant mixes,
            offered/achieved rates, latency percentiles, a capture file)
            slo --url URL | --runlog LEDGER [--check] [--json]
            (per-tenant SLO attainment and burn rates)
            health [--ledger LEDGER] [--json] [--watch [SECS]]
            (risk-ranked fleet durability report from the damage ledger)
            serve-metrics [--port P] [--addr A] [--runlog LEDGER]
            (foreground /metrics, /healthz and /runs endpoint)
            chaos [--seed S] [--iters N] [--silent|--update [--group]|
            --object|--health|--maint] [--device DEVICE] ...
            (seeded chaos harness: encode -> corrupt -> scrub/auto-decode/
            repair, differential-checked; bit-reproducible per seed)
            maint [--root D] [--ledger L] [--drain|--watch [SECS]]
            [--device DEVICE] ... (background maintenance: repair/scrub
            from the damage ledger, compaction of dead-heavy buckets)"""


def _fail(msg: str) -> int:
    print(msg, file=sys.stderr)
    print(_USAGE, file=sys.stderr)
    return 2


def _serve_metrics_main(argv: list[str]) -> int:
    """The ``serve-metrics`` subcommand: a foreground telemetry endpoint
    (/metrics, /healthz, /runs) for this process (:mod:`.obs.serve`)."""
    import argparse

    from .obs import metrics as obs_metrics, serve as obs_serve

    ap = argparse.ArgumentParser(
        prog="rs serve-metrics",
        description="Serve /metrics (Prometheus text), /healthz and /runs (run-ledger tail) over HTTP.",
    )
    ap.add_argument("--port", type=int, default=None, help="bind port (default $RS_METRICS_PORT or 9464)")
    ap.add_argument("--addr", default=None, help="bind address (default $RS_METRICS_ADDR or 0.0.0.0)")
    ap.add_argument("--runlog", default=None, help="ledger served at /runs (default: $RS_RUNLOG)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if args.port is None:
        try:
            args.port = int(os.environ.get("RS_METRICS_PORT", "9464"))
        except ValueError:
            print(f"rs serve-metrics: RS_METRICS_PORT={os.environ['RS_METRICS_PORT']!r} is not a port",
                  file=sys.stderr)
            return 2
    obs_metrics.force_enable()
    try:
        server = obs_serve.make_server(args.port, args.runlog, args.addr)
    except OSError as e:
        print(f"rs serve-metrics: cannot bind: {e}", file=sys.stderr)
        return 1
    host, port = server.server_address[:2]
    print(f"serving /metrics /healthz /runs on http://{host}:{port}", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def _update_main(argv: list[str], op: str) -> int:
    """The ``update`` / ``append`` subcommands: delta-parity partial-stripe
    updates and append-mode encoding, parity' = parity ^ E.delta over the
    touched columns only."""
    import argparse

    from .codec import VALID_STRATEGIES

    ap = argparse.ArgumentParser(
        prog=f"rs {op}",
        description=(
            "Patch a byte range of an encoded archive in place: only the touched segment columns are read, the "
            "parity delta E*delta is XOR-patched, and per-chunk CRCs are fixed incrementally (crash-atomic via the "
            "undo journal)."
            if op == "update" else
            "Grow an encoded archive: interleaved-layout archives extend every chunk by just the tail column block "
            "(cold columns untouched); row-layout archives accept appends bounded by their tail-padding slack.  "
            "Torn appends roll back at the next open."
        ),
    )
    ap.add_argument("archive", help="the encoded file (chunk files and .METADATA live next to it)")
    if op == "update":
        ap.add_argument("--at", type=int, default=None, help="byte offset of the edit in the original file")
        ap.add_argument("--recover", action="store_true",
                        help="only resolve a pending torn update/append journal (rollback), then exit")
        ap.add_argument("--edits", metavar="FILE", default=None,
                        help="group-commit batch mode: coalesce the edits listed in FILE into window groups of up to "
                        "RS_UPDATE_GROUP_WINDOW edits, each group independently all-or-nothing (one journal fsync "
                        "chain + one metadata commit per group).  One edit per line, OFFSET:PAYLOADFILE for an update "
                        "or append:PAYLOADFILE for an append; '#' comments and blank lines are skipped; payload paths "
                        "resolve relative to FILE's directory")
    ap.add_argument("--in", dest="in_path", metavar="FILE", default=None,
                    help=("the replacement bytes" if op == "update" else "the bytes to append"))
    ap.add_argument("--strategy", default="auto", choices=VALID_STRATEGIES)
    ap.add_argument("--segment-bytes", type=int, default=None, help="column block sizing (default 64 MiB of natives)")
    ap.add_argument("--json", action="store_true", help="emit the op summary as one JSON line")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where E*delta runs (default cuda; cpu runs the plain PyTorch path)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)

    from . import api
    from .update import SimulatedCrash

    try:
        if op == "update" and args.recover:
            verdict = api.recover_archive(args.archive)
            print(json.dumps({"archive": args.archive, "recovered": verdict}))
            return 0
        timer = PhaseTimer(enabled=not args.quiet)
        kwargs = dict(strategy=args.strategy, device=args.device, timer=timer)
        if args.segment_bytes:
            kwargs["segment_bytes"] = args.segment_bytes
        if op == "update" and args.edits is not None:
            if args.in_path is not None or args.at is not None:
                print("rs update: --edits replaces --at/--in (the batch file lists every edit)", file=sys.stderr)
                return 2
            try:
                edits = _parse_edit_lines(args.edits)
            except (OSError, ValueError) as e:
                print(f"rs update: bad --edits file: {e}", file=sys.stderr)
                return 2
            summary = api.update_file_many(args.archive, edits, **kwargs)
        else:
            if args.in_path is None:
                print(f"rs {op}: --in FILE is required", file=sys.stderr)
                return 2
            if op == "update" and args.at is None:
                print("rs update: --at OFFSET is required", file=sys.stderr)
                return 2
            if op == "update":
                summary = api.update_file(args.archive, args.at, src=args.in_path, **kwargs)
            else:
                summary = api.append_file(args.archive, src=args.in_path, **kwargs)
    except SimulatedCrash:
        raise  # RS_UPDATE_CRASH stops the process dead, as a power cut would
    except (ValueError, RuntimeError, OSError) as e:
        print(f"rs {op}: error: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summary))
    elif not args.quiet:
        print(f"== {op} {args.archive} ==")
        if summary.get("op") == "group":
            print(f"{summary['edits']} edit(s) in {summary['groups']} group(s) -> {summary['bytes']} payload bytes, "
                  f"{summary['windows']} window(s), {summary['segments']} segment block(s), chunks "
                  f"{summary['chunks_touched']}, generation {summary['generation']}, total {summary['total_size']}")
        else:
            print(f"{summary['bytes']} payload bytes -> {summary['segments']} segment block(s), chunks "
                  f"{summary['chunks_touched']}, generation {summary['generation']}, total {summary['total_size']}")
        print(timer.summary(data_bytes=summary["bytes"]))
    return 0


def _parse_edit_lines(path: str) -> list[dict]:
    """The ``--edits`` batch file: one ``OFFSET:PAYLOADFILE`` or
    ``append:PAYLOADFILE`` record per line; payload paths resolve relative
    to the batch file."""
    base = os.path.dirname(os.path.abspath(path))
    edits: list[dict] = []
    with open(path) as fp:
        for ln, line in enumerate(fp, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            head, sep, payload = line.partition(":")
            if not sep or not payload:
                raise ValueError(f"line {ln}: want OFFSET:PAYLOADFILE or append:PAYLOADFILE, got {line!r}")
            src = os.path.join(base, payload.strip())
            if head.strip() == "append":
                edits.append({"op": "append", "src": src})
            else:
                try:
                    at = int(head)
                except ValueError:
                    raise ValueError(f"line {ln}: offset {head!r} is not an integer (or the keyword 'append')") from None
                edits.append({"op": "update", "at": at, "src": src})
    if not edits:
        raise ValueError("no edit records (every line blank or comment)")
    return edits


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve-metrics":
        return _serve_metrics_main(argv[1:])
    if argv and argv[0] == "health":
        from .obs.health import main as _health_main

        return _health_main(argv[1:])
    if argv and argv[0] == "serve":
        from .serve.daemon import main as _serve_daemon_main

        return _serve_daemon_main(argv[1:])
    if argv and argv[0] == "loadgen":
        from .serve.loadgen import main as _loadgen_main

        return _loadgen_main(argv[1:])
    if argv and argv[0] == "slo":
        from .obs.slo import main as _slo_main

        return _slo_main(argv[1:])
    if argv and argv[0] == "object":
        from .store.cli import main as _object_main

        return _object_main(argv[1:])
    if argv and argv[0] in ("update", "append"):
        return _update_main(argv[1:], argv[0])
    if argv and argv[0] == "chaos":
        from .resilience.chaos import main as _chaos_main

        return _chaos_main(argv[1:])
    if argv and argv[0] == "maint":
        from .maint.controller import main as _maint_main

        return _maint_main(argv[1:])
    try:
        opts, extra = getopt.gnu_getopt(
            argv,
            "S:s:P:p:K:k:N:n:E:e:I:i:C:c:O:o:DdHh",
            ["width=", "layout=", "checksum", "no-verify", "generator=", "segment-bytes=", "strategy=", "device=", "auto", "locate",
             "repair", "scrub", "syndrome", "quiet", "faults="],
        )
    except getopt.GetoptError as e:
        return _fail(f"rs: {e}")
    flags_seen = {flag.lower() for flag, _ in opts}
    # Positional files after the flags: batch encode (-e), fleet repair
    # (--repair) and batch decode (-d --auto).
    if extra and not ("--repair" in flags_seen or "-e" in flags_seen or {"-d", "--auto"} <= flags_seen):
        return _fail(f"rs: unexpected arguments {extra}")
    native_num = total_num = 0
    pipeline_depth, tile_hint, segment_bytes = 2, 0, None
    in_file = conf_file = out_file = None
    op = None
    width, checksum, no_verify = 8, False, False
    layout = "row"
    generator, strategy, device = "vandermonde", "auto", None
    auto = locate = repair = scrub = syndrome = quiet = False
    faults_spec = None
    repair_requested = bool(flags_seen & {"--repair", "--scrub"})
    for flag, val in opts:
        f = flag.lower()
        if f == "-s":
            pipeline_depth = int(val)
        elif f == "-p":
            tile_hint = int(val)
        elif f == "-k":
            native_num = int(val)
        elif f == "-n":
            total_num = int(val)
        elif f == "-e":
            in_file, op = val, "encode"
        elif f == "-d":
            op = "decode"
        elif f in ("-i", "-c", "-o"):
            if op != "decode" and not (f == "-i" and repair_requested):
                return _fail(f"rs: {flag} is only valid after -d (decode)")
            if f == "-i":
                in_file = val
            elif f == "-c":
                conf_file = val
            else:
                out_file = val
        elif f == "-h":
            print(_USAGE)
            return 0
        elif f == "--width":
            width = int(val)
        elif f == "--layout":
            layout = val
        elif f == "--checksum":
            checksum = True
        elif f == "--no-verify":
            no_verify = True
        elif f == "--generator":
            generator = val
        elif f == "--segment-bytes":
            segment_bytes = int(val)
        elif f == "--strategy":
            strategy = val
        elif f == "--device":
            device = val
        elif f == "--auto":
            auto = True
        elif f == "--locate":
            locate = True
        elif f == "--repair":
            repair = True
        elif f == "--scrub":
            scrub = True
        elif f == "--syndrome":
            syndrome = True
        elif f == "--quiet":
            quiet = True
        elif f == "--faults":
            faults_spec = val

    from .codec import VALID_STRATEGIES

    if strategy not in VALID_STRATEGIES:
        return _fail(f"rs: unknown --strategy {strategy!r}; valid strategies are " + "|".join(VALID_STRATEGIES))
    fault_plan = None
    if faults_spec is not None:
        # Validated here, a usage error; activated around the operation
        # below, as RS_FAULTS=SPEC would be, without touching the env.
        from .resilience import faults as _faults

        try:
            fault_plan = _faults.parse_plan(faults_spec, seed=_faults.env_seed())
        except ValueError as e:
            return _fail(f"rs: bad --faults spec: {e}")
    if repair and scrub:
        return _fail("rs: --repair and --scrub conflict")
    if repair:
        if op == "encode" or auto or conf_file or out_file:
            return _fail("rs: --repair takes only -i (plus tuning flags)")
        op = "repair"
    if scrub:
        if op == "encode" or auto or conf_file or out_file:
            return _fail("rs: --scrub takes only -i")
        op = "scrub"
    if op is None:
        return _fail("rs: choose encode (-e), decode (-d), or --repair -i <file>")
    if op in ("repair", "scrub") and not in_file:
        return _fail(f"rs: --{op} requires -i")
    if checksum and op != "encode":
        return _fail("rs: --checksum is encode-only (decode verifies automatically)")
    if no_verify and op != "decode":
        return _fail("rs: --no-verify is decode-only")
    if width != 8 and op != "encode":
        return _fail("rs: --width is encode-only (decode reads it from .METADATA)")
    if width not in (8, 16):
        return _fail(f"rs: --width must be 8 or 16, got {width}")
    if layout != "row":
        if op != "encode":
            return _fail("rs: --layout is encode-only (decode reads it from .METADATA)")
        if layout != "interleaved":
            return _fail(f"rs: --layout must be row or interleaved, got {layout}")
    if auto and op != "decode":
        return _fail("rs: --auto is decode-only")
    if auto and conf_file:
        return _fail("rs: -c and --auto conflict; pick one survivor source")
    if locate:
        if op != "decode":
            return _fail("rs: --locate is decode-only")
        if conf_file:
            return _fail("rs: -c and --locate conflict (locate reads every present chunk, no conf needed)")
        if auto:
            return _fail("rs: --auto and --locate conflict; --auto already escalates to locate (RS_LOCATE tunes it)")
        if extra:
            return _fail("rs: --locate decodes one archive at a time")
    if syndrome and not scrub:
        return _fail("rs: --syndrome only applies to --scrub")
    if extra and op == "decode" and out_file:
        return _fail("rs: batch --auto decode does not take -o (outputs are written in place, one per archive)")

    from . import api

    kwargs = dict(strategy=strategy, device=device, pipeline_depth=max(1, pipeline_depth))
    if segment_bytes:
        kwargs["segment_bytes"] = segment_bytes
    elif tile_hint:
        # -p caps the per-dispatch column extent, the closest analog of the
        # reference's gridDim.x cap (encode.cu:348-355).
        kwargs["segment_bytes"] = max(1, tile_hint) * 128 * 1024
    timer = PhaseTimer(enabled=True)
    fault_ctx = nullcontext() if fault_plan is None else _faults.activate(fault_plan)
    try:
        with fault_ctx:
            if op == "encode":
                if native_num <= 0 or total_num <= 0 or not in_file:
                    return _fail("rs: encoding requires -k, -n and -e")
                if total_num <= native_num:
                    return _fail(f"rs: need n > k (got n={total_num}, k={native_num})")
                files = [in_file, *extra]
                encode_kwargs = dict(generator=generator, checksums=checksum, w=width, layout=layout, timer=timer,
                                     **kwargs)
                if extra:
                    api.encode_fleet(files, native_num, total_num - native_num, **encode_kwargs)
                else:
                    api.encode_file(in_file, native_num, total_num - native_num, **encode_kwargs)
                nbytes = sum(os.path.getsize(f) for f in files)
            elif op == "scrub":
                report = api.scan_file(in_file, syndrome=syndrome, device=device,
                                       **({"segment_bytes": kwargs["segment_bytes"]}
                                          if "segment_bytes" in kwargs else {}))
                print(json.dumps(report))
                # "unknown" (the subset search capped) is not proven healthy.
                return 0 if report["decodable"] is True else 1
            elif op == "repair":
                if extra:
                    fleet = [in_file, *extra]
                    results = api.repair_fleet(fleet, timer=timer, **kwargs)
                    for f in fleet:
                        print(f"{f}: rebuilt {results[f]}" if results[f] else f"{f}: healthy")
                    nbytes = sum(os.path.getsize(f) for f in fleet if os.path.exists(f))
                else:
                    rebuilt = api.repair_file(in_file, timer=timer, **kwargs)
                    print(f"rebuilt chunks: {rebuilt}" if rebuilt else "archive healthy")
                    nbytes = os.path.getsize(in_file) if os.path.exists(in_file) else 0
            else:
                if not in_file or (not conf_file and not auto and not locate):
                    return _fail("rs: decoding requires -i and -c (or --auto/--locate)")
                verify = False if no_verify else None
                if locate:
                    out = api.locate_decode_file(in_file, out_file, timer=timer, **kwargs)
                    nbytes = os.path.getsize(out)
                elif auto and extra:
                    fleet = [in_file, *extra]
                    results = api.decode_fleet(fleet, verify_checksums=verify, timer=timer, **kwargs)
                    for f in fleet:
                        print(f"{f}: decoded -> {results[f]}")
                    nbytes = sum(os.path.getsize(results[f]) for f in fleet)
                elif auto:
                    out = api.auto_decode_file(in_file, out_file, verify_checksums=verify, timer=timer, **kwargs)
                    nbytes = os.path.getsize(out)
                else:
                    out = api.decode_file(in_file, conf_file, out_file, verify_checksums=verify, timer=timer, **kwargs)
                    nbytes = os.path.getsize(out)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"rs: error: {e}", file=sys.stderr)
        return 1

    if not quiet:
        print(f"== {op} {in_file} ==")
        print(timer.summary(data_bytes=nbytes))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
