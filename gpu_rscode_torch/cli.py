"""Command line, flag-compatible with the reference ``RS`` tool.

Encode ``-k <k> -n <n> -e <file>``; decode ``-d -i <file> -c <conf>
[-o <out>]``; ``-h`` prints usage.  Upper- and lower-case flags are both
accepted, and ``-i/-c/-o`` are valid only after ``-d``, as in the
reference.  Extensions: ``--width 8|16``, ``--checksum`` (encode: CRC32
lines in .METADATA; decode verifies them), ``--strategy`` and
``--device``.

``--device`` defaults to CUDA; without a GPU the command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import getopt
import os
import sys

from .utils.timing import PhaseTimer

_USAGE = """Usage: python -m gpu_rscode_torch
[-h]: show usage information
Encode: [-k|-K nativeBlockNum] [-n|-N totalBlockNum] [-e|-E fileName]
Decode: [-d|-D] [-i|-I originalFileName] [-c|-C config] [-o|-O output]
For encoding, the -k, -n, and -e options are all necessary.
For decoding, the -d, -i, and -c options are all necessary.
If -o is not set, the original file name is used as the output file name.
Extensions: [--width 8|16] [--checksum]
            [--strategy auto|cuda|bitplane|table] (auto: the CUDA kernel
            on a GPU, bitplane on the CPU)
            [--device DEVICE] (default cuda; cpu runs the plain PyTorch
            path; with no GPU and no --device the command fails)"""


def _fail(msg: str) -> int:
    print(msg, file=sys.stderr)
    print(_USAGE, file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        opts, extra = getopt.gnu_getopt(
            argv,
            "K:k:N:n:E:e:I:i:C:c:O:o:DdHh",
            ["width=", "checksum", "strategy=", "device="],
        )
    except getopt.GetoptError as e:
        return _fail(f"rs: {e}")
    if extra:
        return _fail(f"rs: unexpected arguments {extra}")

    native_num = total_num = 0
    in_file = conf_file = out_file = None
    op = None
    width, checksum, strategy, device = 8, False, "auto", None
    for flag, val in opts:
        f = flag.lower()
        if f == "-k":
            native_num = int(val)
        elif f == "-n":
            total_num = int(val)
        elif f == "-e":
            in_file, op = val, "encode"
        elif f == "-d":
            op = "decode"
        elif f in ("-i", "-c", "-o"):
            if op != "decode":
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
        elif f == "--checksum":
            checksum = True
        elif f == "--strategy":
            strategy = val
        elif f == "--device":
            device = val

    from .codec import VALID_STRATEGIES

    if strategy not in VALID_STRATEGIES:
        return _fail(f"rs: unknown --strategy {strategy!r}; valid strategies are " + "|".join(VALID_STRATEGIES))
    if op is None:
        return _fail("rs: choose encode (-e) or decode (-d)")
    if checksum and op != "encode":
        return _fail("rs: --checksum is encode-only (decode verifies automatically)")
    if width != 8 and op != "encode":
        return _fail("rs: --width is encode-only (decode reads it from .METADATA)")
    if width not in (8, 16):
        return _fail(f"rs: --width must be 8 or 16, got {width}")

    from . import api

    timer = PhaseTimer(enabled=True)
    try:
        if op == "encode":
            if native_num <= 0 or total_num <= 0 or not in_file:
                return _fail("rs: encoding requires -k, -n and -e")
            if total_num <= native_num:
                return _fail(f"rs: need n > k (got n={total_num}, k={native_num})")
            api.encode_file(
                in_file, native_num, total_num - native_num,
                checksums=checksum, w=width, strategy=strategy, device=device, timer=timer,
            )
            nbytes = os.path.getsize(in_file)
        else:
            if not in_file or not conf_file:
                return _fail("rs: decoding requires -i and -c")
            out = api.decode_file(in_file, conf_file, out_file, strategy=strategy, device=device, timer=timer)
            nbytes = os.path.getsize(out)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"rs: error: {e}", file=sys.stderr)
        return 1

    print(f"== {op} {in_file} ==")
    print(timer.summary(data_bytes=nbytes))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
