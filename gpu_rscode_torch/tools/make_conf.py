"""Conf-file generator: the erasure-scenario tool (own copy of the JAX
package's ``tools/make_conf.py``).

Given n, k and a file name it writes ``conf-<n>-<k>-<file>`` listing the
LAST k chunk names: the first n-k chunks (natives included) are lost, which
forces a real matrix inversion on decode.  ``--pattern`` picks the
survivors instead.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..utils.fileformat import chunk_file_name, write_conf


def make_conf(n: int, k: int, file_name: str, survivors: list[int] | None = None, out: str | None = None) -> str:
    if survivors is None:
        survivors = list(range(n - k, n))
    if len(survivors) != k:
        raise ValueError(f"need exactly k={k} survivors, got {len(survivors)}")
    if any(s < 0 or s >= n for s in survivors):
        raise ValueError(f"survivor index out of range: {survivors}")
    base = os.path.basename(file_name)
    out = out or os.path.join(os.path.dirname(file_name) or ".", f"conf-{n}-{k}-{base}")
    write_conf(out, [os.path.basename(chunk_file_name(file_name, s)) for s in survivors])
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gpu_rscode_torch.tools.make_conf",
        description="generate a decode conf file (erasure scenario)",
    )
    ap.add_argument("n", type=int, help="total chunk count")
    ap.add_argument("k", type=int, help="native chunk count")
    ap.add_argument("file", help="original file name")
    ap.add_argument("--pattern", help="comma-separated surviving chunk indices (default: last k)")
    ap.add_argument("-o", "--out", help="output conf path")
    args = ap.parse_args(argv)
    survivors = [int(x) for x in args.pattern.split(",")] if args.pattern else None
    print(make_conf(args.n, args.k, args.file, survivors, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
