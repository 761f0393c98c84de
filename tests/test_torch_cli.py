"""The port's command line against the JAX package's on the flags that go
with the pipeline: ``-s``, ``-p``, ``--segment-bytes``, ``--generator``,
``--no-verify`` and the batch encode of extra positional files; and on the
resilience reads: ``--scrub`` (``--syndrome``), ``-d --auto`` (one archive
or a batch), ``--repair`` (one archive or a fleet) and ``-d --locate``; on
``--quiet`` and on ``--strategy xor|ring`` (the main command and the
``update`` subcommand).
Both CLIs run on copies of the same files; chunk files, .METADATA, decoded
bytes, the printed reports and the exit codes must be identical."""

import json
import os

import numpy as np
import pytest

from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu.tools.make_conf import make_conf as j_make_conf

SIZE = 300_007


def _write(path, size, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    return data


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _archive(path, n):
    names = [t_ff.chunk_file_name(path, i) for i in range(n)] + [t_ff.metadata_file_name(path)]
    return {os.path.basename(f): _read(f) for f in names}


def _both(tmp_path, argv_of, sizes=(SIZE,), n=6):
    """Run ``argv_of(paths)`` through each CLI on its own copy of the
    files; returns {cli: (rc, [archive per file], [data per file], paths)}."""
    out = {}
    for name, cli in (("torch", t_cli), ("jax", j_cli)):
        d = tmp_path / name
        d.mkdir()
        paths = [str(d / f"f{i}.bin") for i in range(len(sizes))]
        datas = [_write(p, size, 5 + i) for i, (p, size) in enumerate(zip(paths, sizes))]
        argv = argv_of(paths) + (["--device", "cpu"] if cli is t_cli else [])
        rc = cli.main(argv)
        out[name] = (rc, [_archive(p, n) if rc == 0 else None for p in paths], datas, paths)
    return out


@pytest.mark.parametrize("flags", [
    ["-s", "3", "-p", "1"],                        # 128 KiB segments at depth 3
    ["-S", "1", "-P", "2"],
    ["--segment-bytes", "40000", "-s", "2"],        # --segment-bytes wins over -p
    ["--segment-bytes", "40000", "-p", "64"],
    ["--generator", "cauchy", "-p", "1"],
    ["--generator", "cauchy", "--checksum", "-s", "1", "--width", "16", "-p", "1"],
])
def test_encode_flags_byte_identical_to_jax(tmp_path, capsys, flags):
    runs = _both(tmp_path, lambda paths: ["-k", "4", "-n", "6", "-e", paths[0], *flags])
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert runs["torch"][1] == runs["jax"][1]


def test_batch_encode_byte_identical_to_jax(tmp_path, capsys):
    sizes = (SIZE, 17, 140_000)
    runs = _both(tmp_path, lambda paths: ["-k", "4", "-n", "6", "-s", "3", "-p", "1", "-e", *paths], sizes=sizes)
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert runs["torch"][1] == runs["jax"][1]
    assert "== encode" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["-s", "3", "-p", "1"], ["--segment-bytes", "8192", "-s", "1"]])
def test_decode_flags_round_trip_like_jax(tmp_path, capsys, flags):
    """Encode through the JAX CLI, lose two natives, decode through both
    CLIs with the same flags: both rebuild the file."""
    path = str(tmp_path / "f.bin")
    data = _write(path, SIZE, 11)
    assert j_cli.main(["-k", "4", "-n", "6", "-e", path, "--checksum"]) == 0
    for i in (0, 1):
        os.unlink(t_ff.chunk_file_name(path, i))
    conf = j_make_conf(6, 4, path, out=str(tmp_path / "conf"))
    for name, cli, extra in (("torch", t_cli, ["--device", "cpu"]), ("jax", j_cli, [])):
        out = str(tmp_path / f"out_{name}")
        assert cli.main(["-d", "-i", path, "-c", conf, "-o", out, *flags, *extra]) == 0
        assert _read(out) == data


def test_no_verify_decodes_a_corrupt_survivor_like_jax(tmp_path, capsys):
    """With CRC lines, a corrupt survivor fails the decode in both CLIs;
    --no-verify skips the check, and both write the same bytes."""
    path = str(tmp_path / "f.bin")
    _write(path, SIZE, 12)
    assert t_cli.main(["-k", "4", "-n", "6", "-e", path, "--checksum", "--device", "cpu"]) == 0
    victim = t_ff.chunk_file_name(path, 4)
    raw = bytearray(_read(victim))
    raw[100] ^= 0x5A
    with open(victim, "wb") as fp:
        fp.write(raw)
    conf = j_make_conf(6, 4, path, out=str(tmp_path / "conf"))  # chunks 2-5: chunk 4 is used
    outs = {}
    for name, cli, extra in (("torch", t_cli, ["--device", "cpu"]), ("jax", j_cli, [])):
        out = str(tmp_path / f"out_{name}")
        assert cli.main(["-d", "-i", path, "-c", conf, "-o", out, *extra]) == 1
        assert not os.path.exists(out)
        assert cli.main(["-d", "-i", path, "-c", conf, "-o", out, "--no-verify", *extra]) == 0
        outs[name] = _read(out)
    assert outs["torch"] == outs["jax"]


def test_pipeline_flag_errors(capsys):
    assert t_cli.main(["-k", "4", "-n", "6", "-e", "f", "--no-verify", "--device", "cpu"]) == 2
    assert t_cli.main(["-d", "-i", "f", "-c", "c", "extra", "--device", "cpu"]) == 2
    assert "--no-verify is decode-only" in capsys.readouterr().err
    assert t_cli.main(["-h"]) == 0
    usage = capsys.readouterr().out
    for flag in ("[-s|-S]", "[-p|-P]", "--segment-bytes", "--generator", "--no-verify"):
        assert flag in usage


# ----- the resilience reads: --scrub, --auto, --repair, --locate ---------------


def _damaged(tmp_path, name, n_files=1, checksum=True, lost=((0,),), flip=()):
    """Archives of seeded files in ``tmp_path/name`` (encoded by the JAX
    CLI), with the chunks of ``lost[j]`` deleted and ``flip`` (file, chunk)
    pairs rotten; returns (paths, datas)."""
    d = tmp_path / name
    d.mkdir()
    paths = [str(d / f"f{i}.bin") for i in range(n_files)]
    datas = [_write(p, SIZE - 1000 * i, 20 + i) for i, p in enumerate(paths)]
    for p in paths:
        assert j_cli.main(["-k", "4", "-n", "6", "-e", p, *(["--checksum"] if checksum else [])]) == 0
        os.unlink(p)
    for p, chunks in zip(paths, lost):
        for i in chunks:
            os.unlink(t_ff.chunk_file_name(p, i))
    for j, i in flip:
        victim = t_ff.chunk_file_name(paths[j], i)
        raw = bytearray(_read(victim))
        raw[1234] ^= 0x77
        with open(victim, "wb") as fp:
            fp.write(raw)
    return paths, datas


def _run(cli, argv, capsys):
    rc = cli.main(argv + (["--device", "cpu"] if cli is t_cli else []))
    out = capsys.readouterr().out
    return rc, out.split("\n== ")[0].strip()  # the lines before the phase summary


def _each(tmp_path, capsys, make, argv_of):
    """``argv_of(paths)`` through both CLIs, each on its own copy of
    ``make(tmp_path, name)``; returns {name: (rc, stdout head, paths, datas)}."""
    res = {}
    for name, cli in (("torch", t_cli), ("jax", j_cli)):
        paths, datas = make(tmp_path, name)
        capsys.readouterr()
        rc, head = _run(cli, argv_of(paths), capsys)
        res[name] = (rc, head.replace(str(tmp_path / name), "D"), paths, datas)
    return res


@pytest.mark.parametrize("damage,rc", [
    (dict(lost=((),)), 0),
    (dict(lost=((0,),), flip=((0, 3),)), 0),
    (dict(lost=((0, 1),), flip=((0, 3),)), 1),
])
def test_scrub_prints_jax_report_and_exit_code(tmp_path, capsys, damage, rc):
    runs = _each(tmp_path, capsys, lambda tp, name: _damaged(tp, name, **damage), lambda paths: ["--scrub", "-i", paths[0]])
    assert runs["torch"][:2] == runs["jax"][:2]
    assert runs["torch"][0] == rc
    report = json.loads(runs["torch"][1])
    assert report["decodable"] is (rc == 0)


def test_scrub_syndrome_names_silent_bitrot_like_jax(tmp_path, capsys):
    runs = _each(tmp_path, capsys, lambda tp, name: _damaged(tp, name, checksum=False, lost=((),), flip=((0, 2),)),
                 lambda paths: ["--scrub", "--syndrome", "-i", paths[0]])
    assert runs["torch"][:2] == runs["jax"][:2]
    report = json.loads(runs["torch"][1])
    assert report["syndrome"]["silent_bitrot"] == [2] and report["corrupt"] == [2]


def test_auto_decode_cli_like_jax(tmp_path, capsys):
    runs = _each(tmp_path, capsys, lambda tp, name: _damaged(tp, name, flip=((0, 4),)),
                 lambda paths: ["-d", "-i", paths[0], "--auto", "-o", paths[0] + ".out"])
    for name in runs:
        rc, _head, paths, datas = runs[name]
        assert rc == 0 and _read(paths[0] + ".out") == datas[0]
    assert _read(runs["torch"][2][0] + ".auto.conf") == _read(runs["jax"][2][0] + ".auto.conf")


def test_batch_auto_decode_cli_like_jax(tmp_path, capsys):
    make = lambda tp, name: _damaged(tp, name, n_files=3, lost=((0,), (1, 5), ()))  # noqa: E731
    runs = _each(tmp_path, capsys, make, lambda paths: ["-d", "-i", paths[0], "--auto", *paths[1:]])
    assert runs["torch"][:2] == runs["jax"][:2]
    rc, head, paths, datas = runs["torch"]
    assert rc == 0 and head.count("decoded ->") == 3
    assert [_read(p) for p in paths] == datas


@pytest.mark.parametrize("n_files", [1, 3])
def test_repair_cli_like_jax(tmp_path, capsys, n_files):
    make = lambda tp, name: _damaged(tp, name, n_files=n_files, lost=((0,), (), (2, 5))[:n_files],  # noqa: E731
                                     flip=((0, 1),))
    runs = _each(tmp_path, capsys, make, lambda paths: ["--repair", "-i", *paths])
    assert runs["torch"][:2] == runs["jax"][:2]
    assert runs["torch"][0] == 0
    assert ("rebuilt" in runs["torch"][1]) and (n_files == 1 or "healthy" in runs["torch"][1])
    t_paths, j_paths = runs["torch"][2], runs["jax"][2]
    for tp, jp in zip(t_paths, j_paths):
        assert _archive(tp, 6) == _archive(jp, 6)


def test_locate_cli_like_jax(tmp_path, capsys):
    runs = _each(tmp_path, capsys, lambda tp, name: _damaged(tp, name, checksum=False, lost=((),), flip=((0, 3),)),
                 lambda paths: ["-d", "--locate", "-i", paths[0], "-o", paths[0] + ".out"])
    for name in runs:
        rc, _head, paths, datas = runs[name]
        assert rc == 0 and _read(paths[0] + ".out") == datas[0]


@pytest.mark.parametrize("argv", [
    ["--syndrome", "-d", "--auto"], ["--repair", "-c", "c"], ["--repair", "--scrub"],
    ["-d", "--auto", "-c", "c"], ["-d", "--auto", "--locate"], ["-d", "-c", "c", "--locate"], ["--scrub"],
    ["-d", "--auto", "-o", "o", "more.bin"], ["-d", "--locate", "more.bin"], ["-d", "-c", "c", "more.bin"],
])
def test_resilience_flag_errors_like_jax(tmp_path, capsys, argv):
    path = str(tmp_path / "x.bin")
    full = argv[:1] + (["-i", path] if argv != ["--scrub"] else []) + argv[1:]
    assert t_cli.main(full + ["--device", "cpu"]) == j_cli.main(full) == 2
    capsys.readouterr()


# ----- the interleaved layout and the update / append subcommands ---------------


@pytest.mark.parametrize("flags", [[], ["--checksum"], ["--checksum", "--width", "16", "-s", "3", "-p", "1"]])
def test_layout_interleaved_encode_byte_identical_to_jax(tmp_path, capsys, flags):
    runs = _both(tmp_path, lambda paths: ["-k", "4", "-n", "6", "-e", paths[0], "--layout", "interleaved", *flags])
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert runs["torch"][1] == runs["jax"][1]
    assert b"# layout interleaved\n" in runs["torch"][1][0]["f0.bin.METADATA"]


@pytest.mark.parametrize("argv", [
    ["-d", "-i", "f", "-c", "c", "--layout", "interleaved"], ["-k", "4", "-n", "6", "-e", "f", "--layout", "diagonal"],
    ["--scrub", "-i", "f", "--layout", "interleaved"],
])
def test_layout_flag_errors_like_jax(capsys, argv):
    errs = []
    for cli, extra in ((t_cli, ["--device", "cpu"]), (j_cli, [])):
        assert cli.main(argv + extra) == 2
        errs.append(capsys.readouterr().err.splitlines()[0])
    assert errs[0] == errs[1] and "--layout" in errs[0]


def _update_archives(tmp_path, layout):
    """The same seeded file encoded by the JAX CLI into ``torch/`` and
    ``jax/``, plus payload files; returns ({cli: path}, data)."""
    paths = {}
    for name in ("torch", "jax"):
        d = tmp_path / name
        d.mkdir()
        paths[name] = str(d / "f.bin")
        data = _write(paths[name], SIZE, 33)
        assert j_cli.main(["-k", "4", "-n", "6", "-e", paths[name], "--checksum", "--layout", layout]) == 0
    for name, size in (("delta", 5_000), ("tail", 1 if layout == "row" else 7_000), ("e1", 100), ("e2", 64)):
        _write(str(tmp_path / name), size, size)
    with open(tmp_path / "batch.txt", "w") as fp:
        fp.write("# two edits and an append\n10:e1\n\n250000:e2\nappend:tail\n" if layout == "interleaved"
                 else "10:e1\n250000:e2\n")
    return paths, data


def _sub(cli, argv, capsys, path, tmp_path):
    capsys.readouterr()
    rc = cli.main(argv + (["--device", "cpu"] if cli is t_cli else []))
    cap = capsys.readouterr()
    scrub = lambda text: text.replace(path, "F").replace(str(tmp_path), "D")  # noqa: E731
    head = "\n".join(ln for ln in cap.out.splitlines() if not ln.startswith("  "))  # not the phase times
    return rc, scrub(head).strip(), scrub(cap.err).strip()


@pytest.mark.parametrize("layout", ["row", "interleaved"])
def test_update_and_append_subcommands_like_jax(tmp_path, capsys, layout, monkeypatch):
    paths, data = _update_archives(tmp_path, layout)
    steps = [
        ["update", "{p}", "--at", "12345", "--in", str(tmp_path / "delta"), "--json"],
        ["append", "{p}", "--in", str(tmp_path / "tail"), "--json", "--segment-bytes", "8192"],
        ["update", "{p}", "--edits", str(tmp_path / "batch.txt"), "--json"],
        ["update", "{p}", "--at", "7", "--in", str(tmp_path / "e1")],
        ["update", "{p}", "--recover"],
    ]
    for step in steps:
        outs = {}
        for name, cli in (("torch", t_cli), ("jax", j_cli)):
            argv = [a.replace("{p}", paths[name]) for a in step]
            outs[name] = _sub(cli, argv, capsys, paths[name], tmp_path / name)
        assert outs["torch"] == outs["jax"], step
        assert outs["torch"][0] == 0
        if "--json" in step:
            assert json.loads(outs["torch"][1])["generation"] >= 1
        assert _archive(paths["torch"], 6) == _archive(paths["jax"], 6)
    # A torn update, then --recover: the same verdict line, the pre-op archive.
    pre = _archive(paths["torch"], 6)
    monkeypatch.setenv("RS_UPDATE_CRASH", "mid_patch")
    for name, cli in (("torch", t_cli), ("jax", j_cli)):
        with pytest.raises(RuntimeError):
            cli.main(["update", paths[name], "--at", "0", "--in", str(tmp_path / "delta")]
                     + (["--device", "cpu"] if cli is t_cli else []))
    monkeypatch.delenv("RS_UPDATE_CRASH")
    capsys.readouterr()
    outs = {name: _sub(cli, ["update", paths[name], "--recover"], capsys, paths[name], tmp_path / name)
            for name, cli in (("torch", t_cli), ("jax", j_cli))}
    assert outs["torch"] == outs["jax"]
    assert json.loads(outs["torch"][1]) == {"archive": "F", "recovered": "rolled_back"}
    assert _archive(paths["torch"], 6) == pre == _archive(paths["jax"], 6)


@pytest.mark.parametrize("argv,rc", [
    (["update", "{p}"], 2),
    (["update", "{p}", "--in", "{d}"], 2),
    (["append", "{p}"], 2),
    (["update", "{p}", "--edits", "{b}", "--at", "3"], 2),
    (["update", "{p}", "--edits", "{d}"], 2),
    (["update", "{p}", "--edits", "{missing}"], 2),
    (["update", "{p}", "--at", "399990", "--in", "{d}"], 1),
    (["append", "{p}", "--in", "{d}"], 1),
    (["update", "{missing}", "--at", "0", "--in", "{d}"], 1),
    (["update", "--at", "0"], 2),
    (["update", "{p}", "--at", "x", "--in", "{d}"], 2),
])
def test_update_usage_errors_like_jax(tmp_path, capsys, argv, rc):
    paths, _ = _update_archives(tmp_path, "row")
    with open(tmp_path / "bad.txt", "w") as fp:
        fp.write("not-a-record\n")
    outs = {}
    for name, cli in (("torch", t_cli), ("jax", j_cli)):
        subs = {"{p}": paths[name], "{d}": str(tmp_path / "delta"), "{b}": str(tmp_path / "batch.txt"),
                "{missing}": str(tmp_path / "nope")}
        full = [subs.get(a, a) for a in argv]
        if full[-1] == str(tmp_path / "delta") and "--edits" in full:
            full[-1] = str(tmp_path / "bad.txt")
        outs[name] = _sub(cli, full, capsys, paths[name], tmp_path / name)
    assert outs["torch"][0] == outs["jax"][0] == rc
    # The error line (argparse's usage text above it lists each package's
    # own --strategy choices and the port's --device).
    assert outs["torch"][2].splitlines()[-1] == outs["jax"][2].splitlines()[-1]
    assert _archive(paths["torch"], 6) == _archive(paths["jax"], 6)


def test_quiet_encode_prints_nothing_like_jax(tmp_path, capsys):
    """``--quiet`` on the main command: exit 0, nothing on stdout, the same
    archive as the JAX CLI's."""
    outs = {}
    for name, cli in (("torch", t_cli), ("jax", j_cli)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "f.bin")
        _write(path, 5_000, 7)
        capsys.readouterr()
        rc = cli.main(["-k", "4", "-n", "6", "-e", path, "--quiet"] + (["--device", "cpu"] if cli is t_cli else []))
        outs[name] = (rc, capsys.readouterr().out, _archive(path, 6))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][:2] == (0, "")


@pytest.mark.parametrize("strategy", ["xor", "ring"])
def test_strategy_round_trip_like_jax(tmp_path, capsys, strategy):
    """``--strategy xor|ring``: the encode's archive, an ``update`` of it,
    then ``-d --auto`` with a native lost, all equal to the JAX CLI's under
    the same strategy."""
    flags = ["--strategy", strategy, "--quiet"]
    res = _both(tmp_path, lambda ps: ["-k", "4", "-n", "6", "-e", ps[0], "--checksum", "-p", "1"] + flags,
                sizes=(50_000,))
    assert res["torch"][0] == res["jax"][0] == 0
    assert res["torch"][1] == res["jax"][1]
    _write(str(tmp_path / "delta"), 3_000, 3)
    paths = {name: res[name][3][0] for name in res}
    for name, cli in (("torch", t_cli), ("jax", j_cli)):
        dev = ["--device", "cpu"] if cli is t_cli else []
        assert cli.main(["update", paths[name], "--at", "777", "--in", str(tmp_path / "delta")] + flags + dev) == 0
    assert _archive(paths["torch"], 6) == _archive(paths["jax"], 6)
    for name, cli in (("torch", t_cli), ("jax", j_cli)):
        os.unlink(t_ff.chunk_file_name(paths[name], 0))
        dev = ["--device", "cpu"] if cli is t_cli else []
        assert cli.main(["-d", "--auto", "-i", paths[name], "-o", paths[name] + ".out"] + flags + dev) == 0
    want = bytearray(res["torch"][2][0])
    want[777:3_777] = _read(str(tmp_path / "delta"))
    assert _read(paths["torch"] + ".out") == _read(paths["jax"] + ".out") == bytes(want)
    assert capsys.readouterr().out == ""


def test_strategy_refusals_like_jax(tmp_path, capsys):
    f = str(tmp_path / "f.bin")
    _write(f, 1000, 1)
    assert t_cli.main(["-k", "2", "-n", "4", "-e", f, "--strategy", "warp", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "unknown --strategy" in err and "xor|ring" in err
    assert t_cli.main(["update", f, "--at", "0", "--in", f, "--strategy", "warp"]) == 2
    assert "invalid choice" in capsys.readouterr().err
