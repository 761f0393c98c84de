"""The port's chaos harness (``rs chaos``) against the JAX package's, on the
CPU: for every class, three iterations at seed 20260807 through both
packages must give equal per-iteration verdict rows and equal schedule and
verdict digests; and the harness's own surface (``--only``, ``--repro``,
shrinking, the ``REPRODUCE:`` line, ``--repro-out``, the ``chaos_iter``
ledger records, the pinned env, the device rule) behaves as JAX's does.
Tolerance 0."""

import contextlib
import io
import json
import os

import pytest

from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.resilience import chaos as t_chaos
from gpu_rscode_tpu.resilience import chaos as j_chaos

CLASSES = {
    "classic": [],
    "silent": ["--silent"],
    "update": ["--update"],
    "update_group": ["--update", "--group"],
    "object": ["--object"],
    "health": ["--health"],
    "maint": ["--maint"],
}


def _run(main, argv, tmp_path, sub):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main([*argv, "--dir", str(tmp_path / sub)])
    return rc, [json.loads(line) if line.startswith("{") else line for line in buf.getvalue().splitlines()], \
        err.getvalue()


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_three_iterations_equal_jax(tmp_path, cls):
    argv = ["--seed", "20260807", "--iters", "3", "--json", *CLASSES[cls]]
    t_rc, t_rows, _ = _run(t_chaos.main, [*argv, "--device", "cpu"], tmp_path, "t")
    j_rc, j_rows, _ = _run(j_chaos.main, argv, tmp_path, "j")
    assert t_rc == j_rc == 0
    assert t_rows == j_rows
    assert t_rows[-1]["passed"] == 3 and t_rows[-1]["failed"] == 0


def test_schedules_equal_jax_for_every_planner():
    for name in ("plan_iteration", "plan_silent_iteration", "plan_update_iteration", "plan_update_group_iteration",
                 "plan_object_iteration", "plan_health_iteration", "plan_maint_iteration"):
        for seed in (0, 20260804, 20260807):
            for i in range(20):
                assert getattr(t_chaos, name)(seed, i) == getattr(j_chaos, name)(seed, i), (name, seed, i)


def test_only_replays_one_iteration_like_jax(tmp_path):
    argv = ["--seed", "20260807", "--only", "5", "--json"]
    t_out = _run(t_chaos.main, [*argv, "--device", "cpu"], tmp_path, "t")
    j_out = _run(j_chaos.main, argv, tmp_path, "j")
    assert t_out[:2] == j_out[:2] and t_out[1][0]["iter"] == 5


def test_doctored_repro_fails_shrinks_and_prints_one_line(tmp_path):
    """A doctored config that unlinks a chunk the archive does not have
    fails; the shrink drops the fault plan and every event that does not
    matter, and one REPRODUCE: line is printed (and written to
    --repro-out), as the JAX harness does."""
    cfg = {"seed": 1, "iter": 0, "k": 3, "p": 1, "w": 8, "size": 5000,
           "events": [{"kind": "unlink", "chunk": 0}, {"kind": "unlink", "chunk": 9}], "faults": "read:delay@ms=0"}
    outs = []
    for main, sub, extra in ((t_chaos.main, "t", ["--device", "cpu"]), (j_chaos.main, "j", [])):
        out_path = tmp_path / f"{sub}.repro"
        rc, lines, err = _run(main, ["--repro", json.dumps(cfg), "--repro-out", str(out_path), *extra], tmp_path, sub)
        assert rc == 1 and "rs chaos: FAILED" in err
        repro = [line for line in lines if isinstance(line, str) and line.startswith("REPRODUCE: ")]
        assert len(repro) == 1
        assert out_path.read_text() == repro[0][len("REPRODUCE: "):] + "\n"
        outs.append((repro[0], err.splitlines()[0].replace(str(tmp_path / sub), "<dir>")))
    assert outs[0] == outs[1]
    shrunk = json.loads(outs[0][0][len("REPRODUCE: "):])
    assert shrunk["faults"] == "" and shrunk["events"] == [{"kind": "unlink", "chunk": 9}]


def test_chaos_iter_records_and_counters(tmp_path, monkeypatch):
    ledger = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("RS_RUNLOG", str(ledger))
    rc, rows, _ = _run(t_chaos.main, ["--seed", "3", "--iters", "2", "--device", "cpu"], tmp_path, "t")
    assert rc == 0
    recs = [json.loads(line) for line in ledger.read_text().splitlines()]
    iters = [r for r in recs if r.get("op") == "chaos_iter"]
    assert [r["chaos"]["iter"] for r in iters] == [0, 1] and all(r["outcome"] == "ok" for r in iters)
    # Every file op of an iteration leaves its rs_run record too.
    assert {"encode", "scan"} <= {r["op"] for r in recs if r.get("kind") == "rs_run"}


def test_pinned_env_restores_ambient_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("RS_RETRY_ATTEMPTS", "0")
    monkeypatch.setenv("RS_FAULTS", "read:ioerror@p=1")
    rc, rows, _ = _run(t_chaos.main, ["--seed", "20260807", "--iters", "2", "--json", "--device", "cpu"], tmp_path, "t")
    assert rc == 0 and rows[-1]["passed"] == 2
    assert os.environ["RS_RETRY_ATTEMPTS"] == "0" and os.environ["RS_FAULTS"] == "read:ioerror@p=1"
    assert set(t_chaos._PINNED_ENV) == set(j_chaos._PINNED_ENV)
    assert all(t_chaos._PINNED_ENV[k] == j_chaos._PINNED_ENV[k] for k in j_chaos._PINNED_ENV)


def test_usage_errors_and_the_device_rule(tmp_path, capsys):
    assert t_cli.main(["chaos", "--silent", "--update", "--device", "cpu"]) == 2
    assert "pick one workload class" in capsys.readouterr().err
    assert t_cli.main(["chaos", "--group", "--device", "cpu"]) == 2
    assert t_cli.main(["chaos", "--repro", "{", "--device", "cpu"]) == 2
    # No GPU here and no --device: refused, nothing run.
    assert t_cli.main(["chaos", "--iters", "1", "--dir", str(tmp_path / "x")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_chaos.run_iteration(t_chaos.plan_iteration(0, 0), str(tmp_path))
