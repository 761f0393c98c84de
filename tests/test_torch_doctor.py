"""The port's obs/doctor.py (``rs doctor``) against the JAX package's on the
CPU: ``collect()`` has the JAX package's sections with ``torch`` in place
of ``jax``, every other shared section carries the same keys, the mesh
section reports torch.distributed's backends in place of shard_map, the
warning rules are the JAX package's, and ``rs doctor`` / ``--json`` exit as
its do."""

import json
import socket
import time

import pytest

from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.obs import doctor as t_doctor
from gpu_rscode_torch.parallel import _compat
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu.obs import doctor as j_doctor

# The sections whose content depends only on the environment both packages
# read the same way.
SAME_CONTENT = ("env", "serve", "slo", "roofline")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("RS_RUNLOG", "RS_METRICS_PORT", "RS_SERVE_PORT", "RS_SLO", "RS_STORE_ROOT", "RS_MAINT"):
        monkeypatch.delenv(var, raising=False)


def _both(**kw):
    return t_doctor.collect(probe_endpoint=False, **kw), j_doctor.collect(probe_endpoint=False, **kw)


def test_sections_are_jaxs_with_torch_for_jax():
    assert t_doctor.SECTIONS == tuple("torch" if s == "jax" else s for s in j_doctor.SECTIONS)
    t, j = _both()
    assert set(t) - set(j) == {"torch"} and set(j) - set(t) == {"jax"}
    assert t["kind"] == j["kind"] == "rs_doctor" and t["schema"] == j["schema"]


def test_shared_sections_have_equal_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("RS_RUNLOG", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("RS_STORE_ROOT", str(tmp_path / "store"))
    t, j = _both()
    for section in t_doctor.SECTIONS:
        if section in ("torch", "mesh"):
            continue
        if isinstance(j[section], dict) and section != "env":
            assert set(t[section]) == set(j[section]), section
            for key, val in j[section].items():
                if isinstance(val, dict) and key not in ("buckets", "autotune_decisions", "distributed_env",
                                                         "knobs", "auto"):
                    assert set(t[section][key]) == set(val), f"{section}.{key}"
    for section in SAME_CONTENT:
        assert t[section] == j[section], section


def test_torch_and_mesh_sections():
    t, j = _both()
    assert set(j["jax"]) <= set(t["torch"])
    assert set(t["torch"]) - set(j["jax"]) == {"cuda_version", "device_name", "capability", "nvcc", "build_dir"}
    assert t["torch"]["importable"] and t["torch"]["backend"] == "cpu" and t["torch"]["error"] is None
    assert t["torch"]["build_dir"].endswith("build/gpu_rscode_torch")
    # The mesh section drops shard_map and the forced host devices for
    # torch.distributed's backends.
    assert set(j["mesh"]) - set(t["mesh"]) == {"shard_map_available", "forced_host_devices"}
    assert set(t["mesh"]) - set(j["mesh"]) == {"distributed_available", "nccl_available", "gloo_available",
                                               "initialized"}
    assert t["mesh"]["local_device_count"] == 0
    assert t["mesh"]["distributed_available"] and t["mesh"]["gloo_available"] and not t["mesh"]["initialized"]


def test_mesh_section_reads_torchruns_variables(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert t_doctor.collect(probe_endpoint=False)["mesh"]["distributed_env"] == {"WORLD_SIZE": "2", "RANK": "1"}


def _ledger_with(tmp_path, records):
    path = tmp_path / "ledger.jsonl"
    with open(path, "w") as fp:
        for rec in records:
            fp.write(json.dumps(rec) + "\n")
    return str(path)


def test_warning_rules_equal_jax(tmp_path, monkeypatch):
    """A clean environment warns of nothing in either package; a stale
    roofline, an unwritable ledger, an at-risk archive and a perf breach
    give the JAX package's warnings, word for word."""
    t, j = _both()
    assert t["warnings"] == j["warnings"] == []
    stale = {"kind": "rs_roofline", "host": socket.gethostname(), "ts": time.time() - 10 * 86400,
             "triad_gbps": 10.0, "gemm_gflops": 100.0}
    monkeypatch.setenv("RS_RUNLOG", _ledger_with(tmp_path, [stale]))
    t, j = _both()
    assert t["warnings"] == j["warnings"] and len(t["warnings"]) == 1 and "stale" in t["warnings"][0]
    assert t["roofline"] == j["roofline"] and t["roofline"]["fresh"] is False
    (tmp_path / "afile").write_text("")
    monkeypatch.setenv("RS_RUNLOG", str(tmp_path / "afile" / "ledger.jsonl"))
    t, j = _both()
    assert t["warnings"] == j["warnings"] and "not writable" in t["warnings"][0]
    monkeypatch.delenv("RS_RUNLOG")
    for mod in (t_doctor, j_doctor):
        monkeypatch.setattr(mod, "_health_section", lambda records: {"at_risk": 3})
        monkeypatch.setattr(mod, "_perf_section", lambda records: {"breach": True, "worst_cell": "cuda|encode|1M",
                                                                   "worst_ratio": 0.5})
    t, j = _both()
    assert t["warnings"] == j["warnings"] and len(t["warnings"]) == 2


def test_port_only_warning_rules(monkeypatch):
    """The shard_map rule's counterpart (torch.distributed missing) and the
    native library's rule."""
    monkeypatch.setattr(_compat, "distributed_available", lambda: False)
    from gpu_rscode_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    warnings = t_doctor.collect(probe_endpoint=False)["warnings"]
    assert any("torch.distributed missing" in w for w in warnings)
    assert any("native library unavailable" in w for w in warnings)


@pytest.mark.parametrize("argv", [["doctor"], ["doctor", "--no-probe"], ["doctor", "--json", "--no-probe"],
                                  ["doctor", "--bogus"], ["doctor", "-h"]])
def test_rs_doctor_exits_as_jax(argv, capsys):
    t_rc = t_cli.main(argv)
    t_out = capsys.readouterr().out
    j_rc = j_cli.main(argv)
    capsys.readouterr()
    assert t_rc == j_rc
    if "--json" in argv:
        doc = json.loads(t_out)
        assert all(s in doc for s in t_doctor.SECTIONS)
    elif t_rc == 0 and "-h" not in argv:
        assert t_out.startswith("rs doctor @") and "] torch " in t_out and "] mesh: " in t_out
