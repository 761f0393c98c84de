"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and ships its kernel sources."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "gpu_rscode_torch"


def test_port_imports_no_jax():
    """A fresh interpreter (this test process has JAX loaded by conftest)
    with only the checkout on its path."""
    code = (
        "import sys\n"
        "import gpu_rscode_torch.api, gpu_rscode_torch.cli, gpu_rscode_torch.codec\n"
        "import gpu_rscode_torch.ops.cuda_gemm, gpu_rscode_torch.tools.make_conf\n"
        "import gpu_rscode_torch.ops.cuda_pack2, gpu_rscode_torch.ops.cuda_planes, gpu_rscode_torch.obs.runlog\n"
        "import gpu_rscode_torch.tools.kernel_sweep, gpu_rscode_torch.tools.expand_probe\n"
        "import gpu_rscode_torch.native, gpu_rscode_torch.parallel.pipeline, gpu_rscode_torch.parallel.io_executor\n"
        "import gpu_rscode_torch.gf_decode, gpu_rscode_torch.ops.inverse\n"
        "import gpu_rscode_torch.update, gpu_rscode_torch.update.group\n"
        "import gpu_rscode_torch.ops.xor_gemm, gpu_rscode_torch.ops.ring_gemm, gpu_rscode_torch.ops.xor_opt\n"
        "import gpu_rscode_torch.plan, gpu_rscode_torch.tune\n"
        "import gpu_rscode_torch.utils.env, gpu_rscode_torch.obs.percentile, gpu_rscode_torch.obs.metrics\n"
        "import gpu_rscode_torch.store, gpu_rscode_torch.store.index, gpu_rscode_torch.store.snapshot\n"
        "import gpu_rscode_torch.store.readpath, gpu_rscode_torch.store.bucket, gpu_rscode_torch.store.cli\n"
        "import gpu_rscode_torch.store.openbench\n"
        "import gpu_rscode_torch.obs.tracing, gpu_rscode_torch.obs.reqtrace, gpu_rscode_torch.obs.slo\n"
        "import gpu_rscode_torch.obs.health, gpu_rscode_torch.obs.serve\n"
        "import gpu_rscode_torch.serve, gpu_rscode_torch.serve.queue, gpu_rscode_torch.serve.batcher\n"
        "import gpu_rscode_torch.serve.objcache, gpu_rscode_torch.serve.daemon, gpu_rscode_torch.serve.loadgen\n"
        "import gpu_rscode_torch.resilience, gpu_rscode_torch.resilience.faults, gpu_rscode_torch.resilience.retry\n"
        "import gpu_rscode_torch.resilience.chaos, gpu_rscode_torch.maint, gpu_rscode_torch.maint.controller\n"
        "import gpu_rscode_torch.obs.profiler, gpu_rscode_torch.obs.perfbase, gpu_rscode_torch.obs.attrib\n"
        "import gpu_rscode_torch.tools.plan_stats\n"
        "import gpu_rscode_torch.tools.inverse_bench, gpu_rscode_torch.tools.mesh_bench\n"
        "import gpu_rscode_torch.tools.mesh_overhead, gpu_rscode_torch.tools.strategy_bench\n"
        "import gpu_rscode_torch.tools.k_sweep, gpu_rscode_torch.tools.w16_bench, gpu_rscode_torch.tools.stream_bench\n"
        "import gpu_rscode_torch.parallel._compat, gpu_rscode_torch.parallel.mesh\n"
        "import gpu_rscode_torch.parallel.distributed, gpu_rscode_torch.parallel.sharded\n"
        "import gpu_rscode_torch.obs.aggregate, gpu_rscode_torch.obs.doctor\n"
        "from gpu_rscode_torch.obs.doctor import collect\n"
        "collect(probe_endpoint=False)\n"
        "from gpu_rscode_torch.obs.runlog import filter_records, throughput_gbps\n"
        "from gpu_rscode_torch.api import put_object, put_objects, get_object, delete_object, list_objects\n"
        "from gpu_rscode_torch.api import list_objects_page, stat_object, compact_bucket\n"
        "from gpu_rscode_torch.native import gemm, invert, available\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'gpu_rscode_tpu')))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_file_of_the_port_mentions_the_jax_package():
    offenders = [
        str(path.relative_to(REPO))
        for path in PORT.rglob("*")
        if path.is_file() and path.suffix in (".py", ".cu", ".cuh", ".h", ".cpp")
        and ("gpu_rscode_tpu" in path.read_text() or "import jax" in path.read_text())
    ]
    assert not offenders


def test_kernel_source_ships_as_package_data():
    for name in ("gf_gemm.cu", "gf_pack2.cu", "gf_planes.cu"):
        assert (PORT / "ops" / "csrc" / name).is_file()
    assert (PORT / "native" / "rs_native_io.cpp").is_file()
    assert (PORT / "native" / "rs_native_gemm.cpp").is_file()
    pyproject = (REPO / "pyproject.toml").read_text()
    assert "gpu_rscode_torch*" in pyproject
    assert "ops/csrc/*.cu" in pyproject
    assert "native/*.cpp" in pyproject
    assert (PORT / "data" / "inverse_routing_h100.jsonl").is_file()
    assert "data/*.jsonl" in pyproject
