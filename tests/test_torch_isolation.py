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
        if path.is_file() and path.suffix in (".py", ".cu", ".cuh", ".h")
        and ("gpu_rscode_tpu" in path.read_text() or "import jax" in path.read_text())
    ]
    assert not offenders


def test_kernel_source_ships_as_package_data():
    for name in ("gf_gemm.cu", "gf_pack2.cu", "gf_planes.cu"):
        assert (PORT / "ops" / "csrc" / name).is_file()
    pyproject = (REPO / "pyproject.toml").read_text()
    assert "gpu_rscode_torch*" in pyproject
    assert "ops/csrc/*.cu" in pyproject
