"""The port stands alone: importing it, its solver and the chip smoke test
pulls in neither JAX nor the JAX package (checked in a fresh interpreter,
since this test process has both loaded)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_vican_tpu():
    code = (
        "import sys\n"
        "import vican_torch, vican_torch.bipgo, vican_torch.solver.scale\n"
        "import vican_torch.solver.pwr, vican_torch._kernels, vican_torch.synthetic\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vican_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
