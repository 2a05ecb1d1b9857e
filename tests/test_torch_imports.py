"""The port stands alone: importing it, its solver, its perception, its
dataset loaders, its evaluation, serialization and plot modules, its
parallel package, every member of its lazy ``__all__``, building its C
modules and importing the card tests' bars and the kernel tools pulls in
neither JAX nor the JAX package (checked in a fresh interpreter, since this
test process has both loaded)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_vican_tpu():
    code = (
        "import sys\n"
        "import vican_torch, vican_torch.bipgo, vican_torch.solver.scale\n"
        "import vican_torch.solver.pwr, vican_torch._kernels, vican_torch.synthetic\n"
        "import vican_torch.solver.mv, vican_torch.solver.specs, vican_torch._native\n"
        "import vican_torch.solver.packing, vican_torch.solver.tiles\n"
        "assert vican_torch._native.get_fastpack() is not None\n"
        "assert vican_torch._native.get_fastccl() is not None\n"
        "assert vican_torch._native.get_fastthresh() is not None\n"
        "import vican_torch.perception, vican_torch.cam, vican_torch.render\n"
        "import vican_torch.dataset, vican_torch.evaluation, vican_torch.serialization\n"
        "import vican_torch.plot, vican_torch.geometry, vican_torch.ops.lie\n"
        "for name in vican_torch.__all__:\n"
        "    getattr(vican_torch, name)\n"
        "import vican_torch.ops.detect, vican_torch.ops.pnp, vican_torch.ops.threshold\n"
        "import vican_torch.parallel, vican_torch.parallel.mesh, vican_torch.parallel.sharded\n"
        "import torch_bars\n"
        "sys.path.insert(0, 'tools')\n"
        "import kernel_times, detect_sweep\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vican_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_lazy_all_lists_the_jax_package_modules_the_port_has():
    """``vican_torch.__all__`` is ``vican_tpu.__all__``, ``parallel``
    included, each a module that a plain attribute access imports."""
    import importlib

    import vican_torch
    import vican_tpu

    assert vican_torch.__all__ == vican_tpu.__all__
    assert "parallel" in vican_torch.__all__
    for name in vican_torch.__all__:
        assert getattr(vican_torch, name) is importlib.import_module(f"vican_torch.{name}")
    with pytest.raises(AttributeError):
        vican_torch.no_such_module
