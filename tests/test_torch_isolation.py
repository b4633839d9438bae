"""The port stands alone: ``mmlspark_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, and the entry points run on the
card unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.models.gbdt import hist_cuda
from mmlspark_tpu_torch.models.gbdt.trainer import TrainConfig, train
from mmlspark_tpu_torch.ops.binning import BinMapper
from mmlspark_tpu_torch.parallel import flash
from mmlspark_tpu_torch.parallel.attention import fused_attention

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mmlspark_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_hist_ab.py",
       ROOT / "tools" / "torch_flash_ab.py",
       ROOT / "tools" / "torch_hist_quant_configs.py"]


def _imported_modules(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "mmlspark_tpu"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_port_files_were_found():
    names = {p.name for p in PORT_FILES}
    assert {"trainer.py", "hist_cuda.py", "bindings.py", "booster.py",
            "binning.py", "env.py", "chip_smoke.py", "flash.py",
            "attention.py", "mesh.py", "torch_hist_ab.py",
            "torch_flash_ab.py", "torch_hist_quant_configs.py"} <= names


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mmlspark_tpu_torch\n"
            "import mmlspark_tpu_torch.models.gbdt.convert\n"
            "import mmlspark_tpu_torch.parallel.attention\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mmlspark_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 3))
    y = (x[:, 0] > 0).astype(np.float64)
    binned = BinMapper.fit(x, max_bin=15).transform(x)
    cfg = TrainConfig(objective="binary", num_iterations=1, max_bin=15,
                      num_leaves=4, max_depth=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(binned, y, cfg)
    booster = train(binned, y, cfg, device="cpu").booster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        booster.predict_binned(binned.astype(np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        booster.predict(x)
    assert booster.predict(x, device="cpu").shape == (200,)
    q = rng.normal(size=(1, 128, 2, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_attention(q, q, q, causal=True)
    assert fused_attention(q, q, q, device="cpu").shape == q.shape


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers never launch (or build) their kernels."""
    before = (hist_cuda.hist_kernel_launches,
              hist_cuda.hist_quant_kernel_launches,
              flash.flash_kernel_launches)
    n, f, b = 64, 2, 8
    binned = torch.zeros((n, f), dtype=torch.uint8)
    local = torch.zeros(n, dtype=torch.int64)
    out = hist_cuda.level_histogram(binned, torch.ones(n), torch.ones(n),
                                    torch.ones(n), local, 1, f, b)
    ones_q = torch.ones(n, dtype=torch.int16)
    out_q = hist_cuda.level_histogram_quant(binned, ones_q, ones_q,
                                            torch.ones(n), local, 1, f, b,
                                            0.5, 0.25)
    q = torch.ones((1, 128, 1, 8))
    attn = flash.flash_attention(q, q, q, device="cpu")
    assert (hist_cuda.hist_kernel_launches,
            hist_cuda.hist_quant_kernel_launches,
            flash.flash_kernel_launches) == before
    assert torch.equal(attn, q)
    assert out[0, :, 0, 2].tolist() == [float(n)] * f
    assert out_q[0, :, 0].tolist() == [[n * 0.5, n * 0.25, float(n)]] * f
