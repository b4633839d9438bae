"""The port's quantization exponent (``trainer._pow2_scale``) takes the
JAX package's decision without a logarithm: the threshold table it
keeps is XLA's, and its scales are the same bits in every process.

  - the table: derived again from JAX by ``tools/pow2_thresholds.py``
    and compared entry for entry;
  - processes: six fresh interpreters compute the port's scales over
    ``test_torch_gbdt_quant``'s amax grid, three with JAX imported and
    three without; one SHA-256 of the scales in all six, and the
    exponents equal to JAX's at every grid value;
  - no ``torch.log`` / ``torch.log2`` is called on the way.
"""

import hashlib
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu_torch.models.gbdt import trainer
from tests.test_torch_gbdt_quant import QMAX, _amax_grid
from tools import pow2_thresholds

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_threshold_table_is_xlas():
    derived = pow2_thresholds.derive_thresholds()
    assert derived.shape == (253,)
    np.testing.assert_array_equal(
        derived, np.asarray(trainer.POW2_THRESHOLD_BITS, np.int32))
    # the table is sorted and each t_k lies near 2^k
    assert (np.diff(derived.astype(np.int64)) > 0).all()
    exact = np.asarray([(k + 127) << 23 for k in range(-126, 127)])
    assert np.abs(derived - exact).max() < pow2_thresholds.WINDOW


_GRID = """
import numpy as np


def amax_grid():
    # test_torch_gbdt_quant._amax_grid, written out so that a child
    # process need not import the JAX package
    vals = [0.0, 1e-30, 1e-31, 1e-38, 1e-45, 3.4028235e38]
    for j in range(-149, 128):
        for base in (np.ldexp(1.0, j), 32000.0 * np.ldexp(1.0, j),
                     120.0 * np.ldexp(1.0, j)):
            if not np.ldexp(1.0, -149) <= base <= 3.4028234e38:
                continue
            x = np.float32(base)
            up = down = x
            vals.append(x)
            for _ in range(3):
                up = np.nextafter(up, np.float32(np.inf))
                down = np.nextafter(down, np.float32(0))
                vals += [up, down]
    grid = np.unique(np.array(vals, np.float32))
    return grid[np.isfinite(grid)]
"""

_CHILD = _GRID + """
import hashlib, sys
import torch
if sys.argv[1] == "jax":
    import jax.numpy as jnp
    jnp.log2(jnp.ones(4, jnp.float32)).block_until_ready()
from mmlspark_tpu_torch.models.gbdt import trainer
h = hashlib.sha256()
for qmax in (120.0, 32000.0):
    s, si = trainer._pow2_scale(torch.from_numpy(amax_grid()), qmax)
    h.update(s.numpy().tobytes())
    h.update(si.numpy().tobytes())
print(h.hexdigest(), "jax" in sys.modules)
"""


def test_scales_are_the_same_bits_in_six_fresh_processes():
    env = {}
    exec(_GRID, env)
    np.testing.assert_array_equal(env["amax_grid"](), _amax_grid())
    h = hashlib.sha256()
    for qmax in (120.0, 32000.0):
        s, si = trainer._pow2_scale(torch.from_numpy(_amax_grid()), qmax)
        h.update(s.numpy().tobytes())
        h.update(si.numpy().tobytes())
    runs = []
    for mode in ("jax", "plain") * 3:      # one at a time: a light load
        out = subprocess.run([sys.executable, "-c", _CHILD, mode], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        runs.append(tuple(out.stdout.split()))
    assert [loaded for _, loaded in runs] == ["True", "False"] * 3
    assert {digest for digest, _ in runs} == {h.hexdigest()}


@pytest.mark.parametrize("quant", ["q16", "q8"])
def test_exponent_is_jaxs_at_every_grid_value(quant):
    amax = _amax_grid()
    js, _ = jax_trainer._pow2_scale(jnp.asarray(amax), QMAX[quant])
    ps, psi = trainer._pow2_scale(torch.from_numpy(amax), QMAX[quant])
    e_jax = np.round(np.log2(np.asarray(js, np.float64)))
    e_port = (ps.numpy().view(np.int32) >> 23) - 127
    np.testing.assert_array_equal(e_port, e_jax)
    np.testing.assert_array_equal(
        (psi.numpy().view(np.int32) >> 23) - 127, -e_port)


def test_no_logarithm_on_the_path(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a logarithm was taken")

    for name in ("log", "log2"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    s, si = trainer._pow2_scale(torch.tensor(0.37), 32000.0)
    assert s.shape == () and float(s) * float(si) == 1.0
    assert float(s) == 65536.0          # 32000 / 0.37 = 86486.5
