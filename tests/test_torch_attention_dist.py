"""The port's ``ring_attention`` and ``ulysses_attention`` over
``torch.distributed`` (gloo, on the CPU) at world sizes 2 and 4, against
the JAX package's ``ring_attention`` / ``ulysses_attention`` on an ``sp``
mesh of the same size (the first P of the 8 virtual CPU devices) and
against ``dense_attention``, at ``atol=1e-4`` as
``tests/parallel/test_attention.py`` uses.

Each world size runs once, in P processes started from this file
(``python test_torch_attention_dist.py RANK WORLD INIT_FILE CASE_DIR``):
the ranks join through a ``file://`` store under ``tmp_path``, run every
case on their sequence shard, and write their output shards; the tests
gather and compare them. The workers import torch and the port only, and
each is killed if it runs past its timeout, so a hung rank fails the
tests instead of stalling the suite.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
CAUSAL = (False, True)
METHODS = ("ring", "ulysses")
B, N, H, D = 2, 32, 4, 8
SPAWN_TIMEOUT_S = 120


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, N, H, D)).astype(np.float32)
            for _ in range(3)]


def _worker(rank: int, world: int, init_file: str, case_dir: str) -> None:
    """One rank: every case on its shard, outputs to ``case_dir``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from mmlspark_tpu_torch.parallel.attention import (
        ring_attention,
        ulysses_attention,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        q, k, v = (torch.from_numpy(x) for x in _inputs())
        chunk = N // world
        shard = [x[:, rank * chunk:(rank + 1) * chunk] for x in (q, k, v)]
        outs = {}
        for method, fn in (("ring", ring_attention),
                           ("ulysses", ulysses_attention)):
            for causal in CAUSAL:
                out = fn(*shard, causal=causal, device="cpu")
                outs[f"{method}_{int(causal)}"] = out.numpy()
        errors = {}
        # heads not divisible by the group (world 4 divides 4 heads: use 3)
        few = [x[:, :, :3] for x in shard]
        try:
            ulysses_attention(*few, device="cpu")
        except ValueError as e:
            errors["heads"] = str(e)
        # rank 0 one position short: a global length of N - 1; then
        # rank 1 one position long as well: N, in unequal shards
        cut = [x[:, :-1] if rank == 0 else x for x in shard]
        skew = [x[:, :chunk + 1] if rank == 1 else y
                for x, y in zip((q, k, v), cut)]
        for method, fn in (("ring", ring_attention),
                           ("ulysses", ulysses_attention)):
            for name, parts in (("sequence", cut), ("shards", skew)):
                try:
                    fn(*parts, device="cpu")
                except ValueError as e:
                    errors[f"{name}_{method}"] = str(e)
        np.savez(pathlib.Path(case_dir) / f"rank{rank}.npz", **outs)
        (pathlib.Path(case_dir) / f"rank{rank}.json").write_text(
            json.dumps(errors))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """{world: (per-rank outputs, per-rank error messages)}."""
    results = {}
    for world in WORLDS:
        case_dir = tmp_path_factory.mktemp(f"world{world}")
        init_file = case_dir / "store"
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world), str(init_file),
             str(case_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            pytest.fail(f"a rank of world {world} ran past "
                        f"{SPAWN_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"world {world} rank {rank}:\n{log}"
        results[world] = (
            [dict(np.load(case_dir / f"rank{r}.npz")) for r in range(world)],
            [json.loads((case_dir / f"rank{r}.json").read_text())
             for r in range(world)])
    return results


def _jax_reference(method, world, causal):
    import jax

    from mmlspark_tpu.parallel import attention as jax_attn
    from mmlspark_tpu.parallel.mesh import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(dp=1, fp=1, mp=1, sp=world),
                       devices=jax.devices()[:world])
    fn = {"ring": jax_attn.ring_attention,
          "ulysses": jax_attn.ulysses_attention}[method]
    q, k, v = _inputs()
    return (np.asarray(fn(q, k, v, mesh, causal=causal)),
            np.asarray(jax_attn.dense_attention(q, k, v, causal=causal)))


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_attention_matches_jax_and_dense(shards, world, method,
                                                 causal):
    outs, _ = shards[world]
    got = np.concatenate([o[f"{method}_{int(causal)}"] for o in outs],
                         axis=1)
    jax_out, dense = _jax_reference(method, world, causal)
    assert got.shape == (B, N, H, D)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_rejects_heads_not_divisible(shards, world):
    _, errors = shards[world]
    for rank_errors in errors:
        assert f"heads 3 not divisible by sp={world}" in rank_errors["heads"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_unequal_sequence_shards_raise_on_every_rank(shards, world, method):
    _, errors = shards[world]
    lengths = [N // world - 1, N // world + 1] + [N // world] * (world - 2)
    for rank_errors in errors:
        assert rank_errors[f"sequence_{method}"] == \
            f"sequence {N - 1} not divisible by sp={world}"
        assert rank_errors[f"shards_{method}"] == \
            f"sequence shards must be of equal length, got {lengths}"


def test_without_a_process_group_the_sequence_ops_raise():
    from mmlspark_tpu_torch.parallel.attention import ring_attention
    from mmlspark_tpu_torch.parallel.mesh import SEQUENCE_AXIS

    assert SEQUENCE_AXIS == "sp"
    q, k, v = _inputs()
    with pytest.raises(RuntimeError, match="process group"):
        ring_attention(q, k, v, device="cpu")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
