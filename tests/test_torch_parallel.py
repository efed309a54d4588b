"""Data parallelism (parallel/mesh.py, train_lib.py, parallel/dryrun.py):
the batch-sharding rule against the JAX package's shard_host_batch on a
4-device CPU mesh, each rank's slice of the global draws, and a 2-process
gloo dry run on a FileStore whose sharded train and eval steps equal the
one-process steps (parallel/dryrun.py states each gate and why)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.parallel.mesh import LocalMesh, local_rows, make_mesh, shard_host_batch, shard_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (8, 4, 6, 2, 1)


class _Rank(LocalMesh):
    """A rank of an n-rank mesh, without a process group."""

    def __init__(self, n, rank):
        super().__init__("cpu")
        self.n, self.rank = n, rank

    def size(self):
        return self.n

    def get_local_rank(self):
        return self.rank


@pytest.fixture(scope="module")
def jax_specs():
    """For each batch size, whether JAX's shard_host_batch shards each entry
    over 4 CPU devices (run in a process of its own: the device count is
    fixed when JAX starts)."""
    code = (
        "import json, numpy as np\n"
        "from cofii2p_tpu.parallel.mesh import make_mesh, shard_host_batch\n"
        "mesh = make_mesh()\n"
        "assert mesh.devices.size == 4\n"
        "out = {}\n"
        f"for b in {BATCHES!r}:\n"
        "    hb = {'img': np.zeros((b, 2, 2, 3)), 'pc': np.zeros((b, 5, 3)), 'K': np.zeros((3, 3)), 'n': np.zeros(())}\n"
        "    put = shard_host_batch(hb, mesh)\n"
        "    out[b] = {k: v.sharding.spec[0] == 'dp' if len(v.sharding.spec) else False for k, v in put.items()}\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env)
    assert res.returncode == 0, res.stderr
    return {int(k): v for k, v in json.loads(res.stdout.strip().splitlines()[-1]).items()}


@pytest.mark.parametrize("bsz", BATCHES)
def test_shard_rule_matches_jax(jax_specs, bsz):
    """Batched entries are split over the ranks only when the batch divides
    evenly; unbatched ones, and an uneven batch, stay whole on each rank;
    the ranks' rows put together are the batch."""
    hb = {"img": np.arange(bsz * 12, dtype=np.float32).reshape(bsz, 2, 2, 3),
          "pc": np.arange(bsz * 15, dtype=np.float32).reshape(bsz, 5, 3), "K": np.eye(3), "n": np.float32(3)}
    parts = [shard_host_batch(hb, _Rank(4, r), "cpu") for r in range(4)]
    for k, v in hb.items():
        sharded = parts[0][k].shape != np.shape(v)
        assert sharded == jax_specs[bsz][k], k
        got = torch.cat([p[k] for p in parts]) if sharded else parts[0][k]
        np.testing.assert_array_equal(got.numpy(), v)


def test_make_mesh_without_a_group_is_a_world_of_one():
    mesh = make_mesh("cpu")
    assert isinstance(mesh, LocalMesh) and mesh.size() == 1 and mesh.get_group() is None
    x = torch.arange(6)
    assert torch.equal(local_rows(x, 6, mesh), x)


def test_each_rank_takes_its_slice_of_the_global_draws():
    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.config import TinyConfig

    cfg = TinyConfig()
    whole = train_lib.make_train_draws(cfg, 4, torch.Generator().manual_seed(3), "cpu")
    for r in range(2):
        part = train_lib.make_train_draws(cfg, 4, torch.Generator().manual_seed(3), "cpu", _Rank(2, r))
        for a, b in zip(part["perms"], whole["perms"]):
            assert torch.equal(a, b[2 * r:2 * r + 2])
        for k, v in part["keypoint_noise"].items():
            assert torch.equal(v, whole["keypoint_noise"][k][2 * r:2 * r + 2])
    assert shard_tree({"a": [torch.zeros(4, 1)], "b": torch.zeros(3)}, 4, _Rank(2, 1))["b"].shape == (3,)


def test_two_process_dry_run_equals_one_process(tmp_path):
    from cofii2p_tpu_torch.parallel.dryrun import GRAD_TOL, TOL, dryrun_multiprocess

    found = dryrun_multiprocess(2, workdir=str(tmp_path))
    assert (tmp_path / "rank0.pt").exists() and (tmp_path / "rank1.pt").exists()
    assert found["losses"] <= TOL and found["params"] <= TOL and found["poses"] <= TOL
    assert found["gradients"] <= GRAD_TOL
