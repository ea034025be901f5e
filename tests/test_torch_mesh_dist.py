"""The port's process group and mesh over ranks against the JAX package:
``parallel.mesh.make_mesh`` over spawned gloo ranks (world 8 on the CPU)
puts rank r where JAX's ``make_mesh(dp=2, sp=2, tp=2)`` puts device r and
groups the ranks along each axis as the JAX mesh's device grid does;
``parallel.distributed``'s pure layout functions equal JAX's over a grid
of inputs; ``init_distributed`` alone is a no-op; ``DistContext``'s
broadcast, put/get and barrier work across ranks; NCCL is refused for two
ranks on one device.

The ranks run ``tests/torch_dist_ranks.py`` (no JAX in them), one thread
each, with a 120 s limit on the spawn."""

import itertools

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from kubeml_tpu.parallel import distributed as jdist
from kubeml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kubeml_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from kubeml_tpu.parallel.mesh import parse_mesh_spec as jax_parse
from kubeml_tpu_torch.parallel import distributed as D
from kubeml_tpu_torch.parallel.mesh import (AXIS_ORDER, mesh_shape_for,
                                            parse_mesh_spec)


@pytest.fixture(scope="module")
def ranks():
    return R.run(R.mesh_rank, 8)


def _jax_ids():
    jm = jax_make_mesh(dp=2, sp=2, tp=2)
    return jm.axis_names, np.vectorize(lambda d: d.id)(jm.devices)


def test_rank_coordinates_and_axis_groups_equal_the_jax_device_grid(ranks):
    names, ids = _jax_ids()
    assert names == AXIS_ORDER
    for r, res in enumerate(ranks):
        at = [int(c) for c in np.argwhere(ids == r)[0]]
        assert res["coord"] == dict(zip(names, at))
        for ax in ("dp", "sp", "tp"):
            i = names.index(ax)
            line = ids[tuple(slice(None) if j == i else at[j]
                             for j in range(len(names)))]
            assert res["groups"][ax] == sorted(int(x) for x in line), ax
        # the dp x sp replicas of this rank's tp shard
        tp = at[names.index("tp")]
        want = ids[:, :, :, :, tp].reshape(-1)
        assert res["replicas"] == sorted(int(x) for x in want)
        assert (res["device"], res["backend"], res["slices"]) == (
            "cpu", "gloo", 1)
        assert res["global_shape"] == {"dp": 2, "pp": 1, "ep": 1, "sp": 2,
                                       "tp": 2}
        assert res["batch_slice"] == (2 * r, 2 * r + 2)


def test_dist_context_across_eight_ranks(ranks):
    for r, res in enumerate(ranks):
        assert res["broadcast"] == {"from": 0, "list": [1, 2]}
        assert res["flags"] == (True, 10)
        assert res["acks"] == [str(i * i) for i in range(8)]
        assert res["missing"] is None


@pytest.mark.parametrize("spec", ["", "tp=2,sp=2", " dp=4 ", "tp:2", "x"])
def test_parse_mesh_spec_unchanged(spec):
    try:
        want = jax_parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match="mesh spec"):
            parse_mesh_spec(spec)
        assert "mesh spec" in str(e)
        return
    assert parse_mesh_spec(spec) == want


@pytest.mark.parametrize("n,req", [(8, dict(tp=2)), (8, dict(tp=2, sp=2)),
                                   (4, dict(sp=2, tp=2)), (1, {}),
                                   (16, dict(pp=2, ep=2)), (8, dict(tp=3)),
                                   (4, dict(xx=1)), (4, dict(tp=0))])
def test_mesh_shape_for_unchanged(n, req):
    try:
        want = jax_mesh_shape_for(n, **req)
    except ValueError:
        with pytest.raises(ValueError):
            mesh_shape_for(n, **req)
        return
    assert mesh_shape_for(n, **req) == want


def _same(port, ref, *args):
    """Both functions' results, or both raise ValueError."""
    try:
        want = ref(*args)
    except ValueError:
        with pytest.raises(ValueError):
            port(*args)
        return None
    got = port(*args)
    assert got == want, args
    return got


def test_layout_functions_equal_jax_over_a_grid():
    for n_workers, n_devices, n_procs in itertools.product(
            range(1, 17), range(1, 9), range(1, 5)):
        _same(D.worker_device_count, jdist.worker_device_count, n_workers,
              n_devices, n_procs)
    for n_workers, size in itertools.product(range(1, 17), range(1, 5)):
        for rank in range(size):
            _same(D.local_worker_rows, jdist.local_worker_rows, n_workers,
                  rank, size)
    shapes = [mesh_shape_for(8, tp=2), mesh_shape_for(8, sp=2, tp=2),
              mesh_shape_for(8), mesh_shape_for(8, tp=8), dict(dp=3, tp=2),
              {"sp": 2, "tp": 2}]
    for shape, n_slices in itertools.product(shapes, (1, 2, 4)):
        _same(D.hybrid_mesh_shapes, jdist.hybrid_mesh_shapes, shape,
              n_slices, 8)
    for n in (1, 3, 8, 16):
        _same(D.local_batch_slice, jdist.local_batch_slice, n)


class _Dev:
    def __init__(self, i, p):
        self.id, self.process_index = i, p

    def __eq__(self, other):
        return (self.id, self.process_index) == (other.id,
                                                 other.process_index)


def test_pick_worker_devices_equals_jax():
    for n_procs, per in ((1, 8), (2, 4), (4, 2), (2, 2)):
        devs = [_Dev(i, i // per) for i in range(n_procs * per)]
        for n_workers in range(1, 17):
            _same(lambda *a: D.pick_worker_devices(*a),
                  lambda *a: jdist.pick_worker_devices(*a), n_workers, devs,
                  n_procs)


def test_hybrid_grid_lays_dp_across_hosts():
    """Two hosts of four ranks, dp=4 x tp=2: each host's ranks fill one
    (2, 2) block, the blocks stacked along dp (the rank grid of JAX's
    hybrid device mesh)."""
    hosts = ["a"] * 4 + ["b"] * 4
    names, ici, dcn = D.hybrid_mesh_shapes(mesh_shape_for(8, tp=2), 2, 8)
    grid = D.hybrid_grid(hosts, ici, dcn).reshape(4, 2)
    np.testing.assert_array_equal(grid, [[0, 1], [2, 3], [4, 5], [6, 7]])
    with pytest.raises(ValueError, match="ranks"):
        D.hybrid_grid(["a"] * 3 + ["b"] * 5, ici, dcn)


def test_init_distributed_is_a_no_op_alone(monkeypatch):
    for var in ("KUBEML_COORDINATOR", "KUBEML_NUM_PROCESSES",
                "KUBEML_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert D.init_distributed() is False
    assert D.init_distributed(num_processes=1) is False
    assert (D.process_count(), D.process_index(), D.num_slices(),
            D.local_device()) == (1, 0, 1, None)
    ctx = D.DistContext()
    assert ctx.broadcast_obj({"a": 1}) == {"a": 1}
    assert ctx.broadcast_flags(True, 3) == (True, 3)
    ctx.put("k", "v")
    assert ctx.get("k") == "v" and ctx.get("nope", timeout_s=0.05) is None
    ctx.barrier("alone")
    with pytest.raises(ValueError, match="KUBEML_PROCESS_ID"):
        D.init_distributed("localhost:1", 2)


def test_nccl_is_refused_for_two_ranks_on_one_device():
    with pytest.raises(ValueError, match="backend='gloo'"):
        D.rank_device("nccl", "cuda", local_rank=1, device_count=1)
    assert D.rank_device("nccl", "cuda", 0, 1) == torch.device("cuda", 0)
    # gloo ranks may share the card, round robin
    assert D.rank_device("gloo", "cuda", 3, 2) == torch.device("cuda", 1)
    assert D.rank_device("gloo", "cpu", 5, 0) == torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA ranks"):
        D.rank_device("nccl", "cpu", 0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.rank_device("gloo", "cuda", 0, 0)
    with pytest.raises(ValueError, match="unknown backend"):
        D.rank_device("mpi", "cpu", 0, 0)
