"""The port's sharded checkpoints (``storage/sharded_checkpoint.py``)
against the JAX package's, on the CPU.

A checkpoint the JAX store writes from the 8 host devices of
``tests/conftest.py`` at dp x tp slices restores in the port to leaves
equal to the originals, f32 and bf16 (bit for bit: nothing is computed);
one the port writes restores in JAX onto a mesh the same way. The
publication rules (an incomplete checkpoint is invisible, a resave stages
then republishes, a resave racing a restore is detected) and
``apply_remap_host`` are held to JAX's behaviour.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import kubeml_tpu_torch.storage.sharded_checkpoint as tsc
from kubeml_tpu.models.gpt_pipeline import flat_serving_remap
from kubeml_tpu.parallel.mesh import make_mesh
from kubeml_tpu.storage import sharded_checkpoint as jsc
from kubeml_tpu_torch.api.errors import CheckpointNotFoundError, StorageError
from kubeml_tpu_torch.storage.checkpoint import CheckpointStore


def host_tree():
    """f32 matrix and vector, a bf16 matrix, a scalar, an int leaf."""
    return {"params": {
        "dense": {"kernel": np.arange(64 * 32, dtype=np.float32
                                      ).reshape(64, 32) / 7.0,
                  "bias": np.linspace(-1, 1, 32, dtype=np.float32)},
        "h": (np.arange(16 * 8, dtype=np.float32).reshape(16, 8) / 3.0),
        "step": np.asarray(5, np.int32)}}


def jax_tree(mesh):
    t = host_tree()["params"]
    return {"params": {
        "dense": {"kernel": jax.device_put(t["dense"]["kernel"],
                                           NamedSharding(mesh, P("dp", "tp"))),
                  "bias": jax.device_put(t["dense"]["bias"],
                                         NamedSharding(mesh, P()))},
        "h": jax.device_put(t["h"].astype(jnp.bfloat16),
                            NamedSharding(mesh, P("dp", None))),
        "step": t["step"]}}


def as_numpy(leaf):
    """A port leaf as numpy, bf16 widened to f32 (exactly)."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return leaf.float().numpy()
    return np.asarray(leaf)


@pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2)])
def test_jax_written_restores_in_the_port(tmp_path, dp, tp):
    """Every slice of every leaf lands where JAX wrote it from."""
    mesh = make_mesh(dp=dp, tp=tp)
    tree = jax_tree(mesh)
    jsc.ShardedCheckpointStore(root=tmp_path).save(
        "job", tree, epoch=3, tag="ep00003", meta={"note": "x"})
    manifest = tsc.ShardedCheckpointStore(root=tmp_path).read_manifest(
        "job", "ep00003")
    assert len(manifest["leaves"]["params/dense/kernel"]["slices"]) == dp * tp
    ck = tsc.ShardedCheckpointStore(root=tmp_path).restore("job", "ep00003")
    assert (ck.epoch, ck.tag, ck.meta) == (3, "ep00003", {"note": "x"})
    got = ck.variables["params"]
    for path in (("dense", "kernel"), ("dense", "bias"), ("step",)):
        want = tree["params"]
        leaf = got
        for k in path:
            want, leaf = want[k], leaf[k]
        np.testing.assert_array_equal(leaf, np.asarray(want))
        assert leaf.dtype == np.asarray(want).dtype
    h = got["h"]
    assert isinstance(h, torch.Tensor) and h.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        as_numpy(h), np.asarray(tree["params"]["h"]).astype(np.float32))


def test_port_written_restores_in_jax_onto_a_mesh(tmp_path):
    """The port writes one whole slice a leaf (bf16 from a torch tensor);
    JAX restores it onto a dp 2 x tp 4 mesh and onto host numpy."""
    tree = host_tree()
    bf = torch.from_numpy(tree["params"]["h"]).to(torch.bfloat16)
    tree["params"]["h"] = bf
    tsc.ShardedCheckpointStore(root=tmp_path).save(
        "job", tree, epoch=2, tag="final", meta={"request": {"a": 1}})
    mesh = make_mesh(dp=2, tp=4)
    sh = {"params": {"dense": {"kernel": NamedSharding(mesh, P("dp", "tp")),
                               "bias": NamedSharding(mesh, P("tp"))},
                     "h": NamedSharding(mesh, P(None, "tp")),
                     "step": NamedSharding(mesh, P())}}
    jstore = jsc.ShardedCheckpointStore(root=tmp_path)
    placed = jstore.restore("job", "final", shardings=sh)
    host = jstore.restore("job", "final")
    assert placed.epoch == 2 and placed.meta == {"request": {"a": 1}}
    for ck in (placed, host):
        p = ck.variables["params"]
        np.testing.assert_array_equal(np.asarray(p["dense"]["kernel"]),
                                      tree["params"]["dense"]["kernel"])
        np.testing.assert_array_equal(np.asarray(p["dense"]["bias"]),
                                      tree["params"]["dense"]["bias"])
        assert np.asarray(p["h"]).dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(p["h"]).astype(np.float32),
                                      bf.float().numpy())
        assert int(np.asarray(p["step"])) == 5
    assert len(placed.variables["params"]["dense"]["kernel"]
               .addressable_shards) == 8


def test_incomplete_checkpoint_is_invisible(tmp_path, monkeypatch):
    """A save that dies before its manifest is published leaves nothing a
    reader can see: no tag, no job, restore is 'not found'."""
    store = tsc.ShardedCheckpointStore(root=tmp_path)
    real = tsc.os.replace

    def no_manifest(src, dst):
        if str(dst).endswith(tsc.MANIFEST):
            raise OSError("power cut")
        return real(src, dst)

    monkeypatch.setattr(tsc.os, "replace", no_manifest)
    with pytest.raises(OSError):
        store.save("inc", host_tree(), epoch=1, tag="final")
    monkeypatch.undo()
    assert (tmp_path / "inc" / "final.shards" / "shard-0.npz").exists()
    assert not store.exists("inc", "final")
    assert store.tags("inc") == [] and store.list_jobs() == []
    with pytest.raises(CheckpointNotFoundError):
        store.restore("inc", "final")
    # the JAX store sees the same nothing, and so does the flat probe
    assert jsc.ShardedCheckpointStore(root=tmp_path).tags("inc") == []
    assert CheckpointStore(root=tmp_path).sharded_mtime("inc", "final") is None


def test_resave_stages_then_republishes(tmp_path, monkeypatch):
    """A failure while staging leaves the old checkpoint restorable; a
    crash in the rename window reads as absent, never as mixed slices; a
    clean resave republishes (JAX ``test_resave_stages_then_republishes``)."""
    store = tsc.ShardedCheckpointStore(root=tmp_path)
    store.save("jobr", host_tree(), epoch=1, tag="latest")

    def fail(*a, **k):
        raise OSError("disk")

    monkeypatch.setattr(tsc.np, "savez", fail)
    with pytest.raises(OSError):
        store.save("jobr", host_tree(), epoch=2, tag="latest")
    monkeypatch.undo()
    assert store.read_manifest("jobr", "latest")["epoch"] == 1
    assert store.restore("jobr", "latest").epoch == 1
    assert not list((tmp_path / "jobr" / "latest.shards").glob(".shard-*"))

    monkeypatch.setattr(tsc.os, "replace", fail)
    with pytest.raises(OSError):
        store.save("jobr", host_tree(), epoch=2, tag="latest")
    monkeypatch.undo()
    assert not store.exists("jobr", "latest")
    assert store.tags("jobr") == []

    tree = host_tree()
    tree["params"]["dense"]["bias"] = tree["params"]["dense"]["bias"] + 1
    store.save("jobr", tree, epoch=2, tag="latest")
    ck = store.restore("jobr", "latest")
    assert ck.epoch == 2
    np.testing.assert_array_equal(ck.variables["params"]["dense"]["bias"],
                                  tree["params"]["dense"]["bias"])


def test_restore_detects_concurrent_resave(tmp_path, monkeypatch):
    """A resave that completes while a restore opens its shard files is
    detected (StorageError asking for a retry); the settled checkpoint
    then restores (JAX ``test_restore_detects_concurrent_resave``)."""
    store = tsc.ShardedCheckpointStore(root=tmp_path)
    store.save("racer", host_tree(), epoch=1, tag="final")
    real_get = tsc._ShardReaders.get
    fired = {}

    def racing_get(self, shard):
        if not fired:
            fired["x"] = True
            import time
            time.sleep(0.01)
            store.save("racer", host_tree(), epoch=2, tag="final")
        return real_get(self, shard)

    monkeypatch.setattr(tsc._ShardReaders, "get", racing_get)
    with pytest.raises(StorageError, match="replaced while a restore"):
        store.restore("racer", "final")
    monkeypatch.undo()
    assert store.restore("racer", "final").epoch == 2


def test_apply_remap_host_equals_jax(tmp_path):
    """The pipeline's stage-stacked leaves fan out into per-block leaves:
    ``apply_remap_host`` and a remapped restore give JAX's trees."""
    stacked = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    tree = {"params": {"stages": {"layer_0": {"w": stacked}},
                       "ln_f": {"scale": np.ones(4, np.float32)}}}
    remap = flat_serving_remap(stages=2, layers_per_stage=1)
    mine = tsc.apply_remap_host(tree, remap)
    theirs = jsc.apply_remap_host(tree, remap)
    assert set(mine["params"]) == set(theirs["params"]) == {
        "block_0", "block_1", "ln_f"}
    for b in ("block_0", "block_1"):
        np.testing.assert_array_equal(mine["params"][b]["w"],
                                      theirs["params"][b]["w"])
    store = tsc.ShardedCheckpointStore(root=tmp_path)
    store.save("pp", tree, epoch=1, tag="final")
    ck = store.restore("pp", "final", remap=remap)
    np.testing.assert_array_equal(ck.variables["params"]["block_1"]["w"],
                                  stacked[1])
    jck = jsc.ShardedCheckpointStore(root=tmp_path).restore(
        "pp", "final", remap=remap)
    np.testing.assert_array_equal(ck.variables["params"]["block_0"]["w"],
                                  jck.variables["params"]["block_0"]["w"])


def test_tags_jobs_delete_and_mtime(tmp_path):
    """``tags``/``list_jobs``/``delete`` and the flat store's
    ``sharded_mtime`` (the manifest's mtime) agree with the JAX store."""
    store = tsc.ShardedCheckpointStore(root=tmp_path)
    store.save("a", host_tree(), epoch=0, tag="ep00000")
    store.save("a", host_tree(), epoch=1, tag="final")
    jstore = jsc.ShardedCheckpointStore(root=tmp_path)
    assert store.tags("a") == jstore.tags("a") == ["ep00000", "final"]
    assert store.list_jobs() == jstore.list_jobs() == ["a"]
    assert (CheckpointStore(root=tmp_path).sharded_mtime("a", "final")
            == store.manifest_path("a", "final").stat().st_mtime_ns)
    store.delete("a", "ep00000")
    assert jstore.tags("a") == ["final"]
    with pytest.raises(CheckpointNotFoundError):
        store.delete("a", "ep00000")
    with pytest.raises(StorageError):
        store.exists("../x", "final")
