"""The port's ``CheckpointStore`` against the JAX package's, on the CPU.

The store behaviours of ``tests/test_checkpoint.py`` on the port; bfloat16
leaves through the torch bitcast (no ``ml_dtypes``); files written by one
package read by the other with equal leaves, names and dtypes; and GPT and
LeNet weights carried across in the Flax layout (``to_flax``,
``to_flax_variables``) with f32 logits within 1e-5."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeml_tpu.models.lenet import LeNet as JLeNet
from kubeml_tpu.storage.checkpoint import CheckpointStore as JStore
from kubeml_tpu_torch.api.errors import (CheckpointNotFoundError,
                                         StorageError)
from kubeml_tpu_torch.interop.from_flax import (from_flax,
                                                from_flax_variables, to_flax,
                                                to_flax_variables)
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.storage.checkpoint import (FINAL_TAG, CheckpointStore,
                                                 normalize_npz)
from torch_port_helpers import jax_init, jax_tiny, numpy_tree, torch_twin

F32_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tree(seed=0):
    """f32, bf16 (a torch tensor) and int64 leaves."""
    r = np.random.default_rng(seed)
    return {
        "params": {"dense": {
            "kernel": r.normal(size=(4, 3)).astype(np.float32),
            "bias": torch.from_numpy(r.normal(size=(3,)).astype(
                np.float32)).to(torch.bfloat16)}},
        "batch_stats": {"bn": {"count": np.array([7], np.int64)}},
    }


def flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def as_f64(v):
    if isinstance(v, torch.Tensor):
        return v.double().numpy()
    return np.asarray(v, np.float64)


def dtype_name(v):
    return str(v.dtype).replace("torch.", "")


def assert_tree_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert dtype_name(fa[k]) == dtype_name(fb[k]), k
        np.testing.assert_array_equal(as_f64(fa[k]), as_f64(fb[k]), err_msg=k)


@pytest.fixture
def store(tmp_path):
    return CheckpointStore(root=tmp_path / "ck")


# --- the store (tests/test_checkpoint.py:41-117, :206) ---


def test_save_restore_roundtrip(store):
    t = tree()
    store.save("jobabc", t, epoch=3, meta={"note": "hi"})
    ck = store.restore("jobabc")
    assert (ck.epoch, ck.meta, ck.job_id, ck.tag) == (3, {"note": "hi"},
                                                      "jobabc", "ep00003")
    assert_tree_equal(ck.variables, t)


def test_latest_and_explicit_epoch(store):
    store.save("j", tree(1), epoch=1)
    store.save("j", tree(2), epoch=2)
    assert store.latest_epoch("j") == 2
    assert store.epochs("j") == [1, 2]
    assert_tree_equal(store.restore("j", epoch=1).variables, tree(1))
    assert_tree_equal(store.restore("j").variables, tree(2))


def test_final_tag_preferred(store):
    store.save("j", tree(1), epoch=5)
    store.save("j", tree(9), epoch=6, tag=FINAL_TAG)
    assert_tree_equal(store.restore("j").variables, tree(9))
    assert store.tags("j") == ["ep00005", FINAL_TAG]


def test_missing_checkpoint_raises(store):
    for call in (lambda: store.restore("nope"), lambda: store.delete("nope"),
                 lambda: store.read_meta("nope", FINAL_TAG),
                 lambda: CheckpointStore.load_export(store.root / "x.npz")):
        with pytest.raises(CheckpointNotFoundError) as e:
            call()
        assert e.value.status_code == 404


def test_overwrite_same_tag(store):
    store.save("j", tree(1), epoch=0, tag=FINAL_TAG)
    store.save("j", tree(2), epoch=0, tag=FINAL_TAG)
    assert_tree_equal(store.restore("j", tag=FINAL_TAG).variables, tree(2))
    assert list((store.root / ".staging").iterdir()) == []


def test_export_single_file_roundtrip(store, tmp_path):
    store.save("j", tree(4), epoch=2, meta={"request": {"lr": 0.1}})
    out = store.export("j", tmp_path / "model")
    assert out == normalize_npz(tmp_path / "model") and out.exists()
    ck = CheckpointStore.load_export(out)
    assert ck.epoch == 2 and ck.meta["request"]["lr"] == 0.1
    assert_tree_equal(ck.variables, tree(4))


def test_list_and_delete(store):
    store.save("a", tree(), epoch=0)
    store.save("b", tree(), epoch=0)
    store.save("b", tree(), epoch=1)
    assert store.list_jobs() == ["a", "b"]
    store.delete("b", tag="ep00000")
    assert store.epochs("b") == [1]
    store.delete("a")
    assert store.list_jobs() == ["b"]


def test_prune_epochs_retention(store):
    for e in range(5):
        store.save("j", tree(e), epoch=e)
    store.save("j", tree(9), epoch=5, tag=FINAL_TAG)
    assert store.prune_epochs("j", keep=2) == 3
    assert store.epochs("j") == [3, 4]
    assert FINAL_TAG in store.tags("j")  # the final export is never pruned
    assert store.prune_epochs("j", keep=0) == 0  # 0 keeps all


@pytest.mark.parametrize("job_id,tag", [("", None), ("a/b", None),
                                        (".hidden", None), ("j", "a/b"),
                                        ("j", ".x")])
def test_invalid_ids_raise(store, job_id, tag):
    with pytest.raises(StorageError):
        store.save(job_id, tree(), tag=tag)
    assert not list(store.root.glob("*/*.npz"))


def test_read_meta_reads_no_weights(store):
    store.save("j", tree(), epoch=4, tag=FINAL_TAG, meta={"k": 1})
    rec = store.read_meta("j", FINAL_TAG)
    assert (rec["epoch"], rec["meta"], rec["tag"]) == (4, {"k": 1}, FINAL_TAG)
    assert rec["dtypes"] == {"batch_stats/bn/count": "int64",
                             "params/dense/bias": "bfloat16",
                             "params/dense/kernel": "float32"}


def test_bf16_bitcast_is_exact(store):
    """bfloat16 travels as its 16-bit patterns: every value of a tensor
    that covers the patterns' range comes back bit for bit, as a CPU bf16
    tensor, under the dtype string "bfloat16"."""
    bits = np.arange(0, 65536, 7, dtype=np.uint16)
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    store.save("b", {"x": t}, epoch=0)
    back = store.restore("b").variables
    assert back["x"].dtype == torch.bfloat16
    assert np.array_equal(back["x"].view(torch.int16).numpy().view(np.uint16),
                          bits)
    with np.load(store.export_path("b")) as z:
        assert z["x"].dtype == np.uint16


# --- across the two packages ---


def jax_tree(seed=0):
    """``tree`` with the bf16 leaf as an ml_dtypes array (the JAX side)."""
    t = tree(seed)
    t["params"]["dense"]["bias"] = t["params"]["dense"]["bias"].float(
        ).numpy().astype(ml_dtypes.bfloat16)
    return t


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_load_in_the_other_package(tmp_path, writer):
    """One file, both readers: equal leaves, names, dtypes, epoch and
    meta, whichever package wrote it."""
    root = tmp_path / "ck"
    meta = {"request": {"function_name": "f"}, "history": {"x": [1.0]}}
    if writer == "jax":
        JStore(root=root).save("j", jax_tree(3), epoch=2, tag=FINAL_TAG,
                               meta=meta)
    else:
        CheckpointStore(root=root).save("j", tree(3), epoch=2, tag=FINAL_TAG,
                                        meta=meta)
    mine = CheckpointStore(root=root).restore("j")
    theirs = JStore(root=root).restore("j")
    assert (mine.epoch, mine.meta, mine.tag) == (theirs.epoch, theirs.meta,
                                                 theirs.tag)
    assert_tree_equal(mine.variables, tree(3))
    fm, ft = flat(mine.variables), flat(theirs.variables)
    assert sorted(fm) == sorted(ft)
    for k in fm:
        assert dtype_name(fm[k]) == str(ft[k].dtype), k
        np.testing.assert_array_equal(as_f64(fm[k]), np.asarray(ft[k],
                                                                np.float64))


def test_gpt_logits_equal_across_packages(tmp_path):
    """A port GPT saved in the Flax layout (``to_flax``) serves the JAX
    module with equal logits, and the JAX-saved tree loads back into a
    fresh port module (``from_flax``) with equal logits."""
    jm = jax_tiny(max_len=32)
    tm = torch_twin(jm, jax_init(jm, seed=5))
    with torch.no_grad():  # move the weights off the Flax init
        for p in tm.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    ids = np.random.default_rng(0).integers(1, 101, size=(2, 12)).astype(
        np.int32)
    with torch.no_grad():
        want = tm(torch.from_numpy(ids)).numpy()
    root = tmp_path / "ck"
    CheckpointStore(root=root).save("gpt", to_flax(tm.state_dict()),
                                    tag=FINAL_TAG)
    jvars = JStore(root=root).restore("gpt").variables
    assert jax.tree.structure(jvars) == jax.tree.structure(
        numpy_tree(jax_init(jm)))
    got = np.asarray(jm.apply(jvars, ids, train=False))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    JStore(root=root).save("gpt2", jvars, tag=FINAL_TAG)
    fresh = torch_twin(jm, jax_init(jm, seed=6))
    from kubeml_tpu_torch.models.layers import load_tree

    load_tree(fresh, from_flax(CheckpointStore(root=root).restore(
        "gpt2").variables))
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(ids)).numpy(),
                                      want)


def test_lenet_logits_equal_across_packages(tmp_path):
    """LeNet's variables (conv kernels OIHW in the port, HWIO in Flax)
    through ``to_flax_variables`` give the Flax module equal logits, and
    ``from_flax_variables`` inverts it exactly."""
    tm = LeNet(num_classes=10)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    x = np.random.default_rng(1).normal(size=(3, 28, 28, 1)).astype(
        np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    variables = {"params": dict(tm.named_parameters())}
    root = tmp_path / "ck"
    CheckpointStore(root=root).save("lenet", to_flax_variables(variables),
                                    tag=FINAL_TAG)
    jvars = JStore(root=root).restore("lenet").variables
    assert jvars["params"]["Conv_0"]["kernel"].shape == (5, 5, 1, 6)
    got = np.asarray(JLeNet(num_classes=10).apply(jvars, x, train=False))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    back = from_flax_variables(CheckpointStore(root=root).restore(
        "lenet").variables)
    for name, p in tm.named_parameters():
        assert torch.equal(back["params"][name], p.detach()), name
