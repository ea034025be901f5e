"""The port's K-AVG over ranks (``engine/kavg.py`` and ``engine/job.py``
over a ``DistContext``, ``data/loader.py``'s ``worker_rows``) against the
JAX package's K-AVG on its 8 host devices.

Two gloo ranks on the CPU hold N 4 workers, two a rank, and are held
against JAX's ``KAvgTrainer`` and ``TrainJob`` at N 4 in this process;
the ranks run in ``tests/torch_kavg_ranks.py``, which imports no JAX. The
same numpy inputs and one Flax init (through ``interop.from_flax``) go to
both packages. Tolerances as ``tests/test_torch_kavg.py``'s: f32 weights
within 1e-4 absolute and round losses within 1e-5 relative (the ranks sum
the merge in another order than JAX); the round statistics' spread within
1e-5 absolute and divergence within 1e-4 relative; host-side slabs, plans
and chaos masks exactly equal, and the ranks' replicas bit-equal. The
jobs as ``tests/test_torch_train_job.py``'s: epoch losses within 1e-4
relative, validation accuracy within one test sample, validation loss
within 1e-3 relative, and the final weights within 1e-3 absolute (three
epochs of momentum SGD grow the rounds' 1e-7 differences).
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
import torch_kavg_ranks as K
from kubeml_tpu.api import types as jtypes
from kubeml_tpu.api.config import Config as JConfig
from kubeml_tpu.data import loader as jloader
from kubeml_tpu.data import sharding as jsharding
from kubeml_tpu.engine import failures as jfailures
from kubeml_tpu.engine.job import TrainJob as JTrainJob
from kubeml_tpu.engine.kavg import KAvgTrainer as JTrainer
from kubeml_tpu.models.lenet import LeNet as JLeNet
from kubeml_tpu.storage import CheckpointStore as JCheckpointStore
from kubeml_tpu.storage import HistoryStore as JHistoryStore
from kubeml_tpu.storage import ShardStore as JShardStore
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.data import loader as tloader
from kubeml_tpu_torch.data import sharding as tsharding
from kubeml_tpu_torch.engine.kavg import KAvgTrainer, worker_mesh
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.interop.from_flax import from_flax_variables
from kubeml_tpu_torch.storage import CheckpointStore, ShardStore
from test_job import synthetic_mnist
from test_torch_kavg import LOSS_RTOL, W_ATOL, JaxNet, _slab
from test_torch_train_job import JaxLeNet

N, WORLD = 4, 2
SPREAD_ATOL, DIV_RTOL = 1e-5, 1e-4
JOB_LOSS_RTOL, JOB_W_ATOL, TEST_SAMPLES = 1e-4, 1e-3, 128
JID = "kavg-ranks"
# the scheduler's answers after each epoch over the ranks (3 rounds to 2)
# and what JAX's one process is fed
LEVELS, JAX_LEVELS = [3, 4, 4], [2, 4, 4]


def _np(tree):
    return {c: {k: np.asarray(v) for k, v in leaves.items()}
            for c, leaves in tree.items()}


def _rounds():
    """Global N 4 slabs: a clean round; worker 1 masked; only rank 1's
    rows hold data; no participant anywhere; workers 0 and 3 masked.
    Rounds 2, 4 and 5 pass the plan's data_bearing, 1 and 3 leave the
    ranks to sum their flags."""
    out = []
    for i in range(5):
        x, y, m = _slab(N, 10 + i)
        r = dict(x=x, y=y, m=m)
        if i == 1:
            r["worker_mask"] = np.array([1, 0, 1, 1], np.float32)
        if i == 2:
            m[:2] = 0.0
        if i == 3:
            m[:] = 0.0
        if i == 4:
            r["worker_mask"] = np.array([0, 1, 1, 0], np.float32)
        if i in (1, 3, 4):
            r["data_bearing"] = m.reshape(N, -1).sum(1) > 0
        out.append(r)
    return out


@pytest.fixture(scope="module")
def trainer_runs():
    """JAX's rounds at N 4 and the two ranks' (one spawn), and the port's
    one-rank dropout rounds at N 4."""
    j = JTrainer(JaxNet(), precision="f32", devices=jax.devices()[:1],
                 donate=False)
    jv = j.init_variables(jax.random.PRNGKey(0), _slab(1, 0)[0][0, 0], N)
    init = _np(from_flax_variables(j.reference_variables(jv)))
    rounds = _rounds()
    want = []
    for i, r in enumerate(rounds):
        jv, loss = j.sync_round(jv, r["x"], r["y"], r["m"],
                                jax.random.PRNGKey(i), lr=0.1,
                                worker_mask=r.get("worker_mask"))
        want.append(dict(
            loss=float(loss), stats=np.asarray(j.last_round_stats).tolist(),
            ref=_np(from_flax_variables(j.reference_variables(jv)))))
    ex, ey, em = _slab(N, 30)
    em[3, 1, 1:] = 0.0
    em[1] = 0.0
    jeval = j.evaluate(jv, ex, ey, em)
    # the dropout model: one rank's trainer at N 4 is the reference
    torch.manual_seed(0)
    d = KAvgTrainer(K.DropViT(), precision="f32", device="cpu")
    drop_init = _np(d.reference_variables(d.init_variables(0, None, 1)))
    drop_rounds = []
    for i in range(2):
        x = np.random.default_rng(40 + i).normal(
            size=(N, 2, 4, 8, 8, 3)).astype(np.float32)
        y = np.random.default_rng(50 + i).integers(
            0, 4, size=(N, 2, 4)).astype(np.int64)
        drop_rounds.append(dict(x=x, y=y, m=np.ones((N, 2, 4), np.float32),
                                rng=7 + i))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks
    try:
        dv = d.place_reference(drop_init, N)
        _, drop_want = K.run_rounds(d, dv, drop_rounds, (0, N))
    finally:
        torch.set_num_threads(threads)
    ranks = R.run(K.trainer_rank, WORLD, dict(
        n=N, init=init, rounds=rounds, eval=dict(x=ex, y=ey, m=em),
        drop_init=drop_init, drop_rounds=drop_rounds))
    return dict(want=want, jeval=jeval, ranks=ranks, drop_want=drop_want)


def _row0(rows: dict) -> dict:
    return {k: v[0].numpy() for k, v in rows.items()}


def _replicas_bit_equal(ranks, i):
    """Every row of every rank holds the same bits after round ``i``."""
    first = ranks[0]["rounds"][i]["rows"]
    for rk in ranks:
        for k, v in rk["rounds"][i]["rows"].items():
            assert torch.equal(v, first[k][:1].expand_as(v)), (i, k)


@pytest.mark.parametrize("i", range(5), ids=[
    "clean", "masked_worker", "rank1_rows_only", "no_participant",
    "two_masked"])
def test_rounds_over_ranks_match_jax(trainer_runs, i):
    """Each round over two ranks is JAX's one round over all N workers:
    the merged weights, the loss and the round statistics; the replicas
    bit-equal on both ranks."""
    want = trainer_runs["want"][i]
    ranks = trainer_runs["ranks"]
    assert [r["rows"] for r in ranks] == [(0, 2), (2, 4)]
    _replicas_bit_equal(ranks, i)
    for rk in ranks:
        got = rk["rounds"][i]
        if i == 3:
            assert np.isnan(got["loss"]) and np.isnan(want["loss"])
            assert all(np.isnan(got["stats"])) and all(np.isnan(want["stats"]))
        else:
            assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
            assert got["stats"][0] == pytest.approx(want["stats"][0],
                                                    abs=SPREAD_ATOL)
            assert got["stats"][1] == pytest.approx(want["stats"][1],
                                                    rel=DIV_RTOL)
        ref = _row0(got["rows"])
        for coll, leaves in want["ref"].items():
            for k, w in leaves.items():
                np.testing.assert_allclose(ref[f"{coll}/{k}"], w,
                                           atol=W_ATOL, rtol=0,
                                           err_msg=f"round {i} {coll}/{k}")
    if i == 3:
        # the weights kept their pre-round value
        before = ranks[0]["rounds"][2]["rows"]
        for k, v in ranks[0]["rounds"][3]["rows"].items():
            assert torch.equal(v, before[k])


def test_evaluation_and_worker_cap_over_ranks(trainer_runs):
    """The masked sums of both ranks' rows, summed over the ranks, give
    JAX's global evaluation; a worker cap below the world raises JAX's
    error on every rank."""
    ja, jl = trainer_runs["jeval"]
    for rk in trainer_runs["ranks"]:
        ta, tl = rk["eval"]
        assert ta == pytest.approx(ja, abs=1e-6)
        assert tl == pytest.approx(jl, rel=LOSS_RTOL)
        assert rk["device"] == "cpu"
        assert "process 1 has 0 devices, need 1" in rk["cap_error"]
    assert trainer_runs["ranks"][0]["eval"] == trainer_runs["ranks"][1]["eval"]


def test_dropout_seeds_take_the_global_worker_index(trainer_runs):
    """A dropout model over two ranks equals one rank's trainer at the
    same N: rank 1's workers 2 and 3 draw worker 2's and 3's masks."""
    want = trainer_runs["drop_want"]
    for rk in trainer_runs["ranks"]:
        for w, g in zip(want, rk["drop"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-6)
            got, ref = _row0(g["rows"]), _row0(w["rows"])
            for k, v in ref.items():
                np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0,
                                           err_msg=k)


def test_worker_mesh_splits_the_axis_by_rank():
    """JAX's layout math: contiguous blocks a rank, an even split."""
    assert [d.process_index for d in worker_mesh(4, n_procs=1)] == [0]
    devs = [type("D", (), {"process_index": p})() for p in (0, 0, 1, 1)]
    assert [d.process_index for d in worker_mesh(4, devs, 2)] == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="multiple of the 2 host processes"):
        worker_mesh(3, devs, 2)


# --- the loader ---------------------------------------------------------------

@pytest.mark.parametrize("rows", [(0, 2), (2, 4), (3, 4), (1, 3)])
def test_worker_rows_slabs_equal_jax_and_the_full_slab(rows, tmp_path):
    """A rank's slab is JAX's ``build_round(worker_rows=)`` and exactly
    those rows of the full slab; an exhausted block is zeros, mask 0."""
    xtr, ytr = synthetic_mnist(700, seed=1)
    JShardStore(root=tmp_path).create("ds", xtr, ytr, xtr[:64], ytr[:64])
    jh, th = JShardStore(root=tmp_path).get("ds"), ShardStore(
        root=tmp_path).get("ds")

    def tf(x, y):
        return x.astype(np.float32) * 0.5, y

    jp = jsharding.plan_epoch(jh.num_subsets("train"), 4, 32, 2,
                              num_samples=700)
    tp = tsharding.plan_epoch(th.num_subsets("train"), 4, 32, 2,
                              num_samples=700)
    exhausted = 0
    for r in range(tp.num_rounds):
        full = tloader.build_round(th, "train", tp, r, tf)
        got = tloader.build_round(th, "train", tp, r, tf, worker_rows=rows)
        want = jloader.build_round(jh, "train", jp, r, tf, worker_rows=rows)
        assert got.worker_rows == want.worker_rows == rows
        for f in ("x", "y", "mask"):
            a = getattr(got, f)
            np.testing.assert_array_equal(a, getattr(want, f))
            np.testing.assert_array_equal(a, getattr(full, f)[rows[0]:rows[1]])
            assert a.dtype == getattr(want, f).dtype
        exhausted += not got.mask.any()
    if rows == (3, 4):
        assert exhausted == 1  # the last round: worker 3 holds no data
    loaded = list(tloader.RoundLoader(th, "train", tp, transform=tf,
                                      worker_rows=rows))
    assert [rb.worker_rows for rb in loaded] == [rows] * tp.num_rounds
    val = list(tloader.validation_loader(th, 4, 16, worker_rows=rows))
    jval = list(jloader.validation_loader(jh, 4, 16, worker_rows=rows))
    assert len(val) == len(jval)
    for a, b in zip(val, jval):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.mask, b.mask)


# --- the job through the cluster ----------------------------------------------

@pytest.fixture(scope="module")
def job_runs(tmp_path_factory):
    """JAX's jobs in this process and the ranks' through the cluster (one
    spawn): job A (parallelism 4, chaos, validation and a checkpoint every
    epoch, the scheduler's answers) and job B (A resumed for a fourth
    epoch at a requested parallelism of 3)."""
    tmp = tmp_path_factory.mktemp("kavg_ranks")
    jcfg = JConfig(data_root=tmp / "jax")
    pcfg = Config(data_root=tmp / "port")
    for cfg in (jcfg, pcfg):
        cfg.ensure_dirs()
    JShardStore(config=jcfg).create("mnist", *synthetic_mnist(640, seed=1),
                                    *synthetic_mnist(TEST_SAMPLES, seed=2))
    shutil.copytree(jcfg.datasets_dir, pcfg.datasets_dir, dirs_exist_ok=True)
    init = from_flax_variables(jax.tree.map(np.asarray, JLeNet(
        num_classes=10).init(jax.random.PRNGKey(0),
                             np.zeros((1, 28, 28, 1), np.float32))))
    npz = tmp / "lenet-init.npz"
    np.savez(npz, **{f"{c}/{k}": np.asarray(v) for c, leaves in init.items()
                     for k, v in leaves.items()})
    FunctionRegistry(config=pcfg).create("lenet", K.LENET_FN % str(npz))
    probe = synthetic_mnist(8, seed=9)[0]
    a_opts = dict(default_parallelism=4, chaos_prob=0.25, validate_every=1,
                  checkpoint_every=1)
    b_opts = dict(default_parallelism=3, static_parallelism=True,
                  validate_every=1, resume=True)
    ranks = R.run(K.cluster_rank, WORLD, dict(root=str(tmp / "port"), jobs=[
        dict(id=JID, key="a", epochs=3, opts=a_opts, levels=LEVELS,
             probe=probe, infer=probe),
        dict(id=JID, key="b", epochs=4, opts=b_opts)]))
    # JAX's jobs, its chaos masks recorded
    masks = []
    draw = jfailures.FailureInjector.mask

    def mask(obj, n):
        m = draw(obj, n)
        masks.append(m.copy())
        return m

    jfailures.FailureInjector.mask = mask
    try:
        def jax_job(epochs, opts, levels=None):
            req = jtypes.TrainRequest(
                model_type="lenet", batch_size=32, epochs=epochs,
                dataset="mnist", lr=0.05, function_name="lenet",
                options=jtypes.TrainOptions(precision="f32", k=2, **opts))
            job = JTrainJob(JID, req, JaxLeNet(),
                            store=JShardStore(config=jcfg),
                            history_store=JHistoryStore(config=jcfg),
                            checkpoint_store=JCheckpointStore(config=jcfg),
                            on_epoch_end=(lambda s: levels.pop(0))
                            if levels else None)
            return job.train(), job

        ja, jjob = jax_job(3, a_opts, list(JAX_LEVELS))
        jb, jjob_b = jax_job(4, dict(b_opts, default_parallelism=2))
    finally:
        jfailures.FailureInjector.mask = draw
    return dict(ranks=ranks, ja=ja, jb=jb, jfinal=(
        jjob.final_variables, jjob_b.final_variables), jmasks=masks,
        pcfg=pcfg, probe=probe)


def _check_final(got, want):
    """A port final (the port's layout) against a JAX final (Flax's)."""
    for coll, leaves in from_flax_variables(
            jax.tree.map(np.asarray, want)).items():
        for k, w in leaves.items():
            np.testing.assert_allclose(got[coll][k], w.numpy(),
                                       atol=JOB_W_ATOL, rtol=0,
                                       err_msg=f"{coll}/{k}")


def test_job_over_ranks_matches_jax(job_runs):
    """Job A over two ranks: the parallelism trace with JAX's rounding
    note, the epoch and validation losses, the accuracy and the final
    weights of JAX's job fed the rounded answers; the same chaos masks;
    the history read back through JAX's HistoryStore."""
    lead = job_runs["ranks"][0]
    a, ja = lead["jobs"]["a"], job_runs["ja"]
    assert a["error"] is None and a["status"] == "finished"
    assert ja.parallelism == a["parallelism"] == [4, 2, 4]
    assert a["asked"] == [4, 2, 4]
    assert a["notes"] == ["epoch 1: scheduler parallelism 3 rounded to 2 "
                          "(multiple of 2 host processes)"]
    np.testing.assert_allclose(a["train_loss"], ja.train_loss,
                               rtol=JOB_LOSS_RTOL)
    np.testing.assert_allclose(a["validation_loss"], ja.validation_loss,
                               rtol=1e-3)
    for x, y in zip(a["accuracy"], ja.accuracy):
        assert abs(x - y) <= 100.0 / TEST_SAMPLES + 1e-6
    got = JHistoryStore(config=JConfig(
        data_root=job_runs["pcfg"].data_root)).get(JID)
    assert got.parallelism[:3] == [4, 2, 4]
    # every rank drew JAX's masks, in lockstep
    r0, r1 = (r["masks"] for r in job_runs["ranks"])
    jm = job_runs["jmasks"]
    assert len(r0) == len(r1) == len(jm) > 0
    for x, y, z in zip(r0, r1, jm):
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(y, z)
    assert any(m.min() == 0.0 for m in r0)
    # the final weights: JAX's, and the export the leader wrote of them
    # (job B's final replaced it on disk)
    _check_final(a["final"], job_runs["jfinal"][0])
    final = CheckpointStore(config=job_runs["pcfg"]).restore(JID, tag="final")
    assert final.epoch == 4


def test_job_over_ranks_leader_writes_serves_and_resumes(job_runs):
    """Only the leader writes checkpoints and the history; /infer answers
    409 before the first checkpoint, then from the newest checkpoint, and
    the finished job's final serves through the parameter server; job B
    resumes over the ranks from A's final with the requested parallelism
    rounded, and its fourth epoch matches JAX's resumed job."""
    lead, follower = job_runs["ranks"]
    assert follower["jobs_followed"] == 2
    assert follower["checkpoint_saves"] == 0 and follower["history_saves"] == 0
    # job A's three epochs and its final, job B's final
    assert lead["checkpoint_saves"] == 3 + 1 + 1
    assert lead["history_saves"] >= 2
    a, b = lead["jobs"]["a"], lead["jobs"]["b"]
    first, second = a["probes"][:2]
    assert first[0] == 409 and "has no checkpoint yet" in first[1]
    # the second probe serves epoch 1's checkpoint
    ck = CheckpointStore(config=job_runs["pcfg"]).restore(JID, epoch=0)
    trainer = KAvgTrainer(K.Lenet(), precision="f32", device="cpu")
    want = trainer.infer_replica(
        {c: {k: torch.as_tensor(v) for k, v in leaves.items()}
         for c, leaves in from_flax_variables(
             ck.variables, trainer.model.module).items()},
        job_runs["probe"])
    np.testing.assert_array_equal(second, want)
    np.testing.assert_array_equal(a["served"], a["job_infer"])
    # job B: resumed over the ranks
    jb = job_runs["jb"]
    assert b["error"] is None and b["parallelism"] == [4, 2, 4, 2]
    assert b["train_loss"][:3] == a["train_loss"]
    assert b["notes"] == ["requested parallelism 3 rounded to 2 (must be a "
                          "multiple of the 2 host processes)"] + a["notes"]
    np.testing.assert_allclose(b["train_loss"][3], jb.train_loss[3],
                               rtol=JOB_LOSS_RTOL)
    np.testing.assert_allclose(b["validation_loss"][3],
                               jb.validation_loss[3], rtol=1e-3)
    _check_final(b["final"], job_runs["jfinal"][1])


@pytest.mark.parametrize("asked,got", [(3, 2), (1, 2), (4, 4)])
def test_job_over_ranks_rounds_parallelism_and_refuses_custom_chaos(
        asked, got, tmp_path):
    """Over two ranks the requested parallelism becomes a multiple of the
    ranks, at least one a rank, with JAX's note; the heartbeat is stamped
    at construction; an injector passed in is refused (it would draw on
    one rank only)."""
    from types import SimpleNamespace

    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.engine.failures import FailureInjector
    from kubeml_tpu_torch.engine.job import TrainJob
    from kubeml_tpu_torch.storage import HistoryStore

    dist = SimpleNamespace(size=2, rank=0, is_leader=True)

    def job(**kw):
        req = TrainRequest(batch_size=32, epochs=1, dataset="mnist",
                           options=TrainOptions(default_parallelism=asked))
        return TrainJob("j", req, K.Lenet(),
                        store=ShardStore(root=tmp_path / "d"),
                        history_store=HistoryStore(root=tmp_path / "h"),
                        device="cpu", dist=dist, **kw)

    j = job()
    assert j.parallelism == got and j.trainer.local_rows(got) == (0, got // 2)
    assert j.heartbeat > 0 and j.heartbeat_cold
    want = ([] if asked == got else [
        f"requested parallelism {asked} rounded to {got} (must be a "
        f"multiple of the 2 host processes)"])
    assert j.history.notes == want
    with pytest.raises(ValueError, match="custom chaos injectors"):
        job(chaos=FailureInjector(prob=0.5, seed=1))
