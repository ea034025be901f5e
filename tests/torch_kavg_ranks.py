"""Rank functions for ``tests/test_torch_kavg_ranks.py``: K-AVG over gloo
ranks on the CPU.

Spawned ranks import this module to find their function, so it imports
torch and the port only, never JAX. A rank writes what the test checks to
``{out}/rank{r}.pt``; :func:`torch_dist_ranks.run` reads them back.

* :func:`trainer_rank` runs ``KAvgTrainer(dist=)`` rounds on this rank's
  block of the global slabs, then a dropout model's rounds;
* :func:`cluster_rank` runs K-AVG jobs through the parameter server of a
  ``LocalCluster`` on rank 0, the other ranks following
  (``engine.follower.run_follower``), as ``kubeml start`` runs them.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import (JobState, TrainOptions, TrainRequest,
                                        TrainTask)
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.parallel import distributed as D
from kubeml_tpu_torch.runtime.model import KubeModel


# the small ResNet of tests/test_torch_kavg.py (f32, SGD momentum 0.9)
class SmallResNet(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("fake"))

    def build(self):
        from kubeml_tpu_torch.models import resnet

        return resnet.ResNet([1, 1], resnet.BasicBlock, num_classes=4,
                             num_filters=4)

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)


class DropViT(KubeModel):
    """tests/test_torch_dropout.py's tiny ViT with dropout 0.3."""

    def __init__(self):
        super().__init__(KubeDataset("synthetic"))

    def build(self):
        from kubeml_tpu_torch.models.vit import ViT

        return ViT(num_classes=4, patch_size=4, embed_dim=16, depth=1,
                   num_heads=1, dropout=0.3, in_shape=(8, 8, 3))

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)


class Mnist(KubeDataset):
    def __init__(self):
        super().__init__("mnist")

    def transform(self, x, y):
        return x.astype(np.float32), y


class Lenet(KubeModel):
    """The job tests' LeNet (LENET_FN's model without its init)."""

    def __init__(self):
        super().__init__(Mnist())

    def build(self):
        from kubeml_tpu_torch.models.lenet import LeNet

        return LeNet(num_classes=10, in_shape=(28, 28, 1))


def _save(out: str, rank: int, result) -> None:
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def _stacked(trainer, v) -> dict:
    """Every local row of every leaf, on the host."""
    return {f"{c}/{k}": t.detach().cpu().clone() for c, leaves in v.items()
            for k, t in leaves.items()}


def run_rounds(trainer, variables, rounds, rows):
    """``rounds`` (dicts of the global slabs and a round's options) on
    this rank's ``rows`` block; per round the loss, the round statistics
    and every local row of the merged variables."""
    a, b = rows
    out = []
    for r in rounds:
        variables, loss = trainer.sync_round(
            variables, r["x"][a:b], r["y"][a:b], r["m"][a:b], lr=0.1,
            worker_mask=r.get("worker_mask"), rng=r.get("rng"),
            data_bearing=r.get("data_bearing"))
        stats = trainer.last_round_stats
        out.append(dict(loss=float(loss),
                        stats=None if stats is None else stats.tolist(),
                        rows=_stacked(trainer, variables)))
    return variables, out


def trainer_rank(rank: int, out: str, spec: dict) -> None:
    """The small ResNet's rounds over the ranks from ``spec["init"]``
    (at ``spec["n"]`` global workers), its evaluation of ``spec["eval"]``,
    the error of a ``worker`` cap below the world, then the dropout
    model's rounds from ``spec["drop_init"]``."""
    from kubeml_tpu_torch.engine.kavg import KAvgTrainer

    assert D.init_distributed(device="cpu")
    n = spec["n"]
    res = {}
    t = KAvgTrainer(SmallResNet(), precision="f32")
    rows = t.local_rows(n)
    v = t.place_reference(spec["init"], n)
    v, res["rounds"] = run_rounds(t, v, spec["rounds"], rows)
    e = spec["eval"]
    res["eval"] = t.evaluate(v, e["x"][rows[0]:rows[1]],
                             e["y"][rows[0]:rows[1]],
                             e["m"][rows[0]:rows[1]])
    res["rows"], res["device"] = rows, str(t.device)
    try:
        KAvgTrainer(SmallResNet(), precision="f32",
                    mesh_shape={"worker": 1}).local_rows(n)
        res["cap_error"] = None
    except ValueError as err:
        res["cap_error"] = str(err)
    d = KAvgTrainer(DropViT(), precision="f32")
    dv = d.place_reference(spec["drop_init"], n)
    _, res["drop"] = run_rounds(d, dv, spec["drop_rounds"], rows)
    _save(out, rank, res)


# --- jobs through the cluster -----------------------------------------------

# LeNet on tests/test_job.py's synthetic MNIST, its initial weights read
# from the npz beside the data root (the Flax init both packages start
# from); format with the npz's path
LENET_FN = """
import numpy as np
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.runtime.model import KubeModel


class Mnist(KubeDataset):
    def __init__(self):
        super().__init__("mnist")

    def transform(self, x, y):
        return x.astype(np.float32), y


class Model(KubeModel):
    def __init__(self):
        super().__init__(Mnist())

    def build(self):
        return LeNet(num_classes=10, in_shape=(28, 28, 1))

    def init(self, generator, sample_x=None):
        with np.load(%r) as z:
            tree = {}
            for key in z.files:
                coll, name = key.split("/", 1)
                tree.setdefault(coll, {})[name] = z[key]
        return tree

    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr, momentum=0.9)
"""


def request(job_id: str, epochs: int, **opts) -> TrainRequest:
    """The job tests' K-AVG request: LeNet, B 32, K 2, lr 0.05, f32."""
    opts.setdefault("precision", "f32")
    opts.setdefault("k", 2)
    return TrainRequest(model_type="lenet", batch_size=32, epochs=epochs,
                        dataset="mnist", lr=0.05, function_name="lenet",
                        job_id=job_id, options=TrainOptions(**opts))


class _Counted:
    """Counts the calls of a method on its class (every instance)."""

    def __init__(self, cls, name: str):
        self.calls = 0
        fn = getattr(cls, name)

        def counted(obj, *a, **kw):
            self.calls += 1
            return fn(obj, *a, **kw)

        setattr(cls, name, counted)


def _recorded_masks(masks: list) -> None:
    """Keep every chaos mask this rank's jobs draw."""
    from kubeml_tpu_torch.engine.failures import FailureInjector

    draw = FailureInjector.mask

    def mask(obj, n):
        m = draw(obj, n)
        masks.append(m.copy())
        return m

    FailureInjector.mask = mask


def run_job(ps, spec: dict) -> dict:
    """One job through the leader's parameter server: ``spec`` holds its
    id, epochs and options, ``levels`` (the stubbed scheduler's answers),
    ``probe`` (inputs to ask ``/infer`` with at every epoch's end) and
    ``infer`` (inputs to ask once the job is done)."""
    levels = list(spec.get("levels", ()))
    asked, probes = [], []
    jid = spec["id"]

    def answer(job_id, state):
        asked.append(state.parallelism)
        if spec.get("probe") is not None:
            try:
                probes.append(np.asarray(ps.infer(jid, spec["probe"])))
            except KubeMLError as e:
                probes.append((e.status_code, e.message))
        return levels.pop(0) if levels else state.parallelism

    ps._epoch_end = answer
    task = TrainTask(job_id=jid, state=JobState(),
                     parameters=request(jid, spec["epochs"], **spec["opts"]))
    ps.start_task(task)
    with ps._lock:
        job = ps._jobs[jid].job
    assert ps.wait(jid, timeout=240), f"job {jid} hung"
    h = ps.history_store.get(jid)
    out = dict(train_loss=list(h.train_loss),
               validation_loss=list(h.validation_loss),
               accuracy=list(h.accuracy), parallelism=list(h.parallelism),
               notes=list(h.notes), error=(h.task or {}).get("error"),
               status=str(task.status), asked=asked, probes=probes)
    out["final"] = job.final_variables
    if spec.get("infer") is not None:
        out["served"] = np.asarray(ps.infer(jid, spec["infer"]))
        out["job_infer"] = np.asarray(job.infer(np.asarray(spec["infer"])))
    return out


def cluster_rank(rank: int, out: str, spec: dict) -> None:
    """Rank 0 runs ``spec["jobs"]`` one after another through a
    ``LocalCluster``'s parameter server and stops it; the others follow.
    Every rank records the chaos masks its jobs drew and how often it
    wrote a checkpoint and a history."""
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.engine.follower import run_follower
    from kubeml_tpu_torch.storage.checkpoint import CheckpointStore
    from kubeml_tpu_torch.storage.history import HistoryStore

    assert D.init_distributed(device="cpu")
    cfg = Config(data_root=Path(spec["root"]))
    masks: list = []
    _recorded_masks(masks)
    saves = _Counted(CheckpointStore, "save")
    histories = _Counted(HistoryStore, "save")
    res = {}
    if rank == 0:
        cluster = LocalCluster(config=cfg, device="cpu", serve_http=False)
        cluster.start(recover=False)
        try:
            res["jobs"] = {job.get("key", job["id"]): run_job(cluster.ps, job)
                           for job in spec["jobs"]}
        finally:
            cluster.stop()
    else:
        res["jobs_followed"] = run_follower(config=cfg)
    res.update(masks=masks, checkpoint_saves=saves.calls,
               history_saves=histories.calls)
    _save(out, rank, res)
