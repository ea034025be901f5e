"""The port's supervisor (``kubeml_tpu_torch/supervisor.py``) on the CPU.

* A child that dies is restarted after the backoff until the restart
  limit, as JAX's ``Supervisor`` does (the same child, the same starts and
  return code), and a SIGTERM to the supervisor reaches the child and ends
  both with exit 0.
* ``kubeml start --device cpu`` under the supervisor, killed with -9 in
  the middle of a job, is restarted, and the journal resumes the job
  (``resume=True``) to its end.
"""

import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from kubeml_tpu.supervisor import Supervisor as JSupervisor
from kubeml_tpu_torch.supervisor import Supervisor as TSupervisor

REPO = Path(__file__).resolve().parent.parent
WAIT = 120.0


def test_restarts_with_backoff_as_jax(tmp_path):
    rows = []
    for cls in (JSupervisor, TSupervisor):
        starts = tmp_path / f"{cls.__module__}.starts"
        child = [sys.executable, "-c",
                 f"open({str(starts)!r}, 'a').write('x'); raise SystemExit(3)"]
        t0 = time.monotonic()
        rc = cls(child, backoff=0.2, max_restarts=2).run()
        rows.append((rc, starts.read_text(), time.monotonic() - t0 >= 0.4))
    assert rows[0] == rows[1] == (1, "xxx", True)


def test_sigterm_reaches_the_child(tmp_path):
    marker = tmp_path / "child.term"
    child = ("import signal, sys, time\n"
             "def term(*_):\n"
             f"    open({str(marker)!r}, 'w').write('term')\n"
             "    sys.exit(0)\n"
             "signal.signal(signal.SIGTERM, term)\n"
             "print('up', flush=True)\n"
             "time.sleep(60)\n")
    pidfile = tmp_path / "child.pid"
    sup = subprocess.Popen(
        [sys.executable, "-m", "kubeml_tpu_torch.supervisor", "--backoff",
         "0.2", "--pidfile", str(pidfile), "--", sys.executable, "-c",
         child], cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        assert sup.stdout.readline().strip() == "up"
        sup.send_signal(signal.SIGTERM)
        assert sup.wait(timeout=30) == 0
        assert marker.read_text() == "term"
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_kill9_mid_job_restarts_and_the_journal_resumes(tmp_path):
    from test_torch_standalone import GATED_FN, blobs, request

    from kubeml_tpu_torch.controller import KubemlClient

    gate = tmp_path / "gate"
    gate.touch()
    ports = {k: str(_free_port()) for k in
             ("KUBEML_CONTROLLER_PORT", "KUBEML_SCHEDULER_PORT",
              "KUBEML_PS_PORT", "KUBEML_STORAGE_PORT")}
    env = dict(os.environ, KUBEML_DATA_ROOT=str(tmp_path / "kubeml"),
               KUBEML_TEST_GATE=str(gate), OMP_NUM_THREADS="1", **ports)
    pidfile = tmp_path / "child.pid"
    sup = subprocess.Popen(
        [sys.executable, "-m", "kubeml_tpu_torch.supervisor", "--backoff",
         "0.5", "--pidfile", str(pidfile), "--", sys.executable, "-m",
         "kubeml_tpu_torch.cli", "start", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    client = KubemlClient(
        f"http://127.0.0.1:{ports['KUBEML_CONTROLLER_PORT']}")

    def wait_for(cond, what):
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            try:
                got = cond()
            except Exception:
                got = None
            if got:
                return got
            time.sleep(0.1)
        raise AssertionError(f"no {what} within {WAIT} s")

    def jobs():
        return {j["job_id"]: j for j in client.tasks().jobs()
                if "job_id" in j}

    try:
        # the controller answers first, the other services right after
        wait_for(lambda: client.datasets().create(
            "blobs", *blobs(256, 0), *blobs(64, 1)) or True, "cluster")
        client.functions().create("gated", GATED_FN)
        jid = client.networks().train(request(
            3, fn="gated", validate_every=0, checkpoint_every=1))
        # the job holds its second epoch at the gate: its first epoch's
        # checkpoint is written; kill the cluster there
        wait_for(lambda: "ep00000" in client.checkpoints().list(jid),
                 "first checkpoint")
        first = int(pidfile.read_text())
        os.kill(first, signal.SIGKILL)
        wait_for(lambda: int(pidfile.read_text()) != first, "restart")
        gate.unlink(missing_ok=True)
        hist = wait_for(lambda: (lambda h: h if len(h.train_loss) == 3
                                 else None)(client.histories().get(jid)),
                        "resumed job")
        assert all(np.isfinite(hist.train_loss))
        assert not (hist.task or {}).get("error")
        assert jid not in jobs()  # finished: out of the journal
    finally:
        gate.unlink(missing_ok=True)
        sup.send_signal(signal.SIGTERM)
        try:
            sup.wait(timeout=60)
        except subprocess.TimeoutExpired:
            sup.kill()
            sup.wait()
