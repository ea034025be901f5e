"""Process supervisor: restart-and-resume for kubeml-tpu-torch
deployments. The port of ``kubeml_tpu/supervisor.py``.

The reference leaves restarts to Kubernetes and loses the work (weights
lived in RedisAI). Here the supervisor pairs with the PS's job journal:

* it runs ``kubeml start`` as its child and restarts it, after
  ``--backoff`` seconds, whenever it exits without being asked to;
* over ranks, a rank's death ends the process group: every host's child
  exits and every host's supervisor starts its rank again;
* at boot the control plane resubmits the journaled jobs with
  ``resume=True``, so interrupted training goes on from its newest
  checkpoint.

A SIGTERM (or SIGINT) is forwarded to the child and ends the supervisor
once the child has exited.

    python -m kubeml_tpu_torch.supervisor            # supervise `kubeml start`
    python -m kubeml_tpu_torch.supervisor -- python -m kubeml_tpu_torch.cli start --device cpu
"""

from __future__ import annotations

import argparse
import logging
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

log = logging.getLogger("kubeml.supervisor")


class Supervisor:
    def __init__(self, command: List[str], *, backoff: float = 5.0,
                 max_restarts: int = 0, pidfile: Optional[Path] = None,
                 env: Optional[dict] = None):
        self.command = command
        self.backoff = backoff
        self.max_restarts = max_restarts  # 0 = unlimited
        self.pidfile = Path(pidfile) if pidfile else None
        self.env = env  # child environment override (tests/multi-rank hosts)
        self._stop = False
        self._child: Optional[subprocess.Popen] = None

    def stop(self) -> None:
        """Programmatic shutdown (signal-handler equivalent)."""
        self._terminate(None, None)

    def _terminate(self, signum, frame):
        self._stop = True
        if self._child is not None and self._child.poll() is None:
            self._child.terminate()

    def run(self) -> int:
        try:
            signal.signal(signal.SIGTERM, self._terminate)
            signal.signal(signal.SIGINT, self._terminate)
        except ValueError:
            pass  # not the main thread (embedded/test use): stop() instead
        restarts = 0
        while not self._stop:
            log.info("starting child: %s", " ".join(self.command))
            self._child = subprocess.Popen(self.command, env=self.env)
            if self._stop:
                # SIGTERM landed between the loop check and Popen: the
                # handler saw no (or the previous) child, so terminate this
                # one ourselves or the supervisor blocks in wait() forever
                # with an orphan holding the service ports
                self._child.terminate()
            if self.pidfile is not None:
                self.pidfile.write_text(str(self._child.pid))
            rc = self._child.wait()
            if self._stop:
                log.info("supervisor stopping (child exited %s)", rc)
                return 0
            log.warning("child exited with code %s; restarting in %.1fs",
                        rc, self.backoff)
            restarts += 1
            if self.max_restarts and restarts > self.max_restarts:
                log.error("restart limit (%d) reached; giving up",
                          self.max_restarts)
                return 1
            # interruptible backoff
            deadline = time.time() + self.backoff
            while time.time() < deadline and not self._stop:
                time.sleep(0.2)
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="supervise a kubeml-tpu-torch process: restart on exit; "
                    "the "
                    "control plane's job journal turns restarts into "
                    "resumes")
    p.add_argument("--backoff", type=float, default=5.0,
                   help="seconds between restarts")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="give up after this many restarts (0 = never)")
    p.add_argument("--pidfile", default=None,
                   help="write the CHILD pid here on every (re)start")
    p.add_argument("command", nargs="*",
                   help="child command (default: `<python> -m kubeml_tpu_torch.cli start`)")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s supervisor %(levelname)s %(message)s")
    command = args.command or [sys.executable, "-m", "kubeml_tpu_torch.cli",
                               "start"]
    return Supervisor(command, backoff=args.backoff,
                      max_restarts=args.max_restarts,
                      pidfile=args.pidfile).run()


if __name__ == "__main__":
    sys.exit(main())
