"""The running-job journal: the port of ``kubeml_tpu/ps/journal.py``.

The PS records every accepted job as one JSON file under
``<data_root>/journal`` (``{"job_id", "request"}``, the JAX package's
layout, so a journal written by either package recovers in the other),
clears it when the job finishes, and a rebooting control plane
resubmits what is left with ``resume=True``: a crash costs at most the
epochs since the job's newest checkpoint.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import List, Optional

from ..api.config import Config, get_config
from ..api.types import TrainRequest

log = logging.getLogger("kubeml.journal")


class JobJournal:
    def __init__(self, config: Optional[Config] = None):
        cfg = config or get_config()
        self.dir = cfg.journal_dir
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, job_id: str) -> Path:
        return self.dir / f"{job_id}.json"

    def record(self, job_id: str, request: TrainRequest) -> None:
        """Persist an accepted job (written aside, then renamed)."""
        tmp = self._path(job_id).with_suffix(".tmp")
        tmp.write_text(json.dumps({"job_id": job_id,
                                   "request": request.to_dict()}))
        tmp.replace(self._path(job_id))

    def clear(self, job_id: str) -> None:
        self._path(job_id).unlink(missing_ok=True)

    def pending(self, quarantine: bool = True) -> List[dict]:
        """The journaled jobs. A corrupt entry is renamed to
        ``<name>.corrupt`` with a warning (once, not at every boot);
        ``quarantine=False`` only skips it, for read-only listings."""
        out = []
        for p in sorted(self.dir.glob("*.json")):
            try:
                out.append(json.loads(p.read_text()))
            except ValueError:
                if not quarantine:
                    log.debug("journal entry %s is corrupt; skipping", p.name)
                    continue
                quarantined = p.with_suffix(p.suffix + ".corrupt")
                try:
                    p.replace(quarantined)
                    log.warning(
                        "journal entry %s is corrupt; quarantined to %s (the "
                        "job is not recovered: resubmit it with --resume if "
                        "its checkpoints exist)", p.name, quarantined.name)
                except OSError:
                    log.warning("journal entry %s is corrupt and could not "
                                "be quarantined; skipping", p.name)
            except OSError:
                log.warning("journal entry %s is unreadable; skipping",
                            p.name)
        return out

    def recover_into(self, scheduler) -> int:
        """Resubmit every journaled job with ``resume=True`` under its own
        id (so it finds its checkpoints); returns the count. The entry
        stays until the job finishes: a crash while it is still queued
        recovers it again at the next boot."""
        n = 0
        for entry in self.pending():
            job_id = entry.get("job_id", "")
            try:
                req = TrainRequest.from_dict(entry.get("request", {}))
                req.job_id = job_id
                req.options.resume = True
                scheduler.submit_train(req)
                n += 1
                log.info("recovered job %s (resubmitted with resume)", job_id)
            except Exception:
                log.exception("recovering job %s failed", job_id)
        return n
