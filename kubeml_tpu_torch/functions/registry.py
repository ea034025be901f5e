"""The function registry: the port of ``kubeml_tpu/functions/registry.py``.

A function is one user source file stored as ``<functions_dir>/<name>.py``.
Loading imports it in process under a fresh module name (so concurrent
loads do not share module state) and builds its model: the file defines
``main()`` returning a :class:`~kubeml_tpu_torch.runtime.model.KubeModel`,
or exactly one ``KubeModel`` subclass constructible with no arguments.
Loads share a concurrency semaphore (``function_concurrency``) and run
under the function timeout (``function_timeout``), so a user module that
hangs at import is abandoned with a 408 instead of wedging the caller.

A function file imports its own package: a port function builds its model
from ``kubeml_tpu_torch``, a JAX one from ``kubeml_tpu``.
"""

from __future__ import annotations

import importlib.util
import sys
import threading
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from ..api.config import Config, get_config
from ..api.errors import FunctionNotFoundError, KubeMLError
from ..utils.watchdog import FunctionBusyError, run_with_timeout

# single-file source limit
MAX_SOURCE_BYTES = 256 * 1024


@dataclass
class FunctionSummary:
    name: str
    size: int
    created_at: float

    def to_dict(self):
        return {"name": self.name, "size": self.size,
                "created_at": self.created_at}


class FunctionRegistry:
    """Filesystem registry: ``<functions_dir>/<name>.py``."""

    def __init__(self, root: Optional[Path] = None,
                 config: Optional[Config] = None):
        self.cfg = config or get_config()
        self.root = Path(root) if root is not None else self.cfg.functions_dir
        self.root.mkdir(parents=True, exist_ok=True)
        self._load_slots = threading.Semaphore(
            max(1, self.cfg.function_concurrency))

    def _path(self, name: str) -> Path:
        if not name or "/" in name or name.startswith("."):
            raise KubeMLError(f"invalid function name {name!r}", 400)
        return self.root / f"{name}.py"

    def exists(self, name: str) -> bool:
        return self._path(name).exists()

    def create(self, name: str, source: str, validate: bool = True
               ) -> FunctionSummary:
        """Store a function; with ``validate`` it must load, else it is
        removed again and the load's error raised."""
        if len(source.encode()) > MAX_SOURCE_BYTES:
            raise KubeMLError(f"function source exceeds {MAX_SOURCE_BYTES} "
                              f"bytes (single-file limit)", 400)
        path = self._path(name)
        if path.exists():
            raise KubeMLError(f"function {name!r} already exists", 400)
        path.write_text(source)
        if validate:
            try:
                self.load(name)
            except Exception:
                path.unlink(missing_ok=True)
                raise
        return self.summary(name)

    def delete(self, name: str) -> None:
        path = self._path(name)
        if not path.exists():
            raise FunctionNotFoundError(name)
        path.unlink()

    def summary(self, name: str) -> FunctionSummary:
        path = self._path(name)
        if not path.exists():
            raise FunctionNotFoundError(name)
        st = path.stat()
        return FunctionSummary(name=name, size=st.st_size,
                               created_at=st.st_mtime)

    def list(self) -> List[FunctionSummary]:
        return [self.summary(p.stem) for p in sorted(self.root.glob("*.py"))
                if not p.name.startswith(".")]

    def read_source(self, name: str) -> str:
        path = self._path(name)
        if not path.exists():
            raise FunctionNotFoundError(name)
        return path.read_text()

    def load(self, name: str):
        """Import the function afresh and build its KubeModel, under the
        load semaphore (429 when full) and the function timeout (408)."""
        path = self._path(name)
        if not path.exists():
            raise FunctionNotFoundError(name)
        if not self._load_slots.acquire(timeout=1.0):
            raise FunctionBusyError(self.cfg.function_concurrency)
        try:
            return run_with_timeout(
                lambda: self._load_unguarded(name, path),
                self.cfg.function_timeout, f"loading function {name!r}")
        finally:
            self._load_slots.release()

    def _load_unguarded(self, name: str, path: Path):
        from ..runtime.model import KubeModel

        mod_name = f"kubeml_fn_{name}_{uuid.uuid4().hex[:8]}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        # registered only while it executes (self-referencing imports,
        # dataclasses); the model keeps the module alive after
        sys.modules[mod_name] = module
        try:
            spec.loader.exec_module(module)
        except Exception as e:
            raise KubeMLError(f"function {name!r} failed to import: {e}",
                              400) from e
        finally:
            sys.modules.pop(mod_name, None)

        main = getattr(module, "main", None)
        if callable(main):
            model = main()
            if not isinstance(model, KubeModel):
                raise KubeMLError(
                    f"function {name!r}: main() must return a KubeModel, "
                    f"got {type(model).__name__}", 400)
            return model
        candidates = [
            v for v in vars(module).values()
            if isinstance(v, type) and issubclass(v, KubeModel)
            and v is not KubeModel and v.__module__ == mod_name]
        if len(candidates) != 1:
            raise KubeMLError(
                f"function {name!r} must define main() or exactly one "
                f"KubeModel subclass (found {len(candidates)})", 400)
        return candidates[0]()
