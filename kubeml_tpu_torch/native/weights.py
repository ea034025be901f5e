"""Model-weight exchange through the native tensor store: the port of
``kubeml_tpu/native/weights.py``.

The reference exchanges weights through RedisAI (ml/pkg/model/model.go:
135-161). Here a standalone job runner publishes each epoch's reference
weights into its socket-served :class:`~.bindings.TensorStore`, and the
parameter server pulls them once a version and serves a live job's
``/infer`` itself (``ps/parameter_server.py``).

Publish protocol (a seqlock): the version key is set to the NEGATED new
version before any leaf is touched, then the leaves, the manifest, and
last the real version. Readers reject a sentinel or absent version and
re-read it after the fetch, so a publish racing a fetch never yields a
tree mixed from two epochs.

Delta publish and fetch: the manifest (v2, ``{"v", "keys", "vers",
"sums"}``) carries a per-leaf version and content hash beside the key list
(a v1 plain key list still reads). A writer holding a
:class:`PublishState` skips leaves whose bytes did not change (their leaf
version stays at the epoch that last wrote them), and a reader holding a
:class:`FetchCache` pulls only leaves whose manifest version is newer
than its cached copy.

Leaves are numpy arrays or torch tensors; they move as numpy, bfloat16 as
its uint16 bit patterns (``bindings.to_wire``), and a fetched tree holds
numpy arrays and, for bfloat16 leaves, CPU ``torch.bfloat16`` tensors.
Trees flatten with the checkpoint store's ``a/b/c`` path scheme
(``storage.checkpoint``), including its "no '/' in keys" guard.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..storage.checkpoint import _flatten, _unflatten
from ..utils import profiler
from .bindings import to_wire

MANIFEST_KEY = "__manifest__"
VERSION_KEY = "__version__"


def _digest(leaf) -> str:
    """Content hash of one leaf (bytes + dtype + shape; blake2b-96). The
    dtype/shape salt keeps a reinterpret (e.g. f32 -> int8 of equal bytes)
    from reading as 'unchanged'."""
    arr, name = to_wire(leaf)
    h = hashlib.blake2b(digest_size=12)
    h.update(name.encode())
    h.update(str(tuple(arr.shape)).encode())
    h.update(arr)
    return h.hexdigest()


def _structure_sig(tree: Any) -> Any:
    """Hashable signature of the dict nesting (keys only, sorted like
    ``_flatten``) — the flatten-cache validity key."""
    if isinstance(tree, dict):
        return tuple((k, _structure_sig(tree[k])) for k in sorted(tree))
    return None


def _leaves_in_order(tree: Any, out: List[Any]) -> None:
    """Leaves in ``_flatten``'s (sorted-key DFS) order, without rebuilding
    the path strings."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves_in_order(tree[k], out)
    else:
        out.append(tree)


class PublishState:
    """Writer-side memory for delta publishes into one store.

    Tracks the per-leaf content hash + the version that last wrote each
    leaf, and caches the flattened key list / manifest key-encoding while
    the tree STRUCTURE is unchanged between publishes (it used to
    re-flatten and re-JSON-encode every epoch on the hot path)."""

    def __init__(self):
        self.sig: Any = None
        self.keys: Optional[List[str]] = None
        self.keys_json: Optional[str] = None
        self.digests: Dict[str, str] = {}
        self.leaf_versions: Dict[str, int] = {}

    def pairs_for(self, variables: dict) -> List[Tuple[str, Any]]:
        sig = _structure_sig(variables)
        if sig == self.sig and self.keys is not None:
            leaves: List[Any] = []
            _leaves_in_order(variables, leaves)
            return list(zip(self.keys, leaves))
        pairs = _flatten(variables)
        self.sig = sig
        self.keys = [k for k, _ in pairs]
        self.keys_json = json.dumps(self.keys)
        # structure changed: stale per-leaf state must not claim 'unchanged'
        # for a path that now names a different leaf
        live = set(self.keys)
        self.digests = {k: v for k, v in self.digests.items() if k in live}
        self.leaf_versions = {k: v for k, v in self.leaf_versions.items()
                              if k in live}
        return pairs


class FetchCache:
    """Reader-side memory: the last consistently-fetched tree, per-leaf
    versions from its manifest, and the tree version.

    The whole state lives in ONE tuple swapped atomically (GIL reference
    assignment), so concurrent fetchers sharing a cache always see a
    version-consistent (leaf_versions, leaves) pair — a reader observing
    half of another thread's update could otherwise pair a new version map
    with old leaf bytes and assemble a mixed-epoch tree, the exact state
    the seqlock exists to prevent."""

    def __init__(self):
        # (version, {key: leaf_version}, {key: leaf})
        self.state: Tuple[Optional[int], Dict[str, int],
                          Dict[str, Any]] = (None, {}, {})

    @property
    def version(self) -> Optional[int]:
        return self.state[0]

    @property
    def leaf_versions(self) -> Dict[str, int]:
        return self.state[1]

    @property
    def leaves(self) -> Dict[str, Any]:
        return self.state[2]


def _encode_manifest(keys_json: str, vers: List[int],
                     sums: List[str]) -> bytes:
    # v2: dict with aligned per-leaf version + hash arrays. The key-list
    # JSON fragment is the cached (dominant) part; versions/hashes are
    # cheap to re-encode per publish.
    return (b'{"v": 2, "keys": ' + keys_json.encode()
            + b', "vers": ' + json.dumps(vers).encode()
            + b', "sums": ' + json.dumps(sums).encode() + b"}")


def _decode_manifest(raw: bytes) -> Tuple[List[str], List[int]]:
    """(keys, per-leaf versions). Accepts the v1 plain key list (every leaf
    at the tree version, signaled by version -1 -> caller substitutes)."""
    doc = json.loads(raw)
    if isinstance(doc, list):  # v1: no per-leaf versions
        return doc, [-1] * len(doc)
    keys = doc["keys"]
    vers = doc.get("vers") or [-1] * len(keys)
    return keys, vers


def publish_variables(store, variables: dict, version: int,
                      state: Optional[PublishState] = None) -> None:
    """Write a (nested-dict) variables tree into ``store``.

    ``version`` must be >= 1 (the seqlock negates it as the in-progress
    sentinel, and readers treat <= 0 as not-ready). With ``state`` (one per
    writer x store), leaves whose content hash is unchanged since their last
    write are skipped — their manifest leaf-version stays old, which is what
    tells delta readers they need not re-pull them."""
    if version < 1:
        raise ValueError(f"version must be >= 1, got {version}")
    if state is not None:
        pairs = state.pairs_for(variables)
        keys_json = state.keys_json
    else:
        pairs = _flatten(variables)
        keys_json = json.dumps([k for k, _ in pairs])
    t0 = time.perf_counter()
    store.set(VERSION_KEY, np.array([-version], np.int64))  # in progress
    nbytes = 0
    skipped = 0
    vers: List[int] = []
    sums: List[Optional[str]] = []
    for key, arr in pairs:
        # hashing every leaf only buys anything on the delta path; a
        # state-less (full) publish skips the whole-model blake2b pass and
        # writes nulls — readers never require the sums, they are the
        # optional integrity/debug channel of the v2 manifest
        digest = _digest(arr) if state is not None else None
        sums.append(digest)
        if (state is not None and state.digests.get(key) == digest
                and key in state.leaf_versions):
            skipped += 1
            vers.append(state.leaf_versions[key])
            continue
        store.set(key, arr)
        nbytes += to_wire(arr)[0].nbytes
        vers.append(version)
        if state is not None:
            state.digests[key] = digest
            state.leaf_versions[key] = version
    store.set(MANIFEST_KEY, np.frombuffer(
        _encode_manifest(keys_json, vers, sums), np.uint8))
    store.set(VERSION_KEY, np.array([version], np.int64))
    # data-plane accounting: only the bytes actually written count (skipped
    # leaves moved nothing)
    profiler.record_io("weights.publish", nbytes,
                       time.perf_counter() - t0, version=version,
                       leaves_written=len(pairs) - skipped,
                       leaves_skipped=skipped)


def read_version(reader) -> Optional[int]:
    """The currently published version; None when absent OR mid-publish."""
    v = reader.get(VERSION_KEY)
    if v is None:
        return None
    version = int(np.asarray(v).reshape(-1)[0])
    return version if version > 0 else None


def fetch_variables(
    reader, retries: int = 2, cache: Optional[FetchCache] = None,
) -> Tuple[Optional[dict], Optional[int]]:
    """Read the full tree; returns (variables, version) or (None, None) when
    nothing is published. Retries when a concurrent publish tears the read
    (detected by the seqlock version flipping through its sentinel); torn
    attempts account their wasted bytes under the ``weights.fetch_torn``
    phase plus a retry counter, so the attribution report sees the channel's
    REAL traffic, not just the reads that landed.

    With ``cache``, only leaves whose manifest version is newer than the
    cached copy cross the channel; the rest assemble from the cache. The
    cache updates only from consistent (version-rechecked) reads."""
    for _ in range(retries + 1):
        t0 = time.perf_counter()
        fetched_bytes = 0
        v0 = read_version(reader)
        if v0 is None:
            return None, None
        man = reader.get(MANIFEST_KEY)
        if man is None:
            profiler.record_retry("weights.fetch")
            continue
        try:
            keys, vers = _decode_manifest(np.asarray(man).tobytes())
        except (ValueError, KeyError, TypeError):
            profiler.record_retry("weights.fetch")
            continue  # mid-publish manifest of a mixed-format writer
        vers = [v0 if v < 0 else v for v in vers]
        # ONE atomic snapshot of the shared cache for this whole attempt
        _, cached_vers, cached_leaves = (cache.state if cache is not None
                                         else (None, {}, {}))
        leaves: Dict[str, Any] = {}
        fetched = 0
        torn = False
        for key, leaf_v in zip(keys, vers):
            if key in cached_leaves and cached_vers.get(key) == leaf_v:
                leaves[key] = cached_leaves[key]
                continue
            arr = reader.get(key)
            if arr is None:
                torn = True
                break
            fetched += 1
            fetched_bytes += to_wire(arr)[0].nbytes
            leaves[key] = arr
        if torn or read_version(reader) != v0:
            # publish raced us: the bytes we pulled are wasted — account
            # them on their own phase so they can't vanish from the report
            profiler.account("weights.fetch_torn", fetched_bytes,
                             time.perf_counter() - t0)
            profiler.record_retry("weights.fetch")
            continue
        profiler.record_io(
            "weights.fetch", fetched_bytes, time.perf_counter() - t0,
            version=v0, leaves_fetched=fetched,
            leaves_cached=len(leaves) - fetched)
        if cache is not None:
            # single atomic swap — see FetchCache
            cache.state = (v0, dict(zip(keys, vers)), dict(leaves))
        return _unflatten(leaves), v0
    return None, None
