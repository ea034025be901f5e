"""Cross-package checks of the tensor socket and the weight exchange, run
in a process of their own by ``tests/test_torch_native.py``: each
package's ``TensorClient`` against the other's ``TensorServer``, and
``publish_variables``/``fetch_variables`` across them. Prints one JSON
object of results.

    python tests/torch_native_interop.py <scratch dir>
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from kubeml_tpu.native import bindings as jb  # noqa: E402
from kubeml_tpu.native import weights as jw  # noqa: E402
from kubeml_tpu_torch.native import bindings as tb  # noqa: E402
from kubeml_tpu_torch.native import weights as tw  # noqa: E402


def arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "i64": np.arange(7, dtype=np.int64),
        "u8": np.array(5, np.uint8),
        "bf16": rng.standard_normal((4, 2)).astype(np.float32),
    }


def as_jax(name, a):
    return a.astype(ml_dtypes.bfloat16) if name == "bf16" else a


def as_port(name, a):
    return torch.from_numpy(a).to(torch.bfloat16) if name == "bf16" else a


def bits(v):
    """Comparable bytes of a leaf from either package."""
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy().view(np.uint16).tobytes(), \
            "bfloat16", tuple(v.shape)
    a = np.asarray(v)
    return a.tobytes(), str(a.dtype), a.shape


def tree(bf16_step=0.0, frozen=None):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((6, 4)).astype(np.float32) + bf16_step
    return {"params": {"dense": {"kernel": w,
                                 "bias": np.full(4, bf16_step, np.float32)},
                       "embed": frozen if frozen is not None else
                       rng.standard_normal((8, 3)).astype(np.float32)},
            "stats": {"count": np.array([3], np.int64)}}


class Counting:
    """A reader that counts the leaf reads of a fetch."""

    def __init__(self, reader):
        self.reader = reader
        self.leaf_gets = 0

    def get(self, key):
        if not key.startswith("__"):
            self.leaf_gets += 1
        return self.reader.get(key)


def flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = bits(v)
    return out


def main(scratch):
    out = {}
    src = arrays()
    # 1. each package's client on each package's server: the same arrays
    for server_pkg in ("jax", "port"):
        B = jb if server_pkg == "jax" else tb
        store = B.TensorStore()
        path = os.path.join(scratch, f"{server_pkg}.sock")
        srv = B.TensorServer(store, path)
        conv = as_jax if server_pkg == "jax" else as_port
        for k, a in src.items():
            store.set(k, conv(k, a))
        got = {}
        for client_pkg, C, cw in (("jax", jb, as_jax), ("port", tb, as_port)):
            cli = C.TensorClient(path)
            got[client_pkg] = {k: bits(cli.get(k)) for k in src}
            # a client also writes through the other's server
            cli.set(f"w-{client_pkg}", cw("bf16", src["bf16"]))
            got[client_pkg]["missing"] = cli.get("nosuch") is None
            counts = (cli.count(), cli.keys("w-"))
            cli.close()
        out[f"clients_on_{server_pkg}_server"] = {
            "equal": got["jax"] == got["port"], "counts": counts,
            "written_equal": bits(store.get("w-jax")) == bits(
                store.get("w-port")),
            "f32_exact": got["port"]["f32"][0] == src["f32"].tobytes()}
        srv.stop()
        store.close()
    # 2. publish/fetch across the packages over the socket: equal
    # manifests, equal trees, and the fetch cache pulls the stale leaves
    manifests, trees, pulls = {}, {}, {}
    frozen = np.ones((8, 3), np.float32)
    for pub_pkg, fetch_pkg in (("port", "jax"), ("jax", "port")):
        B, W = (tb, tw) if pub_pkg == "port" else (jb, jw)
        FB, FW = (tb, tw) if fetch_pkg == "port" else (jb, jw)
        store = B.TensorStore()
        path = os.path.join(scratch, f"pub-{pub_pkg}.sock")
        srv = B.TensorServer(store, path)
        state = W.PublishState()
        cli = FB.TensorClient(path)
        cache = FW.FetchCache()
        for version in (1, 2):
            t = tree(0.5 * version, frozen=frozen)
            W.publish_variables(store, t, version, state=state)
            reader = Counting(cli)
            got, v = FW.fetch_variables(reader, cache=cache)
            pulls[f"{fetch_pkg}_from_{pub_pkg}_v{version}"] = \
                reader.leaf_gets
            trees[f"{fetch_pkg}_from_{pub_pkg}_v{version}"] = (
                v == version and flat(got) == flat(t))
        manifests[pub_pkg] = bytes(np.asarray(
            store.get(W.MANIFEST_KEY)).tobytes()).decode()
        cli.close()
        srv.stop()
        store.close()
    out["manifests_equal"] = manifests["port"] == manifests["jax"]
    out["manifest"] = json.loads(manifests["port"])
    out["trees"] = trees
    out["pulls"] = pulls
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
