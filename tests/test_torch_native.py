"""The port's host data plane (``kubeml_tpu_torch/native``) against the JAX
package's (``kubeml_tpu/native``): the same numpy inputs through both.

* ``pack_rounds``: the same bytes for uint8, f32 and int64 slabs with
  ragged counts, an empty worker, a non-contiguous source and an
  overlong one, and through the numpy fallback (a dtype mismatch), which
  the port counts;
* ``f32_to_bf16``: bit-equal on finite values, ±0, ±inf and subnormals;
  a NaN stays a NaN;
* ``TensorStore``: the same op sequence gives equal keys, counts and
  ``nbytes``;
* in a process of their own (``tests/torch_native_interop.py``): each
  package's ``TensorClient`` reads the other's ``TensorServer``, and
  ``publish_variables``/``fetch_variables`` across them give equal
  manifests and trees, with a ``FetchCache`` pulling exactly the leaves
  that changed;
* the cross-process build lock of the kernel and native builds: two
  processes building at once build once (a stub compiler on ``PATH``).

Tolerance: none, every comparison is exact.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from kubeml_tpu import native as jnative
from kubeml_tpu_torch import native as tnative

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def built():
    # both libraries built before the first call (the data path never
    # waits for a compile and would take the fallback meanwhile)
    assert jnative.native_available() and tnative.native_available()


def _sources(dtype, rng):
    def draw(n, shape):
        if dtype == np.uint8:
            return rng.integers(0, 256, (n, *shape)).astype(np.uint8)
        if dtype == np.int64:
            return rng.integers(-1000, 1000, (n, *shape)).astype(np.int64)
        return rng.standard_normal((n, *shape)).astype(np.float32)

    shape = (3, 2)
    wide = draw(9, (3, 4))
    srcs = [draw(5, shape), None, wide[:, :, ::2], draw(12, shape),
            draw(2, shape)]
    counts = [5, 0, 7, 20, 2]  # ragged, empty, strided, overlong, short
    return srcs, counts, shape


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int64])
def test_pack_rounds_bytes_equal_jax(dtype):
    srcs, counts, shape = _sources(dtype, np.random.default_rng(3))
    want = np.full((5, 8, *shape), 7, dtype)
    got = np.full((5, 8, *shape), 7, dtype)
    before = tnative.fallback_counts()["pack_rounds"]
    jnative.pack_rounds(want, srcs, counts)
    tnative.pack_rounds(got, srcs, counts)
    assert got.tobytes() == want.tobytes()
    assert tnative.fallback_counts()["pack_rounds"] == before  # native


def test_pack_rounds_dtype_mismatch_and_numpy_path_equal_jax():
    rng = np.random.default_rng(4)
    srcs = [rng.standard_normal((4, 2)).astype(np.float64), None]
    for native in (True, False):
        want = np.ones((2, 6, 2), np.float32)
        got = np.ones((2, 6, 2), np.float32)
        before = tnative.fallback_counts()["pack_rounds"]
        jnative.pack_rounds(want, srcs, [4, 0], native=native)
        tnative.pack_rounds(got, srcs, [4, 0], native=native)
        assert got.tobytes() == want.tobytes()
        assert tnative.fallback_counts()["pack_rounds"] == before + 1
    with pytest.raises(ValueError):
        tnative.pack_rounds(np.zeros((2, 3), np.float32), [None], [0])


def test_f32_to_bf16_bit_equal_jax():
    rng = np.random.default_rng(5)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 1e-45,
                        np.finfo(np.float32).max, np.finfo(np.float32).tiny,
                        1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, np.nan],
                       np.float32)
    # above 65536 elements the native cast runs multithreaded
    x = np.concatenate([special, rng.standard_normal(70000).astype(
        np.float32) * 1e3, (rng.standard_normal(500) * 1e-39).astype(
            np.float32)])
    got = tnative.f32_to_bf16(x)
    want = jnative.f32_to_bf16(x).view(np.uint16)
    assert got.dtype == np.uint16 and got.shape == x.shape
    finite = ~np.isnan(x)
    assert np.array_equal(got[finite], want[finite])
    as_f32 = (got.astype(np.uint32) << 16).view(np.float32)
    assert np.isnan(as_f32[~finite]).all()
    # and the cast equals torch's round-to-nearest-even
    ref = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    assert np.array_equal(got[finite], ref.view(np.uint16)[finite])


def test_tensor_store_ops_equal_jax():
    rng = np.random.default_rng(6)
    bf = rng.standard_normal((3, 3)).astype(np.float32)
    ops = [("set", "job1:w", rng.standard_normal((4, 5)).astype(np.float32)),
           ("set", "job1:b", np.arange(6, dtype=np.int64)),
           ("set", "job1:bf", bf),
           ("set", "job2:s", np.array(9, np.uint8)),
           ("set", "job1:w", rng.standard_normal((2, 2)).astype(np.float32)),
           ("del", "job2:s", None), ("del", "nosuch", None),
           ("set", "job2:t", np.zeros((7,), np.float32)),
           ("delp", "job2", None)]
    stores = (jnative.TensorStore(), tnative.TensorStore())
    results = ([], [])
    for i, store in enumerate(stores):
        assert store.native
        for op, key, val in ops:
            if op == "set":
                if key.endswith("bf"):
                    val = (val.astype(ml_dtypes.bfloat16) if i == 0
                           else torch.from_numpy(val).to(torch.bfloat16))
                store.set(key, val)
            elif op == "del":
                results[i].append(store.delete(key))
            else:
                results[i].append(store.delete_prefix(key))
            results[i].append((store.keys(), store.keys("job1:"),
                               store.count(), store.nbytes()))
    assert results[0] == results[1]
    jw, tw = stores[0].get("job1:w"), stores[1].get("job1:w")
    assert jw.tobytes() == tw.tobytes() and tw.shape == (2, 2)
    got = stores[1].get("job1:bf")
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == \
        stores[0].get("job1:bf").tobytes()
    assert stores[1].get("gone") is None
    for s in stores:
        s.close()


@pytest.fixture(scope="module")
def interop(tmp_path_factory):
    scratch = tmp_path_factory.mktemp("sock")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_native_interop.py"),
         str(scratch)], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_clients_read_each_others_servers(interop):
    for server in ("jax", "port"):
        r = interop[f"clients_on_{server}_server"]
        assert r["equal"] and r["written_equal"] and r["f32_exact"], r
        assert r["counts"] == [6, ["w-jax", "w-port"]]


def test_publish_and_fetch_across_the_packages(interop):
    assert interop["manifests_equal"]
    man = interop["manifest"]
    # the frozen embedding and the integer leaf kept their first version
    assert man["v"] == 2 and man["vers"] == [2, 2, 1, 1]
    assert all(interop["trees"].values()), interop["trees"]
    # the first fetch pulls every leaf, the second only the two that moved
    for pair in ("jax_from_port", "port_from_jax"):
        assert interop["pulls"][f"{pair}_v1"] == 4
        assert interop["pulls"][f"{pair}_v2"] == 2


STUB_NVCC = """#!{python}
import os, subprocess, sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
out = args[args.index("-o") + 1]
time.sleep(0.5)
if "-shared" in args:
    src = out + ".c"
    with open(src, "w") as f:
        f.write("".join("int %s(void) {{ return 0; }}\\n" % n
                        for n in {names!r}))
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", out, src], check=True)
else:
    open(out, "w").close()
"""

STUB_CXX = """#!/bin/sh
echo build >> {log}
sleep 0.5
exec g++ "$@"
"""

BUILD_CHILD = {
    "kernels": """
import sys
from pathlib import Path
from kubeml_tpu_torch.ops import kernels
kernels.BUILD_ROOT = Path(sys.argv[1])
print(kernels.library()._name)
""",
    "native": """
import sys
from pathlib import Path
from kubeml_tpu_torch.native import build
build.BUILD_ROOT = Path(sys.argv[1])
print(build.library_path())
""",
}


@pytest.mark.parametrize("library", ["kernels", "native"])
def test_two_processes_build_once(library, tmp_path):
    from kubeml_tpu_torch.ops.kernels import _SIGNATURES

    log = tmp_path / "calls.log"
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    if library == "kernels":
        stub = bin_dir / "nvcc"
        stub.write_text(STUB_NVCC.format(python=sys.executable, log=str(log),
                                         names=sorted(_SIGNATURES)))
        env.update(CUDA_HOME=str(tmp_path / "nocuda"),
                   PATH=f"{bin_dir}:{env['PATH']}")
    else:
        stub = bin_dir / "cxx"
        stub.write_text(STUB_CXX.format(log=str(log)))
        env["CXX"] = str(stub)
    stub.chmod(0o755)
    out_root = tmp_path / "build"
    code = textwrap.dedent(BUILD_CHILD[library])
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out_root)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and Path(paths.pop()).exists()
    calls = log.read_text().split()
    if library == "kernels":
        # one nvcc a source and one link, whichever process ran them
        assert calls.count("link") == 1 and calls.count("compile") == 3
    else:
        assert calls == ["build"]
