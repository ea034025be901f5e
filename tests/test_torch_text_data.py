"""The port's text data path (``kubeml_tpu_torch/data/{text,bpe}.py``, the
storage service's ``corpus`` form, ``kubeml dataset create-text`` and
``kubeml generate --text``) beside the JAX package's, on the CPU.

Held equal to JAX: the byte tokenizer, ``VocabTokenizer``,
``pack_corpus``'s rows and record and its rejections; ``train_bpe``'s
merge tables (bit for bit, on a slice of the repo's Markdown and on a
corpus full of ties) and ``BPETokenizer``'s ids and text; an upload's
rows, manifest ``meta`` and tokenizer route. ``generate --text`` through
the port's CLI, on a tiny byte-level and a tiny BPE ``CausalTransformer``
whose weights come from Flax, prints the text JAX's CLI logic prints for
JAX's greedy tokens, streamed and not; a character split across two
streamed records prints whole.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kubeml_tpu.api.errors import KubeMLError as JError
from kubeml_tpu.data import bpe as jbpe
from kubeml_tpu.data import text as jtext
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.data import bpe, text
from torch_port_helpers import numpy_tree

REPO = Path(__file__).resolve().parent.parent
TIES = "abc abd abe abc abd abc ab ba ab ba " * 20
PROMPT = "naïve café —"


def markdown(n_bytes=24000):
    """A slice of files no port change edits: the same text at every
    commit."""
    return (REPO / "docs" / "design.md").read_text()[:n_bytes]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- tokenizers and packing ---


@pytest.mark.parametrize("s", ["Hello, TPU! é漢", "", PROMPT + " 🙂",
                               "\n\n tabs\tand  spaces"])
def test_byte_codec_equals_jax(s):
    ids = text.byte_encode(s)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, jtext.byte_encode(s))
    assert text.byte_decode(ids.tolist()) == s == jtext.byte_decode(ids)
    tail = ids.tolist() + [text.EOS_ID, 99]
    assert text.byte_decode(tail) == jtext.byte_decode(tail) == s
    assert (text.BYTE_VOCAB, text.EOS_ID, text.BYTE_OFFSET) == (
        jtext.BYTE_VOCAB, jtext.EOS_ID, jtext.BYTE_OFFSET) == (258, 1, 2)


def test_vocab_tokenizer_equals_jax():
    spec = {"tokens": {"ab": 2, "a": 3, "b": 4, "abc": 5, " ": 6, "é": 7}}
    ours, theirs = text.VocabTokenizer(spec), jtext.VocabTokenizer(spec)
    ids = ours.encode("abc ab a é")
    np.testing.assert_array_equal(ids, theirs.encode("abc ab a é"))
    assert ours.decode(ids) == theirs.decode(ids) == "abc ab a é"
    assert ([ours.decode_bytes(t) for t in range(9)]
            == [theirs.decode_bytes(t) for t in range(9)])
    assert ours.vocab_size == theirs.vocab_size == 8
    for bad in ({"tokens": {"x": 1}}, {"tokens": {}}, {"tokens": {"x": "y"}},
                {}):
        with pytest.raises(KubeMLError) as e:
            text.VocabTokenizer(bad)
        with pytest.raises(JError):
            jtext.VocabTokenizer(bad)
        assert e.value.status_code == 400
    with pytest.raises(KubeMLError):
        ours.encode("abz")


@pytest.mark.parametrize("kind", ["byte", "vocab", "bpe"])
def test_pack_corpus_rows_and_meta_equal_jax(kind):
    corpus = "\n\n".join(f"document {i} of the corpus, naïve café"
                         for i in range(40))
    spec = {"byte": None,
            "vocab": {"tokens": {ch: 2 + i for i, ch in
                                 enumerate(sorted(set(corpus)))}},
            "bpe": jbpe.train_bpe(corpus, 320)}[kind]
    rows, meta = text.pack_corpus(corpus, 16, spec)
    jrows, jmeta = jtext.pack_corpus(corpus, 16, spec)
    np.testing.assert_array_equal(rows, jrows)
    assert rows.dtype == np.int32 and meta == jmeta
    assert meta["documents"] == 40 and rows.shape == (meta["rows"], 16)


@pytest.mark.parametrize("args", [("", 8), ("tiny", 512), ("abc", 1),
                                  ("\n\n\n\n", 4)])
def test_pack_corpus_rejections_equal_jax(args):
    with pytest.raises(KubeMLError) as e:
        text.pack_corpus(*args)
    with pytest.raises(JError) as je:
        jtext.pack_corpus(*args)
    assert e.value.status_code == je.value.status_code == 400
    assert text.split_documents("a\n\n\n\nb\n\n ") == \
        jtext.split_documents("a\n\n\n\nb\n\n ") == ["a", "b"]


# --- BPE ---


@pytest.mark.parametrize("corpus,vocab", [(TIES, 300), (TIES, 4096),
                                          ("markdown", 700)])
def test_train_bpe_merge_table_equals_jax(corpus, vocab):
    if corpus == "markdown":
        corpus = markdown()
    spec = bpe.train_bpe(corpus, vocab)
    assert spec == jbpe.train_bpe(corpus, vocab)
    assert spec["kind"] == "bpe" and 258 < spec["vocab_size"] <= vocab
    if vocab == 4096:  # nothing repeats any more: training stopped early
        assert spec["vocab_size"] < vocab


def test_bpe_tokenizer_equals_jax():
    corpus = markdown()
    spec = bpe.train_bpe(corpus, 700)
    ours, theirs = bpe.BPETokenizer(spec), jbpe.BPETokenizer(spec)
    for s in (corpus[:3000], PROMPT, "zxqj éé 🙂", ""):
        ids = ours.encode(s)
        np.testing.assert_array_equal(ids, theirs.encode(s))
        assert ours.decode(ids.tolist()) == theirs.decode(ids.tolist()) == s
    assert len(ours.encode(corpus[:3000])) < 0.6 * len(corpus[:3000].encode())
    assert ([ours.decode_bytes(t) for t in range(0, 700, 7)]
            == [theirs.decode_bytes(t) for t in range(0, 700, 7)])
    assert bpe.tokenizer_from_spec(None) is None
    assert isinstance(bpe.tokenizer_from_spec({"tokens": {"a": 2}}),
                      text.VocabTokenizer)
    for bad in ({"merges": "x"}, {"merges": [[1, 2, 3]]},
                {"merges": [[900, 2]]}):
        with pytest.raises(KubeMLError):
            bpe.BPETokenizer(bad)
        with pytest.raises(JError):
            jbpe.BPETokenizer(bad)
    with pytest.raises(KubeMLError):
        bpe.train_bpe("abc", 258)


# --- the upload ---


def _upload_files(corpus, **parts):
    files = {"corpus": ("c.txt", corpus.encode() if isinstance(corpus, str)
                        else corpus), "seq-len": (None, "16")}
    files.update({k: (None, v) for k, v in parts.items()})
    return files


def test_corpus_upload_equals_jax(tmp_path):
    from kubeml_tpu.api.config import Config as JConfig
    from kubeml_tpu.controller.controller import Controller as JController
    from kubeml_tpu.storage.service import \
        create_dataset_from_upload as jcreate
    from kubeml_tpu.storage.store import ShardStore as JShardStore
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.controller.controller import Controller
    from kubeml_tpu_torch.storage.service import StorageService
    from kubeml_tpu_torch.storage.store import ShardStore
    from kubeml_tpu_torch.utils import http_client as http

    cfg = Config(data_root=tmp_path / "port", storage_port=0)
    jcfg = JConfig(data_root=tmp_path / "jax")
    jstore = JShardStore(config=jcfg)
    svc = StorageService(config=cfg).start()
    corpus = "\n\n".join(f"a longer document {i} about serving tokens"
                         for i in range(60))

    class Req:
        def __init__(self, name):
            self.params = {"name": name}

        @staticmethod
        def arg(name, default=None):
            return default

    try:
        for name, parts in (("byteset", {}), ("bpeset", {"train-bpe": "600"}),
                            ("split", {"corpus-test": "held out text " * 30})):
            files = _upload_files(corpus, **parts)
            r = http.post(f"{svc.url}/dataset/{name}", files=files,
                          timeout=60, idempotency_key=True)
            assert r.status_code == 200, r.text
            want = jcreate(jstore, name,
                           {k: v.encode() if isinstance(v, str) else v
                            for k, (_, v) in files.items()})
            assert r.json()["packing"] == want["packing"]
            ours, theirs = ShardStore(config=cfg).get(name), jstore.get(name)
            for split in ("train", "test"):
                np.testing.assert_array_equal(ours.raw(split, "data"),
                                              theirs.raw(split, "data"))
            assert ours.manifest["meta"] == theirs.manifest["meta"]
            ctl, jctl = Controller(None, None, config=cfg), JController(
                None, None, config=jcfg)
            if "train-bpe" in parts:
                assert (ctl._dataset_tokenizer(Req(name))
                        == jctl._dataset_tokenizer(Req(name)))
            else:
                with pytest.raises(KubeMLError) as e:
                    ctl._dataset_tokenizer(Req(name))
                assert e.value.status_code == 404
        rows = ShardStore(config=cfg).get("byteset")
        assert rows.num_samples("test") == max(1, (rows.num_samples("train")
                                                   + rows.num_samples("test"))
                                               // 10)
        for name, files in (
                ("notutf8", _upload_files(b"\xff\xfe\xfa")),
                ("onerow", _upload_files("x" * 20)),
                ("both", _upload_files(corpus, **{
                    "train-bpe": "600", "tokenizer": '{"tokens": {"a": 5}}'})),
                ("badlen", {**_upload_files(corpus),
                            "seq-len": (None, "sixteen")})):
            r = http.post(f"{svc.url}/dataset/{name}", files=files, timeout=60)
            assert r.status_code == 400, (name, r.text)
            with pytest.raises(JError) as je:
                jcreate(jstore, name, {k: v.encode() if isinstance(v, str)
                                       else v for k, (_, v) in files.items()})
            assert je.value.status_code == 400
    finally:
        svc.stop()


# --- generate --text through the CLI ---

JOB_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.runtime.model import KubeModel

class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("{dataset}"))
    def build(self):
        return CausalTransformer(vocab_size={vocab}, max_len=48, embed_dim=32,
                                 depth=2, num_heads=2, device="cpu")
"""


@pytest.fixture(scope="module")
def text_cluster(tmp_path_factory):
    from kubeml_tpu_torch.api.config import Config
    from kubeml_tpu_torch.cluster import LocalCluster

    root = tmp_path_factory.mktemp("text") / "kubeml"
    cfg = Config(data_root=root, controller_port=0, scheduler_port=0,
                 ps_port=0, storage_port=0)
    with LocalCluster(config=cfg, device="cpu") as c:
        yield c


def _served_job(cluster, kind, seed):
    """A final of a tiny Flax ``CausalTransformer`` over the ``kind``
    dataset's vocabulary, registered as a finished job of the cluster;
    returns (job id, the JAX module and variables, the JAX tokenizer)."""
    from kubeml_tpu.models.gpt import CausalTransformer as JaxTransformer
    from kubeml_tpu.storage.checkpoint import CheckpointStore as JStore
    from kubeml_tpu_torch.api.types import History
    from kubeml_tpu_torch.controller import KubemlClient

    client = KubemlClient(cluster.controller_url)
    corpus = "\n\n".join(f"{PROMPT} document {i} — è ü ß"
                           for i in range(50))
    dataset, job, fn = f"{kind}-text", f"{kind}-lm", f"{kind}fn"
    out = client.datasets().create_text(
        dataset, corpus, seq_len=16,
        train_bpe=300 if kind == "bpe" else None)
    vocab = out["packing"]["vocab_size"]
    client.functions().create(fn, JOB_FN.format(dataset=dataset, vocab=vocab))
    module = JaxTransformer(vocab_size=vocab, max_len=48, embed_dim=32,
                            depth=2, num_heads=2)
    variables = numpy_tree(module.init(jax.random.PRNGKey(seed),
                                       np.zeros((1, 4), np.int32)))
    JStore(root=cluster.cfg.checkpoints_dir).save(
        job, variables, epoch=1, tag="final",
        meta={"request": {"function_name": fn}})
    cluster.history_store.save(History(id=job, task={"request": {
        "dataset": dataset, "function_name": fn}}))
    tok = (None if kind == "byte"
           else jbpe.tokenizer_from_spec(client.datasets().tokenizer(dataset)))
    return job, module, variables, tok


@pytest.mark.parametrize("kind,seed", [("byte", 3), ("bpe", 4)])
def test_generate_text_prints_jax_text(text_cluster, capsys, kind, seed):
    from kubeml_tpu.models.generation import generate as jgenerate
    from kubeml_tpu_torch.cli import main

    job, module, variables, tok = _served_job(text_cluster, kind, seed)
    prompt = (tok.encode(PROMPT) if tok is not None
              else jtext.byte_encode(PROMPT))[None]
    res = jgenerate(module, variables, prompt, max_new_tokens=12,
                    eos_id=jtext.EOS_ID)
    tokens = np.asarray(res.tokens)[0]
    want = (tok.decode(tokens) if tok is not None
            else jtext.byte_decode(tokens))
    outs = []
    for extra in ((), ("--stream",)):
        rc = main(["--url", text_cluster.controller_url, "generate", "-n",
                   job, "--text", PROMPT, "--max-new-tokens", "12", *extra])
        captured = capsys.readouterr()
        assert rc == 0, captured.err
        outs.append(captured.out)
    assert want and outs[0] == outs[1] == want + "\n"


def test_stream_prints_a_split_character_whole():
    """``é`` is two bytes: fed one record at a time it prints once whole;
    PAD or EOS ends the text and foreign ids are skipped, as
    ``byte_decode`` does."""
    from kubeml_tpu_torch.cli import _TextStream

    ids = text.byte_encode("café").tolist()
    stream = _TextStream(None)
    pieces = [stream.feed(ids[:4]), stream.feed(ids[4:] + [9999]),
              stream.feed([text.EOS_ID, 70]), stream.feed([71]),
              stream.end()]
    assert pieces == ["caf", "é", "", "", ""]
    spec = bpe.train_bpe("café café café", 270)
    tok = bpe.BPETokenizer(spec)
    ids = tok.encode("café").tolist()
    stream = _TextStream(tok)
    got = "".join(stream.feed([t]) for t in ids) + stream.end()
    assert got == tok.decode(ids) == "café"


def test_model_tokenizer_resolution(text_cluster):
    """A model without a history, or whose dataset has no asset, is
    byte-level; any other failure raises."""
    from kubeml_tpu_torch.cli import _model_tokenizer
    from kubeml_tpu_torch.controller import KubemlClient

    client = KubemlClient(text_cluster.controller_url)
    assert _model_tokenizer(client, "no-such-job") is None

    class Down:
        def get(self, job_id):
            raise KubeMLError("history store down", 503)

    class Client:
        def histories(self):
            return Down()

    with pytest.raises(KubeMLError) as e:
        _model_tokenizer(Client(), "x")
    assert e.value.status_code == 503
