"""The port's checkpoint format against the reference's, on the CPU.

``repro_torch.checkpoint`` reads and writes the reference's msgpack files
with its own codec (``checkpoint/_msgpack.py``). Held here:

* the codec gives ``msgpack.packb(obj, use_bin_type=True)``'s bytes for
  every type width it supports, and reads them back;
* the port's ``_flatten_with_paths`` gives ``jax.tree_util``'s key paths in
  its order (dicts sorted, NamedTuples by field name, sequences by index);
* the port's ``save_federation`` of a trained federation is byte-identical
  to the reference's ``save_checkpoint`` of the same arrays, each package
  loads the other's file with equal values and the template's dtypes;
* a torn newest step falls back to the one before (``strict`` raises), and
  truncated data, extra data and a missing key each raise one of
  ``_CORRUPT_ERRORS``.
"""
from typing import NamedTuple

import msgpack
import numpy as np
import pytest

from repro.checkpoint import ckpt as jckpt
from repro.serve import federation_template as jfederation_template
from repro_torch.api import FedEngine, method_config
from repro_torch.checkpoint import (
    checkpoint_steps,
    latest_step,
    load_checkpoint,
    load_latest,
    save_checkpoint,
)
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.checkpoint._msgpack import MsgpackError, packb, unpackb
from repro_torch.faults import tear_file
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from repro_torch.serve import federation_template, federation_tree, save_federation
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)

STEP = 2

# one case per form of each type: the boundaries where msgpack changes form
CODEC_CASES = {
    "fixint": [0, 127], "uint8": [128, 255], "uint16": [256, 65535],
    "uint32": [65536, 2 ** 32 - 1], "uint64": [2 ** 32, 2 ** 64 - 1],
    "fixstr": ["", "x" * 31, "ü"], "str8": ["x" * 32, "x" * 255], "str16": ["x" * 256],
    "str32": ["x" * 65536],
    "bin8": [b"", b"\x00" * 255], "bin16": [b"\x01" * 256], "bin32": [b"\x02" * 65536],
    "fixarray": [[], list(range(15))], "array16": [list(range(16))],
    "array32": [[1] * 65536],
    "fixmap": [{}, {str(i): i for i in range(15)}], "map16": [{str(i): i for i in range(16)}],
    "map32": [{str(i): b"" for i in range(65536)}],
    "record": [{"w": {"dtype": "float32", "shape": [3, 4],
                      "data": np.arange(12, dtype=np.float32).tobytes()}}],
}


@pytest.mark.parametrize("form", sorted(CODEC_CASES))
def test_codec_matches_msgpack_for_every_width(form):
    for obj in CODEC_CASES[form]:
        want = msgpack.packb(obj, use_bin_type=True)
        assert packb(obj) == want
        assert unpackb(want) == msgpack.unpackb(want, raw=False) == obj


@pytest.mark.parametrize("data", [b"", b"\x81\xa1a", b"\xcd\x01", b"\xc6\x00\x00\x00\x09ab"])
def test_codec_raises_on_truncated_data(data):
    with pytest.raises(MsgpackError, match="truncated"):
        unpackb(data)


@pytest.mark.parametrize("data", [b"\x00\x00", packb({"a": 1}) + b"\x90"])
def test_codec_raises_on_extra_data(data):
    with pytest.raises(MsgpackError, match="extra data"):
        unpackb(data)


@pytest.mark.parametrize("data", [b"\xc0", b"\xc2", b"\xca\x00\x00\x00\x00", b"\xff",
                                  b"\x91\xd0\x01"])
def test_codec_raises_on_a_type_it_does_not_know(data):
    with pytest.raises(MsgpackError, match="unsupported type byte"):
        unpackb(data)


def test_codec_refuses_what_it_cannot_write():
    for obj in (-1, 1.5, None, True, 2 ** 64):
        with pytest.raises(MsgpackError):
            packb(obj)
    assert issubclass(MsgpackError, ValueError)


class _Pair(NamedTuple):
    second: np.ndarray
    first: np.ndarray


def test_flatten_paths_and_order_are_jax_tree_utils():
    leaf = np.zeros(2, np.float32)
    tree = {"b": [leaf, (leaf, None)], "a": _Pair(second=leaf, first=leaf),
            "c": {"z": leaf, "y": {"x": leaf}}, "d": None}
    want = list(jckpt._flatten_with_paths(tree)[0])
    assert list(tckpt._flatten_with_paths(tree)) == want
    assert want == ["a/second", "a/first", "b/0", "b/1/0", "c/y/x", "c/z"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port-trained federation (pubmed scale 64, 4 clients, fedais 2
    rounds on the CPU), saved by the port: (fed, state, dir)."""
    g = make_dataset("pubmed", scale=64, seed=0)
    fed = partition_graph(g, 4, alpha=0.5, seed=0)
    eng = FedEngine(g, fed, method_config("fedais", tau0=2), rounds=STEP, clients_per_round=2,
                    seed=0, eval_every=STEP, device="cpu")
    state = eng.init_state()
    eng.run(state)
    d = str(tmp_path_factory.mktemp("ckpt"))
    save_federation(d, STEP, state)
    return fed, state, d


def test_federation_tree_has_the_reference_template_dtypes(trained):
    fed, state, _ = trained
    tree = federation_tree(state)
    jt = jfederation_template(fed)
    assert sorted(tree) == sorted(jt) and sorted(tree["params"]) == sorted(jt["params"])
    for k in ("hist1", "age", "ghost_feat", "prev_loss"):
        assert tree[k].dtype == np.dtype(jt[k].dtype) and tree[k].shape == jt[k].shape, k
    for k, v in tree["params"].items():
        assert v.dtype == np.float32 and v.shape == jt["params"][k].shape, k
    # the port keeps ghost_feat in its historical state; the tree writes it
    # under the reference's key
    assert np.array_equal(tree["ghost_feat"], state.hist.ghost_feat.numpy())
    # an int64 age (which the reference's reader would take silently) is
    # written as the template's int32
    wide = federation_tree({**tree, "age": tree["age"].astype(np.int64)})
    assert wide["age"].dtype == np.int32


def test_port_file_is_byte_identical_to_the_reference_writer(trained, tmp_path):
    _, state, d = trained
    ref_path = jckpt.save_checkpoint(str(tmp_path), STEP, federation_tree(state))
    port_path = f"{d}/step_{STEP:08d}.msgpack"
    with open(port_path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()


def test_reference_loads_the_port_file(trained):
    fed, state, d = trained
    jt = jfederation_template(fed)
    got = jckpt.load_checkpoint(d, STEP, jt)
    want = federation_tree(state)
    for k in ("hist1", "age", "ghost_feat", "prev_loss"):
        assert got[k].dtype == jt[k].dtype and np.array_equal(np.asarray(got[k]), want[k]), k
    for k, v in got["params"].items():
        assert v.dtype == jt["params"][k].dtype
        assert np.array_equal(np.asarray(v), want["params"][k]), k


def test_port_loads_the_reference_file(trained, tmp_path):
    fed, state, _ = trained
    rng = np.random.default_rng(3)
    jt = jfederation_template(fed)
    arrays = {k: rng.standard_normal(v.shape).astype(v.dtype) if k != "params" else
              {n: rng.standard_normal(p.shape).astype(p.dtype) for n, p in v.items()}
              for k, v in jt.items()}
    arrays["age"] = rng.integers(0, 9, jt["age"].shape).astype(np.int32)
    jckpt.save_checkpoint(str(tmp_path), 7, arrays)
    template = federation_template(fed)
    got = load_checkpoint(str(tmp_path), 7, template)
    assert got.keys() == template.keys()
    for k in ("hist1", "age", "ghost_feat", "prev_loss"):
        assert got[k].dtype == template[k].dtype and np.array_equal(got[k], arrays[k]), k
        assert got[k].flags.writeable
    for k, v in got["params"].items():
        assert v.dtype == np.float32 and np.array_equal(v, arrays["params"][k]), k


def test_torn_newest_step_falls_back(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "n": np.arange(3, dtype=np.int32)}
    d = str(tmp_path)
    save_checkpoint(d, 1, tree)
    newer = {k: v + 1 for k, v in tree.items()}
    path = save_checkpoint(d, 2, newer)
    assert checkpoint_steps(d) == [1, 2] and latest_step(d) == 2
    assert load_latest(d, tree)[0] == 2
    tear_file(path)
    step, got = load_latest(d, tree)
    assert step == 1 and all(np.array_equal(got[k], tree[k]) for k in tree)
    with pytest.raises(tckpt._CORRUPT_ERRORS):
        load_latest(d, tree, strict=True)
    tear_file(f"{d}/step_{1:08d}.msgpack")
    with pytest.raises(ValueError, match="every candidate failed"):
        load_latest(d, tree)
    with pytest.raises(FileNotFoundError):
        load_latest(str(tmp_path / "empty"), tree)
    assert not list(tmp_path.glob("*.tmp"))


def _corrupt_cases(tmp_path):
    tree = {"w": np.ones((2, 2), np.float32)}
    d = str(tmp_path)
    path = save_checkpoint(d, 1, tree)
    good = open(path, "rb").read()
    return d, tree, path, good


@pytest.mark.parametrize("kind", ["truncated", "extra", "missing_key", "bad_shape",
                                  "not_a_map"])
def test_corrupt_file_raises_a_corrupt_error(tmp_path, kind):
    d, tree, path, good = _corrupt_cases(tmp_path)
    like = tree
    if kind == "truncated":
        data = good[:-3]
    elif kind == "extra":
        data = good + b"\x00"
    elif kind == "not_a_map":
        data = packb([1, 2])
    else:
        data = good
        like = ({"w": tree["w"], "v": tree["w"]} if kind == "missing_key"
                else {"w": np.ones((4,), np.float32)})
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(tckpt._CORRUPT_ERRORS):
        load_checkpoint(d, 1, like)
    # the reference reads the same bytes as corrupt too
    with pytest.raises(jckpt._CORRUPT_ERRORS):
        jckpt.load_checkpoint(d, 1, like)


def test_a_failed_write_leaves_no_tmp(tmp_path, monkeypatch):
    def broken(obj):
        raise MsgpackError("disk full")

    monkeypatch.setattr(tckpt, "packb", broken)
    with pytest.raises(MsgpackError):
        save_checkpoint(str(tmp_path), 1, {"w": np.ones(2, np.float32)})
    assert not list(tmp_path.iterdir())
