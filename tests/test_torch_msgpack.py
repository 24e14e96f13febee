"""The port's msgpack reader and writer (``lfvdm_tpu_torch.utils.msgpack``)
against flax's (``flax.serialization``), on the CPU.

The writer's bytes equal ``flax.serialization.to_bytes`` on the flagship's
JAX parameter tree (the tree ``export_params`` writes: every leaf at the
flagship's shape, f32, keys sorted as ``jax.tree.map`` leaves them), on
scalars of every header width, and with flax's chunking of large leaves;
the reader gives what ``msgpack_restore`` gives, and refuses truncated data.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from lfvdm_tpu_torch.config import flagship_config
from lfvdm_tpu_torch.models.unet import UNetVideoModel
from lfvdm_tpu_torch.scripts.export_params import jax_tree
from lfvdm_tpu_torch.utils import msgpack


def flagship_tree():
    """The flagship U-Net's JAX tree with patterned f32 leaves (no init: the
    shapes come from the model built on the meta device)."""
    cfg = flagship_config()
    with torch.device("meta"):
        model = UNetVideoModel(cfg["in_channels"], cfg["num_channels"], cfg["in_channels"],
                               cfg["num_res_blocks"], (8, 16), channel_mult=(1, 1, 2, 3, 4),
                               num_heads=4)
    sd = {}
    for i, (name, p) in enumerate(model.state_dict().items()):
        n = p.numel()
        sd[name] = (np.arange(n, dtype=np.float32) % 251 * 1e-3 + i).reshape(tuple(p.shape))
    return jax_tree(sd, cfg)


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    return ta == tb and all(type(x) is type(y) and np.array_equal(x, y) for x, y in zip(la, lb))


def test_writer_and_reader_match_flax_on_the_flagship_tree():
    tree = flagship_tree()
    assert sum(x.size for x in jax.tree.leaves(tree)) == 77665923  # the flagship's parameters
    want = serialization.to_bytes(jax.tree.map(np.asarray, tree))
    digest = hashlib.sha256(want).hexdigest()
    got = msgpack.to_bytes(tree)
    assert len(got) == len(want) and hashlib.sha256(got).hexdigest() == digest
    del got
    assert _leaves_equal(msgpack.from_bytes(want), serialization.msgpack_restore(want))


def test_scalars_strings_and_lists_match_flax():
    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, -1, -32,
                     -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1],
            "floats": (0.5, -1e300), "none": None, "flags": [True, False],
            "text": {"short": "a" * 31, "str8": "b" * 255, "str16": "c" * 70000},
            "bin": b"\x00" * 300, "numpy": {"i32": np.int32(-7), "f64": np.float64(2.5),
                                          "u8": np.zeros((3, 0), np.uint8),
                                          "f16": np.ones((17,), np.float16)},
            "map16": {f"k{i}": i for i in range(20)}}
    want = serialization.to_bytes(tree)
    assert msgpack.to_bytes(tree) == want
    assert _leaves_equal(msgpack.from_bytes(want), serialization.msgpack_restore(want))


def test_chunked_leaves_match_flax(monkeypatch):
    """Leaves past MAX_CHUNK_SIZE bytes are split as flax splits them (the
    limit made small here), and joined again on reading."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10), "small": np.ones(3)}
    want = serialization.to_bytes(tree)
    assert msgpack.to_bytes(tree) == want
    got = msgpack.from_bytes(want)
    assert np.array_equal(got["big"], tree["big"]) and got["big"].shape == (5, 10)


@pytest.mark.parametrize("cut", [1, 10, 1000])
def test_truncated_data_raises(cut):
    data = serialization.to_bytes({"params": {"w": np.ones((30, 20), np.float32)}})
    with pytest.raises(ValueError, match="truncated msgpack data"):
        msgpack.from_bytes(data[:-cut])
    with pytest.raises(ValueError, match="extra data"):
        msgpack.from_bytes(data + b"\x00")
