"""Port parity: the port's msgpack checkpoint reader against flax's
``serialization.msgpack_restore`` on every checkpoint in the repo, leaf
by leaf, and on hand-built bytes of every msgpack type it reads."""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from flax import serialization

from gcn_grabcut_tpu.train import checkpoints as jckpt
from gcn_grabcut_torch.train import checkpoints as tckpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINTS = sorted(ROOT.glob("examples/**/*.msgpack")) + sorted(
    ROOT.glob("checkpoints/*.msgpack"))
BGC_PARAMS = 187_826


def assert_same_tree(a, b, path="") -> int:
    """Equal structure, types and leaves; returns the number of leaves."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        return sum(assert_same_tree(a[k], b[k], f"{path}/{k}") for k in b)
    if isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        return sum(assert_same_tree(x, y, f"{path}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path
    return 1


def test_every_checkpoint_decodes_as_flax_does():
    assert len(CHECKPOINTS) >= 20
    with_opt_state = []
    for p in CHECKPOINTS:
        blob = p.read_bytes()
        want = serialization.msgpack_restore(blob)
        got = tckpt.msgpack_restore(blob)
        assert assert_same_tree(got, want, p.name) > 0
        if "opt_state" in want:
            with_opt_state.append(p.name)
    assert "bgc_s42.msgpack" in with_opt_state


def test_load_checkpoint_matches_jax():
    p = ROOT / "examples/ensemble_r5/bgc_s42.msgpack"
    jp, jb, jm = jckpt.load_checkpoint(p)
    tp, tb, tm = tckpt.load_checkpoint(p)
    assert tm == jm and tm["model_kwargs"] == {"hidden_channels": 128,
                                               "n_layers": 6}
    assert_same_tree(tp, jp)
    assert_same_tree(tb, jb)
    assert sum(a.size for a in _leaves(tp)) == BGC_PARAMS
    model, meta = tckpt.load_model_auto(str(p), device="cpu")
    assert meta["ensemble_size"] == 1
    assert sum(q.numel() for q in model.parameters()) == BGC_PARAMS


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_incompatible_members_and_other_variants_raise():
    a = ROOT / "examples/ensemble_r5/bgc_s42.msgpack"
    other = ROOT / "examples/hard_synth_resgcn.msgpack"
    assert (tckpt.load_checkpoint(other)[2]["model_kwargs"]
            != tckpt.load_checkpoint(a)[2]["model_kwargs"])
    with pytest.raises(ValueError, match="architecture-incompatible"):
        tckpt.load_model_auto(f"{a},{other}", device="cpu")
    with pytest.raises(ValueError, match="Unknown variant"):
        tckpt.build_model("sage")


@pytest.mark.parametrize("variant", ["resgcn", "gcn", "gat"])
def test_each_variant_builds_and_round_trips_its_weights(variant, tmp_path):
    """build_model for every variant; its weights through a checkpoint
    the port writes come back leaf for leaf, into the variant its meta
    names."""
    from gcn_grabcut_torch.models.convert import jax_variables_from_state_dict
    model = tckpt.build_model(variant, hidden_channels=16, n_layers=2)
    variables = jax_variables_from_state_dict(model.state_dict())
    path = tmp_path / f"{variant}.msgpack"
    tckpt.save_checkpoint(path, variables["params"],
                          variables["batch_stats"],
                          meta=dict(variant=variant, model_kwargs=dict(
                              hidden_channels=16, n_layers=2)))
    params, stats, _ = jckpt.load_checkpoint(path)

    def sorted_tree(tree):     # flax writes maps in sorted key order
        return tckpt.msgpack_restore(tckpt.msgpack_serialize(tree))
    assert assert_same_tree(params, sorted_tree(variables["params"])) > 0
    assert_same_tree(stats, sorted_tree(variables["batch_stats"]))
    loaded, meta = tckpt.load_model_auto(str(path), device="cpu")
    assert type(loaded) is type(model) and meta["variant"] == variant
    sd = model.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in loaded.state_dict().items())


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        return bytes([fix[n]]) + struct.pack(">b", code) + payload
    if n < 256:
        return b"\xc7" + struct.pack(">Bb", n, code) + payload
    if n < 65536:
        return b"\xc8" + struct.pack(">Hb", n, code) + payload
    return b"\xc9" + struct.pack(">Ib", n, code) + payload


def _ndarray_payload(shape, name: str, raw: bytes) -> bytes:
    shape_b = bytes([0x90 | len(shape)]) + b"".join(
        bytes([s]) for s in shape)
    return (b"\x93" + shape_b + bytes([0xA0 | len(name)]) + name.encode()
            + b"\xc4" + bytes([len(raw)]) + raw)


CASES = [
    (b"\x05", 5), (b"\x7f", 127), (b"\xff", -1), (b"\xe0", -32),
    (b"\xcc\xc8", 200), (b"\xcd\x01\x00", 256),
    (b"\xce\x00\x01\x00\x00", 65536), (b"\xcf" + (2 ** 40).to_bytes(8, "big"),
                                       2 ** 40),
    (b"\xd0\x80", -128), (b"\xd1\x80\x00", -32768),
    (b"\xd2\x80\x00\x00\x00", -2 ** 31),
    (b"\xd3" + (-2 ** 40).to_bytes(8, "big", signed=True), -2 ** 40),
    (b"\xc0", None), (b"\xc2", False), (b"\xc3", True),
    (b"\xca" + struct.pack(">f", 1.5), 1.5),
    (b"\xcb" + struct.pack(">d", -0.1), -0.1),
    (b"\xa3abc", "abc"), (b"\xd9\x03xyz", "xyz"),
    (b"\xda\x00\x02hi", "hi"), (b"\xdb\x00\x00\x00\x01z", "z"),
    (b"\xc4\x02\x01\x02", b"\x01\x02"), (b"\xc5\x00\x01\x07", b"\x07"),
    (b"\xc6\x00\x00\x00\x00", b""),
    (b"\x92\x01\xa1a", [1, "a"]), (b"\xdc\x00\x01\xc3", [True]),
    (b"\xdd\x00\x00\x00\x00", []),
    (b"\x82\xa1a\x01\xa1b\x90", {"a": 1, "b": []}),
    (b"\xde\x00\x01\xa1k\xc0", {"k": None}),
    (b"\xdf\x00\x00\x00\x00", {}),
]


@pytest.mark.parametrize("blob,want", CASES,
                         ids=[c[0][:1].hex() + f"_{i}"
                              for i, c in enumerate(CASES)])
def test_each_msgpack_type(blob, want):
    import msgpack
    assert msgpack.unpackb(blob, raw=False) == want
    got = tckpt.msgpack_restore(blob)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16])
def test_fixext_framings(size):
    """fixext 1-16 hold their code and payload at the right offsets: an
    unknown code is named, a known one decodes (fixext16: 5 uint8)."""
    import msgpack
    blob = _ext(9, bytes(range(size)))
    assert blob[0] == 0xD4 + size.bit_length() - 1
    assert msgpack.unpackb(blob) == msgpack.ExtType(9, bytes(range(size)))
    with pytest.raises(ValueError, match="ext type 9"):
        tckpt.msgpack_restore(blob)
    if size == 16:
        arr = np.arange(5, dtype=np.uint8)
        blob = _ext(1, _ndarray_payload((5,), "uint8", arr.tobytes()))
        assert blob[0] == 0xD8
        np.testing.assert_array_equal(tckpt.msgpack_restore(blob), arr)


@pytest.mark.parametrize("n", [3, 300, 70000])
def test_ext_ndarray_and_scalar(n):
    """flax's ndarray ext (code 1) in ext8, ext16 and ext32 framings, and
    its numpy-scalar ext (code 3)."""
    import msgpack
    arr = np.arange(n, dtype=np.int32).reshape(-1, 1)
    blob = _ext(1, msgpack.packb((arr.shape, "int32", arr.tobytes()),
                                 use_bin_type=True))
    assert blob[0] == (0xC7 if n < 60 else 0xC8 if n < 16000 else 0xC9)
    want = serialization.msgpack_restore(blob)
    got = tckpt.msgpack_restore(blob)
    assert got.dtype == want.dtype and got.shape == want.shape == (n, 1)
    np.testing.assert_array_equal(got, want)

    scalar = _ext(3, _ndarray_payload((), "float32",
                                      np.float32(2.5).tobytes()))
    s_want = serialization.msgpack_restore(scalar)
    s_got = tckpt.msgpack_restore(scalar)
    assert type(s_got) is type(s_want) and s_got == s_want


def test_bfloat16_leaves_widen_exactly():
    import jax.numpy as jnp
    import msgpack
    vals = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32)
    raw = np.asarray(jnp.asarray(vals, jnp.bfloat16)).tobytes()
    blob = _ext(1, msgpack.packb(((4,), "bfloat16", raw), use_bin_type=True))
    want = np.asarray(serialization.msgpack_restore(blob), np.float32)
    np.testing.assert_array_equal(tckpt.msgpack_restore(blob), want)


def test_bad_input_raises():
    with pytest.raises(ValueError, match="truncated"):
        tckpt.msgpack_restore(b"\xa5ab")
    with pytest.raises(ValueError, match="trailing"):
        tckpt.msgpack_restore(b"\x01\x02")
    with pytest.raises(ValueError, match="0xc1"):
        tckpt.msgpack_restore(b"\xc1")
    with pytest.raises(NotImplementedError, match="complex"):
        tckpt.msgpack_restore(_ext(2, b"\x92\x01\x02"))
    with pytest.raises(ValueError, match="ext type 9"):
        tckpt.msgpack_restore(_ext(9, b"\x00"))
