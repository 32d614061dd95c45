"""Checkpoint I/O in the JAX package's msgpack format, without flax or
msgpack.

Counterpart of ``gcn_grabcut_tpu/train/checkpoints.py``.
A checkpoint is a flax ``msgpack_serialize`` tree: a map with ``params``,
``batch_stats``, ``meta_json`` (the JSON metadata as a uint8 array) and
optionally ``opt_state``.  flax writes arrays as msgpack ext type 1 and
numpy scalars as ext type 3, each holding a msgpack array ``[shape,
dtype name, raw C-order bytes]``.  `msgpack_restore` decodes the subset
of msgpack flax writes into the same tree flax's own ``msgpack_restore``
gives: dicts, lists, str, bytes, int, float, bool, None and numpy arrays.
The weights then go through ``models/convert.py``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from ..core.device import resolve_device
from ..models.convert import state_dict_from_jax
from ..models.factory import ModelEnsemble, build_model

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3

# Keys of model_kwargs that change parameter shapes; the rest (dropout,
# dtype) may differ between members and do not reach the port's modules.
_SHAPE_KEYS = ("in_channels", "edge_channels", "hidden_channels",
               "n_layers", "n_classes", "n_heads")


class _Reader:
    """Decodes one msgpack value at a time from `buf`."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, size: int):
        code = self.unpack(">b")
        return _decode_ext(code, bytes(self.take(size)))

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(">" + "BHI"[b - 0xC7]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(">" + "BHI"[b - 0xD9])),
                       "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_restore(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        # numpy has no bfloat16: widen exactly to float32 (the high half
        # of a float32's bits).
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _decode_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        raise NotImplementedError("msgpack ext type 2 (complex) is not read")
    raise ValueError(f"unknown msgpack ext type {code}")


def msgpack_restore(data: bytes):
    """The tree flax's ``serialization.msgpack_restore`` decodes from
    `data` (chunked oversized arrays excepted: checkpoints hold none)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes "
                         "after the msgpack value")
    return out


def load_checkpoint(path: str | Path):
    """Returns (params, batch_stats, meta dict)."""
    payload = msgpack_restore(Path(path).read_bytes())
    meta = json.loads(bytes(payload["meta_json"]).decode())
    return payload["params"], payload["batch_stats"], meta


def _shape_kwargs(kw: dict) -> dict:
    return {k: kw[k] for k in _SHAPE_KEYS if k in kw}


def _load_member(path, dtype=None):
    """(model on the CPU, meta) from one checkpoint: the variant its meta
    names, its weights converted by ``models/convert.py``."""
    params, batch_stats, meta = load_checkpoint(path)
    model = build_model(meta.get("variant", "resgcn"), dtype=dtype,
                        **_shape_kwargs(meta.get("model_kwargs", {})))
    model.load_state_dict(state_dict_from_jax(
        {"params": params, "batch_stats": batch_stats}))
    return model.eval(), meta


def load_model_from_checkpoint(path: str | Path, device=None, dtype=None):
    """(model, meta) rebuilt from a checkpoint's own metadata, on `device`
    (default: the card), in the compute `dtype` (default float32)."""
    dev = resolve_device(device)
    model, meta = _load_member(path, dtype)
    return model.to(dev), meta


def load_ensemble_from_checkpoints(paths, device=None, dtype=None):
    """(ModelEnsemble, metas) from M architecture-compatible checkpoints:
    every file must share the first one's variant and shape kwargs."""
    dev = resolve_device(device)
    paths = [Path(p) for p in paths]
    if not paths:
        raise ValueError("load_ensemble_from_checkpoints needs >= 1 path")
    members, metas = [], []
    for p in paths:
        model, meta = _load_member(p, dtype)
        members.append(model)
        metas.append(meta)
    ref_kw = _shape_kwargs(metas[0].get("model_kwargs", {}))
    ref_variant = metas[0].get("variant", "resgcn")
    for p, m in zip(paths[1:], metas[1:]):
        if (m.get("variant", "resgcn") != ref_variant
                or _shape_kwargs(m.get("model_kwargs", {})) != ref_kw):
            raise ValueError(
                f"checkpoint {p} is architecture-incompatible with "
                f"{paths[0]} ({m.get('variant')}/{m.get('model_kwargs')} vs "
                f"{ref_variant}/{metas[0].get('model_kwargs')})")
    return ModelEnsemble(members).to(dev).eval(), metas


def load_model_auto(spec, device=None, dtype=None):
    """`spec` is one checkpoint path, a comma-separated list or a sequence
    of paths.  One path loads a plain model, several the ensemble.
    Returns (model, meta) with meta["ensemble_size"] set."""
    if isinstance(spec, (str, Path)):
        paths = [p for p in str(spec).split(",") if p]
    else:
        paths = [str(p) for p in spec]
    if len(paths) == 1:
        model, meta = load_model_from_checkpoint(paths[0], device=device,
                                                 dtype=dtype)
        return model, dict(meta, ensemble_size=1)
    model, metas = load_ensemble_from_checkpoints(paths, device=device,
                                                  dtype=dtype)
    return model, dict(metas[0], ensemble_size=len(paths))
