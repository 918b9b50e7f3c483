"""Packed shards: training records and serving clips (port of
``jafpro_tpu/data/shardio.py``; numpy, and ``ctypes`` for the reader).

A record layout is declared by a spec: ordered (name, shape, dtype)
fields. ``pack_shard`` writes fixed-size records behind a header that
holds a hash of the spec. ``ShardReader`` streams shuffled training
batches through the native reader ``csrc/shardio.cc`` (the port's copy of
``native/shardio.cc``, built with ``g++`` at first use into ``_build/``),
so one seed gives both packages the same batches; ``ClipPackReader`` reads
one whole serving clip per record with plain file reads. Files are
byte-compatible with the JAX package's: either package reads what the
other packed.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import json
import os
import struct
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

Spec = Sequence[Tuple[str, Tuple[int, ...], str]]

# Shard-file header: magic + format version + a hash of the record spec,
# so a shard packed under another spec is refused instead of misread.
# Headerless files (packed before the header existed) get the
# size-divisibility check only.
SHARD_MAGIC = b"JFS1"
SHARD_VERSION = 1
HEADER_BYTES = 24  # magic[4] + version u32 + spec_hash u64 + reserved u64

# uint8 wire encoding by field semantics: symmetric (-1, 1) images,
# (0, 1) masks, raw 0..255 IUV codes
U8_SYMMETRIC_FIELDS = frozenset({
    "src_parts", "tgt_parts", "tgt_img", "src_img_first", "src_imgs",
    "prev_img"})
U8_UNIT_FIELDS = frozenset({
    "src_mask_parts", "tgt_mask_parts", "smpl_mask"})
U8_RAW_FIELDS = frozenset({"tgt_iuv255"})


def spec_hash(spec: Spec) -> int:
    """Stable 64-bit hash of the record layout (names, shapes, dtypes)."""
    canon = ";".join(
        f"{name}:{','.join(map(str, shape))}:{np.dtype(dtype).str}"
        for name, shape, dtype in spec)
    return struct.unpack(
        "<Q", hashlib.blake2b(canon.encode(), digest_size=8).digest())[0]


def _pack_header(spec: Spec) -> bytes:
    return SHARD_MAGIC + struct.pack(
        "<IQQ", SHARD_VERSION, spec_hash(spec), 0)


def _check_header(path: str, spec: Spec, rb: int) -> int:
    """Validate ``path`` against ``spec``; returns the header size to skip
    (0 for legacy headerless files, which only get the size check)."""
    sz = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
    if head[:4] == SHARD_MAGIC:
        version, shash, _ = struct.unpack("<IQQ", head[4:])
        if version != SHARD_VERSION:
            raise IOError(f"{path}: shard format version {version} != "
                          f"{SHARD_VERSION}; re-run `cli pack`")
        if shash != spec_hash(spec):
            raise IOError(
                f"{path}: shard spec hash {shash:#x} does not match the "
                f"requested record layout ({spec_hash(spec):#x}) — the "
                "shard was packed under a different spec (field set, "
                "shapes, or dtypes differ); re-run `cli pack`")
        payload = sz - HEADER_BYTES
        header = HEADER_BYTES
    else:
        payload = sz
        header = 0
    if payload < 0 or payload % rb:
        raise IOError(
            f"{path}: payload {payload} is not a multiple of the record "
            f"size {rb} — the shard was packed under a different spec "
            "(e.g. the pre-uint8 float32 format); re-run `cli pack`")
    return header


def record_bytes(spec: Spec) -> int:
    total = 0
    for _, shape, dtype in spec:
        total += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return total


def pack_record(spec: Spec, sample: Dict[str, np.ndarray]) -> bytes:
    parts = []
    for name, shape, dtype in spec:
        arr = np.ascontiguousarray(sample[name], dtype=dtype)
        if arr.shape != tuple(shape):
            raise ValueError(f"{name}: {arr.shape} != {tuple(shape)}")
        parts.append(arr.tobytes())
    return b"".join(parts)


def pack_shard(spec: Spec, samples, path: str) -> int:
    """Write an iterable of sample dicts to one shard file (with the
    spec-hash header); returns the record count."""
    n = 0
    with open(path, "wb") as f:
        f.write(_pack_header(spec))
        for s in samples:
            f.write(pack_record(spec, s))
            n += 1
    return n


def unpack_batch(spec: Spec, buf: np.ndarray, batch: int) -> Dict[str, np.ndarray]:
    out = {}
    offset = 0
    rb = record_bytes(spec)
    mat = buf.reshape(batch, rb)
    for name, shape, dtype in spec:
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        field = mat[:, offset:offset + nbytes]
        out[name] = np.ascontiguousarray(field).view(dtype).reshape(
            (batch,) + tuple(shape))
        offset += nbytes
    return out


def encode_field_u8(name: str, value: np.ndarray) -> np.ndarray:
    """Float sample field -> its uint8 wire form (exact for PNG-derived
    values, which the loaders compute as u/255*2-1 and u/255).
    Out-of-range values saturate instead of wrapping mod 256."""
    if name in U8_SYMMETRIC_FIELDS:
        scaled = np.rint((value + 1.0) * 0.5 * 255.0)
    elif name in U8_UNIT_FIELDS:
        scaled = np.rint(value * 255.0)
    else:
        scaled = np.rint(value)  # raw 0..255 codes
    return np.clip(scaled, 0.0, 255.0).astype(np.uint8)


def _lib() -> ctypes.CDLL:
    """The native reader, built at first use; argtypes declared once."""
    from jafpro_tpu_torch import cuda_build

    lib = cuda_build.load("shardio.cc")
    if lib.shardio_open.restype is not ctypes.c_void_p:
        lib.shardio_open.restype = ctypes.c_void_p
        lib.shardio_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.shardio_next.restype = ctypes.c_int64
        lib.shardio_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.shardio_num_records.restype = ctypes.c_int64
        lib.shardio_num_records.argtypes = [ctypes.c_void_p]
        lib.shardio_close.restype = None
        lib.shardio_close.argtypes = [ctypes.c_void_p]
    return lib


class ShardReader:
    """Batches of ``batch`` records from packed shards, read ahead by
    ``threads`` native workers into a ring of ``prefetch`` batches. With
    ``shuffle`` every epoch visits all records in an order fixed by
    (``seed``, epoch); with one thread the batches come in that order,
    with more they may arrive out of order. ``loop=False`` stops after
    the last whole batch."""

    def __init__(self, spec: Spec, paths: List[str], batch: int = 1,
                 prefetch: int = 2, threads: int = 2, seed: int = 0,
                 shuffle: bool = True, loop: bool = True):
        self.spec = list(spec)
        self.batch = batch
        self.rb = record_bytes(spec)
        self._h = None
        headers = {p: _check_header(p, spec, self.rb) for p in paths}
        if len(set(headers.values())) > 1:
            raise IOError(
                "mixed headered/headerless shards in one reader: "
                f"{headers} — re-run `cli pack` on the legacy files")
        header = next(iter(headers.values())) if headers else 0
        self._lib = _lib()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = self._lib.shardio_open(
            arr, len(paths), self.rb, header, batch, prefetch, threads,
            seed, int(shuffle), int(loop))
        if not self._h:
            raise IOError(f"shardio_open failed for {paths}")
        self.num_records = int(self._lib.shardio_num_records(self._h))
        self._buf = np.empty(self.rb * batch, np.uint8)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if not self._h:
            raise StopIteration
        idx = self._lib.shardio_next(
            self._h, self._buf.ctypes.data_as(ctypes.c_void_p))
        if idx < 0:
            raise StopIteration
        return unpack_batch(self.spec, self._buf, self.batch)

    def close(self) -> None:
        """Stop the workers and close the files."""
        if self._h:
            self._lib.shardio_close(self._h)
            self._h = None

    def __enter__(self) -> "ShardReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


def interval_spec(num_refs: int = 4, image_size: int = 256,
                  part_size: int = 200, num_parts: int = 24,
                  num_verts: int = 6890) -> Spec:
    """Record layout of a stage-3/4 training sample. Image-like fields are
    uint8 and expanded on the device (``train.common.normalize_batch``);
    ``tgt_iuv`` is derived there from ``tgt_iuv255``. ``bg_incomplete``
    stays float32: it carries unclipped Gaussian noise
    (``train/4:230-231``)."""
    S, p, P, R = image_size, part_size, num_parts, num_refs
    return [
        ("src_parts", (R, P, p, p, 3), "uint8"),
        ("src_mask_parts", (R, P, p, p), "uint8"),
        ("tgt_iuv255", (1, S, S, 3), "uint8"),
        ("tgt_img", (1, S, S, 3), "uint8"),
        ("src_img_first", (1, S, S, 3), "uint8"),
        ("src_imgs", (R, S, S, 3), "uint8"),
        ("bg_incomplete", (1, S, S, 3), "float32"),
        ("smpl_mask", (1, S, S, 1), "uint8"),
        ("face_bbox", (1, 4), "float32"),
        ("src_cams", (R, 3), "float32"),
        ("src_verts", (R, num_verts, 3), "float32"),
        ("tgt_cam", (1, 3), "float32"),
        ("tgt_verts", (1, num_verts, 3), "float32"),
    ]


# interval-record fields stored with a leading singleton target dim; the
# step takes them as (B, ...)
_SINGLE_TARGET_FIELDS = frozenset({
    "tgt_iuv255", "tgt_iuv", "tgt_img", "src_img_first", "bg_incomplete",
    "smpl_mask", "face_bbox", "tgt_cam", "tgt_verts"})


def collapse_target_dims(spec: Spec,
                         batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Merge each record's singleton target dim into the batch dim (the
    fields in ``_SINGLE_TARGET_FIELDS``); per-reference (R, ...) and
    multi-target (T, ...) fields keep their axis."""
    out = {}
    for name, shape, _ in spec:
        v = batch[name]
        if name in _SINGLE_TARGET_FIELDS:
            v = v.reshape((v.shape[0],) + tuple(shape)[1:])
        out[name] = v
    return out


def textonly_spec(num_refs: int = 4, num_target: int = 3,
                  part_size: int = 200, num_parts: int = 24) -> Spec:
    """Record layout of a stage-1/2 (texture-only) training sample, uint8
    (27 MB at the full widths)."""
    p, P, R, T = part_size, num_parts, num_refs, num_target
    return [
        ("src_parts", (R, P, p, p, 3), "uint8"),
        ("src_mask_parts", (R, P, p, p), "uint8"),
        ("tgt_parts", (T, P, p, p, 3), "uint8"),
        ("tgt_mask_parts", (T, P, p, p), "uint8"),
    ]


def stage_spec(stage: int, num_refs: int = 4, num_target: int = 3,
               image_size: int = 256, part_size: int = 200,
               num_parts: int = 24, num_verts: int = 6890) -> Spec:
    """The record layout a training stage reads."""
    if stage <= 2:
        return textonly_spec(num_refs=num_refs, num_target=num_target,
                             part_size=part_size, num_parts=num_parts)
    return interval_spec(num_refs=num_refs, image_size=image_size,
                         part_size=part_size, num_parts=num_parts,
                         num_verts=num_verts)


def clip_spec(num_refs: int = 4, frames: int = 30, image_size: int = 256,
              part_size: int = 200, num_parts: int = 24,
              num_verts: int = 6890) -> Spec:
    """Record layout for one whole serving clip (every field ``load_clip``
    assembles, minus the gt frames)."""
    S, p, P, R, T = image_size, part_size, num_parts, num_refs, frames
    return [
        ("src_parts", (R, P, p, p, 3), "uint8"),
        ("src_mask_parts", (R, P, p, p), "uint8"),
        ("bg_incomplete", (S, S, 3), "float32"),
        ("src_imgs", (R, S, S, 3), "uint8"),
        ("chosen_frames", (R,), "int32"),
        ("tgt_iuv255", (T, S, S, 3), "uint8"),
        ("smpl_mask", (T, S, S, 1), "uint8"),
        ("cams", (T, 3), "float32"),
        ("verts", (T, num_verts, 3), "float32"),
    ]


def write_clip_pack(clips: Iterable[dict], out_dir: str, mode: str = "test",
                    num_refs: int = 4) -> int:
    """Pack clips (``load_clip`` dicts, each with its ``vid_name`` and
    ``chosen_names``) into ``<out_dir>/{mode}-clips-00000.shard`` +
    ``index.json`` (vid names, chosen reference-frame names, spec). The
    spec comes from the first clip's shapes. Returns the clip count."""
    os.makedirs(out_dir, exist_ok=True)
    index = {"mode": mode, "num_refs": num_refs, "vids": [],
             "chosen_names": []}
    it = iter(clips)
    first = next(it, None)
    if first is None:
        raise ValueError(f"no {mode} clips to pack")
    spec = clip_spec(
        num_refs=num_refs, frames=first["tgt_iuv255"].shape[0],
        image_size=first["tgt_iuv255"].shape[1],
        part_size=first["src_parts"].shape[-2],
        num_parts=first["src_parts"].shape[2],
        num_verts=first["verts"].shape[1])

    def records():
        for c in itertools.chain([first], it):
            rec = {}
            for name, shape, dtype in spec:
                v = np.asarray(c[name])
                if v.shape != tuple(shape):
                    v = v.reshape(shape)  # strip the loader's batch dim
                if np.dtype(dtype) != v.dtype:
                    if dtype == "uint8":
                        v = encode_field_u8(name, v)
                    else:
                        v = v.astype(dtype)
                rec[name] = v
            index["vids"].append(c["vid_name"])
            index["chosen_names"].append(list(c["chosen_names"]))
            yield rec

    n = pack_shard(spec, records(),
                   os.path.join(out_dir, f"{mode}-clips-00000.shard"))
    index["spec"] = [[name, list(shape), dtype]
                     for name, shape, dtype in spec]
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f)
    return n


def pack_test_clips(data_root: str, smpl_root: str, mask_root: str,
                    out_dir: str, mode: str = "test",
                    num_refs: int = 4) -> int:
    """Decode every ``mode`` clip of the dataset and pack it with
    ``write_clip_pack``. Returns the clip count."""
    from jafpro_tpu_torch.data.dataset import list_videos, load_clip

    vids = list_videos(data_root, mode)
    if not vids:
        raise FileNotFoundError(f"no {mode} videos under {data_root}")
    return write_clip_pack(
        (load_clip(os.path.join(data_root, mode),
                   os.path.join(smpl_root, mode),
                   os.path.join(mask_root, mode), vid, num_refs=num_refs)
         for vid in vids),
        out_dir, mode=mode, num_refs=num_refs)


class ClipPackReader:
    """Random-access reader over a packed serving-clip shard
    (``pack_test_clips`` output). ``load(i)`` returns the dict
    ``load_clip`` would (minus ``gt_frames``), in the uint8 wire form."""

    def __init__(self, pack_dir: str):
        with open(os.path.join(pack_dir, "index.json")) as f:
            self.index = json.load(f)
        self.spec: Spec = [
            (name, tuple(shape), dtype)
            for name, shape, dtype in self.index["spec"]]
        self.vids: List[str] = self.index["vids"]
        self.num_refs: int = self.index["num_refs"]
        self.rb = record_bytes(self.spec)
        self.path = os.path.join(
            pack_dir, f"{self.index['mode']}-clips-00000.shard")
        self._header = _check_header(self.path, self.spec, self.rb)
        n = (os.path.getsize(self.path) - self._header) // self.rb
        if n != len(self.vids):
            raise IOError(
                f"{self.path}: {n} records but index lists "
                f"{len(self.vids)} vids — repack")

    def __len__(self) -> int:
        return len(self.vids)

    def load(self, i: int) -> Dict[str, np.ndarray]:
        with open(self.path, "rb") as f:
            f.seek(self._header + i * self.rb)
            buf = np.fromfile(f, np.uint8, count=self.rb)
        rec = unpack_batch(self.spec, buf, 1)
        out = {}
        for name, shape, _ in self.spec:
            v = rec[name][0]
            # restore the loader's batch-dim layout (load_clip contract)
            if name in ("src_parts", "src_mask_parts", "bg_incomplete"):
                v = v[None]
            out[name] = v
        out["ref_mask"] = np.ones((1, self.num_refs), np.float32)
        out["vid_name"] = self.vids[i]
        out["chosen_names"] = self.index["chosen_names"][i]
        return out
