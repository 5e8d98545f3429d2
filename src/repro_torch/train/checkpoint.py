"""Checkpoints in the JAX package's on-disk layout, written and read with
neither ``msgpack`` nor ``zstandard`` required.

Layout:  <dir>/step_<N>/
           manifest.json        leaf paths, shapes, dtypes, content hashes
           shard_<host>.msgpack this host's leaf bytes (each leaf
                                compressed; the codec in the manifest)

* atomic commit: written to ``step_<N>.tmp``, then renamed;
* integrity: a blake2b hash per leaf, checked on restore;
* elasticity: whole tensors are stored; ``restore_checkpoint`` places
  them on the ``device`` it is given (the reference's ``shardings``); a
  mesh saves whole logical leaves too, streamed (``save_checkpoint`` of
  ``(path, leaf)`` pairs, each leaf gathered as the writer takes it), and
  a mesh of any shape reads them back leaf by leaf (:func:`iter_checkpoint`),
  each rank keeping its blocks; either way no more than about
  ``STREAM_BYTES`` of leaves (and one more leaf) are held at once;
* retention: the ``keep`` newest checkpoints survive;
* async: ``save_checkpoint(..., blocking=False)`` copies the leaves to the
  host, then hands the writing to a thread; a blocking save copies each
  leaf as it writes it, so the host never holds the whole tree.

A tree is nested dicts and lists of tensors or numpy arrays; its leaves
are named by their ``"/"``-joined paths, dict keys in sorted order, as the
JAX package names them.  bfloat16 leaves keep their two bytes an element
under the dtype ``"bfloat16"``, which numpy cannot hold: they are written
and read as uint8 views.  The shard file is a msgpack map of str keys to
bin values, which this module writes and reads itself (the subset that
payload needs), leaf by leaf; a restore reads each leaf's bytes at its
offset, on the pool.  A leaf streams through the hash and the codec in
pieces of 16 MiB, a card's through a pinned buffer of the thread's, so
the host makes no whole copy of a card's leaf (a save holds a leaf's
compressed bytes until they are written).  Leaves are compressed with zstd
(level 3) when ``zstandard`` imports, else stored in stdlib zlib's framing
(level 0): the reference's fallback codec, which reads any level, but
without deflate, whose CPU time near-random parameter bytes do not repay.  A
zstd checkpoint without ``zstandard`` raises.  Leaves are hashed and
(de)compressed on a pool of threads, which both release the GIL, one
thread a leaf, the largest first; a leaf is written as soon as it is
done, so the shard's order (which the manifest lists, and no reader
depends on) may differ from one save to the next.  ``timings``, a dict, receives the
seconds of each part of a save or a restore.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import struct
import threading
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..convert import flatten_paths, nest_paths

try:  # optional: stdlib zlib when zstandard is not installed
    import zstandard
except ImportError:
    zstandard = None

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "Checkpointer"]

_DTYPES = {str(t).removeprefix("torch."): t for t in (
    torch.float64, torch.float32, torch.bfloat16, torch.float16, torch.int64,
    torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)}


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _make_compressor():
    """(codec name, a function of a leaf's byte count that makes a
    streaming compressor): zstd when available (the frame records the
    size, which the reference's one-shot decompress needs), else zlib's
    stored form."""
    if zstandard is not None:
        return "zstd", lambda size: zstandard.ZstdCompressor(level=3).compressobj(size=size)
    return "zlib", lambda size: zlib.compressobj(0)


def _check_codec(codec: str):
    if codec == "zstd" and zstandard is None:
        raise ImportError(
            "checkpoint was written with zstd compression but the "
            "'zstandard' package is not installed; pip install zstandard")
    if codec not in ("zstd", "zlib"):
        raise IOError(f"unknown checkpoint compression codec {codec!r}")


def _inflate(codec: str, chunks, times: list):
    """The raw bytes of a leaf's compressed ``chunks``, in pieces; the
    seconds spent go to ``times[1]``."""
    if codec == "zstd":
        d = zstandard.ZstdDecompressor().decompressobj()
        for data in chunks:
            t0 = time.perf_counter()
            piece = d.decompress(data)
            times[1] += time.perf_counter() - t0
            yield piece
        return
    d = zlib.decompressobj()
    for data in chunks:
        while data:
            t0 = time.perf_counter()
            piece = d.decompress(data, _CHUNK)
            data = d.unconsumed_tail
            times[1] += time.perf_counter() - t0
            yield piece
    yield d.flush()
    if not d.eof:
        raise IOError("truncated checkpoint leaf")


# ---------------------------------------------------------------------------
# the msgpack subset: a map of str keys to bin values
# ---------------------------------------------------------------------------

def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 1 << 16:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        head = bytes([0xa0 | n])
    elif n < 1 << 8:
        head = b"\xd9" + struct.pack(">B", n)
    elif n < 1 << 16:
        head = b"\xda" + struct.pack(">H", n)
    else:
        head = b"\xdb" + struct.pack(">I", n)
    return head + b


def _bin_header(n: int) -> bytes:
    if n < 1 << 8:
        return b"\xc4" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xc5" + struct.pack(">H", n)
    if n < 1 << 32:
        return b"\xc6" + struct.pack(">I", n)
    raise ValueError(f"a leaf of {n} bytes does not fit a msgpack bin")


def _packb(payload: dict) -> bytes:
    """``msgpack.packb(payload, use_bin_type=True)`` for a dict of str keys
    and bytes values."""
    parts = [_map_header(len(payload))]
    for key, data in payload.items():
        parts += [_str(key), _bin_header(len(data)), bytes(data)]
    return b"".join(parts)


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise IOError("truncated checkpoint shard")
    return b


def _read_len(f, tag: int, table: dict, what: str) -> int:
    if tag not in table:
        raise IOError(f"checkpoint shard: {what} expected, msgpack tag 0x{tag:02x}")
    size, fmt = table[tag]
    return struct.unpack(fmt, _read_exact(f, size))[0]


def _entries(f):
    """(key, offset, size) of each bin value of the shard's map, in file
    order; the values themselves are skipped."""
    tag = _read_exact(f, 1)[0]
    n = tag & 0x0f if tag & 0xf0 == 0x80 else _read_len(
        f, tag, {0xde: (2, ">H"), 0xdf: (4, ">I")}, "a map")
    for _ in range(n):
        tag = _read_exact(f, 1)[0]
        k = tag & 0x1f if tag & 0xe0 == 0xa0 else _read_len(
            f, tag, {0xd9: (1, ">B"), 0xda: (2, ">H"), 0xdb: (4, ">I")}, "a str")
        key = _read_exact(f, k).decode("utf-8")
        tag = _read_exact(f, 1)[0]
        size = _read_len(f, tag, {0xc4: (1, ">B"), 0xc5: (2, ">H"),
                                  0xc6: (4, ">I")}, "a bin")
        yield key, f.tell(), size
        f.seek(size, os.SEEK_CUR)


# ---------------------------------------------------------------------------
# a leaf's bytes, in pieces
# ---------------------------------------------------------------------------

_CHUNK = 16 << 20   # bytes a piece: under glibc's largest mmap threshold, so
                    # a piece's host buffer is reused, not mapped anew
_local = threading.local()


def _read_buffer() -> bytearray:
    """This thread's buffer of ``_CHUNK`` bytes for the shard's reads."""
    if not hasattr(_local, "read"):
        _local.read = bytearray(_CHUNK)
    return _local.read


def _pinned() -> torch.Tensor:
    """This thread's pinned buffer of ``_CHUNK`` bytes: copies to and from
    a card go through it."""
    if not hasattr(_local, "pinned"):
        _local.pinned = torch.empty(_CHUNK, dtype=torch.uint8, pin_memory=True)
    return _local.pinned


def _leaf_pieces(leaf: torch.Tensor, times: list):
    """The bytes of ``leaf`` in pieces of at most ``_CHUNK``: a card's
    through this thread's pinned buffer (each piece valid until the
    next), a host's in place.  The copies' seconds go to ``times[0]``."""
    if leaf.device.type == "cpu":
        raw = _raw(leaf.detach().contiguous())
        for a in range(0, len(raw), _CHUNK):
            yield raw[a:a + _CHUNK]
        return
    flat = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
    buf = _pinned()
    for a in range(0, flat.numel(), _CHUNK):
        t0 = time.perf_counter()
        n = min(_CHUNK, flat.numel() - a)
        buf[:n].copy_(flat[a:a + n])
        times[0] += time.perf_counter() - t0
        yield memoryview(buf[:n].numpy())


def _read_pieces(fd: int, offset: int, size: int, times: list):
    """``size`` bytes of the shard at ``offset``, in pieces read into this
    thread's read buffer (each valid until the next); the reads' seconds
    go to ``times[0]``."""
    view, done = memoryview(_read_buffer()), 0
    while done < size:
        t0 = time.perf_counter()
        n = os.preadv(fd, [view[:min(_CHUNK, size - done)]], offset + done)
        times[0] += time.perf_counter() - t0
        if n <= 0:
            raise IOError("truncated checkpoint shard")
        yield view[:n]
        done += n


def _place(out: torch.Tensor, at: int, piece) -> int:
    """Copy ``piece`` into the uint8 tensor ``out`` from byte ``at`` (on
    a card through this thread's pinned buffer); returns the end."""
    src = np.frombuffer(piece, dtype=np.uint8)
    end = at + len(src)
    if end > out.numel():
        raise IOError("checkpoint corruption: a leaf longer than its manifest entry")
    if out.device.type == "cpu":
        out[at:end].numpy()[:] = src
        return end
    buf = _pinned()
    for a in range(0, len(src), _CHUNK):
        n = min(_CHUNK, len(src) - a)
        buf[:n].numpy()[:] = src[a:a + n]
        out[at + a:at + a + n].copy_(buf[:n])
    return end


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _rebuild(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _host_copy(leaf) -> torch.Tensor:
    """``leaf`` as a host tensor that no later update of ``leaf`` reaches."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return torch.from_numpy(np.array(leaf, order="C"))


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.array(leaf, order="C"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _drained(items: list):
    """The items of a list in order, each dropped from it as it is taken."""
    items.reverse()
    while items:
        yield items.pop()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _raw(t: torch.Tensor) -> memoryview:
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _as_done(fn, items, workers: int, budget: float = math.inf, size=None):
    """``fn`` over ``items`` on a pool of threads, in the order given, at
    most ``workers`` at a time; each result as soon as it is done.  The
    items are taken one at a time on the calling thread, and none while
    those running hold ``budget`` bytes or more (``size(item)`` each)."""
    items, held = iter(items), 0
    with ThreadPoolExecutor(workers) as pool:
        running = {}

        def admit():
            nonlocal held
            while len(running) < workers and held < budget:
                item = next(items, _END)
                if item is _END:
                    return
                n = size(item) if size else 0
                running[pool.submit(fn, item)] = n
                held += n

        admit()
        while running:
            done, _ = wait(running, return_when=FIRST_COMPLETED)
            for fut in done:
                held -= running.pop(fut)
            admit()
            for fut in done:
                yield fut.result()


_END = object()
STREAM_BYTES = 4 << 30      # leaves in flight in a streamed save or restore


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def save_checkpoint(directory, step: int, tree, *, host_id: int = 0, keep: int = 3,
                    blocking: bool = True, timings: Optional[dict] = None) -> Path:
    """Write ``tree`` as ``<directory>/step_<step>``.  With
    ``blocking=False`` the leaves are copied to the host before this
    returns and a thread writes them; else each leaf is read (a device
    leaf copied to the host piece by piece) as the pool of threads gets to
    it.  ``tree`` may instead be an iterable of ``(path, leaf)`` pairs (a
    blocking save only): they are taken in their order on the calling
    thread, each when the pool has room for it (see ``STREAM_BYTES``), so a
    generator can make each leaf when it is taken and the whole tree is
    never held.  ``timings`` gets, once the write is done, ``wall_s`` and the
    seconds of ``host_s`` (the copies to the host), ``hash_s`` and
    ``compress_s`` summed over the pool's threads, and ``write_s`` (the
    file writes, on the calling thread or the writer thread)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    streamed = not isinstance(tree, (dict, list, tuple))
    if streamed and not blocking:
        raise ValueError("a save of (path, leaf) pairs is a blocking one")
    if streamed:
        items = ((k, _tensor(v)) for k, v in tree)
    else:
        # one thread a leaf, the largest first, so that no large leaf
        # starts last; each is written when it is done
        items = sorted(((k, _tensor(v) if blocking else _host_copy(v))
                        for k, v in flatten_paths(tree).items()),
                       key=lambda kv: -_nbytes(kv[1]))
    host_s = 0.0 if blocking else time.perf_counter() - t_start

    def _write():
        tmp = directory / f"step_{step}.tmp"
        final = directory / f"step_{step}"
        tmp.mkdir(parents=True, exist_ok=True)
        codec, compressor = _make_compressor()
        manifest = {"step": step, "codec": codec, "leaves": {}}

        def work(item):
            key, t = item
            times = [0.0, 0.0, 0.0]     # to the host, hash, compress
            hasher = hashlib.blake2b(digest_size=16)
            comp = compressor(t.numel() * t.element_size())
            parts = []
            for piece in _leaf_pieces(t, times):
                t0 = time.perf_counter()
                hasher.update(piece)
                t1 = time.perf_counter()
                parts.append(comp.compress(piece))
                times[1] += t1 - t0
                times[2] += time.perf_counter() - t1
            t0 = time.perf_counter()
            parts.append(comp.flush())
            times[2] += time.perf_counter() - t0
            spec = {"shape": list(t.shape), "dtype": _dtype_name(t),
                    "hash": hasher.hexdigest()}
            return key, spec, parts, times

        parts = {"host_s": host_s, "hash_s": 0.0, "compress_s": 0.0, "write_s": 0.0}
        with open(tmp / f"shard_{host_id}.msgpack", "wb") as f:
            # streamed, the leaves are counted as they come: the map's
            # header takes its widest form (map32), filled in at the end
            f.write(b"\xdf" + struct.pack(">I", 0) if streamed else _map_header(len(items)))
            done = _as_done(work, items if streamed else _drained(items), _workers(),
                            STREAM_BYTES if streamed else math.inf,
                            lambda kv: _nbytes(kv[1]))
            for key, spec, data, dts in done:
                for part, dt in zip(("host_s", "hash_s", "compress_s"), dts):
                    parts[part] += dt
                t0 = time.perf_counter()
                manifest["leaves"][key] = spec
                f.write(_str(key) + _bin_header(sum(map(len, data))))
                for piece in data:
                    f.write(piece)
                parts["write_s"] += time.perf_counter() - t0
            if streamed:
                f.seek(1)
                f.write(struct.pack(">I", len(manifest["leaves"])))
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _gc(directory, keep)
        if timings is not None:
            timings.update(parts, wall_s=time.perf_counter() - t_start,
                           threads=_workers())

    if blocking:
        _write()
    else:
        threading.Thread(target=_write, daemon=True).start()
    return directory / f"step_{step}"


def _gc(directory: Path, keep: int):
    steps = sorted(
        (int(p.name.split("_")[1]), p)
        for p in directory.glob("step_*")
        if p.is_dir() and not p.name.endswith(".tmp")
    )
    for _s, p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.glob("step_*")
        if p.is_dir() and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def checkpoint_leaves(directory, step: int) -> dict:
    """``{path: {"shape", "dtype", "hash"}}`` of the checkpoint's leaves,
    from its manifest (no leaf is read)."""
    with open(Path(directory) / f"step_{step}" / "manifest.json") as f:
        return json.load(f)["leaves"]


def iter_checkpoint(directory, step: int, paths=None, *, host_id: int = 0,
                    device=None, budget: float = STREAM_BYTES,
                    timings: Optional[dict] = None):
    """``(path, tensor)`` for each leaf of ``paths`` (every leaf when None),
    each as soon as it is read, in its stored dtype on ``device`` (the
    host when None); the largest first, on the pool of threads, and no
    more leaves started while those being read hold ``budget`` bytes.  A
    caller that drops each leaf before it takes the next holds about
    ``budget`` bytes and a leaf.  ``timings`` gets, at the end, ``wall_s``
    and the seconds of ``read_s``, ``decompress_s``, ``hash_s`` and
    ``place_s`` (the bytes copied into the leaf's tensor on ``device``)
    summed over the pool's threads."""
    t_start = time.perf_counter()
    path = Path(directory) / f"step_{step}"
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    shard = path / f"shard_{host_id}.msgpack"
    if not shard.exists():  # pre-codec checkpoints used a .zst suffix
        shard = path / f"shard_{host_id}.msgpack.zst"
    codec = manifest.get("codec", "zstd")
    _check_codec(codec)
    specs = manifest["leaves"]
    wanted = set(specs) if paths is None else set(paths)
    dev = torch.device("cpu" if device is None else device)

    def nbytes(entry):
        spec = specs[entry[0]]
        return math.prod(spec["shape"]) * _DTYPES[spec["dtype"]].itemsize

    def work(entry):
        key, offset, size = entry
        spec = specs[key]
        dtype = _DTYPES[spec["dtype"]]
        out = torch.empty(nbytes(entry), dtype=torch.uint8, device=dev)
        times = [0.0, 0.0, 0.0, 0.0]     # read, decompress, hash, place
        hasher, done = hashlib.blake2b(digest_size=16), 0
        for piece in _inflate(codec, _read_pieces(fd, offset, size, times), times):
            t0 = time.perf_counter()
            hasher.update(piece)
            t1 = time.perf_counter()
            done = _place(out, done, piece)
            times[2] += t1 - t0
            times[3] += time.perf_counter() - t1
        if done != out.numel() or hasher.hexdigest() != spec["hash"]:
            raise IOError(f"checkpoint corruption at leaf {key}")
        return key, out.view(dtype).reshape(spec["shape"]), times

    parts = dict.fromkeys(("read_s", "decompress_s", "hash_s", "place_s"), 0.0)
    with open(shard, "rb") as f:
        entries = sorted((e for e in _entries(f) if e[0] in wanted and e[0] in specs),
                         key=lambda e: -e[2])     # the largest first
        missing = wanted - {e[0] for e in entries}
        if missing:
            raise IOError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")
        fd = f.fileno()
        for key, t, dts in _as_done(work, entries, _workers(), budget, nbytes):
            for part, dt in zip(parts, dts):
                parts[part] += dt
            yield key, t
    if timings is not None:
        timings.update(parts, wall_s=time.perf_counter() - t_start, threads=_workers())


def restore_checkpoint(directory, step: int, like=None, *, host_id: int = 0,
                       device=None, timings: Optional[dict] = None):
    """Restore into the structure of ``like`` (nested dicts and lists whose
    leaves may be anything: only their paths are read), or, when ``like``
    is None, every leaf of the checkpoint nested by its path.  Leaves come
    back as tensors in their stored dtypes on ``device`` (the host when
    None); ``timings`` as :func:`iter_checkpoint` gives them."""
    out = dict(iter_checkpoint(directory, step, None if like is None else flatten_paths(like),
                               host_id=host_id, device=device, budget=math.inf,
                               timings=timings))
    return nest_paths(dict(sorted(out.items()))) if like is None else _rebuild(like, out)


class Checkpointer:
    """save-every-N helper with preemption flush (see ``fault.py``)."""

    def __init__(self, directory, every: int = 100, keep: int = 3, host_id: int = 0):
        self.directory = Path(directory)
        self.every = every
        self.keep = keep
        self.host_id = host_id

    def maybe_save(self, step: int, tree, force: bool = False, blocking: bool = True):
        """Save ``tree`` (or what ``tree()`` builds, called only when a
        checkpoint is due) every ``every`` steps, or when ``force``; a tree
        of None (a rank of a mesh that does not write) is not saved."""
        if force or (self.every and step % self.every == 0 and step > 0):
            tree = tree() if callable(tree) else tree
            if tree is None:
                return None
            return save_checkpoint(self.directory, step, tree,
                                   host_id=self.host_id, keep=self.keep,
                                   blocking=blocking)
        return None

    def resume(self, like=None, device=None):
        step = latest_step(self.directory)
        if step is None:
            return None, 0
        tree = restore_checkpoint(self.directory, step, like,
                                  host_id=self.host_id, device=device)
        return tree, step
