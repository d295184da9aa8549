"""Async checkpoints in the reference's format v2 (the port of
``repro/checkpoint/io.py``).

The files are the reference's, so a checkpoint written by either
package loads in the other.  ``<directory>/<name>/`` holds::

    manifest.json        # format_version, name, process_index,
                         # process_count, treedef, leaves (per leaf:
                         # shape, dtype, shards of {file, entry, index,
                         # stored_dtype}); written last
    manifest-p<K>.json   # process K's leaves and shards
    shards-p<K>.npz      # process K's shard payloads, entry "<key>::<i>"

A leaf's key is its reference path joined by ``/``
(``params/stack/blocks/0/attn/wq/w``, ``opt/u/embed/table``): the port's
flat dicts are taken to the reference's leaves by
``convert.jax_leaves``, a pattern block's tensors stacked back along the
``num_blocks`` axis (after the node axis where there is one).  bf16 and
fp8 travel as same-width unsigned ints, ``stored_dtype`` naming the real
dtype, as the reference's ``_to_storable`` stores them; the bits go
through ``torch.Tensor.view``, never through a numpy bf16 type.  A Python
int (the ``step``, a compressed method's ``ct``) is an int32 of shape
``()``.  ``treedef`` holds a plain description: the reference's loader
takes the structure from its template, as this one does.

**One shard per process.**  With ``process_count > 1`` every tensor is
process K's ``(1, ...)`` slice of a leaf stacked over the processes
along its first axis (the distributed trainer's rank slice,
``convert.rank_slice``): K writes it as one shard with index ``[[K,
K+1], [0, d1], ...]``, exactly how the reference stores a tree sharded
over its node axis.  A rank of the tensor-parallel trainer holds its
node's row and its slice of each weight dim instead
(:func:`mesh_placement`): it writes that slice with the global index it
covers, as the reference stores a device's shard of a mesh.  A leaf of shape ``()`` is written whole by every
process; the loader keeps one copy.  :func:`load_pytree` restores the
whole ``(n, ...)`` leaves, one rank's ``(1, ...)`` slice, or (given a
:func:`mesh_placement`) a rank's shards on any mesh, whatever mesh wrote
the checkpoint, reading only the shards that cover the region it
returns.

**Commit.**  Every process calls ``save`` in the same order, so the
staging directory ``.tmp-<name>-<token>-<seq>`` is named alike on all of
them: ``seq`` counts the checkpointer's saves, and ``token`` is drawn by
process 0 and broadcast when the checkpointer is made, on the caller's
thread, so that a staging directory left by an earlier run is never
mistaken for this one's.  Each process writes its shard file and, last,
its ``manifest-p<K>.json`` (written aside and renamed).  Process 0's
writer waits until every process's manifest is there, writes
``manifest.json``, fsynced, and renames the directory into place (an
existing checkpoint of the name is swapped out, not clobbered).  The
other writers wait until their own manifest file has reached the
committed directory.  So ``wait()`` returns on every process only once
the checkpoint is committed, and re-raises a writer's failure; a process
whose writer fails leaves ``failed-p<K>`` in the staging directory, and
process 0 gives up at once.  The writer threads make no
``torch.distributed`` call: the file system is their only channel.

**Snapshot.**  The reference's writer may read its arrays later because
jax arrays are immutable.  Here they are not (the EF21 residuals and a
Mamba layer's state are updated in place), and keeping the old tensors
alive would hold another copy of the parameters and the state on the
card.  So ``save()`` copies every tensor on the caller's thread into one
host buffer (pinned for a CUDA tensor: the copies are issued
non-blocking on the current stream, followed by one CUDA event), and the
writer thread waits for that event before it serialises.  A change made
after ``save()`` returns does not reach the checkpoint.  The checkpointer
keeps the buffers of :data:`SNAPSHOTS` snapshots and hands a buffer back
once its shard file is written, so only its first saves allocate (and
pin) host memory; the step loop waits for the disk only when a save
finds every buffer still held by the writer.

**Crash consistency** as the reference's: ``manifest.json`` is the last
byte written, a staging directory is never loadable, a missing shard
file is detected (the shards then do not cover the array), and a second
save under a name swaps in atomically.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from glob import glob

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import BIT_VIEWS, jax_leaves

FORMAT_VERSION = 2
TREEDEF = ("repro_torch: nested dicts whose leaves are tensors and ints; "
           "each leaf is keyed by its reference path")
#: seconds a writer waits for the other processes' files before it raises
COMMIT_TIMEOUT = 1800.0
#: snapshots a checkpointer keeps host buffers for: the writer serialises
#: one while the next save fills the other
SNAPSHOTS = 2
_ALIGN = 64
_POLL = 0.02
_BITS_BY_NAME = {str(d).removeprefix("torch."): d for d in BIT_VIEWS}


# ---------------------------------------------------------------------------
# tree <-> the reference's leaves
# ---------------------------------------------------------------------------

def _walk(tree, prefix=()):
    """(path, leaf) for every leaf of nested dicts; None is no leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    elif tree is not None:
        yield prefix, tree


def _unflatten(template, values: dict, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in template.items()}
    return values.get(prefix, template)


@dataclass(frozen=True)
class _Leaf:
    key: str              # the reference's path, joined by "/"
    paths: list           # the tree paths it holds, in block order
    stacked: bool         # stacked along a num_blocks axis


def _layout(values: dict) -> list[_Leaf]:
    by_dots = {".".join(p): p for p in values}
    return [_Leaf(path.replace(".", "/"), [by_dots[k] for k in keys],
                  stacked)
            for path, keys, stacked in jax_leaves(by_dots)]


def _is_scalar(x) -> bool:
    return not isinstance(x, torch.Tensor) or x.ndim == 0


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _scalar_tensor(x) -> torch.Tensor:
    """A Python or numpy scalar as the 0-d tensor the reference keeps:
    an int as int32 (``jnp.int32(step)``), a float as float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, (bool, np.bool_)):
        return torch.tensor(bool(x))
    if isinstance(x, (int, np.integer)):
        return torch.tensor(int(x), dtype=torch.int32)
    return torch.tensor(float(x), dtype=torch.float32)


def _storable(t: torch.Tensor) -> tuple[np.ndarray, str | None]:
    """A host tensor as numpy: bf16 and fp8 as same-width uint bits, with
    the real dtype's name (the reference's ``_to_storable``)."""
    if t.dtype in BIT_VIEWS:
        arr = t.view(BIT_VIEWS[t.dtype]).numpy()
        return (arr.view(np.dtype(f"u{t.element_size()}")),
                _dtype_name(t.dtype))
    return t.numpy(), None


def _stored_np(name: str) -> np.dtype:
    if name in _BITS_BY_NAME:
        return np.dtype(f"u{_BITS_BY_NAME[name].itemsize}")
    return np.dtype(name)


def _from_stored(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _BITS_BY_NAME:
        real = _BITS_BY_NAME[name]
        ints = np.int16 if BIT_VIEWS[real] == torch.int16 else np.uint8
        return torch.from_numpy(arr.view(ints)).view(real)
    return torch.from_numpy(arr)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _fsync_write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _write_shard_file(tmp_dir: str, proc: int, payload: dict) -> None:
    path = os.path.join(tmp_dir, f"shards-p{proc}.npz")
    with open(path, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())


def _write_manifest(tmp_dir: str, fname: str, manifest: dict) -> None:
    """Manifest write = the commit point of this process's data (written
    aside and renamed, so a reader never meets half of one); a hook of its
    own so the crash-consistency test can sever it."""
    part = os.path.join(tmp_dir, fname + ".part")
    _fsync_write(part, json.dumps(manifest, indent=1).encode())
    os.replace(part, os.path.join(tmp_dir, fname))


def _commit(tmp_dir: str, final_dir: str) -> str:
    """Atomically promote the staging dir.  An existing checkpoint of the
    same name is swapped out, not clobbered in place."""
    if os.path.exists(final_dir):
        old = final_dir + f".old-{uuid.uuid4().hex[:8]}"
        os.rename(final_dir, old)
        os.rename(tmp_dir, final_dir)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp_dir, final_dir)
    return final_dir


def _await_manifests(tmp_dir: str, count: int, deadline: float) -> None:
    """Process 0: until every process's manifest is in the staging dir."""
    want = [os.path.join(tmp_dir, f"manifest-p{k}.json")
            for k in range(count)]
    while not all(os.path.exists(p) for p in want):
        failed = glob(os.path.join(tmp_dir, "failed-p*"))
        if failed:
            raise RuntimeError(f"checkpoint writer of process "
                               f"{os.path.basename(failed[0])[8:]} failed")
        if time.monotonic() > deadline:
            missing = [os.path.basename(p) for p in want
                       if not os.path.exists(p)]
            raise TimeoutError(f"{tmp_dir}: {missing} never came")
        time.sleep(_POLL)


def _committed(final_dir: str, proc: int, inode: int) -> bool:
    try:
        return (os.path.exists(os.path.join(final_dir, "manifest.json"))
                and os.stat(os.path.join(
                    final_dir, f"manifest-p{proc}.json")).st_ino == inode)
    except FileNotFoundError:
        return False


def _await_commit(tmp_dir: str, final_dir: str, proc: int, inode: int,
                  deadline: float) -> str:
    """Process K > 0: until its own manifest file sits in the committed
    directory (the rename keeps the file's inode)."""
    while not _committed(final_dir, proc, inode):
        if not os.path.isdir(tmp_dir) \
                and not _committed(final_dir, proc, inode):
            raise RuntimeError(f"{final_dir}: process 0 did not commit the "
                               f"checkpoint")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{final_dir}: not committed in time")
        time.sleep(_POLL)
    return final_dir


@dataclass
class _Snap:
    key: str
    shape: tuple          # the leaf's global shape
    dtype: str
    index: list           # this process's shard: [[start, stop], ...]
    host: torch.Tensor    # the shard on the host, blocks first if stacked
    axis: int | None      # where the blocks go in the stored array


def mesh_placement(specs: dict, mesh, node_axis: str | None, *,
                   nodes: bool = True):
    """Where a rank of a live ``mesh`` writes each tensor of a tree of its
    shards: ``place(key, local, blocks_axis) -> (shape, index)``, the
    global shape of the reference's leaf and the slice this rank's tensor
    covers, as the reference's format v2 stores a device's shard
    (``repro/checkpoint/io.py:84-99``).  ``key`` is the tensor's flat key
    (its spec in ``specs``, ``dist.sharding.param_partition_specs``);
    ``local`` the leaf's shape on this rank, leading with the node axis
    of size 1 when ``nodes`` (its row: this rank's coordinate on
    ``node_axis``, none for None) and with the pattern blocks at
    ``blocks_axis`` (whole); each other dim is the slice of its spec
    entry's axes at this rank's coordinates.  Ranks that hold the same
    slice (a replicated tensor) write the same index, which the loaders
    read once."""
    from repro_torch.dist.sharding import entry_axes

    n = mesh.shape[node_axis] if node_axis else 1
    node = mesh.coords[node_axis] if node_axis else 0

    def place(key, local, blocks_axis):
        """``(global shape, index)`` of this rank's ``local`` tensor."""
        shape, index = [], []
        lead = 0
        if nodes:
            if not local or local[0] != 1:
                raise ValueError(f"{key}: a rank's tensor must lead with a "
                                 f"node axis of 1, got {tuple(local)}")
            shape.append(n)
            index.append([node, node + 1])
            lead = 1
        if blocks_axis is not None:
            shape.append(local[blocks_axis])
            index.append([0, local[blocks_axis]])
            lead += 1
        spec = tuple(specs[key])
        for i, d in enumerate(local[lead:]):
            pos, size = 0, 1
            for a in entry_axes(spec[i] if i < len(spec) else None):
                pos = pos * mesh.shape[a] + mesh.coords[a]
                size *= mesh.shape[a]
            shape.append(d * size)
            index.append([pos * d, (pos + 1) * d])
        return tuple(shape), index

    place.nodes = nodes
    return place


class AsyncCheckpointer:
    """Background-thread checkpoint writer.

    ``save()`` copies the tree to host buffers on the caller's thread (see
    the module's docstring) and returns a future; serialisation and the
    commit run on the writer thread.  ``process_index`` and
    ``process_count`` default to this process's rank and the size of
    ``group`` when ``torch.distributed`` is initialised, else 0 and 1;
    with more than one process the constructor broadcasts process 0's
    staging token over ``group`` (call it on every process at the same
    point).  ``stats`` holds one record per save: ``save_ms`` on the
    caller's thread, ``new_buffer`` (the snapshot allocated its host
    buffer), ``write_s`` on the writer's, ``bytes`` written.
    ``placement`` (:func:`mesh_placement`) gives each tensor's global
    shape and index on a mesh."""

    def __init__(self, directory: str, *, group=None,
                 process_index: int | None = None,
                 process_count: int | None = None, placement=None):
        if process_count is None:
            if dist.is_available() and dist.is_initialized():
                process_index = dist.get_rank(group)
                process_count = dist.get_world_size(group)
            else:
                process_index, process_count = 0, 1
        self.directory = directory
        self.process_index = process_index or 0
        self.process_count = process_count
        # each tensor's global shape and index (:func:`mesh_placement`),
        # or None: a process's tensor is its row of the node axis
        self.placement = placement
        token = uuid.uuid4().hex[:8]
        if process_count > 1:
            box = [token]
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(group, 0)
                if group is not None else 0, group=group)
            token = box[0]
        self.token = token
        self.stats: list[dict] = []
        self._seq = 0
        # One writer thread: the commit needs the saves to reach the disk
        # in the order they were made (process 0 commits seq 0 before seq
        # 1; process K watches for its own file in the committed one).
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-write")
        self._pending: list[Future] = []
        self._lock = threading.Lock()
        self._buffers = threading.Condition()
        self._free: list[tuple[torch.Tensor, bool]] = []  # (buffer, pinned)
        self._held = 0        # buffers of saves whose shards are unwritten

    def save(self, tree, name: str = "ckpt", *,
             node_axis: bool | None = None) -> Future:
        """Save ``tree`` (nested dicts of flat dicts of tensors, and ints)
        under ``name``.  ``node_axis``: the tensors lead with a node axis,
        so a pattern block stacks after it (default: with more than one
        process, where each tensor is this process's ``(1, ...)``
        slice)."""
        t0 = time.perf_counter()
        if node_axis is None:
            node_axis = self.process_count > 1
        os.makedirs(self.directory, exist_ok=True)
        snap, event, buf, fresh = self._snapshot(tree, node_axis)
        rec = {"name": name, "seq": self._seq,
               "save_ms": 1e3 * (time.perf_counter() - t0),
               "new_buffer": fresh}
        fut = self._pool.submit(self._write, snap, event, buf, name,
                                self._seq, rec)
        self._seq += 1
        self.stats.append(rec)
        with self._lock:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(fut)
        return fut

    def _take(self, nbytes: int, pinned: bool) -> tuple[torch.Tensor, bool]:
        """A host buffer of at least ``nbytes`` (and whether it is new):
        a free one if one fits, else a new one; waits while every buffer
        is held by the writer."""
        with self._buffers:
            while self._held >= SNAPSHOTS:
                self._buffers.wait()
            self._held += 1
            for i, (buf, pin) in enumerate(self._free):
                if pin == pinned and buf.numel() >= nbytes:
                    return self._free.pop(i)[0], False
            if self._free and self._held + len(self._free) > SNAPSHOTS:
                self._free.pop(0)
        try:
            return torch.empty(nbytes, dtype=torch.uint8,
                               pin_memory=pinned), True
        except BaseException:
            self._give_back(None, pinned)
            raise

    def _give_back(self, buf: torch.Tensor | None, pinned: bool) -> None:
        with self._buffers:
            if buf is not None:
                self._free.append((buf, pinned))
            self._held -= 1
            self._buffers.notify_all()

    def _snapshot(self, tree, node_axis: bool):
        values = dict(_walk(tree))
        K, P = self.process_index, self.process_count
        snaps, tensors = [], []
        for leaf in _layout(values):
            xs = [values[p] for p in leaf.paths]
            if _is_scalar(xs[0]):
                host = _scalar_tensor(xs[0])
                snaps.append(_Snap(leaf.key, (), _dtype_name(host.dtype), [],
                                   host, None))
            else:
                tensors.append((leaf, xs))
        sizes = [len(xs) * xs[0].numel() * xs[0].element_size()
                 for _, xs in tensors]
        cuda = next((x.device for _, xs in tensors for x in xs if x.is_cuda),
                    None)
        pinned = cuda is not None
        buf, fresh = self._take(sum(-(-n // _ALIGN) * _ALIGN for n in sizes),
                                pinned)
        try:
            off = 0
            for (leaf, xs), nbytes in zip(tensors, sizes):
                x0 = xs[0]
                blocks = len(xs) if leaf.stacked else 1
                host = buf[off:off + nbytes].view(x0.dtype).view(
                    (blocks,) + tuple(x0.shape))
                off += -(-nbytes // _ALIGN) * _ALIGN
                for b, x in enumerate(xs):
                    host[b].copy_(x.detach(), non_blocking=True)
                axis = (1 if node_axis else 0) if leaf.stacked else None
                local = list(x0.shape)
                if axis is not None:
                    local.insert(axis, blocks)
                else:
                    host = host[0]
                if self.placement is not None:
                    shape, index = self.placement(leaf.paths[0][-1], local,
                                                  axis)
                elif P > 1:
                    if not local or local[0] != 1:
                        raise ValueError(f"{leaf.key}: a process's tensor "
                                         f"must lead with a node axis of 1, "
                                         f"got {tuple(x0.shape)}")
                    shape = (P, *local[1:])
                    index = [[K, K + 1]] + [[0, d] for d in local[1:]]
                else:
                    shape = tuple(local)
                    index = [[0, d] for d in local]
                snaps.append(_Snap(leaf.key, shape, _dtype_name(x0.dtype),
                                   index, host, axis))
            event = None
            if cuda is not None:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(cuda))
        except BaseException:
            if cuda is not None:
                torch.cuda.current_stream(cuda).synchronize()
            self._give_back(buf, pinned)
            raise
        return snaps, event, (buf, pinned), fresh

    def _write(self, snaps, event, buf, name: str, seq: int,
               rec: dict) -> str:
        t0 = time.perf_counter()
        K, P = self.process_index, self.process_count
        final_dir = os.path.join(self.directory, name)
        tmp_dir = os.path.join(self.directory,
                               f".tmp-{name}-{self.token}-{seq}")
        try:
            if event is not None:
                event.synchronize()
            os.makedirs(tmp_dir, exist_ok=True)
            payload, leaves = {}, {}
            shard_file = f"shards-p{K}.npz"
            for s in snaps:
                arr, stored_as = _storable(s.host)
                if s.axis is not None:
                    arr = np.moveaxis(arr, 0, s.axis)
                entry = f"{s.key}::0"
                payload[entry] = arr
                leaves[s.key] = {"shape": list(s.shape), "dtype": s.dtype,
                                 "shards": [{"file": shard_file,
                                             "entry": entry, "index": s.index,
                                             "stored_dtype": stored_as}]}
            try:
                _write_shard_file(tmp_dir, K, payload)
            finally:
                del payload, snaps
                self._give_back(*buf)
                buf = None
            manifest = {"format_version": FORMAT_VERSION, "name": name,
                        "process_index": K, "process_count": P,
                        "treedef": TREEDEF, "leaves": leaves}
            _write_manifest(tmp_dir, f"manifest-p{K}.json", manifest)
            rec["bytes"] = sum(
                os.path.getsize(os.path.join(tmp_dir, f))
                for f in (shard_file, f"manifest-p{K}.json"))
            deadline = time.monotonic() + COMMIT_TIMEOUT
            if K == 0:
                _await_manifests(tmp_dir, P, deadline)
                # The marker manifest commits the checkpoint (written
                # LAST; the loader refuses a directory without it).
                _write_manifest(tmp_dir, "manifest.json", manifest)
                path = _commit(tmp_dir, final_dir)
            else:
                inode = os.stat(os.path.join(
                    tmp_dir, f"manifest-p{K}.json")).st_ino
                path = _await_commit(tmp_dir, final_dir, K, inode, deadline)
            rec["write_s"] = time.perf_counter() - t0
            return path
        except BaseException:
            if buf is not None:
                self._give_back(*buf)
            if K == 0:
                shutil.rmtree(tmp_dir, ignore_errors=True)
            else:
                try:
                    _fsync_write(os.path.join(tmp_dir, f"failed-p{K}"), b"")
                except OSError:
                    pass
            raise

    def wait(self) -> None:
        """Block until every outstanding save has committed (re-raises
        the first writer failure)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
            with self._buffers:
                self._free.clear()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _load_manifests(ckpt_dir: str) -> dict:
    """The committed marker manifest, with the per-process shard lists
    merged in (a multi-process save leaves one manifest-p<K>.json each)."""
    marker = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(marker):
        raise FileNotFoundError(
            f"no committed checkpoint at {ckpt_dir!r} (manifest.json "
            "missing: the write never reached its commit point)")
    with open(marker) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format "
                         f"{manifest.get('format_version')!r}")
    for path in sorted(glob(os.path.join(ckpt_dir, "manifest-p*.json"))):
        with open(path) as f:
            part = json.load(f)
        for key, rec in part["leaves"].items():
            base = manifest["leaves"].setdefault(key, dict(rec, shards=[]))
            have = {tuple(map(tuple, s["index"])) for s in base["shards"]}
            for s in rec["shards"]:
                if tuple(map(tuple, s["index"])) not in have:
                    base["shards"].append(s)
    return manifest


def _read_region(ckpt_dir: str, rec: dict, files: dict,
                 region: list) -> np.ndarray:
    """The rows ``region`` ([[start, stop], ...]) of one leaf, in its
    stored dtype, from the shards that cover them (the others are not
    read)."""
    stored = _stored_np(rec["dtype"])
    shape = tuple(b - a for a, b in region)
    out = np.empty(shape, stored)
    covered = np.zeros(shape, bool)
    for s in rec["shards"]:
        cut = [(max(a, ra), min(b, rb))
               for (a, b), (ra, rb) in zip(s["index"], region)]
        if any(lo >= hi for lo, hi in cut):
            continue
        if s["file"] not in files:
            files[s["file"]] = np.load(os.path.join(ckpt_dir, s["file"]))
        arr = files[s["file"]][s["entry"]]
        src = tuple(slice(lo - a, hi - a)
                    for (lo, hi), (a, _) in zip(cut, s["index"]))
        dst = tuple(slice(lo - ra, hi - ra)
                    for (lo, hi), (ra, _) in zip(cut, region))
        piece = arr[src]
        out[dst] = piece if piece.dtype == stored else piece.astype(stored)
        covered[dst] = True
    if not bool(np.all(covered)):
        raise ValueError(f"checkpoint shards do not cover the full array "
                         f"for shape {tuple(rec['shape'])} rows {region}: a "
                         f"process's shard file is missing")
    return out


def load_pytree(template, directory: str, name: str = "ckpt", *,
                node_axis: bool = False, rank: int | None = None,
                placement=None):
    """Restore into the structure of ``template`` (nested dicts of flat
    dicts of tensors, and ints; the leaves give shape, dtype and device,
    and a checkpoint leaf of another dtype is cast to the template's).

    ``rank=None``: the template's tensors are whole leaves (``node_axis``:
    they lead with a node axis, so a pattern block stacks after it).
    ``rank=r``: they are rank r's ``(1, ...)`` slices of leaves stacked
    over the nodes, and only the shards covering row r are read.
    ``placement`` (:func:`mesh_placement` of the restoring rank's specs,
    mesh and node axis): they are that rank's shards, each the region
    ``placement`` gives it (a node's row and its slice of each sharded
    dim; ``node_axis`` is the placement's ``nodes``), read from whatever
    shards cover it, so a checkpoint written on one mesh restores onto
    another (as the reference's ``load_pytree(shardings=)``,
    ``repro/checkpoint/io.py:288-334``), bit for bit.  A checkpoint from
    the reference restores each way, as does one from the port's
    distributed trainer."""
    if placement is not None and rank is not None:
        raise ValueError("pass rank= or placement=, not both")
    ckpt_dir = os.path.join(directory, name)
    manifest = _load_manifests(ckpt_dir)
    values = dict(_walk(template))
    if rank is not None:
        node_axis = True
    if placement is not None:
        node_axis = placement.nodes
    files: dict = {}
    out = {}
    try:
        for leaf in _layout(values):
            rec = manifest["leaves"].get(leaf.key)
            if rec is None:
                raise KeyError(f"checkpoint {name!r} has no leaf "
                               f"{leaf.key!r}")
            xs = [values[p] for p in leaf.paths]
            x0 = xs[0]
            want = tuple(rec["shape"])
            if _is_scalar(x0):
                if want != ():
                    raise ValueError(f"{leaf.key}: template is a scalar, "
                                     f"the checkpoint holds {want}")
                t = _from_stored(_read_region(ckpt_dir, rec, files, []),
                                 rec["dtype"])
                out[leaf.paths[0]] = (
                    t.to(x0.dtype).to(x0.device)
                    if isinstance(x0, torch.Tensor) else type(x0)(t.item()))
                continue
            axis = (1 if node_axis else 0) if leaf.stacked else None
            local = list(x0.shape)
            if axis is not None:
                local.insert(axis, len(xs))
            if placement is not None:
                shape, region = placement(leaf.paths[0][-1], local, axis)
                ok = tuple(shape) == want
            elif rank is None:
                ok = tuple(local) == want
                region = [[0, d] for d in local]
            else:
                ok = (len(local) == len(want) and local[0] == 1
                      and tuple(local[1:]) == want[1:] and rank < want[0])
                region = [[rank, rank + 1]] + [[0, d] for d in local[1:]]
            if not ok:
                where = (f"region {region}" if placement is not None
                         else f"rank {rank}")
                raise ValueError(f"{leaf.key}: template {tuple(local)} "
                                 f"({where}) does not fit the "
                                 f"checkpoint's {want}")
            t = _from_stored(_read_region(ckpt_dir, rec, files, region),
                             rec["dtype"]).to(x0.dtype)
            parts = t.unbind(axis) if axis is not None else (t,)
            for path, x, part in zip(leaf.paths, xs, parts):
                out[path] = part.contiguous().to(x.device)
    finally:
        for f in files.values():
            f.close()
    return _unflatten(template, out)


# ---------------------------------------------------------------------------
# synchronous convenience API (the reference's signature)
# ---------------------------------------------------------------------------

def save_pytree(tree, directory: str, name: str = "ckpt", *,
                node_axis: bool = False) -> str:
    """Synchronous one-process save: the async engine, then its result.
    Returns the committed checkpoint directory."""
    ckpt = AsyncCheckpointer(directory, process_index=0, process_count=1)
    try:
        return ckpt.save(tree, name=name, node_axis=node_axis).result()
    finally:
        ckpt._pool.shutdown(wait=True)
