"""Point-to-point gossip: a compiled slot plan executed across the ranks of
a ``torch.distributed`` group, one node per rank (the port of
``repro/dist/gossip.py``).

A round of the plan is ``x'_i = w_self[i] x_i + sum_s w_recv[s][i] *
recv_s(x)``.  Each slot is a partial permutation (every node sends and
receives at most one message), executed as one
``dist.batch_isend_irecv``: this rank sends to ``dst`` where ``(me, dst)``
is in the slot's ``perm`` and receives from ``src`` where ``(src, me)``
is.  A rank that receives nothing in a slot takes zeros at weight 0, as
``ppermute`` gives it.  So a degree-k round costs at most k messages per
node and no all-reduce at all: the paper's communication saving.  The
round is chosen on the host (``r % len(plan)``); no ``lax.switch`` is
needed.

A rank holds its own node's flat dict, every tensor with a leading node
axis of size 1 (the reference's shard shape), so
``repro_torch.optim.decentralized`` runs unchanged through its
callable-mixer branch.  Each float tensor becomes an f32 work buffer,
which is what travels, and the received buffers come in beside it.  The
exchanges run tensor by tensor, as before, but the combines are
deferred: tensors gather into a bucket until its f32 work buffers reach
:data:`BUCKET_BYTES` (a larger tensor is a bucket of its own, see
:func:`plan_buckets`), and each bucket is one
``ops.gossip_mix_many`` call, on the card one grouped launch of the
slots-combine kernel per dtype pair, which sums each tensor's buffers in
slot order in f32 and writes the tensor's own dtype (a bf16 output is
the f32 sum rounded once, the bits of a cast).  A bucket holds its work
and received buffers until it is combined, so the mixer's memory rises
by at most (S + 1) x :data:`BUCKET_BYTES` over a per-tensor combine,
for S buffers per tensor.  With ``flatten=True`` one f32 buffer holds all
float tensors, so each slot sends one message for the whole tree, and
its combine is one segment.  Tensors that are not floats pass through: a
weighted average is meaningless for them.

Compressed gossip (``compression=``, DESIGN.md Sec. 13): each reference
leaf (the blocks of one stacked leaf, back to back, padded once:
``compress.mixing.group_to_rows``) is quantized once per step, with
``row_offset = rank * rows``, so its payload bits equal the simulation's
rows of this node.  For int8 and fp8 the leaves gather into buckets of
at most :data:`BUCKET_BYTES` of f32 chunk rows (a larger leaf, the
embedding, is a bucket of its own), and a bucket is quantized in one
``ops.quantize_payload_many`` call and combined in one
``ops.quantized_gossip_mix_many`` call: on the card one grouped launch
of each kernel per bucket.  Between the two, each leaf's payload (``q``
and ``scale``) goes through the same exchange as before, leaf by leaf
and slot by slot: the same messages and bytes.  Until its combine a
bucket holds its chunk rows and (until the residuals are written) their
err rows and residuals, f32 each, and its payloads: at most about
(3.25 + S/4) x the cap beside a leaf-by-leaf mixer, for S received
payloads.  The other codecs take one leaf at a time and
decode-and-accumulate.  The EF21 residual is written into the ``ef``
tensors in place, as ``compress.compressed_dense_mix`` does.

Messages travel as bytes.  Under the ``gloo`` backend, whose send and
receive read host memory, a message on the card is staged through a
pinned host buffer (a copy out on a side stream before the send, a copy
in after the receive); ``nccl`` moves card memory directly.  The combine
runs where the tensors are.

The uncompressed mixer also comes in two halves, for the overlapped
train step (``dist.steps``): ``mixer.issue(tree, r)`` posts every
exchange of the round and returns at once, and ``mixer.complete(handle)``
waits for them and combines, bucket by bucket, into what ``mixer(tree,
r)`` returns, bit for bit, with the same messages.  Until it completes,
a handle holds all its buckets' buffers.

Over a dry mesh's stand-in group (``launch.mesh.DryGroup``, the dry run
on the meta device) the same mixer runs on a dry wire: each message is
counted in ``stats`` as the live wire counts it, nothing is sent, and
what would be received is an empty tensor of its shape.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.compress import get_codec
from repro_torch.compress import resolve as resolve_compression
from repro_torch.compress.mixing import (compress_bucket, group_to_rows,
                                         reference_leaves, rows_bytes,
                                         rows_to_group)
from repro_torch.core.ppermute_plan import SchedulePlan
from repro_torch.kernels import ops
from repro_torch.kernels.multi_tensor import BUCKET_BYTES, plan_buckets
from repro_torch.kernels.ref import _f32_weights, sr_key
from repro_torch.launch.mesh import DryGroup


@dataclass(frozen=True)
class _Slot:
    send_to: int | None      # the global rank this rank sends to
    recv_from: int | None    # the global rank it receives from
    weight: float            # recv_weight[me] in f32


@dataclass(frozen=True)
class _Round:
    weights: list            # [w_self, *slot weights] of this rank, f32
    slots: tuple


def _rank_rounds(plan: SchedulePlan, me: int, to_global) -> list[_Round]:
    """This rank's side of every round: peers and f32 weights."""
    rounds = []
    for rp in plan.rounds:
        slots = []
        for sp in rp.slots:
            dst = next((d for s, d in sp.perm if s == me), None)
            src = next((s for s, d in sp.perm if d == me), None)
            slots.append(_Slot(None if dst is None else to_global(dst),
                               None if src is None else to_global(src),
                               _f32_weights([sp.recv_weight[me]])[0]))
        w = _f32_weights([rp.self_weight[me]]) + [s.weight for s in slots]
        rounds.append(_Round(w, tuple(slots)))
    return rounds


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class _Pending:
    """One slot's messages in flight: the received buffers, and until
    :meth:`_Wire.complete` the works, the host copies to come in and the
    buffers the sends read."""

    def __init__(self, recvs, works, copy_in, keep):
        self.recvs, self.works = recvs, works
        self.copy_in, self.keep = copy_in, keep


class HostStaging:
    """Copies of card tensors on pinned host memory, for gloo, whose
    collectives and point-to-point messages read and write host memory.
    Each copy out runs on a side stream and records an event; the host
    waits for it before it hands the buffer to gloo.  A copy in (a
    received host buffer to the card) is a non-blocking copy on the
    current stream."""

    def __init__(self):
        self._side = None

    def out(self, t: torch.Tensor):
        """``t``'s bytes (a uint8 tensor on the card) on pinned host
        memory, copied on the side stream; returns the host buffer and
        the copy's event."""
        if self._side is None:
            self._side = torch.cuda.Stream(t.device)
        cur = torch.cuda.current_stream(t.device)
        self._side.wait_stream(cur)
        host = torch.empty(t.shape, dtype=torch.uint8, pin_memory=True)
        with torch.cuda.stream(self._side):
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        t.record_stream(self._side)
        return host, done


class _Wire:
    """This rank's point-to-point transport: one slot's messages per
    call, counted in ``stats``, in two halves.  :meth:`issue` posts the
    sends and receives and returns at once; :meth:`complete` waits for
    them.  Under gloo a message on the card is staged through pinned host
    memory (:class:`HostStaging`): the host waits for a message's copy
    out just before it posts the send (gloo reads host memory as soon as
    it is given it); the copies in follow the receives.  Every rank
    issues its slots in the same order, and gloo matches a pair's
    messages in that order."""

    def __init__(self, group):
        self.group = group
        self.stage = dist.get_backend(group) == "gloo"
        self.stats = {"messages": 0, "bytes": 0}
        self.staging = HostStaging()

    def issue(self, tensors: list, slot: _Slot) -> _Pending:
        """Post the sends of ``tensors`` to the slot's peer and the
        receives of their like from its source (zeros where this rank
        receives nothing)."""
        if slot.recv_from is None:
            recvs = [torch.zeros_like(t) for t in tensors]
        else:
            recvs = [torch.empty_like(t) for t in tensors]
        p2p, copy_in, keep = [], [], []
        if slot.send_to is not None:
            out = [_as_bytes(t.contiguous()) for t in tensors]
            if self.stage and out and out[0].is_cuda:
                out = [self.staging.out(b) for b in out]
                for host, done in out:
                    done.synchronize()
                out = [host for host, _ in out]
            for b in out:
                p2p.append(dist.P2POp(dist.isend, b, slot.send_to,
                                      self.group))
                self.stats["messages"] += 1
                self.stats["bytes"] += b.numel()
            keep = out
        if slot.recv_from is not None:
            for r in recvs:
                b = _as_bytes(r)
                if self.stage and b.is_cuda:
                    host = torch.empty(b.shape, dtype=torch.uint8,
                                       pin_memory=True)
                    copy_in.append((b, host))
                    b = host
                p2p.append(dist.P2POp(dist.irecv, b, slot.recv_from,
                                      self.group))
        works = dist.batch_isend_irecv(p2p) if p2p else []
        return _Pending(recvs, works, copy_in, keep)

    def complete(self, pending: _Pending) -> list:
        """Wait for an issued slot; returns its received tensors."""
        for work in pending.works:
            work.wait()
        for b, host in pending.copy_in:
            b.copy_(host, non_blocking=True)
        pending.works = pending.copy_in = pending.keep = None
        return pending.recvs

    def exchange(self, tensors: list, slot: _Slot) -> list:
        """Send ``tensors`` to the slot's peer and receive their like from
        its source, zeros where this rank receives nothing."""
        return self.complete(self.issue(tensors, slot))


class _DryWire(_Wire):
    """The wire of a dry mesh's stand-in group: meta tensors only, each
    message counted in ``stats`` as :class:`_Wire` counts it, nothing
    sent; the received tensors are empty tensors of their shape."""

    def __init__(self):
        self.stats = {"messages": 0, "bytes": 0}

    def issue(self, tensors: list, slot: _Slot) -> _Pending:
        if any(t.device.type != "meta" for t in tensors):
            raise ValueError("a dry group's mixer takes meta tensors only")
        if slot.send_to is not None:
            self.stats["messages"] += len(tensors)
            self.stats["bytes"] += sum(t.numel() * t.element_size()
                                       for t in tensors)
        return _Pending([torch.empty_like(t) for t in tensors], [], [], [])

    def complete(self, pending: _Pending) -> list:
        return pending.recvs


def make_gossip_mixer(group, plan: SchedulePlan, *, flatten: bool = False,
                      compression=None):
    """Build this rank's ``mixer(tree, r) -> tree`` applying round
    ``r % len(plan)`` over ``group`` (None: the default group), whose
    rank i is the plan's node i.

    ``tree`` is this rank's flat dict, every tensor with a leading node
    axis of size 1.  The uncompressed mixer combines in buckets of at
    most :data:`BUCKET_BYTES` of f32 work buffers (see the module's
    docstring).  With ``compression`` (a ``CompressionConfig`` or a
    CLI string; identity and None mean uncompressed) the signature is
    ``mixer(tree, r, ef, t) -> (tree, ef)``: ``ef`` the EF21 residuals
    mirroring ``tree`` (None without error feedback), updated in place,
    and ``t`` the step counter keying the stochastic rounding.  The
    mixer's ``stats`` counts the messages and bytes this rank sent.
    ``group`` may be a dry mesh's ``DryGroup`` (module docstring)."""
    ccfg = resolve_compression(compression)
    if ccfg is not None and flatten:
        raise ValueError(
            "flatten_gossip + compression is unsupported: the whole-tree "
            "flat buffer would chunk across leaf boundaries, breaking "
            "payload-bit parity with the per-leaf simulation layout")
    dry = isinstance(group, DryGroup)
    world = group.size if dry else dist.get_world_size(group)
    if world != plan.n:
        raise ValueError(f"plan built for n={plan.n} nodes but the group "
                         f"has {world} ranks")
    if len(plan.rounds) == 0:
        raise ValueError("empty schedule plan")
    me = group.rank if dry else dist.get_rank(group)
    if dry or group is None or group is dist.group.WORLD:
        def to_global(r):
            return r
    else:
        def to_global(r):
            return dist.get_global_rank(group, r)
    rounds = _rank_rounds(plan, me, to_global)
    wire = _DryWire() if dry else _Wire(group)
    cap = BUCKET_BYTES

    def parts(tree: dict) -> list:
        """The float keys, cut into the combine's buckets (one part of
        every key with ``flatten``)."""
        keys = [k for k, x in tree.items() if x.is_floating_point()]
        if flatten:
            return [keys] if keys else []
        return [[keys[i] for i in b] for b in
                plan_buckets([4 * tree[k].numel() for k in keys], cap)]

    def issue_part(tree: dict, names: list, rnd: _Round) -> list:
        """Each work buffer of a part, with its slots' exchanges issued."""
        trace.mark("exchange")
        if flatten:
            works = [torch.cat([tree[k].reshape(-1).to(torch.float32)
                                for k in names])]
        else:
            works = [tree[k].to(torch.float32) for k in names]
        return [(w, [wire.issue([w], slot) for slot in rnd.slots])
                for w in works]

    def complete_part(tree: dict, names: list, posted: list, rnd: _Round,
                      out: dict) -> None:
        """Wait for a part's exchanges and combine it into ``out``."""
        bufs = [[w, *(wire.complete(p)[0] for p in ps)] for w, ps in posted]
        del posted
        trace.mark("combine")
        if flatten:
            mixed = ops.gossip_mix_many(bufs, rnd.weights)[0]
            del bufs
            start = 0
            for k in names:
                x = tree[k]
                out[k] = mixed[start:start + x.numel()].reshape(
                    x.shape).to(x.dtype)
                start += x.numel()
            return
        mixed = ops.gossip_mix_many(bufs, rnd.weights,
                                    [tree[k].dtype for k in names])
        del bufs
        out.update(zip(names, mixed))

    def mixer(tree: dict, r: int) -> dict:
        rnd = rounds[r % len(rounds)]
        out = dict(tree)
        for names in parts(tree):      # one bucket's buffers at a time
            complete_part(tree, names, issue_part(tree, names, rnd), rnd,
                          out)
        return out

    def issue(tree: dict, r: int):
        """Issue round ``r``'s exchanges of ``tree`` and return at once;
        :func:`complete` of the handle waits, combines and returns what
        ``mixer(tree, r)`` returns, bit for bit, having sent the same
        messages.  Until then the handle holds every bucket's buffers."""
        rnd = rounds[r % len(rounds)]
        return tree, rnd, [(names, issue_part(tree, names, rnd))
                           for names in parts(tree)]

    def complete(handle) -> dict:
        tree, rnd, posted = handle
        out = dict(tree)
        while posted:
            names, p = posted.pop(0)
            complete_part(tree, names, p, rnd, out)
        return out

    mixer.issue, mixer.complete = issue, complete

    if ccfg is None:
        mixer.stats = wire.stats
        return mixer

    codec = get_codec(ccfg.codec)

    def compressed_mixer(tree: dict, r: int, ef: dict | None, t: int):
        rnd = rounds[r % len(rounds)]
        key = sr_key(ccfg.seed, t)
        C = ccfg.chunk
        out, leaves = {}, []
        for names in reference_leaves(tree):
            if tree[names[0]].is_floating_point():
                leaves.append(names)
            else:
                out.update((k, tree[k]) for k in names)
        sizes = [rows_bytes([tree[k] for k in names], C) for names in leaves]
        grouped = codec.compress_many is not None
        for bucket in plan_buckets(sizes, cap if grouped else 0):
            group = [leaves[i] for i in bucket]
            trace.mark("quantize")
            owns = [group_to_rows([tree[k] for k in names], C)
                    for names in group]
            e2ds = None if ef is None else [
                group_to_rows([ef[k] for k in names], C) for names in group]
            payloads, resids = compress_bucket(
                codec, ccfg, owns, e2ds, key,
                [me * own.shape[0] for own in owns])
            del e2ds
            if ef is not None:
                for names, resid in zip(group, resids):
                    shape = tree[names[0]].shape
                    for k, part in zip(names, rows_to_group(resid, shape,
                                                            len(names))):
                        ef[k].copy_(part)
                del resid, part
            del resids
            trace.mark("exchange")
            recvs = []
            for payload in payloads:
                fields = sorted(payload)
                recvs.append([dict(zip(fields, wire.exchange(
                    [payload[f] for f in fields], slot)))
                    for slot in rnd.slots])
            del payloads, payload
            trace.mark("combine")
            if codec.fused_mix:
                mixed = ops.quantized_gossip_mix_many(
                    owns, [[rc["q"] for rc in rcs] for rcs in recvs],
                    [[rc["scale"] for rc in rcs] for rcs in recvs],
                    rnd.weights)
            else:
                mixed = []
                for own, rcs in zip(owns, recvs):
                    m = rnd.weights[0] * own
                    for w, rc in zip(rnd.weights[1:], rcs):
                        m = m + w * codec.decode(ccfg, rc)
                    mixed.append(m)
                del m
            del owns, recvs
            for names, m in zip(group, mixed):
                xs = [tree[k] for k in names]
                for k, x, part in zip(names, xs, rows_to_group(
                        m, xs[0].shape, len(names))):
                    out[k] = part.to(x.dtype)
            del mixed, m, part
        return {k: out[k] for k in tree}, ef

    compressed_mixer.stats = wire.stats
    return compressed_mixer
