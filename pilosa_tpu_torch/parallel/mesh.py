"""Multi-device placement: a plane's shard axis in contiguous blocks.

The counterpart of ``pilosa_tpu.parallel.mesh``.  One process drives its
devices, as the reference's single controller does: a plane's shard axis
is split into contiguous blocks, one per device (device ``i`` holds shards
``[i*S/D, (i+1)*S/D)``, the layout of the reference's ``P("shard")``); each
hand kernel launches per block on that block's device; per-shard outputs
are gathered onto the placement's first device in block order, and the
reduction that follows is the one the single-device port runs.  Within a
process that gather stands in for the reference's ``psum`` / all-gather
over ICI.  A placement whose ``group`` is set spans several processes
(:class:`~pilosa_tpu_torch.parallel.multiproc.ProcessPlacement`): after
the local gather or sum, one all-gather or all-reduce over the group, on
the current stream of the first local device, gives every process the
whole answer.

A device may repeat: ``MeshPlacement(["cuda:0"] * 4)`` is four blocks on
one card (:func:`pilosa_tpu_torch.virtmesh.virtual_placement`), the
counterpart of the reference's virtual CPU mesh.  On a CUDA device every
block launches on a stream of its own: a block's work first waits on the
caller's current stream, the caller's stream waits on the block's after
it, and a block's output is copied onto the first device only after an
event recorded on the source device's stream.

:class:`Blocked` is one such tensor: per-block device tensors and their
shard (and, on a 2-D placement, word) spans.  :meth:`Blocked.map` runs a
function per block, :meth:`Blocked.gather` concatenates per-shard
outputs onto the first device, :meth:`Blocked.total` sums per-block
totals there.  Bitwise operators and ``torch.bitwise_*`` run per block;
any other torch function on a blocked tensor raises
:class:`~pilosa_tpu_torch.exec.errors.MeshNotSupported` rather than
quietly gathering a resident plane onto one device.

Three exchanges serve the calls whose answer per block depends on other
blocks: :func:`shard_prefix` (each block's base of an exclusive prefix
over per-shard counts in serving order: ``Limit``'s global ranks),
:meth:`Blocked.reduce_words` (per-shard counts summed over a shard's word
blocks and handed back to each: the Min/Max descent on a 2-D placement,
through ``per_block(steps=True)``) and :func:`words_below` (the words
below each word block: ``Shift``'s carry).  Every copy between devices
waits on an event recorded on the source's stream.
"""

from __future__ import annotations

import inspect
import threading
from functools import reduce, wraps

import numpy as np
import torch

PAD_SHARD = -1  # shard-list padding entry: an all-zero shard
SHARD_AXIS = "shard"
WORDS_AXIS = "words"


def not_supported(what: str) -> Exception:
    """The refusal of an operation no serving path routes over blocked
    tensors."""
    from pilosa_tpu_torch.exec.errors import MeshNotSupported
    return MeshNotSupported(
        f"{what} is not supported by this port under a mesh placement")


def _cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass the devices (e.g. ['cpu'] * 4) "
            "to place blocks on the CPU explicitly")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class _Placement:
    """What the 1-D and 2-D placements share: devices, streams, padding,
    placing host arrays and replicating small tensors."""

    devices: list[torch.device]
    n_devices: int      # the shard-axis width (what shard lists pad to)
    words_size: int = 1
    group = None        # the process group the placement spans (None:
    #                     this process alone; parallel.multiproc)

    def _init_devices(self, devices) -> None:
        if devices is None:
            devices = _cuda_devices()
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh placement needs at least one device")
        self._streams: dict[int, torch.cuda.Stream] = {}
        self._stream_lock = threading.Lock()

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def pad_shards(self, shards: tuple[int, ...]) -> tuple[int, ...]:
        """Pad a shard list to a multiple of the shard-axis width with
        ``PAD_SHARD`` entries (all-zero shards)."""
        rem = len(shards) % self.n_devices
        if rem:
            shards = tuple(shards) + (PAD_SHARD,) * (self.n_devices - rem)
        return tuple(shards)

    def stream(self, i: int) -> torch.cuda.Stream:
        """Block ``i``'s CUDA stream (one per block, made on first use)."""
        with self._stream_lock:
            s = self._streams.get(i)
            if s is None:
                s = self._streams[i] = torch.cuda.Stream(self.devices[i])
            return s

    def place(self, host) -> "Blocked":
        """A host array (axis 0 = shards; numpy uint32 words become int32
        bits) as a :class:`Blocked` over this placement, one copy per
        block."""
        if isinstance(host, np.ndarray):
            arr = np.ascontiguousarray(host)
            if arr.dtype == np.uint32:
                arr = arr.view(np.int32)
            host = torch.from_numpy(arr)
        host = host.cpu()
        layout = self.layout(host.shape[0],
                             host.shape[-1] if host.dim() > 1 else None)
        blocks = [host[s0:s1, ..., w0:w1] if w0 is not None
                  else host[s0:s1] for s0, s1, w0, w1 in layout]
        return Blocked([b.contiguous().to(self.devices[i])
                        for i, b in enumerate(blocks)], layout, self)

    def zeros(self, shape: tuple, dtype=torch.int32) -> "Blocked":
        """An all-zero blocked tensor of global ``shape`` (axis 0 =
        shards), allocated on each block's device."""
        layout = self.layout(shape[0], shape[-1] if len(shape) > 1 else None)
        blocks = []
        for i, (s0, s1, w0, w1) in enumerate(layout):
            bshape = (s1 - s0,) + tuple(shape[1:])
            if w0 is not None:
                bshape = bshape[:-1] + (w1 - w0,)
            blocks.append(torch.zeros(bshape, dtype=dtype,
                                      device=self.devices[i]))
        return Blocked(blocks, layout, self)

    def replicate(self, t: torch.Tensor) -> "PerBlock":
        """One copy of ``t`` per block (blocks on one device share it)."""
        copies: dict = {}
        return PerBlock([copies.setdefault(d, t.to(d))
                         for d in self.devices])


class MeshPlacement(_Placement):
    """A plane's shard axis over ``devices`` (all CUDA devices by
    default) in contiguous blocks."""

    def __init__(self, devices: list | None = None, axis: str = SHARD_AXIS):
        self._init_devices(devices)
        self.axis = axis
        self.n_devices = len(self.devices)

    def layout(self, n_shards: int, n_words: int | None = None) -> tuple:
        """Each block's ``(shard start, shard stop, None, None)``."""
        d = self.n_devices
        if n_shards % d:
            raise ValueError(f"{n_shards} shards do not divide over {d} "
                             "devices (pad the shard list first)")
        per = n_shards // d
        return tuple((i * per, (i + 1) * per, None, None) for i in range(d))

    @property
    def key(self) -> tuple:
        """The placement's identity in batch-group keys."""
        return ("mesh1d", self.axis, self.n_devices)


class MeshPlacement2D(_Placement):
    """A ``(shard, words)`` placement: shards over ``shard_size`` blocks
    AND each shard's word axis over ``words_size`` blocks, block ``(i,
    j)`` on ``devices[i * words_size + j]``.  Counts over a block are
    partial per shard and sum over the word blocks of its shard range."""

    def __init__(self, devices: list | None = None, shard_size: int = 1,
                 words_size: int = 2, shard_axis: str = SHARD_AXIS,
                 words_axis: str = WORDS_AXIS):
        self._init_devices(devices)
        if shard_size * words_size != len(self.devices):
            raise ValueError(
                f"mesh {shard_size}x{words_size} needs "
                f"{shard_size * words_size} devices, have "
                f"{len(self.devices)}")
        self.shard_axis, self.words_axis = shard_axis, words_axis
        self.axis = shard_axis
        self.n_devices = shard_size
        self.words_size = words_size

    def layout(self, n_shards: int, n_words: int | None = None) -> tuple:
        """Each block's ``(shard start, shard stop, word start, word
        stop)``, word blocks of one shard range adjacent."""
        ss, ws = self.n_devices, self.words_size
        if n_shards % ss:
            raise ValueError(f"{n_shards} shards do not divide over {ss} "
                             "shard blocks (pad the shard list first)")
        if n_words is None or n_words % ws:
            raise ValueError(f"a word axis of {n_words} does not divide "
                             f"over {ws} word blocks")
        per, wper = n_shards // ss, n_words // ws
        return tuple((i * per, (i + 1) * per, j * wper, (j + 1) * wper)
                     for i in range(ss) for j in range(ws))

    @property
    def key(self) -> tuple:
        return ("mesh2d", self.shard_axis, self.words_axis,
                self.n_devices, self.words_size)


def local_placement() -> MeshPlacement | None:
    """A placement over every CUDA device when there is more than one,
    else None (single-device serving)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return MeshPlacement(_cuda_devices()) if n > 1 else None


class PerBlock:
    """One value per block of a placement: a replicated tensor's copies, a
    blocked overlay's parts, a block's own CSR arrays.
    :meth:`Blocked.map` hands block ``i`` its ``parts[i]``."""

    def __init__(self, parts):
        self.parts = list(parts)


# torch functions that run per block on blocked operands, element by
# element (shape and layout kept)
_ELEMENTWISE = {
    torch.bitwise_and, torch.bitwise_or, torch.bitwise_xor,
    torch.bitwise_not, torch.zeros_like, torch.Tensor.__and__,
    torch.Tensor.__or__, torch.Tensor.__xor__, torch.Tensor.__invert__,
    torch.Tensor.__rand__, torch.Tensor.__ror__, torch.Tensor.__rxor__,
}


class Blocked:
    """A tensor whose axis 0 (shards) is split into contiguous blocks, one
    per device of its placement (on a 2-D placement the last axis, words,
    is split too).  ``layout`` holds each block's ``(shard start, shard
    stop, word start, word stop)``, the word pair None when words are
    whole.  ``partial``: the blocks hold counts over a word block each
    (2-D placements), which sum per shard in :meth:`gather`."""

    __slots__ = ("blocks", "layout", "placement", "partial")

    def __init__(self, blocks: list, layout: tuple, placement,
                 partial: bool = False):
        if len(blocks) != len(layout):
            raise ValueError("one block per layout entry")
        self.blocks = list(blocks)
        self.layout = layout
        self.placement = placement
        self.partial = partial

    # -- tensor surface ------------------------------------------------------

    @property
    def shape(self) -> torch.Size:
        b0 = self.blocks[0].shape
        spans = {(s0, s1) for s0, s1, _, _ in self.layout}
        dims = [sum(s1 - s0 for s0, s1 in spans)] + list(b0[1:])
        w0 = self.layout[0][2]
        if w0 is not None and not self.partial:
            dims[-1] = sum(w1 - w0 for s0, _, w0, w1 in self.layout
                           if s0 == self.layout[0][0])
        return torch.Size(dims)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first block's device (where gathers land)."""
        return self.blocks[0].device

    @property
    def ndim(self) -> int:
        return self.blocks[0].dim()

    def numel(self) -> int:
        return sum(b.numel() for b in self.blocks)

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.blocks)

    def words_split(self) -> bool:
        return self.layout[0][2] is not None

    # -- per block ---------------------------------------------------------

    def map(self, fn, *args, **kw) -> list:
        """``fn`` once per block, each Blocked argument (alike laid out)
        replaced by its block, a :class:`PerBlock` by its part, tuples
        and lists element by element; other arguments pass as they are.
        On CUDA each block runs on its own stream, ordered after the
        caller's stream and before it again.  A failing block raises to
        the caller."""
        outs = []
        used = []
        try:
            for i, blk in enumerate(self.blocks):
                a = [_pick(x, i, self) for x in args]
                k = {n: _pick(v, i, self) for n, v in kw.items()}
                dev = blk.device
                if dev.type != "cuda":
                    outs.append(fn(*a, **k))
                    continue
                stream = self.placement.stream(i)
                stream.wait_stream(torch.cuda.current_stream(dev))
                used.append((dev, stream))
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    outs.append(fn(*a, **k))
        finally:
            for dev, stream in used:
                torch.cuda.current_stream(dev).wait_stream(stream)
        return outs

    def like(self, outs: list, partial: bool | None = None) -> "Blocked":
        """Per-block outputs laid out as this tensor's shard blocks."""
        return Blocked(outs, self.layout, self.placement,
                       self.partial if partial is None else partial)

    def to_first(self, t: torch.Tensor) -> torch.Tensor:
        """One block's output on the first device (:func:`move_to`)."""
        return move_to(t, self.placement.first)

    def gather(self, outs: list | None = None, dim: int = 0) -> torch.Tensor:
        """Per-shard outputs (axis ``dim`` = this tensor's shards; the
        blocks' own by default) concatenated onto the first device in
        block order; a 2-D placement's word blocks of one shard range sum
        first (their counts are partial).  Across processes every
        process's part follows in rank order."""
        if outs is None:
            outs = self.blocks
            if self.words_split() and not self.partial:
                raise not_supported("reading a word-split bitmap as counts")
        rows = [self._sum([outs[i] for i in idx]) for idx in self._spans()]
        return self._across(rows[0] if len(rows) == 1
                            else torch.cat(rows, dim), dim)

    def full(self) -> torch.Tensor:
        """The whole tensor on the first device: shard blocks concatenated,
        a 2-D placement's word blocks of one shard range side by side (a
        bitmap's words; counts go through :meth:`gather`); across
        processes every process's shards in rank order."""
        if self.partial:
            raise not_supported("reading partial counts as a bitmap")
        rows = [self._cat([self.blocks[i] for i in idx], -1)
                for idx in self._spans()]
        return self._across(rows[0] if len(rows) == 1
                            else torch.cat(rows, 0), 0)

    def concat(self, outs: list, dim: int = 0) -> torch.Tensor:
        """Per-block outputs concatenated along ``dim`` on the first device
        in block order, a 2-D placement's word blocks too (nothing sums:
        entries of partial counts the host combines).  Not across
        processes: the entries' shapes may differ between them."""
        if self.placement.group is not None:
            raise not_supported("per-block entries across processes")
        return self._cat(outs, dim)

    def total(self, outs: list) -> torch.Tensor:
        """Per-block totals summed on the first device, then over every
        process of the placement's group (one all-reduce)."""
        t = self._sum(outs)
        group = self.placement.group
        return t if group is None else group.sum(t)

    def _cat(self, outs: list, dim: int) -> torch.Tensor:
        outs = [self.to_first(o) for o in outs]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim)

    def _sum(self, outs: list) -> torch.Tensor:
        return reduce(lambda a, b: a + b, [self.to_first(o) for o in outs])

    def _across(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's part of a per-shard output, joined in rank order
        with every other process's (one all-gather) under a group."""
        group = self.placement.group
        return t if group is None else group.cat(t, dim)

    def _spans(self) -> list:
        """The block indices of each shard range, in serving order (one
        per block on a 1-D placement, a shard range's word blocks
        together on a 2-D one)."""
        groups: list = []
        last = None
        for i, (s0, s1, _, _) in enumerate(self.layout):
            if (s0, s1) != last:
                groups.append([])
                last = (s0, s1)
            groups[-1].append(i)
        return groups

    def reduce_words(self) -> "Blocked":
        """Per-shard counts (axis 0 = the block's shards) summed over each
        shard range's word blocks on the first device, and the sums copied
        back to each of those blocks: whole per-shard counts on every
        block, for a descent that decides per shard.  Without word blocks
        the counts are whole already."""
        if not self.words_split():
            return self.like(self.blocks, partial=False)
        out: list = [None] * len(self.blocks)
        for idx in self._spans():
            total = self._sum([self.blocks[i] for i in idx])
            for i in idx:
                out[i] = move_to(total, self.blocks[i].device)
        return self.like(out, partial=False)

    # -- elementwise ---------------------------------------------------------

    def __getitem__(self, idx) -> "Blocked":
        """Indexing that keeps the shard axis (``x[:, i]``, ``x[..., r,
        :]``) and, on a 2-D placement, the word axis, per block."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        if not _keeps_axes(idx, self.ndim,
                           self.words_split() and not self.partial):
            raise not_supported(f"indexing a blocked tensor with {idx!r}")
        return self.like([b[idx] for b in self.blocks])

    def contiguous(self) -> "Blocked":
        return self.like([b.contiguous() for b in self.blocks])

    def __and__(self, other):
        return _elementwise(torch.bitwise_and, self, other)

    def __or__(self, other):
        return _elementwise(torch.bitwise_or, self, other)

    def __xor__(self, other):
        return _elementwise(torch.bitwise_xor, self, other)

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def __invert__(self):
        return _elementwise(torch.bitwise_not, self)

    def __eq__(self, other):
        raise not_supported("comparing a blocked tensor")

    __ne__ = __eq__
    __hash__ = object.__hash__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in _ELEMENTWISE:
            return _elementwise(func, *args, **(kwargs or {}))
        raise not_supported(
            f"torch.{getattr(func, '__name__', func)} on a blocked tensor")

    def __repr__(self) -> str:
        return (f"Blocked(shape={tuple(self.shape)}, blocks="
                f"{len(self.blocks)}, devices="
                f"{[str(b.device) for b in self.blocks]})")


def move_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: a tensor already there is marked used on the
    caller's stream; another CUDA device's is copied after an event
    recorded on the source device's current stream."""
    if t.device.type != "cuda":
        return t.to(device)
    src = torch.cuda.current_stream(t.device)
    if t.device == device:
        t.record_stream(src)
        return t
    ev = torch.cuda.Event()
    ev.record(src)
    if device.type == "cuda":
        torch.cuda.current_stream(device).wait_event(ev)
    t.record_stream(src)
    return t.to(device, non_blocking=device.type == "cuda")


def shard_prefix(counts):
    """The exclusive prefix of per-shard counts in serving order, int64:
    each shard's count of the set bits before it.  A plain int32[S] gives
    an int64[S] tensor; a blocked one (on a 2-D placement per (shard,
    word block), word blocks in order within a shard) is summed on the
    first device and each block's int64[S_b] base copied to its device,
    a :class:`PerBlock`."""
    if not isinstance(counts, Blocked):
        c = counts.to(torch.int64)
        return torch.cumsum(c, 0) - c
    if counts.placement.group is not None:
        raise not_supported("a prefix over shards across processes")
    spans = counts._spans()
    # [S_span, word blocks] per shard range: serving order row by row
    mats = [torch.stack([counts.to_first(counts.blocks[i]).to(torch.int64)
                         for i in idx], 1) for idx in spans]
    flat = torch.cat([m.reshape(-1) for m in mats])
    base = torch.cumsum(flat, 0) - flat
    out: list = [None] * len(counts.blocks)
    off = 0
    for idx, m in zip(spans, mats):
        part = base[off:off + m.numel()].reshape(m.shape)
        off += m.numel()
        for j, i in enumerate(idx):
            out[i] = move_to(part[:, j].contiguous(),
                             counts.blocks[i].device)
    return PerBlock(out)


def words_below(x: Blocked, k: int) -> PerBlock:
    """For each block, the ``k`` words of its shards just below its word
    range (int32[..., k], zeros below the shard's word 0), taken from the
    lower word blocks of its shard range and copied to its device: the
    bits a shift by up to ``32 * k`` columns carries into the block."""
    out: list = []
    for i, (s0, s1, w0, w1) in enumerate(x.layout):
        blk = x.blocks[i]
        lo = w0 - k
        pieces = []
        if lo < 0:
            pieces.append(blk.new_zeros(blk.shape[:-1] + (-lo,)))
        for j, (t0, t1, v0, v1) in enumerate(x.layout):
            if (t0, t1) != (s0, s1):
                continue
            a, b = max(v0, lo), min(v1, w0)
            if a < b:
                pieces.append(move_to(x.blocks[j][..., a - v0:b - v0],
                                      blk.device))
        out.append(pieces[0] if len(pieces) == 1
                   else torch.cat(pieces, -1))
    return PerBlock(out)


def _full(i) -> bool:
    return isinstance(i, slice) and i == slice(None)


def _keeps_axes(idx: tuple, ndim: int, words_split: bool) -> bool:
    """Whether ``idx`` leaves axis 0 (shards) whole and, when words are
    split, the last axis too: only ints and slices, one Ellipsis at
    most."""
    if any(isinstance(i, torch.Tensor) or i is None for i in idx):
        return False
    ell = [k for k, i in enumerate(idx) if i is Ellipsis]
    if len(ell) > 1:
        return False
    if not (_full(idx[0]) or (ell == [0] and len(idx) - 1 < ndim)):
        return False
    if not words_split:
        return True
    if ell:
        return ell[0] == len(idx) - 1 or _full(idx[-1])
    return len(idx) < ndim or _full(idx[-1])


def _pick(x, i: int, owner: Blocked):
    if isinstance(x, Blocked):
        if x.layout != owner.layout or x.placement is not owner.placement:
            raise ValueError("blocked operands of different layouts")
        if x.partial:
            raise not_supported("an operation on partial counts")
        return x.blocks[i]
    if isinstance(x, PerBlock):
        return x.parts[i]
    if isinstance(x, (tuple, list)):
        return type(x)(_pick(v, i, owner) for v in x)
    return x


def first_blocked(*args) -> Blocked | None:
    """The first :class:`Blocked` among ``args`` (tuples and lists
    searched), or None."""
    for x in args:
        if isinstance(x, Blocked):
            return x
        if isinstance(x, (tuple, list)):
            hit = first_blocked(*x)
            if hit is not None:
                return hit
    return None


def _elementwise(func, *args, **kw):
    """``func`` per block over blocked operands of one layout; a plain
    tensor operand must be a scalar (a whole-shape plain tensor has no
    block to pair with)."""
    owner = first_blocked(*args)
    for a in args:
        if isinstance(a, torch.Tensor) and a.dim() > 0:
            raise not_supported(
                f"torch.{getattr(func, '__name__', func)} between a blocked "
                "and a plain tensor")
    return owner.like(owner.map(func, *args, **kw))


def per_block(fn=None, *, combine="blocked", dim: int = 0,
              reduces_words: bool = False, steps: bool = False):
    """Decorator: a function over per-shard tensors (axis 0 = shards) runs
    per block when one of its arguments is, or holds, a :class:`Blocked`,
    and its per-block outputs combine on the first device by ``combine``:

    - ``"blocked"``: laid out as that argument (the outputs stay per
      shard on their blocks);
    - ``"total"``: summed (per-block totals);
    - ``"gather"``: concatenated along ``dim`` in block order (per-shard
      outputs; a 2-D placement's word blocks of one shard range sum);
    - ``"concat"``: concatenated along ``dim`` in block order, word
      blocks too (entries the host combines, partial counts included);
    - a function of the call's arguments, bound by name, that returns
      one of these.

    A dict or tuple output (nested too) combines entry by entry.  ``reduces_words``:
    the function reduces the word axis (a popcount), so on a 2-D
    placement its blocked outputs are partial counts.  ``steps``: the
    function is a generator (see :func:`run_steps`) whose every yield is
    a per-shard count it reads back summed over the shard's words."""
    def wrap(f):
        sig = inspect.signature(f) if callable(combine) else None

        @wraps(f)
        def inner(*args, **kw):
            owner = first_blocked(*args, *kw.values())
            if owner is None:
                return drive(f(*args, **kw)) if steps else f(*args, **kw)
            how = combine
            if sig is not None:
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                how = combine(bound.arguments)
            outs = (run_steps(owner, f, *args, **kw) if steps
                    else owner.map(f, *args, **kw))
            partial = reduces_words and owner.words_split()

            def one(parts):
                if isinstance(parts[0], dict):
                    return {k: one([p[k] for p in parts]) for k in parts[0]}
                if isinstance(parts[0], tuple):
                    return tuple(one([p[j] for p in parts])
                                 for j in range(len(parts[0])))
                if how == "total":
                    return owner.total(parts)
                if how == "gather":
                    return owner.gather(parts, dim)
                if how == "concat":
                    return owner.concat(parts, dim)
                return owner.like(parts, partial)

            return one(outs)
        return inner
    return wrap if fn is None else wrap(fn)


def drive(gen):
    """Run a step generator (:func:`run_steps`) over whole shards: each
    yielded count goes back as it is; returns the generator's value."""
    try:
        value = next(gen)
        while True:
            value = gen.send(value)
    except StopIteration as stop:
        return stop.value


def _advance(gen, value):
    try:
        return False, gen.send(value)
    except StopIteration as stop:
        return True, stop.value


def run_steps(owner: Blocked, f, *args, **kw) -> list:
    """A step generator ``f`` once per block of ``owner``: per-block
    outputs in block order.  ``f`` yields per-shard counts over its
    block's words (axis 0 = the block's shards) and reads back each
    shard's count over its whole words.  With whole words per block that
    is its own count (:func:`drive` per block); on a 2-D placement the
    blocks advance in lockstep, every yield summed over each shard
    range's word blocks (:meth:`Blocked.reduce_words`) before any block
    resumes."""
    if not owner.words_split():
        return owner.map(lambda *a, **k: drive(f(*a, **k)), *args, **kw)
    gens = owner.map(f, *args, **kw)      # generator objects: no step yet
    sent: list = [None] * len(gens)
    while True:
        res = owner.map(_advance, PerBlock(gens), PerBlock(sent))
        done = [r[0] for r in res]
        if all(done):
            return [r[1] for r in res]
        if any(done):
            raise RuntimeError("blocks of one placement stopped at "
                               "different steps")
        sent = owner.like([r[1] for r in res], partial=True) \
            .reduce_words().blocks


def blocks_of(x) -> list:
    """``[((shard start, shard stop, word start, word stop), tensor),
    ...]``: each block of a :class:`Blocked` (its words whole, ``[0,
    W)``, on a 1-D placement), or a plain tensor as one block."""
    if not isinstance(x, Blocked):
        return [((0, x.shape[0], 0, x.shape[-1]), x)]
    return [((s0, s1, 0 if w0 is None else w0,
              blk.shape[-1] if w1 is None else w1), blk)
            for (s0, s1, w0, w1), blk in zip(x.layout, x.blocks)]


def gathered(x):
    """A per-shard count tensor on one device: a :class:`Blocked` one
    gathered (partial word-block counts summed), a plain one as it is."""
    return x.gather() if isinstance(x, Blocked) else x


def whole(x):
    """A bitmap on one device: a :class:`Blocked` one whole on the first
    device (:meth:`Blocked.full`), a plain one as it is."""
    return x.full() if isinstance(x, Blocked) else x
