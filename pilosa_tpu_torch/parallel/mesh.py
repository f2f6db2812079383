"""Multi-device placement: a plane's shard axis in contiguous blocks.

The counterpart of ``pilosa_tpu.parallel.mesh``.  One process drives every
device, as the reference's single controller does: a plane's shard axis is
split into contiguous blocks, one per device (device ``i`` holds shards
``[i*S/D, (i+1)*S/D)``, the layout of the reference's ``P("shard")``); each
hand kernel launches per block on that block's device; per-shard outputs
are gathered onto the placement's first device in block order, and the
reduction that follows is the one the single-device port runs.  That
gather stands in for the reference's ``psum`` / all-gather over ICI: the
port has no collectives.

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
    """The refusal of a call this port does not serve under a placement."""
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
        """One block's output on the first device: same-device outputs are
        marked used on the caller's stream; another device's are copied
        after an event recorded on the source device's stream."""
        first = self.placement.first
        if t.device.type != "cuda":
            return t.to(first)
        src = torch.cuda.current_stream(t.device)
        if t.device == first:
            t.record_stream(src)
            return t
        ev = torch.cuda.Event()
        ev.record(src)
        torch.cuda.current_stream(first).wait_event(ev)
        t.record_stream(src)
        return t.to(first, non_blocking=True)

    def gather(self, outs: list | None = None, dim: int = 0) -> torch.Tensor:
        """Per-shard outputs (axis ``dim`` = this tensor's shards; the
        blocks' own by default) concatenated onto the first device in
        block order; a 2-D placement's word blocks of one shard range sum
        first (their counts are partial)."""
        if outs is None:
            outs = self.blocks
            if self.words_split() and not self.partial:
                raise not_supported("reading a word-split bitmap as counts")
        groups: list = []
        spans: list = []
        for (s0, s1, _, _), out in zip(self.layout, outs):
            out = self.to_first(out)
            if spans and spans[-1] == (s0, s1):
                groups[-1] = groups[-1] + out
            else:
                groups.append(out)
                spans.append((s0, s1))
        return groups[0] if len(groups) == 1 else torch.cat(groups, dim)

    def full(self) -> torch.Tensor:
        """The whole tensor on the first device: shard blocks concatenated,
        a 2-D placement's word blocks of one shard range side by side (a
        bitmap's words; counts go through :meth:`gather`)."""
        if self.partial:
            raise not_supported("reading partial counts as a bitmap")
        groups: list = []
        spans: list = []
        for (s0, s1, _, _), blk in zip(self.layout, self.blocks):
            blk = self.to_first(blk)
            if spans and spans[-1] == (s0, s1):
                groups[-1].append(blk)
            else:
                groups.append([blk])
                spans.append((s0, s1))
        rows = [g[0] if len(g) == 1 else torch.cat(g, -1) for g in groups]
        return rows[0] if len(rows) == 1 else torch.cat(rows, 0)

    def total(self, outs: list) -> torch.Tensor:
        """Per-block totals summed on the first device."""
        return reduce(lambda a, b: a + b, [self.to_first(o) for o in outs])

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
              reduces_words: bool = False, whole_words: str | None = None):
    """Decorator: a function over per-shard tensors (axis 0 = shards) runs
    per block when one of its arguments is, or holds, a :class:`Blocked`,
    and its per-block outputs combine on the first device by ``combine``:

    - ``"blocked"``: laid out as that argument (the outputs stay per
      shard on their blocks);
    - ``"total"``: summed (per-block totals);
    - ``"gather"``: concatenated along ``dim`` in block order (per-shard
      outputs; a 2-D placement's word blocks of one shard range sum);
    - a function of the call's arguments, bound by name, that returns
      one of these.

    A dict or tuple output (nested too) combines entry by entry.  ``reduces_words``:
    the function reduces the word axis (a popcount), so on a 2-D
    placement its blocked outputs are partial counts.  ``whole_words``:
    the function needs each shard's words whole; the name it is refused
    under over word-split blocks."""
    def wrap(f):
        sig = inspect.signature(f) if callable(combine) else None

        @wraps(f)
        def inner(*args, **kw):
            owner = first_blocked(*args, *kw.values())
            if owner is None:
                return f(*args, **kw)
            if whole_words and owner.words_split():
                raise not_supported(f"{whole_words} over word-split blocks")
            how = combine
            if sig is not None:
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                how = combine(bound.arguments)
            outs = owner.map(f, *args, **kw)
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
                return owner.like(parts, partial)

            return one(outs)
        return inner
    return wrap if fn is None else wrap(fn)


def gathered(x):
    """A per-shard count tensor on one device: a :class:`Blocked` one
    gathered (partial word-block counts summed), a plain one as it is."""
    return x.gather() if isinstance(x, Blocked) else x


def whole(x):
    """A bitmap on one device: a :class:`Blocked` one whole on the first
    device (:meth:`Blocked.full`), a plain one as it is."""
    return x.full() if isinstance(x, Blocked) else x
