"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` on the card.

The JAX package runs its hot programs (the tracking window, the per-frame
tracking steps, the local-BA solve) as one compiled device program each.
Run op by op from Python, the same programs cost hundreds of small kernel
launches per frame, and the host's launch loop, not the device, sets the
pace.  ``compiled`` closes that gap the PyTorch way: it records one eager
run of the program into a CUDA graph and replays it as one launch.

``compiled(fn, static=(...), by_ref=(...))`` wraps a function whose
arguments are tensors or tuples, NamedTuples, lists and dicts of tensors
(``None`` allowed).  The arguments named in ``static`` are Python values
baked into the graph.  Calls are keyed, as ``jax.jit`` keys its cache, by
the static values, the structure of the other arguments, every tensor's
shape and dtype, the device, and the calling thread.

The tensors of the arguments named in ``by_ref`` are read where they lie:
no copy goes into the graph, and each one's storage address and strides
join the key.  This is for large device-resident tables a program gathers
a few rows of (the keyframe feature pool): the graph reads the table's
current contents on every replay, and a reallocated table is a new key,
never a stale pointer.  The graph does not keep its table alive: when the
table is freed, the graph is dropped with it (and its pool released), so
pass the table itself, not a view made for the call.

On CUDA tensors:

- The first call of a key runs ``fn`` eagerly once on the thread's capture
  stream (outside capture, so nvcc-built kernels are built and bound
  there) and returns that result.  It then captures ``fn`` into a CUDA
  graph whose static input buffers the arguments were copied into.
- Every later call ``copy_``s its arguments (all but the ``by_ref`` ones)
  into the static inputs, on the caller's stream, and replays the graph
  there (a ``clone=True`` program: on the thread's capture stream, which
  waits for the caller's and which the caller's then waits for; see
  Memory).  A pinned host tensor among the arguments is an upload: it is
  copied without blocking straight into its static input.  Any other host
  tensor raises, as does a Python value that is not named static.
- Output lifetime: a replay returns the graph's static output buffers,
  valid until the next replay of the same key.  Work queued behind the
  call on the same stream (a device-to-host copy, a copy into another
  graph's inputs) reads them before that replay overwrites them.  With
  ``clone=True`` every call returns fresh copies instead, for callers that
  read the results later.
- No fallback: a capture or a replay that fails raises ``GraphError``
  naming the program and its key; nothing reruns the eager version.
- Streams and threads: each thread captures on its own stream in
  ``thread_local`` mode, so other threads go on launching (async mode's
  worker captures while the main thread replays); one capture runs at a
  time in the process.  Since the key holds the thread, no graph is
  replayed from two threads.
- Memory: the graphs of a ``clone=True`` program on one thread share one
  memory pool, and each replays on that thread's capture stream, its
  outputs copied out there before the stream runs the next: no two of
  them run at once, so one graph's scratch may lie where another's was.
  Every other graph has a private pool, since its outputs stay live
  until the key's next replay.  Each program keeps its ``max_entries``
  most recently used graphs (default ``MAX_ENTRIES``): capturing one more
  drops the least recently used (the caching allocator frees a pool no
  graph holds at its next retry or ``torch.cuda.empty_cache()``), so keys
  that never repeat do not hold memory for the life of the process.

On CPU tensors ``fn`` runs as it is.  Inside ``disabled()`` (the
counterpart of ``jax.disable_jit()``) every call runs eagerly on the
card too.

Launch counts: a kernel wrapper counts its launches with ``count(add)``.
Outside a capture that calls ``add(1)``; inside one it adds to the graph's
tally, and every replay of the graph calls ``add(n)`` with the launches it
holds.  So a count reads the launches the device really ran.

``stats()`` reports captures, replays, cache entries and evictions per
program and the MiB its graphs' pools hold.

Constants: a program may not copy a host array to the card while it is
captured.  ``constant(key, device, make)`` builds such a table once per
device, on the first (eager) call, and hands the same device tensor to
every later call, the capture's included.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from snakeslam_tpu_torch.system import stats as tracer

_lock = threading.Lock()          # the registry and the disabled depth
_capture_lock = threading.Lock()  # one capture at a time in the process
_local = threading.local()        # per thread: capture streams, the tally
_disabled = 0
_programs: list["Compiled"] = []
_constants: dict = {}

MAX_ENTRIES = 8                   # graphs a program keeps, by default


class GraphError(RuntimeError):
    """A capture or a replay of a compiled program failed."""


@contextlib.contextmanager
def disabled():
    """Run every compiled program eagerly while inside (nests; all
    threads)."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def is_disabled() -> bool:
    return _disabled > 0


def count(add, n: int = 1):
    """Count ``n`` kernel launches through ``add(n)``; while this thread
    captures a graph, into the graph's tally instead (see the module
    docstring)."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        add(n)
    else:
        tally[add] = tally.get(add, 0) + n


def constant(key, device, make) -> torch.Tensor:
    """The tensor ``make()`` (a numpy array or a tensor) on ``device``,
    made on the first call for (``key``, ``device``) and kept.  Programs
    take their tables from here: the eager warm-up makes them, so the
    capture that follows copies nothing from the host."""
    device = torch.device(device)
    t = _constants.get((key, device))
    if t is None:
        t = torch.as_tensor(make()).to(device)
        with _lock:
            t = _constants.setdefault((key, device), t)
    return t


# ---------------------------------------------------------------------------
# argument trees
# ---------------------------------------------------------------------------

def _flatten(x, leaves: list, values: list, ref: bool = False):
    """Append the tensors of ``x`` to ``leaves`` and its other leaves to
    ``values``; return a hashable description of ``x`` that holds its
    structure and every tensor's shape and dtype (with ``ref``, also its
    storage address and strides: a by-reference argument)."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        if ref:
            return ("R", tuple(x.shape), x.dtype, x.stride(), x.data_ptr())
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves, values, ref) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, leaves, values, ref))
                            for k, v in x.items()))
    if x is None:
        return None
    values.append(x)
    return ("V", x)


def _rebuild(desc, tensors):
    """The tree ``desc`` describes, its tensors taken in order from the
    iterator ``tensors``."""
    if desc is None:
        return None
    kind = desc[0]
    if kind in ("T", "R"):
        return next(tensors)
    if kind == "V":
        return desc[1]
    if kind is dict:
        return {k: _rebuild(v, tensors) for k, v in desc[1]}
    items = [_rebuild(v, tensors) for v in desc[1]]
    if kind is list:
        return items
    if kind is tuple:
        return tuple(items)
    return kind(*items)               # a NamedTuple


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    s = streams.get(device.index)
    if s is None:
        s = streams[device.index] = torch.cuda.Stream(device)
    return s


# ---------------------------------------------------------------------------
# compiled programs
# ---------------------------------------------------------------------------

@dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    inputs: list                 # static input buffers, one per tensor leaf
                                 # (None for a by-reference leaf)
    copied: list                 # per leaf: copied in on a replay
    outputs: list                # static output buffers
    out_desc: object
    tally: dict = field(default_factory=dict)   # add -> launches held
    thread: int = 0              # the capturing (and replaying) thread
    replays: int = 0


class Compiled:
    """A function whose CUDA calls run as captured graphs (see the module
    docstring).  Made by ``compiled``."""

    def __init__(self, fn, static=(), clone: bool = False,
                 name: str | None = None, by_ref=(),
                 max_entries: int = MAX_ENTRIES):
        self.fn = fn
        self.static = frozenset(static)
        self.by_ref = frozenset(by_ref)
        self.clone = clone
        self.name = name or fn.__name__
        if max_entries < 1:
            raise ValueError(f"{self.name}: max_entries {max_entries} < 1")
        self.max_entries = max_entries
        self._sig = inspect.signature(fn)
        unknown = (self.static | self.by_ref) - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"{self.name}: static or by_ref names "
                             f"{sorted(unknown)} are not parameters")
        both = self.static & self.by_ref
        if both:
            raise ValueError(f"{self.name}: {sorted(both)} named both static "
                             "and by_ref")
        self._entries: OrderedDict = OrderedDict()   # least recent first
        self._pools: dict = {}     # (thread, device index) -> shared pool
        self.captures = 0
        self.replays = 0
        self.evictions = 0
        functools.update_wrapper(self, fn)
        with _lock:
            _programs.append(self)

    def _bind(self, args, kwargs):
        """(static (name, value) pairs, the other arguments' description,
        their tensors, their other leaves, per tensor whether it is copied
        in (not by reference), the call's device: the first CUDA tensor's,
        else None)."""
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        statics, items = [], []
        leaves, values, copied = [], [], []
        for k, v in bound.arguments.items():
            if k in self.static:
                statics.append((k, v))
                continue
            n = len(leaves)
            items.append((k, _flatten(v, leaves, values, k in self.by_ref)))
            copied += [k not in self.by_ref] * (len(leaves) - n)
        desc = (dict, tuple(items))
        device = next((t.device for t in leaves if t.is_cuda), None)
        return tuple(statics), desc, leaves, values, copied, device

    def key(self, *args, **kwargs):
        """The cache key of this call on this thread (on CPU tensors the
        key a card call of the same shapes would have, with the CPU as its
        device)."""
        statics, desc, _, _, _, device = self._bind(args, kwargs)
        return (statics, desc, device or torch.device("cpu"),
                threading.get_ident())

    def __call__(self, *args, **kwargs):
        statics, desc, leaves, values, copied, device = self._bind(args,
                                                                   kwargs)
        if device is None:
            return self.fn(*args, **kwargs)
        if values:
            raise TypeError(
                f"{self.name}: non-tensor argument {values[0]!r} on the "
                "card: pass a tensor or name it static")
        for t, c in zip(leaves, copied):
            if t.device != device and not (c and t.device.type == "cpu"
                                           and t.is_pinned()):
                raise ValueError(
                    f"{self.name}: a tensor on {t.device} beside tensors on "
                    f"{device} (only pinned host tensors are uploaded, and "
                    "none by reference)")
        if _disabled:
            ins = [t.to(device, non_blocking=True) for t in leaves]
            return self.fn(**dict(statics), **_rebuild(desc, iter(ins)))
        key = (statics, desc, device, threading.get_ident())
        entry = self._entries.get(key)
        if entry is None:
            with tracer.span("graphs.capture"):
                return self._capture(key, statics, desc, leaves, copied,
                                     device)
        return self._replay(key, entry, leaves)

    def _describe(self, key) -> str:
        statics, desc, device, thread = key
        return (f"key (static {dict(statics)}, arguments {desc}, {device}, "
                f"thread {thread})")

    def _capture(self, key, statics, desc, leaves, copied, device):
        """Warm up eagerly, capture, and return the warm-up's result."""
        caller = torch.cuda.current_stream(device)
        stream = _capture_stream(device)
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=device)
                  if c else None for t, c in zip(leaves, copied)]
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            for s, t, c in zip(inputs, leaves, copied):
                if c:
                    s.copy_(t, non_blocking=True)
            args = dict(statics)
            args.update(_rebuild(desc, iter(
                s if c else t for s, t, c in zip(inputs, leaves, copied))))
            result = self.fn(**args)
        out_leaves = []
        out_desc = _flatten(result, out_leaves, [])
        for t in out_leaves:
            if t.is_cuda:
                t.record_stream(caller)
        graph = torch.cuda.CUDAGraph()
        tally = {}
        pool = anchor = None
        if self.clone:
            pk = (key[3], device.index)
            with _lock:
                # a live graph of the shared pool, held through the capture;
                # a pool that no graph holds any more may be freed, and is
                # not captured into again: a new one takes its place
                anchor = next((e.graph for k, e in self._entries.items()
                               if (k[3], k[2].index) == pk), None)
                if anchor is None:
                    self._pools[pk] = torch.cuda.graph_pool_handle()
                pool = self._pools[pk]
        with _capture_lock:
            _local.tally = tally
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        captured = self.fn(**args)
                    except BaseException:
                        with contextlib.suppress(RuntimeError):
                            graph.capture_end()
                        raise
                    graph.capture_end()
            except Exception as e:
                raise GraphError(f"{self.name}: capture failed for "
                                 f"{self._describe(key)}: {e}") from e
            finally:
                _local.tally = None
        caller.wait_stream(stream)
        del anchor
        outputs = []
        cap_desc = _flatten(captured, outputs, [])
        if cap_desc != out_desc:
            raise GraphError(f"{self.name}: the captured run returned "
                             f"{cap_desc}, the eager run {out_desc}")
        entry = _Entry(graph=graph, inputs=inputs, copied=copied,
                       outputs=outputs, out_desc=out_desc, tally=tally,
                       thread=key[3])
        with _lock:
            self._entries[key] = entry
            self.captures += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
        for t, c in zip(leaves, copied):
            if not c:        # the graph goes when a table it reads goes
                weakref.finalize(t, self._forget, key)
        return result

    def _forget(self, key):
        with _lock:
            self._entries.pop(key, None)

    def _replay(self, key, entry: _Entry, leaves):
        caller = torch.cuda.current_stream(key[2])
        stream = caller
        if self.clone:   # a shared pool's graphs run in turn on one stream
            stream = _capture_stream(key[2])
            stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            for s, t, c in zip(entry.inputs, leaves, entry.copied):
                if c:
                    s.copy_(t, non_blocking=True)
            try:
                entry.graph.replay()
            except RuntimeError as e:
                raise GraphError(f"{self.name}: replay failed for "
                                 f"{self._describe(key)}: {e}") from e
            outs = entry.outputs
            if self.clone:
                outs = [t.clone() for t in outs]
        if self.clone:
            for t in outs:
                t.record_stream(caller)
            caller.wait_stream(stream)
        for add, n in entry.tally.items():
            add(n)
        with _lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            entry.replays += 1
            self.replays += 1
        return _rebuild(entry.out_desc, iter(outs))

    def graph(self, *args, **kwargs) -> torch.cuda.CUDAGraph:
        """The captured graph of this call's key on this thread (the call
        must have been made once on the card)."""
        return self._entries[self.key(*args, **kwargs)].graph

    def entries(self) -> list[_Entry]:
        with _lock:
            return list(self._entries.values())

    def clear(self):
        """Drop every captured graph of this program (their pools become
        the allocator's to free)."""
        with _lock:
            self._entries.clear()


def compiled(fn, static=(), clone: bool = False, name: str | None = None,
             by_ref=(), max_entries: int = MAX_ENTRIES) -> Compiled:
    """``fn`` as a compiled program: see the module docstring."""
    return Compiled(fn, static=static, clone=clone, name=name, by_ref=by_ref,
                    max_entries=max_entries)


def programs() -> list[Compiled]:
    with _lock:
        return list(_programs)


def stats() -> dict:
    """Per program: captures, replays, cache entries, entries dropped to
    keep ``max_entries``, and the MiB reserved by its graphs' pools (a
    shared pool counted once; 0 without a CUDA context)."""
    pool_bytes: dict = {}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for seg in torch.cuda.memory_snapshot():
            pid = tuple(seg["segment_pool_id"])
            pool_bytes[pid] = pool_bytes.get(pid, 0) + seg["total_size"]
    out = {}
    for p in programs():
        entries = p.entries()
        pools = {tuple(e.graph.pool()) for e in entries}
        out[p.name] = dict(
            captures=p.captures, replays=p.replays, entries=len(entries),
            evictions=p.evictions,
            pool_mib=sum(pool_bytes.get(pid, 0) for pid in pools) / 2 ** 20)
    return out
