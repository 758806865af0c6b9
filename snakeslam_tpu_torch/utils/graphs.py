"""Captured CUDA graphs: the port's counterpart of ``jax.jit`` on the card.

The JAX package runs its hot programs (the tracking window, the per-frame
tracking steps, the local-BA solve) as one compiled device program each.
Run op by op from Python, the same programs cost hundreds of small kernel
launches per frame, and the host's launch loop, not the device, sets the
pace.  ``compiled`` closes that gap the PyTorch way: it records one eager
run of the program into a CUDA graph and replays it as one launch.

``compiled(fn, static=(...))`` wraps a function whose arguments are tensors
or tuples, NamedTuples, lists and dicts of tensors (``None`` allowed).
The arguments named in ``static`` are Python values baked into the graph.
Calls are keyed, as ``jax.jit`` keys its cache, by the static values, the
structure of the other arguments, every tensor's shape and dtype, the
device, and the calling thread.

On CUDA tensors:

- The first call of a key runs ``fn`` eagerly once on the thread's capture
  stream (outside capture, so nvcc-built kernels are built and bound
  there) and returns that result.  It then captures ``fn`` into a CUDA
  graph whose static input buffers the arguments were copied into.
- Every later call ``copy_``s its arguments into the static inputs, on the
  caller's stream, and replays the graph there.  A pinned host tensor
  among the arguments is an upload: it is copied without blocking straight
  into its static input.  Any other host tensor raises, as does a Python
  value that is not named static.
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
  time in the process.  Every graph has a private memory pool: no two
  graphs share memory, and since the key holds the thread, no graph is
  replayed from two threads.

On CPU tensors ``fn`` runs as it is.  Inside ``disabled()`` (the
counterpart of ``jax.disable_jit()``) every call runs eagerly on the
card too.

Launch counts: a kernel wrapper counts its launches with ``count(add)``.
Outside a capture that calls ``add(1)``; inside one it adds to the graph's
tally, and every replay of the graph calls ``add(n)`` with the launches it
holds.  So a count reads the launches the device really ran.

``stats()`` reports captures, replays and cache entries per program and
the MiB its graphs' pools hold.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
from dataclasses import dataclass, field

import torch

_lock = threading.Lock()          # the registry and the disabled depth
_capture_lock = threading.Lock()  # one capture at a time in the process
_local = threading.local()        # per thread: capture streams, the tally
_disabled = 0
_programs: list["Compiled"] = []


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


# ---------------------------------------------------------------------------
# argument trees
# ---------------------------------------------------------------------------

def _flatten(x, leaves: list, values: list):
    """Append the tensors of ``x`` to ``leaves`` and its other leaves to
    ``values``; return a hashable description of ``x`` that holds its
    structure and every tensor's shape and dtype."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves, values) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, leaves, values))
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
    if kind == "T":
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
    outputs: list                # static output buffers
    out_desc: object
    tally: dict = field(default_factory=dict)   # add -> launches held
    thread: int = 0              # the capturing (and replaying) thread
    replays: int = 0


class Compiled:
    """A function whose CUDA calls run as captured graphs (see the module
    docstring).  Made by ``compiled``."""

    def __init__(self, fn, static=(), clone: bool = False,
                 name: str | None = None):
        self.fn = fn
        self.static = frozenset(static)
        self.clone = clone
        self.name = name or fn.__name__
        self._sig = inspect.signature(fn)
        unknown = self.static - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"{self.name}: static names {sorted(unknown)} "
                             "are not parameters")
        self._entries: dict = {}
        self.captures = 0
        self.replays = 0
        functools.update_wrapper(self, fn)
        with _lock:
            _programs.append(self)

    def _bind(self, args, kwargs):
        """(static (name, value) pairs, the other arguments' description,
        their tensors, their other leaves, the call's device: the first
        CUDA tensor's, else None)."""
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        statics, dynamic = [], {}
        for k, v in bound.arguments.items():
            if k in self.static:
                statics.append((k, v))
            else:
                dynamic[k] = v
        leaves, values = [], []
        desc = _flatten(dynamic, leaves, values)
        device = next((t.device for t in leaves if t.is_cuda), None)
        return tuple(statics), desc, leaves, values, device

    def key(self, *args, **kwargs):
        """The cache key of this call on this thread (on CPU tensors the
        key a card call of the same shapes would have, with the CPU as its
        device)."""
        statics, desc, _, _, device = self._bind(args, kwargs)
        return (statics, desc, device or torch.device("cpu"),
                threading.get_ident())

    def __call__(self, *args, **kwargs):
        statics, desc, leaves, values, device = self._bind(args, kwargs)
        if device is None:
            return self.fn(*args, **kwargs)
        if values:
            raise TypeError(
                f"{self.name}: non-tensor argument {values[0]!r} on the "
                "card: pass a tensor or name it static")
        for t in leaves:
            if t.device != device and not (t.device.type == "cpu"
                                           and t.is_pinned()):
                raise ValueError(
                    f"{self.name}: a tensor on {t.device} beside tensors on "
                    f"{device} (only pinned host tensors are uploaded)")
        if _disabled:
            ins = [t.to(device, non_blocking=True) for t in leaves]
            return self.fn(**dict(statics), **_rebuild(desc, iter(ins)))
        key = (statics, desc, device, threading.get_ident())
        entry = self._entries.get(key)
        if entry is None:
            return self._capture(key, statics, desc, leaves, device)
        return self._replay(key, entry, leaves)

    def _describe(self, key) -> str:
        statics, desc, device, thread = key
        return (f"key (static {dict(statics)}, arguments {desc}, {device}, "
                f"thread {thread})")

    def _capture(self, key, statics, desc, leaves, device):
        """Warm up eagerly, capture, and return the warm-up's result."""
        caller = torch.cuda.current_stream(device)
        stream = _capture_stream(device)
        inputs = [torch.empty(t.shape, dtype=t.dtype, device=device)
                  for t in leaves]
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            for s, t in zip(inputs, leaves):
                s.copy_(t, non_blocking=True)
            args = dict(statics)
            args.update(_rebuild(desc, iter(inputs)))
            result = self.fn(**args)
        out_leaves = []
        out_desc = _flatten(result, out_leaves, [])
        for t in out_leaves:
            if t.is_cuda:
                t.record_stream(caller)
        graph = torch.cuda.CUDAGraph()
        tally = {}
        with _capture_lock:
            _local.tally = tally
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin(capture_error_mode="thread_local")
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
        outputs = []
        cap_desc = _flatten(captured, outputs, [])
        if cap_desc != out_desc:
            raise GraphError(f"{self.name}: the captured run returned "
                             f"{cap_desc}, the eager run {out_desc}")
        entry = _Entry(graph=graph, inputs=inputs, outputs=outputs,
                       out_desc=out_desc, tally=tally, thread=key[3])
        with _lock:
            self._entries[key] = entry
            self.captures += 1
        return result

    def _replay(self, key, entry: _Entry, leaves):
        for s, t in zip(entry.inputs, leaves):
            s.copy_(t, non_blocking=True)
        try:
            entry.graph.replay()
        except RuntimeError as e:
            raise GraphError(f"{self.name}: replay failed for "
                             f"{self._describe(key)}: {e}") from e
        for add, n in entry.tally.items():
            add(n)
        with _lock:
            entry.replays += 1
            self.replays += 1
        outs = entry.outputs
        if self.clone:
            outs = [t.clone() for t in outs]
        return _rebuild(entry.out_desc, iter(outs))

    def graph(self, *args, **kwargs) -> torch.cuda.CUDAGraph:
        """The captured graph of this call's key on this thread (the call
        must have been made once on the card)."""
        return self._entries[self.key(*args, **kwargs)].graph

    def entries(self) -> list[_Entry]:
        with _lock:
            return list(self._entries.values())

    def clear(self):
        """Drop every captured graph of this program (frees their pools)."""
        with _lock:
            self._entries.clear()


def compiled(fn, static=(), clone: bool = False,
             name: str | None = None) -> Compiled:
    """``fn`` as a compiled program: see the module docstring."""
    return Compiled(fn, static=static, clone=clone, name=name)


def programs() -> list[Compiled]:
    with _lock:
        return list(_programs)


def stats() -> dict:
    """Per program: captures, replays, cache entries, and the MiB reserved
    by its graphs' private pools (0 without a CUDA context)."""
    pool_bytes: dict = {}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for seg in torch.cuda.memory_snapshot():
            pid = tuple(seg["segment_pool_id"])
            pool_bytes[pid] = pool_bytes.get(pid, 0) + seg["total_size"]
    out = {}
    for p in programs():
        entries = p.entries()
        out[p.name] = dict(
            captures=p.captures, replays=p.replays, entries=len(entries),
            pool_mib=sum(pool_bytes.get(tuple(e.graph.pool()), 0)
                         for e in entries) / 2 ** 20)
    return out
