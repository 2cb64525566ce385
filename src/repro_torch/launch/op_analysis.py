"""Op-level cost analysis of one traced call (counterpart of
`repro.launch.hlo_analysis`).

The JAX package walks the optimized HLO of a compiled step. The port runs
eagerly, so there is no program to walk: `analyze(fn, *args)` runs the
call under a `TorchDispatchMode` and records every aten op it dispatches,
forward and autograd's backward alike. On meta tensors nothing runs and
nothing is allocated, so a call at published widths costs only its
Python time; on CPU or CUDA tensors the same records come from a real
run.

Per op (and summed):

- ``calls``;
- ``flops``: `torch.utils.flop_counter`'s formulas (the table
  `FlopCounterMode` uses: matmuls, convolutions, attention; 0 for the
  rest, as there);
- ``result_bytes``: the bytes of the op's tensor results, the
  counterpart of the HLO walk's ``traffic_result_bytes`` (each result
  written once; a result that is a view of an input counts 0, unless the
  op writes it in place);
- the peak of live bytes: every storage is counted from the op that
  creates it until a weakref finalizer on it fires, so a tensor that
  autograd saves for the backward stays live as long as it does on the
  card. Storages that exist before the call (its arguments, and any
  other it reads: a trainer's caches) count as live throughout.

The same sums are kept per ``repro.obs/<phase>`` span (`obs.tracing`):
the mode sees each span's profiler range open and close as ops of the
``profiler`` namespace and keeps a stack of their names, so an op is
charged to the innermost span around it (``"(none)"`` outside any),
the clock's finer spans (`tracing.CLOCK_PHASES`) seen through.
Spans must be on in the traced call for the split; the totals do not
depend on it. A kernel's abstract form (`kernels.meta`) is one op of the
``repro_torch`` namespace with its outputs, as the card runs it. The
launches each hand-written kernel made on the card during the call
(`kernels.launch_counts`: B1-B4, B5's forward and backward) come with the
records, so a run on CUDA tensors shows which paths went through them; on
CPU or meta tensors the plain versions run and every count is 0.

On meta tensors an op's outputs depend only on its inputs' shapes,
strides and dtypes and its other arguments, and many of PyTorch's meta
functions are Python. So the mode keeps, for each functional op (no
output is a view of an input, nothing mutated) whose tensors are all meta, the
outputs' shapes, strides and dtypes by that signature, and makes them
anew with `empty_strided` when the signature comes again (a trainer's
per-chunk loops repeat it many times). The records are those of calling
the op: the meta-against-CPU test holds them op for op.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import launch_counts, launches_since
from repro_torch.obs.tracing import CLOCK_PHASES, PREFIX

NONE = "(none)"
_CALL = "call"          # a signature whose op is always called
_ENTER = "profiler::_record_function_enter"
_EXIT = "profiler::_record_function_exit"


def _empty_sums() -> dict:
    return {"calls": 0, "flops": 0, "result_bytes": 0}


def _tensors(args):
    """The tensors among `args` and the lists and tuples in them."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def _key(x):
    """A hashable stand-in for an argument of a meta op: a tensor by its
    metadata, a generator by nothing (meta draws nothing)."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, torch.Generator):
        return "G"
    return x


def _cacheable(func) -> bool:
    schema = func._schema
    return (not schema.is_mutable
            and all(r.alias_info is None for r in schema.returns))


class OpAnalysis(TorchDispatchMode):
    """The dispatch mode behind `analyze`. Use as a context manager around
    the call; `summary()` after it."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, dict] = {}
        self.phases: Dict[str, dict] = {}
        self.total = _empty_sums()
        self._stack: list = []
        self._live: Dict[int, int] = {}      # storage id -> bytes
        self._held = 0          # bytes of storages from before the call
        self._made = 0          # bytes of live storages made in the call
        self.peak_made = 0
        self._meta_out: Dict[Any, Any] = {}  # signature -> outputs' metadata

    # ---- storages --------------------------------------------------- #
    def _release(self, key: int, nbytes: int, made: bool) -> None:
        if self._live.pop(key, None) is not None and made:
            self._made -= nbytes

    def _see(self, t: torch.Tensor, made: bool) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._live:
            return
        nbytes = s.nbytes()
        self._live[key] = nbytes
        if made:
            self._made += nbytes
            self.peak_made = max(self.peak_made, self._made)
        else:
            self._held += nbytes
        weakref.finalize(s, self._release, key, nbytes, made)

    def hold(self, *trees) -> None:
        """Count the storages of `trees` (the call's arguments) as live
        from the start."""
        for t in tree_leaves(trees):
            if isinstance(t, torch.Tensor):
                self._see(t, made=False)

    # ---- the mode --------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.name()
        if name.startswith(_ENTER):
            self._stack.append(args[0])
            return func(*args, **kwargs)
        if name.startswith(_EXIT):
            self._stack.pop()
            return func(*args, **kwargs)
        inputs = list(_tensors((args, tuple(kwargs.values()))))
        for t in inputs:
            self._see(t, made=False)
        out = self._call(func, args, kwargs, inputs)
        results = list(_tensors((out,)))
        for t in results:
            self._see(t, made=True)
        packet = func._overloadpacket
        flops = (int(flop_registry[packet](*args, **kwargs, out_val=out))
                 if packet in flop_registry else 0)
        if func._schema.is_mutable:      # in place or out=: written
            written = results
        else:                            # a view of an input writes nothing
            ins = {t.untyped_storage()._cdata for t in inputs}
            written = [t for t in results
                       if t.untyped_storage()._cdata not in ins]
        nbytes = sum(t.numel() * t.element_size() for t in written)
        phase = NONE
        for span in reversed(self._stack):
            if span.startswith(PREFIX):
                name = span[len(PREFIX):].split("/", 1)[0]
                if name not in CLOCK_PHASES:
                    phase = name
                    break
        for rec in (self.ops.setdefault(str(func), _empty_sums()),
                    self.phases.setdefault(phase, _empty_sums()),
                    self.total):
            rec["calls"] += 1
            rec["flops"] += flops
            rec["result_bytes"] += nbytes
        return out

    def _call(self, func, args, kwargs, inputs):
        """func(*args, **kwargs), or on meta tensors its outputs remade
        from the metadata of an earlier call with the same signature."""
        if not inputs or any(t.device.type != "meta" for t in inputs) \
                or not _cacheable(func):
            return func(*args, **kwargs)
        key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        try:
            meta = self._meta_out.get(key)
        except TypeError:            # an unhashable argument
            return func(*args, **kwargs)
        if meta is None:
            out = func(*args, **kwargs)
            flat = out if isinstance(out, (list, tuple)) else (out,)
            ins = {t.untyped_storage()._cdata for t in inputs}
            # an output that is a view of an input (`_unsafe_view`
            # declares none) is made by calling the op, every time
            self._meta_out[key] = _CALL if not all(
                isinstance(t, torch.Tensor)
                and t.untyped_storage()._cdata not in ins for t in flat) \
                else (type(out), [(tuple(t.shape), t.stride(), t.dtype)
                                  for t in flat])
            return out
        if meta is _CALL:
            return func(*args, **kwargs)
        kind, specs = meta
        made = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                for sh, st, dt in specs]
        return made[0] if kind is torch.Tensor else kind(made)

    def summary(self) -> dict:
        return {
            "ops": {k: dict(v) for k, v in sorted(self.ops.items())},
            "phases": {k: dict(v) for k, v in sorted(self.phases.items())},
            "calls": self.total["calls"],
            "flops": self.total["flops"],
            "traffic_result_bytes": self.total["result_bytes"],
            "held_bytes": self._held,
            "peak_bytes": self._held + self.peak_made,
        }


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run `fn(*args, **kwargs)` under `OpAnalysis` and return its summary
    with the call's result under ``"result"``:

    - ``ops``: {aten op: {calls, flops, result_bytes}};
    - ``phases``: the same sums per ``repro.obs/<phase>`` span, ``"(none)"``
      outside every span; they add up to the totals;
    - ``calls``, ``flops``, ``traffic_result_bytes``: the totals;
    - ``held_bytes``: storages live before the call (and any other it
      read that it did not make);
    - ``peak_bytes``: ``held_bytes`` plus the peak of what the call made
      and had not freed;
    - ``launches``: {kernel: launches on the card during the call}
      (`kernels.launch_counts`' names).
    """
    mode = OpAnalysis()
    mode.hold(args, kwargs)
    before = launch_counts()
    with mode:
        result = fn(*args, **kwargs)
    out = mode.summary()
    out["launches"] = launches_since(before)
    out["result"] = result
    return out
