"""Work accounting of a step: the counting mode and its registry.

A :class:`Count` records, while it is active (``with Count() as c:``),
everything the port's code does that costs the card time:

* every aten op, through a ``TorchDispatchMode``: the FLOPs of matrix
  products and the bytes the op moves;
* every hand-written kernel call, which the wrappers of
  :mod:`repro_torch.kernels.ops` report with their kernel's ``*_work``
  (:func:`kernel`), the plain version's aten ops inside not counted, so
  that one call counts the same whether the kernel, its plain version
  or (on the ``meta`` device) neither runs it;
* every collective the port writes out (``launch.mesh``'s
  ``all_reduce`` / ``all_gather`` / ``spec_gather`` / ``group_sum``, the
  fsdp gathers of ``sharding.train_shard_params``, the route gather and
  scatter of ``transformer.route_data_shards``,
  ``ModelShards.replicate``): its op kind and per-device output bytes
  (:func:`collective`).

The rules, the same on every device:

* **FLOPs** are those of matrix products only (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``mv``, ``dot``: 2 per multiply-add, the bias
  add not counted), as ``torch.utils.flop_counter`` counts them, plus
  each kernel's own count; elementwise ops count none.  Each product is
  filed under the rate kind of its inputs (``"f32"``: CUDA cores, TF32
  off as the port runs; ``"bf16"``: tensor cores), each kernel call
  under its ``*_work``'s (``"tf32x3"``: the 3xTF32 ``mma.sync`` kernels
  on f32 inputs; ``"tf32"``: the same kernels on bf16 inputs, one TF32
  product each; ``"f32"``: the CUDA-core kernels).
* **Bytes** of an aten op are its tensor inputs' and outputs' bytes
  (the analogue of XLA's "bytes accessed").  Ops that move no data count
  0: views (an output aliasing an input without writing it), reshapes,
  ``expand``, ``as_strided``, allocations (``empty*``), and copies
  between devices, which the collective they stand for counts.
* **Live bytes**: each tensor an op allocates (an output that is not a
  view and not written in place) is added when it is made and taken off
  when its tensor object is freed; :attr:`Count.peak_live_bytes` is the
  high-water mark over the count.  A view that outlives its base keeps
  no storage alive in this estimate, so it can read low.
"""
from __future__ import annotations

import weakref
from collections import Counter, defaultdict
from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# the registry: the counts now active, innermost last
_ACTIVE: List["Count"] = []

# ops that move no data whatever their schema says
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.detach.default, aten.alias.default,
         aten.view.default, aten._reshape_alias.default,
         aten.expand.default, aten.as_strided.default,
         aten.set_.source_Storage_storage_offset}
_COPIES = {aten._to_copy.default, aten.copy_.default}


def _mm(a, b):
    return 2 * a[0] * a[1] * b[1]


def _bmm(a, b):
    return 2 * a[0] * a[1] * a[2] * b[2]


# op -> (FLOPs from the input shapes, the indices of the product's operands)
_PRODUCTS = {
    aten.mm.default: (_mm, (0, 1)),
    aten.addmm.default: (_mm, (1, 2)),
    aten.bmm.default: (_bmm, (0, 1)),
    aten.baddbmm.default: (_bmm, (1, 2)),
    aten.mv.default: (lambda a, b: 2 * a[0] * a[1], (0, 1)),
    aten.dot.default: (lambda a, b: 2 * a[0], (0, 1)),
}


def active() -> Optional["Count"]:
    """The innermost active count, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _rate_kind(dtype) -> str:
    """The rate kind of an aten product on ``dtype`` inputs."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _writes_input(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns)


class Count(TorchDispatchMode):
    """The counting mode (module docstring).  Fields: ``flops`` (by rate
    kind), ``bytes``, ``ops`` (aten op name -> calls), ``kernels``
    (kernel name -> ``{"calls", "bytes", "flops"}``), ``collectives``
    (:func:`collective`'s events in order), ``live_bytes`` /
    ``peak_live_bytes``.  Kernel calls add their bytes and FLOPs to the
    totals too."""

    def __init__(self):
        super().__init__()
        self.flops = defaultdict(float)
        self.bytes = 0.0
        self.ops = Counter()
        self.kernels = {}
        self.collectives: List[Tuple[str, int, int]] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._quiet = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def _alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        self.ops[func.name()] += 1
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors((out,)))
        if func in _FREE or _is_view(func):
            return out
        if func in _COPIES and len({t.device for t in ins + outs}) > 1:
            return out
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if func in _PRODUCTS:
            flops, (i, j) = _PRODUCTS[func]
            a, b = args[i], args[j]
            self.flops[_rate_kind(a.dtype)] += flops(a.shape, b.shape)
        if not _writes_input(func):
            for t in outs:
                self._alloc(t)
        return out


class kernel:
    """``with kernel(name, work, *args, **kwargs):`` around a wrapper's
    body: where a count is active, the call counted as ``name`` with
    ``work(*args, **kwargs) = (bytes, flops, rate kind)`` (the kernel's
    ``*_work``, computed only then), and the aten ops inside not
    counted."""

    def __init__(self, name: str, work, *args, **kwargs):
        self.count = active()
        if self.count is not None:
            self.name, self.work = name, work(*args, **kwargs)

    def __enter__(self):
        c = self.count
        if c is None:
            return self
        nbytes, flops, kind = self.work
        k = c.kernels.setdefault(self.name, {"calls": 0, "bytes": 0.0,
                                             "flops": 0.0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops
        c.bytes += nbytes
        c.flops[kind] += flops
        c._quiet += 1
        return self

    def __exit__(self, *exc):
        if self.count is not None:
            self.count._quiet -= 1
        return False


def collective(op: str, outputs) -> None:
    """Report one collective to the active count (if any): its op kind
    (``"all-reduce"``, ``"all-gather"``, ``"all-to-all"``,
    ``"collective-permute"``) and ``outputs``, what it leaves on each
    device it delivers to (a tensor, or a tuple of tensors, a device).
    The event is ``(op, their bytes, their number)``: summed over a
    mesh's events and divided by its device count, the per-device output
    bytes and op count of ``launch.hlo``."""
    c = active()
    if c is not None:
        outputs = list(outputs)
        c.collectives.append((op, sum(map(_nbytes, _tensors(outputs))),
                              len(outputs)))
