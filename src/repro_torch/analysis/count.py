"""What one step of the port does, counted while it runs on meta tensors.

The counterpart of the reference's ``repro/analysis/hlo.py``, which has no
torch counterpart: the reference reads its roofline numerators from the
compiled HLO text (dots, fusions, collectives inside while bodies weighted
by their loop trips), because XLA lowers the whole step into one module and
its ``cost_analysis`` does not multiply by trip counts.  The port has no
HLO.  It runs every layer and every collective explicitly, eagerly, one
aten op at a time, so counting the ops as they are dispatched counts the
step as it runs, and no loop weighting is needed.

``count_step(fn, args)`` runs ``fn(*args)`` once under one dispatch mode
and returns, beside ``fn``'s result:

* ``flops``: the aten ops' FLOPs as ``torch.utils.flop_counter.
  FlopCounterMode`` counts them (its formulas, ``flop_registry``, and its
  decomposition of an op it has none for; one mode counts FLOPs and bytes
  together, which halves the cost of stacking two), plus each kernel's own
  count from its meta route (``kernels/dispatch.py::WORK``);
* ``bytes``: the operand and result bytes of every aten op outside the
  kernels (a view or another op whose result aliases its operand counts 0,
  an allocation without a write 0, a copy its source and destination, a
  gather (``embedding``, ``index_select``, ...) its indices and the
  entries it selects, read and written, a scatter (``index_put_``, ...)
  its values and indices read and as much written, the collectives none:
  they are the ``shardctx`` counts), plus each kernel's HBM bytes.  No op is fused here, so this is an eager program's traffic
  (a fused one moves less);
* the memory of the step, the counterparts of XLA's ``memory_analysis``:
  ``argument`` the bytes of ``args``' tensors, ``output`` those of the
  result's tensors that are new, ``alias`` those that are arguments
  updated in place (a decode step's cache, a train step's params and
  moments), and ``temp`` the peak live bytes of the storages the step
  created, tracked by storage (a storage is freed when the last tensor,
  view or autograd's saved copy holding it goes), less the new outputs;
* ``op_histogram``: the aten ops by how often they ran.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import dispatch

aten = torch.ops.aten
# allocations that write nothing
_NO_WRITE = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
             aten.new_empty.default, aten.new_empty_strided.default}
# reads of the entries its indices select from its first operand
_GATHER = {aten.embedding.default, aten.index_select.default, aten.gather.default,
           aten.index.Tensor}
# writes of its values into the entries its indices select of its first operand
_SCATTER = {aten.index_put_.default, aten.index_put.default, aten.scatter_.src,
            aten.scatter.src, aten.index_add_.default, aten.index_add.default,
            aten.index_copy_.default, aten.scatter_add_.default, aten.scatter_add.default}


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> list:
    """The tensors of ``tree``: nested tuples, lists and dicts (an op's
    arguments and results, a step's arguments and outputs)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(_tensors(x))
    return out


def _op_info(func) -> tuple:
    """(name, FLOP formula or None, whether it may decompose, whether its
    bytes count, whether it writes its operands) of an op."""
    packet = func._overloadpacket
    formula = flop_registry.get(packet)
    aten_op = func.namespace == "aten"
    decomposes = (formula is None and aten_op and torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))
    counted = aten_op and not func.is_view and func not in _NO_WRITE
    return str(packet), formula, decomposes, counted, func._schema.is_mutable


class _Count(TorchDispatchMode):
    """FLOPs and bytes of every aten op, and the live bytes of the storages
    the ops make."""

    def __init__(self, arguments: set):
        super().__init__()
        self.arguments = arguments
        self.flops = 0
        self.bytes = 0
        self.live: dict[int, int] = {}
        self.now = 0
        self.peak = 0
        self.ops: Counter = Counter()
        self.info: dict = {}

    def _release(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self.info.get(func)
        if info is None:
            info = self.info[func] = _op_info(func)
        name, formula, decomposes, counted, mutable = info
        if decomposes:
            # as FlopCounterMode: an op without a formula counted through its
            # decomposition
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.ops[name] += 1
        if formula is not None:
            if func._overloadname == "dtype":
                # mm/bmm with a float32 output: the product's formula
                # without the output dtype, which it would take for a shape
                args = tuple(a for a in args if not isinstance(a, torch.dtype))
                kwargs = {k: v for k, v in kwargs.items() if k != "out_dtype"}
            self.flops += formula(*args, **kwargs, out_val=out)
        results = _tensors(out)
        live, arguments = self.live, self.arguments
        for t in results:
            st = t.untyped_storage()
            key = st._cdata
            if key not in live and key not in arguments:
                n = st.nbytes()
                live[key] = n
                self.now += n
                if self.now > self.peak:
                    self.peak = self.now
                weakref.finalize(st, self._release, key)
        if not counted:
            return out
        operands = _tensors(args) + (_tensors(kwargs) if kwargs else [])
        if not mutable and results and operands:
            seen = {_key(t) for t in operands}
            if any(_key(t) in seen for t in results):
                return out          # a reshape of its operand's storage, as a view
        if func is aten.copy_.default:
            operands = operands[1:]   # the destination is written, not read
        elif func in _GATHER:
            self.bytes += sum(t.nbytes for t in operands[1:]) + 2 * sum(t.nbytes for t in results)
            return out
        elif func in _SCATTER:
            # the values and indices read, as many entries written
            self.bytes += 2 * sum(t.nbytes for t in operands[1:])
            return out
        self.bytes += sum(t.nbytes for t in operands) + sum(t.nbytes for t in results)
        return out


def count_step(fn, args: tuple):
    """-> (``fn(*args)``, the counts of that call: see the module's
    docstring).  The kernels' meta routes' ``WORK`` is reset first."""
    storages = {_key(t): t.untyped_storage().nbytes() for t in _tensors(args)}
    arguments, arg_bytes = set(storages), sum(storages.values())
    dispatch.reset_work()
    traffic = _Count(arguments)
    with traffic:
        out = fn(*args)
    outs, alias, new = set(), 0, 0
    for t in _tensors(out):
        key = _key(t)
        if key in outs:
            continue
        outs.add(key)
        if key in arguments:
            alias += t.untyped_storage().nbytes()
        else:
            new += t.untyped_storage().nbytes()
    kernels = dispatch.work()
    k_flops = sum(f for _, f, _ in kernels.values())
    k_bytes = sum(b for _, _, b in kernels.values())
    aten_flops = float(traffic.flops)
    return out, {
        "flops": aten_flops + k_flops, "aten_flops": aten_flops, "kernel_flops": k_flops,
        "bytes": float(traffic.bytes) + k_bytes, "aten_bytes": float(traffic.bytes),
        "kernel_bytes": k_bytes,
        "kernels": {k: {"calls": n, "flops": f, "bytes": b}
                    for k, (n, f, b) in sorted(kernels.items())},
        "argument_bytes": arg_bytes, "output_bytes": new, "alias_bytes": alias,
        "temp_bytes": max(traffic.peak - new, 0),
        "op_histogram": [[op, n] for op, n in traffic.ops.most_common()],
    }
