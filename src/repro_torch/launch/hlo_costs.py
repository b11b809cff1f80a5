"""The cost pass: a step's work counted by the operations it dispatches;
the port's ``repro.launch.hlo_costs``.

The reference re-reads the compiled HLO of a step, loop trip counts
multiplied in.  The port compiles nothing: it runs the step itself (on
fake tensors in a dry run, ``launch/dryrun.py``, or on the card) under
``CostPass``, a ``TorchDispatchMode`` that sees every aten operation as
it runs, a loop's body once per trip.  Per device it counts

  flops      — products: 2 · |result| · |contraction| (``mm``, ``addmm``,
               ``bmm``, ``baddbmm``, ``mv``, ``dot``; ``linear`` and
               ``einsum`` reach these), the reference's count of a dot;
               a hand-written kernel reports its own (``kernels/costs.py``)
  bytes      — the reference's fusion-ideal HBM model:
               products — operands + result
               gathers (``index``, ``index_select``, ``gather``,
               ``embedding``) — result
               copies (``clone``, a same-dtype ``_to_copy``, ``copy_``),
               and so transposes that materialise, and sorts — 2 × result
               updates (``index_put``, ``scatter``, ``index_copy``,
               ``index_add``, ``embedding_dense_backward``) — 2 × update
               a kernel — its formula's bytes
               views, elementwise ops and reductions — fused away, free
  collectives — a copy between two distinct devices: its bytes go to the
               sender, by tag (the port's helper that made it, ``_tag``;
               else ``stack_tag``, the tag ``launch/perf_probe.py`` uses),
               and by link: within a host of 8 cards (NVLink) or between
               hosts (host = device index // 8)
  memory     — each storage made during the pass, from its creation until
               it is freed (a ``weakref.finalize`` on it), beside the
               arguments' storages: argument, output, temporary and peak
               bytes (``Memory``)

A kernel's work is reported by its wrapper at each launch, or at each
call on a dry run's fake tensors (``repro_torch.kernels.costs``), and
``kernels`` sums it by kernel.
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import costs as kernel_costs

aten = torch.ops.aten
HOST_CARDS = 8          # cards per host: NVLink within, the network between

_PRODUCTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
             aten.baddbmm.default, aten.mv.default, aten.dot.default}
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
_COPIES = {aten.clone.default, aten.copy_.default, aten.sort.default,
           aten.sort.stable, aten.topk.default}
# update ops: the argument position of the update
_UPDATES = {aten.index_put.default: 2, aten.index_put_.default: 2,
            aten._index_put_impl_.default: 2, aten.scatter.src: 3,
            aten.scatter_.src: 3, aten.scatter_add.default: 3,
            aten.scatter_add_.default: 3, aten.index_copy.default: 3,
            aten.index_copy_.default: 3, aten.index_add.default: 3,
            aten.index_add_.default: 3,
            aten.embedding_dense_backward.default: 0}

# the helpers whose copies between devices are the step's collectives,
# outermost on the stack first: {(file's tail, function): tag}
_HELPERS = {
    ("train/train_step.py", "_zero1_update"): "zero1",
    ("train/train_step.py", "_grads_of"): "grad_blocks",
    ("models/factory.py", "combine_parts"): "combine_parts",
    ("parallelism/sharding.py", "shard_tree"): "shard_tree",
    ("models/layers/moe.py", "experts_group"): "moe",
    ("models/layers/attention.py", "merge_slabs"): "merge_slabs",
    ("parallelism/tensor.py", "row_sum"): "row_sum",
    ("parallelism/tensor.py", "join"): "join",
    ("parallelism/tensor.py", "ordered_sum"): "ordered_sum",
    ("parallelism/tensor.py", "fan_out"): "fan_out",
    ("parallelism/tensor.py", "forward"): "fan_out",     # _FanOut
    ("parallelism/tensor.py", "backward"): "fan_out",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _key(t):
    return t.untyped_storage()._cdata


def host_of(device) -> int:
    return (device.index or 0) // HOST_CARDS


def stack_frames() -> list:
    """The running Python stack, innermost first, as (file, function)."""
    frames, f = [], sys._getframe(1)
    while f is not None:
        frames.append((f.f_code.co_filename, f.f_code.co_name))
        f = f.f_back
    return frames


def _port_frames(frames):
    """(path below ``repro_torch/``, function) of the port's frames among
    ``frames``, in their order."""
    for path, fn in frames:
        path = path.replace("\\", "/")
        if "repro_torch/" in path:
            yield path.split("repro_torch/", 1)[1], fn


def stack_tag(frames, coarse: tuple = ()) -> tuple:
    """(tag, in_model) of a stack (``frames``: (file, function), innermost
    first).  The tag is the first ``coarse`` key that the name of one of
    the port's functions contains; else the innermost ``models/`` or
    ``parallelism/`` function, else the innermost function of the port
    outside ``launch/`` and ``kernels/``, as "models/layers/ffn.apply_ffn";
    else None.  ``in_model``: whether a ``models/`` or ``parallelism/``
    function is on the stack."""
    names, inner, model = [], None, None
    for tail, fn in _port_frames(frames):
        if tail.startswith(("launch/", "kernels/")):
            continue
        names.append(fn)
        label = f"{tail[:-3]}.{fn}"[:70]
        inner = inner or label
        if model is None and tail.startswith(("models/", "parallelism/")):
            model = label
    for key in coarse:
        if any(key in n for n in names):
            return key, model is not None
    return model or inner, model is not None


def _tag() -> str:
    """The helper that made a copy between devices: the outermost of
    ``_HELPERS`` on the stack (an MoE layer's: its dispatch, the
    ``fan_out`` of its tokens, or its combine); else the stack's
    ``stack_tag``; else, in the autograd engine, the backward node that
    runs."""
    frames = stack_frames()
    found = [_HELPERS[k] for k in _port_frames(frames) if k in _HELPERS]
    if found:
        if found[-1] == "moe":
            return "moe_dispatch" if "fan_out" in found else "moe_combine"
        return found[-1]
    tag = stack_tag(frames)[0]
    if tag is not None:
        return tag
    node = torch._C._current_autograd_node()
    return f"backward:{node.name()}" if node is not None else "other"


@dataclass
class Costs:
    """One device's counts."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = field(default_factory=dict)     # by tag
    coll_count: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)
    link_bytes: dict = field(default_factory=lambda: {"intra": 0.0,
                                                      "inter": 0.0})

    def add_bytes(self, op: str, b: float):
        self.bytes += b
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b

    def add_coll(self, tag: str, b: float, link: str):
        self.coll_bytes[tag] = self.coll_bytes.get(tag, 0.0) + b
        self.coll_count[tag] = self.coll_count.get(tag, 0) + 1
        self.link_bytes[link] += b

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))


@dataclass
class Memory:
    """One device's bytes: ``arg`` the arguments' storages, ``live`` the
    storages made during the pass and not yet freed, ``peak`` the most of
    arg + live, ``out`` those of the outputs made during the pass."""
    arg: int = 0
    live: int = 0
    peak: int = 0
    out: int = 0

    @property
    def temp(self) -> int:
        """The most bytes held beside the arguments and the outputs."""
        return self.peak - self.arg - self.out


def _walk(x, seen: set):
    """Every tensor reachable from ``x``: through dicts, lists, tuples,
    modules (parameters and buffers) and the attributes of the port's own
    objects (a placed leaf's ``Shards``, a ``PlacedModel``)."""
    if id(x) in seen:
        return
    seen.add(id(x))
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _walk(v, seen)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _walk(v, seen)
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
        yield from x.buffers()
    elif type(x).__module__.startswith("repro_torch.") and hasattr(
            x, "__dict__"):
        yield from _walk(vars(x), seen)


class CostPass(TorchDispatchMode):
    """Counts what runs under it, per device (``costs``: ``Costs``;
    ``memory``: ``Memory``), and the kernels' reports (``kernels``:
    {name: {"calls", "flops", "bytes"}}).  ``args`` are the pass's
    arguments: their storages are its argument bytes.  ``tagger``, where
    given, is called at each counted operation and its tag keys
    ``by_tag`` (``launch/perf_probe.py``)."""

    def __init__(self, args=(), tagger=None):
        super().__init__()
        self.costs: dict = {}
        self.memory: dict = {}
        self.kernels: dict = {}
        self.tagger = tagger
        self.by_tag = {"flops": {}, "bytes": {}, "colls": {}}
        self._held: dict = {}          # storage key -> (device, bytes)
        self._args: set = set()
        for t in _walk(args, set()):
            if t.layout != torch.strided:
                continue
            k = _key(t)
            if k not in self._args:
                self._args.add(k)
                self._mem(t.device).arg += t.untyped_storage().nbytes()
        for m in self.memory.values():
            m.peak = m.arg

    # ---- bookkeeping --------------------------------------------------
    def _dev(self, device) -> Costs:
        c = self.costs.get(device)
        if c is None:
            c = self.costs[device] = Costs()
        return c

    def _mem(self, device) -> Memory:
        m = self.memory.get(device)
        if m is None:
            m = self.memory[device] = Memory()
        return m

    def _add(self, device, op: str, nbytes: float, flops: float = 0.0):
        """``nbytes`` of HBM traffic by ``op`` (and ``flops``) on
        ``device``, and under the tagger's tag."""
        c = self._dev(device)
        c.flops += flops
        c.add_bytes(op, nbytes)
        if self.tagger is not None:
            tag = self.tagger()
            by = self.by_tag
            if flops:
                by["flops"][tag] = by["flops"].get(tag, 0.0) + flops
            by["bytes"][op, tag] = by["bytes"].get((op, tag), 0.0) + nbytes

    def _free(self, key):
        dev, n = self._held.pop(key, (None, 0))
        if dev is not None:
            self.memory[dev].live -= n

    def _track(self, func, out, args):
        for t in _tensors(out):
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            k = st._cdata
            if k in self._held or k in self._args:
                continue
            if (func.is_view or func._schema.is_mutable) and any(
                    _key(a) == k for a in _tensors(args)):
                continue                # a view of a storage made outside
            n = st.nbytes()
            self._held[k] = (t.device, n)
            m = self._mem(t.device)
            m.live += n
            m.peak = max(m.peak, m.arg + m.live)
            weakref.finalize(st, self._free, k)

    def kernel(self, name: str, device, flops: float, nbytes: float):
        """A kernel wrapper's report (``kernels/costs.py``)."""
        self._add(device, name, nbytes, flops)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def finish(self, out) -> None:
        """Count ``out``'s storages made during the pass as output bytes."""
        keys = {_key(t) for t in _walk(out, set())
                if t.layout == torch.strided}
        for k in keys & self._held.keys():
            dev, n = self._held[k]
            self._mem(dev).out += n

    # ---- counting -----------------------------------------------------
    def _count(self, func, args, out):
        if func in _PRODUCTS:                  # (bias,) a, b
            a, b = args[-2:]
            self._add(out.device, "product",
                      _nbytes(a) + _nbytes(b) + _nbytes(out),
                      2.0 * out.numel() * a.shape[-1])
        elif func in _GATHERS:
            self._add(out.device, "gather", _nbytes(out))
        elif func is aten._to_copy.default:
            src = args[0]
            if out.device != src.device:
                self._collective(src.device, out.device, _nbytes(out))
            elif out.dtype == src.dtype:       # else a cast: elementwise
                self._add(out.device, "copy", 2 * _nbytes(out))
        elif func is aten.copy_.default and args[0].device != args[1].device:
            self._collective(args[1].device, args[0].device,
                             _nbytes(args[0]))
        elif func in _COPIES:
            outs = list(_tensors(out))
            self._add(outs[0].device, "copy",
                      2 * sum(_nbytes(t) for t in outs))
        elif func in _UPDATES:
            i = _UPDATES[func]
            dev = next(_tensors(out)).device
            upd = args[i] if len(args) > i and isinstance(
                args[i], torch.Tensor) else next(_tensors(out))
            self._add(dev, "update", 2 * _nbytes(upd))

    def _collective(self, src, dst, n: int):
        tag = _tag()
        link = "intra" if host_of(src) == host_of(dst) else "inter"
        self._dev(src).add_coll(tag, n, link)
        self._add(src, "collective", n)
        if self.tagger is not None:
            d = self.by_tag["colls"]
            d[link, tag] = d.get((link, tag), 0.0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, out)
        self._track(func, out, args)
        return out

    def __enter__(self):
        kernel_costs.PASSES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_costs.PASSES.remove(self)
        return super().__exit__(*exc)


def analyze(fn, *args, tagger=None, **kwargs):
    """(fn(*args, **kwargs), its ``CostPass``): ``fn`` run under a fresh
    pass whose argument bytes are those of ``args`` and ``kwargs``."""
    cp = CostPass((args, kwargs), tagger=tagger)
    with cp:
        out = fn(*args, **kwargs)
    cp.finish(out)
    return out, cp
