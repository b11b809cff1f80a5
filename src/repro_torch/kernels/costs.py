"""The kernels' side of a cost pass (``repro_torch.launch.hlo_costs``).

A cost pass counts a step's work by the aten operations it dispatches;
a hand-written kernel is a ctypes launch that no dispatch sees, so each
kernel wrapper reports its own work here, by its kernel's formula, each
time it launches (``report``).  A dry run's inputs are fake tensors
(``torch._subclasses.fake_tensor.FakeTensor``): a wrapper given one
checks it as it would a card's tensor, allocates its outputs' shapes
and reports, but builds, loads and launches nothing, and leaves its
``launches`` counter alone (``is_fake``).  A fake tensor stands for a
card's whatever device it carries: a dry run puts the mesh's positions
on fake ``cpu:i`` devices, because autograd on a fake CUDA tensor needs
the CUDA device guard, which a CPU-only build lacks and a card's build
has only for the cards it sees.
"""
from __future__ import annotations

from torch._subclasses.fake_tensor import FakeTensor

# the cost passes now running, innermost last; each takes
# pass.kernel(name, device, flops, nbytes)
PASSES: list = []


def is_fake(x) -> bool:
    """Whether ``x`` is a dry run's fake tensor."""
    return isinstance(x, FakeTensor)


def misaligned(x) -> int:
    """``x``'s start modulo 16 bytes: of its address on the card, or for
    a fake tensor of its storage offset (the card's allocator aligns every
    storage it hands out)."""
    if isinstance(x, FakeTensor):
        return (x.storage_offset() * x.element_size()) % 16
    return x.data_ptr() % 16


def report(kernel: str, device, flops: float, nbytes: float) -> None:
    """One launch (or a fake input's call) of ``kernel`` on ``device``,
    doing ``flops`` operations and moving ``nbytes`` of device memory, to
    every running cost pass."""
    for p in PASSES:
        p.kernel(kernel, device, flops, nbytes)
