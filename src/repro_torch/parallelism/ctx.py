"""Sharding context, the JAX package's ``parallelism/ctx.py``.

``ShardCtx`` carries a mesh's axis names: the batch (data) axes and the
tensor-parallel axis.  The reference threads it through its layers so
they can drop ``with_sharding_constraint`` hints; the port places
tensors explicitly instead (``parallelism/sharding.py``), so there is no
``hint``.  The mesh is the port's single-controller ``Mesh``
(``core/distribute.py``), or any object with ``shape`` (axis name ->
size) and ``axis_names``, such as the tests' fake meshes.  With no mesh
every size is 1 and every axis helper returns None.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from operator import mul
from typing import Optional


@dataclass(frozen=True)
class ShardCtx:
    mesh: Optional[object]
    batch_axes: tuple = ()          # ('pod', 'data') / ('data',) / ()
    tp_axis: Optional[str] = None   # 'model'

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return reduce(mul, (self.mesh.shape[a] for a in self.batch_axes), 1)

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.shape[self.tp_axis]

    # ---- axis helpers ------------------------------------------------------
    def tp_if(self, n: int):
        """'model' if the tp axis evenly divides n, else replicated."""
        if self.tp_axis is not None and n % self.tp_size == 0 and \
                self.tp_size > 1:
            return self.tp_axis
        return None

    def dp_if(self, n: int):
        """The batch axes' spec entry if their size divides n, else None
        (replicated)."""
        if self.batch_axes and n % self.dp_size == 0:
            return self.batch
        return None

    def ep_axes(self, n_experts: int, d_ff: int):
        """Expert-parallel placement: (expert_axis, ff_axis), in the
        reference's order of preference: experts over the data axes and
        the expert FFN's width over tp (2-D); experts over data and tp
        combined; experts over tp; replicated."""
        dp, tp = self.dp_size, self.tp_size
        if self.mesh is None:
            return None, None
        all_axes = tuple(self.batch_axes) + ((self.tp_axis,) if self.tp_axis
                                             else ())
        if dp > 1 and n_experts % dp == 0 and self.tp_axis and d_ff % tp == 0:
            return self.batch, self.tp_axis
        if dp * tp > 1 and n_experts % (dp * tp) == 0:
            return all_axes, None
        if self.tp_axis and n_experts % tp == 0:
            return self.tp_axis, None
        return None, None

    @property
    def batch(self):
        """Spec entry for a batch-sharded leading dim."""
        if not self.batch_axes:
            return None
        return self.batch_axes if len(self.batch_axes) > 1 else \
            self.batch_axes[0]


NULL_CTX = ShardCtx(mesh=None)
