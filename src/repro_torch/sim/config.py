"""GPU timing-model configuration, PyTorch side.

The same machine description as ``repro.sim.config``: default parameters
model an NVIDIA RTX 3080 Ti (80 SMs × 48 warps, 4 sub-cores per SM,
128 KB L1 per SM, 6 MB L2 over 48 slices, 24 DRAM channels), the machine
runs in quanta of Δ = 16 cycles, and a config splits into a hashable
``StaticConfig`` (shapes, loop bounds) and a ``DynConfig`` of int32
tensors (timing numerics).

``DynConfig`` keeps the reference's grouping by machine layer (``core``,
``cache``, ``mem``, ``icnt``) so that ``dyn.core.lat[op]`` reads the same
on both sides; its leaves are 0-d or ``(N_CLASSES,)`` int32 tensors on one
device.  Counter-timeline telemetry is not ported yet: a ``StaticConfig``
with ``telemetry_samples > 0`` is refused.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

# instruction classes (BAR = CTA-level barrier, __syncthreads)
FP32, INT32, SFU, TENSOR, LDG, STG, BAR = range(7)
N_CLASSES = 7
CLASS_NAMES = ("fp32", "int32", "sfu", "tensor", "ldg", "stg", "bar")
# execution units (per sub-core dispatch ports)
U_FP32, U_INT, U_SFU, U_TENSOR, U_LSU = range(5)
N_UNITS = 5

# class → execution unit: structural (which port an op occupies)
UNIT_OF_CLASS = (U_FP32, U_INT, U_SFU, U_TENSOR, U_LSU, U_LSU, U_INT)
# default result latency per class (the LDG entry is inert: load latency
# comes from cache.l1_hit_lat or the memory system)
LATENCY_OF_CLASS = (4, 4, 16, 8, 0, 0, 1)
# default dispatch interval (cycles the port stays busy per issue)
DISPATCH_OF_CLASS = (1, 1, 4, 2, 1, 1, 1)

# warp scheduler selector (a dynamic config value)
SCHED_GTO, SCHED_LRR = 0, 1
SCHEDULERS = {"gto": SCHED_GTO, "lrr": SCHED_LRR}

DYNAMIC_FIELDS = ("l1_hit_lat", "l2_lat", "part_lat", "dram_burst",
                  "dram_row_penalty", "icnt_lat")
TABLE_FIELDS = ("lat", "disp")
DYN_KEYS = DYNAMIC_FIELDS + ("sched",) + TABLE_FIELDS


# ---------------------------------------------------------------------------
# DynConfig — the dynamic half of a GPU config, as int32 tensors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CoreDyn:
    """``lat[c]``: result latency of class ``c``; ``disp[c]``: dispatch
    interval; ``sched``: SCHED_GTO / SCHED_LRR."""
    lat: torch.Tensor
    disp: torch.Tensor
    sched: torch.Tensor


@dataclass(frozen=True)
class CacheDyn:
    l1_hit_lat: torch.Tensor
    l2_lat: torch.Tensor


@dataclass(frozen=True)
class MemDyn:
    part_lat: torch.Tensor
    dram_burst: torch.Tensor
    dram_row_penalty: torch.Tensor


@dataclass(frozen=True)
class IcntDyn:
    icnt_lat: torch.Tensor


# flat key → (group attr, leaf attr)
_FLAT_TO_GROUP = {
    "lat": ("core", "lat"), "disp": ("core", "disp"),
    "sched": ("core", "sched"),
    "l1_hit_lat": ("cache", "l1_hit_lat"), "l2_lat": ("cache", "l2_lat"),
    "part_lat": ("mem", "part_lat"), "dram_burst": ("mem", "dram_burst"),
    "dram_row_penalty": ("mem", "dram_row_penalty"),
    "icnt_lat": ("icnt", "icnt_lat"),
}


@dataclass(frozen=True)
class DynConfig:
    """Every timing parameter as an int32 tensor on one device, grouped by
    machine layer like the reference's pytree."""
    core: CoreDyn
    cache: CacheDyn
    mem: MemDyn
    icnt: IcntDyn

    @classmethod
    def from_flat(cls, src: dict, device) -> "DynConfig":
        """Build from a flat {key: value} dict (DYN_KEYS complete)."""
        groups = {"core": {}, "cache": {}, "mem": {}, "icnt": {}}
        for k, v in src.items():
            g, leaf = _FLAT_TO_GROUP[k]
            groups[g][leaf] = (
                v.to(device=device, dtype=torch.int32)
                if isinstance(v, torch.Tensor)
                else torch.tensor(v, dtype=torch.int32, device=device))
        return cls(core=CoreDyn(**groups["core"]),
                   cache=CacheDyn(**groups["cache"]),
                   mem=MemDyn(**groups["mem"]),
                   icnt=IcntDyn(**groups["icnt"]))

    def flat(self) -> dict:
        """The inverse of ``from_flat``: flat {key: tensor} view."""
        return {k: getattr(getattr(self, g), leaf)
                for k, (g, leaf) in _FLAT_TO_GROUP.items()}


def check_dyn(static: "StaticConfig", dyn: DynConfig, lane: str = "") -> None:
    """Validate one dynamic config against its StaticConfig: table shapes
    are (N_CLASSES,) and the machine invariant quantum Δ ≤ icnt_lat holds
    (SM shards run one full quantum between memory exchanges)."""
    where = f"{lane}: " if lane else ""
    for name in TABLE_FIELDS:
        tbl = getattr(dyn.core, name)
        if tuple(tbl.shape) != (N_CLASSES,):
            raise ValueError(
                f"{where}dyn table '{name}' must have shape ({N_CLASSES},) "
                f"(one entry per instruction class {CLASS_NAMES}), got "
                f"{tuple(tbl.shape)}")
    icnt = int(dyn.icnt.icnt_lat)
    if static.quantum > icnt:
        raise ValueError(
            f"{where}quantum Δ={static.quantum} must be ≤ icnt_lat={icnt} "
            "(SM shards run one full quantum between memory exchanges; "
            "this lane would break the exactness window)")


@dataclass(frozen=True)
class StaticConfig:
    """Shape-determining (hashable) half of a GPU config."""
    n_sm: int
    warps_per_sm: int
    n_subcores: int
    max_cta_per_sm: int
    l1_sets: int
    l1_ways: int
    l2_slices: int
    l2_sets: int
    l2_ways: int
    dram_channels: int
    dram_row_div: int
    quantum: int
    mshr_per_sm: int
    addrset_cap: int
    mem_blocks: int
    telemetry_samples: int = 0
    telemetry_every: int = 1

    def __post_init__(self):
        if self.telemetry_samples > 0:
            raise ValueError(
                f"telemetry_samples={self.telemetry_samples}: counter-"
                "timeline telemetry is not ported to repro_torch yet; "
                "use telemetry_samples=0")


def static_part(cfg) -> StaticConfig:
    """The hashable static half of a full GPUConfig (identity on an
    already-static config)."""
    if isinstance(cfg, StaticConfig):
        return cfg
    return StaticConfig(
        **{f.name: getattr(cfg, f.name) for f in fields(StaticConfig)})


def _check_override_keys(src: dict, need_all: bool) -> None:
    """ValueError naming unknown (always) and missing (when the dict must
    be self-contained) override keys."""
    unknown = sorted(set(src) - set(DYN_KEYS))
    if unknown:
        raise ValueError(
            f"unknown dynamic override key(s) {unknown}; valid keys are "
            f"{sorted(DYN_KEYS)}")
    if need_all:
        missing = sorted(set(DYN_KEYS) - set(src))
        if missing:
            raise ValueError(
                f"missing dynamic override key(s) {missing}: a StaticConfig "
                "carries no timing values, so the override dict must supply "
                f"every dynamic key {sorted(DYN_KEYS)} — including the "
                f"per-class tables {TABLE_FIELDS} (LATENCY_OF_CLASS / "
                "DISPATCH_OF_CLASS are the defaults to start from, or pass "
                "a typed DynConfig)")


def _table_shape(v) -> tuple:
    return tuple(torch.as_tensor(v).shape)


def split_config(cfg: "GPUConfig | StaticConfig", dyn_overrides=None, *,
                 device):
    """(GPUConfig) -> (StaticConfig, DynConfig on ``device``).

    ``dyn_overrides`` may be a ``DynConfig`` (used as-is) or a flat dict
    keyed by ``DYN_KEYS``.  Unknown or missing keys and wrong table
    lengths raise ``ValueError`` by name."""
    if isinstance(cfg, StaticConfig):
        if dyn_overrides is None:
            raise ValueError("StaticConfig alone has no dynamic values")
        static = cfg
        if isinstance(dyn_overrides, DynConfig):
            check_dyn(static, dyn_overrides)
            return static, dyn_overrides
        src = dict(dyn_overrides)
        _check_override_keys(src, need_all=True)
    else:
        static = static_part(cfg)
        if isinstance(dyn_overrides, DynConfig):
            check_dyn(static, dyn_overrides)
            return static, dyn_overrides
        src = {k: getattr(cfg, k) for k in DYNAMIC_FIELDS}
        src["sched"] = SCHEDULERS[cfg.scheduler]
        src["lat"] = cfg.lat_of_class
        src["disp"] = cfg.disp_of_class
        if dyn_overrides:
            overrides = dict(dyn_overrides)
            _check_override_keys(overrides, need_all=False)
            src.update(overrides)
    for name in TABLE_FIELDS:
        shape = _table_shape(src[name])
        if shape != (N_CLASSES,):
            raise ValueError(
                f"dynamic table '{name}' must have {N_CLASSES} entries "
                f"(one per instruction class {CLASS_NAMES}), got shape "
                f"{shape}")
    dyn = DynConfig.from_flat(src, device)
    check_dyn(static, dyn)
    return static, dyn


@dataclass(frozen=True)
class GPUConfig:
    # table 1
    n_sm: int = 80
    warps_per_sm: int = 48
    n_subcores: int = 4
    max_cta_per_sm: int = 16
    # L1: 128 KB / 128 B lines = 1024 lines
    l1_sets: int = 128
    l1_ways: int = 8
    l1_hit_lat: int = 32
    # L2: 6 MB / 48 slices / 128 B = 1024 lines per slice
    l2_slices: int = 48
    l2_sets: int = 128
    l2_ways: int = 8
    l2_lat: int = 32
    # memory partitions / DRAM
    dram_channels: int = 24
    part_lat: int = 8
    dram_burst: int = 4
    dram_row_penalty: int = 24
    dram_row_div: int = 64       # blocks per DRAM row
    # interconnect
    icnt_lat: int = 16
    # machine quantum (Δ): must be ≤ icnt_lat
    quantum: int = 16
    # misc
    mshr_per_sm: int = 32
    addrset_cap: int = 2048      # per-SM unique-address stat set
    scheduler: str = "gto"       # gto | lrr
    mem_blocks: int = 1 << 22    # simulated VRAM in 128 B blocks
    # counter-timeline telemetry: only 0 (off) is ported so far
    telemetry_samples: int = 0
    telemetry_every: int = 1
    # per-class timing tables (dynamic)
    lat_of_class: tuple = LATENCY_OF_CLASS
    disp_of_class: tuple = DISPATCH_OF_CLASS

    def __post_init__(self):
        if self.quantum > self.icnt_lat:
            raise ValueError(
                f"quantum Δ={self.quantum} must be ≤ icnt_lat="
                f"{self.icnt_lat} (SM shards run one full quantum between "
                "memory exchanges)")
        if self.warps_per_sm % self.n_subcores:
            raise ValueError(
                f"warps_per_sm={self.warps_per_sm} must be divisible by "
                f"n_subcores={self.n_subcores}")
        if self.telemetry_every < 1:
            raise ValueError(
                f"telemetry_every={self.telemetry_every} must be ≥ 1 "
                "(sampling cadence in quanta)")
        for name in ("lat_of_class", "disp_of_class"):
            tbl = getattr(self, name)
            if not isinstance(tbl, tuple):       # keep the config hashable
                object.__setattr__(self, name, tuple(int(v) for v in tbl))
                tbl = getattr(self, name)
            if len(tbl) != N_CLASSES:
                raise ValueError(
                    f"{name} must have {N_CLASSES} entries (one per "
                    f"instruction class {CLASS_NAMES}), got {len(tbl)}")


RTX3080TI = GPUConfig()

# a small config for fast tests
TINY = GPUConfig(n_sm=8, warps_per_sm=8, n_subcores=2, l1_sets=16, l1_ways=4,
                 l2_slices=4, l2_sets=16, l2_ways=4, dram_channels=2,
                 mshr_per_sm=8, addrset_cap=256)
