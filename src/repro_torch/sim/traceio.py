"""Accel-sim SASS trace ingestion: real-app traces → ``KernelTrace`` IR.

The port's copy of ``repro.sim.traceio`` (pure Python and numpy, the same
behaviour and messages), lowering onto the port's ``KernelTrace``.

The simulator's first *real-workload* path.  Accel-sim's tracer (NVBit)
emits one text file per kernel launch; this module parses a documented
**subset** of that format and lowers each kernel onto the existing
procedural IR (sim/trace.py), so trace-derived workloads flow unchanged
through the batched frontend — core/batch.py padding, grid_sweep and
``--sample-lat`` table sweeps.

SUBSET GRAMMAR (line oriented; blank lines ignored)::

    trace      := kernel+
    kernel     := header+ tb*
    header     := "-" key "=" value
                  # required: "kernel name", "grid dim = (x,y,z)",
                  #           "block dim = (x,y,z)"
                  # recognized: "kernel id", "shmem"
                  # any other "-key = value" line is tolerated and
                  # recorded (dropped), e.g. nregs / binary version /
                  # shmem base_addr / nvbit version
    tb         := "#BEGIN_TB" tbhead warpblk+ "#END_TB"
    tbhead     := "thread block = x,y,z"
    warpblk    := "warp = N" ["insts = N"] insn+
    insn       := PC MASK NDEST REG*NDEST OPCODE NSRC REG*NSRC
                  MEMWIDTH [addrinfo]
    addrinfo   := MODE BASEADDR rest*      # required iff MEMWIDTH > 0
                  # MODE 0: full per-thread address list (BASEADDR is
                  #         the first); MODE 1: base + stride;
                  #         MODE 2: base + per-thread deltas.
                  # Only the warp's BASE address is consumed — the IR
                  # addresses at warp granularity.  Other modes raise
                  # TraceFormatError.

WHAT IS KEPT / DROPPED

* The IR replays ONE instruction list on every warp of the grid, so the
  canonical stream is **thread block 0, lowest warp id**.  Warps whose
  (post-drop) opcode sequence differs are counted in
  ``KernelFit.divergent_warps`` and excluded from address fitting.
* ``EXIT`` / ``RET`` are dropped (the IR has no control flow; a stream
  simply ends).  Branches (BRA/…) issue like INT32 ALU ops.
* Opcodes classify into the ``N_CLASSES`` instruction classes by their
  first dotted token (``classify_opcode``): FP32/INT32/SFU/TENSOR/
  LDG/STG/BAR.  Shared-memory ops (LDS/STS/LDSM) have no class of their
  own — they lower to INT32 (issue-slot cost only, no DRAM traffic) and
  are counted in ``KernelFit.shmem_ops``.  Unknown opcodes lower to
  INT32 and are counted in ``KernelFit.unknown_ops``.
* ``dep[i]`` is True iff instruction *i* reads a general register that
  instruction *i-1* wrote (R255/RZ excluded) — the IR models only
  prev-instruction dependencies.  ``dep[0]`` is always False.
* CTA/warp shape: ``n_ctas = gx*gy*gz``; ``warps_per_cta =
  ceil(bx*by*bz / 32)``.  ``max_warps_per_cta=`` splits oversized CTAs
  into ``ceil(wpc/max)`` CTAs of at most ``max`` warps (approximation:
  the barrier scope shrinks with the CTA).

ADDRESS-FIT SEMANTICS

Real address streams are fitted, per memory instruction, to the IR's
procedural generators (sim/trace.py:gen_address), working on 128-byte
block addresses modulo ``mem_blocks`` (default 1<<22, matching the
built-in configs).  Observations are the per-warp base addresses of the
conforming warps, keyed by ``gwarp = tb_linear*warps_per_cta + warp``
and the instruction's position in the *lowered* stream (not its SASS
PC).  Three candidates are scored by mean circular distance (blocks):

    A_STREAM :  (p*4096 + gwarp*8   + pc%8 ) % mem_blocks
    A_STRIDED:  (p*4096 + gwarp*257 + pc*31) % mem_blocks
    A_RANDOM :  hash(gwarp, pc, p)           (brute-forced p < 4096)

The lowest-error candidate wins (ties: STREAM, then STRIDED — with a
single observed gwarp the linear fits are inherently ambiguous; give
the fitter ≥2 gwarps to disambiguate).  The per-instruction error and
kernel aggregates are recorded in ``KernelFit`` — a *fit-error stat*,
so a lossy ingest is visible, never silent.  A stream synthesized from
the generators themselves round-trips exactly within each mode's
recoverable param window: the linear modes only ever observe
``p*4096 mod mem_blocks``, so STREAM/STRIDED params recover modulo
``mem_blocks/4096`` (1024 at the default ``mem_blocks``; a larger
param generates the *identical* address stream), while A_RANDOM params
recover exactly for p < 4096 (tests/test_traceio.py).

API:  ``parse_trace_text`` / ``parse_trace_file`` → ``ParsedKernel``s;
``lower_kernel`` → (``KernelTrace``, ``KernelFit``); ``load_trace(path)``
→ ``TraceIngest`` (whole-file Workload + per-kernel fit stats);
``synthesize_trace`` is the inverse (IR → subset text) used by the
round-trip conformance tests.  CLI: ``python -m
repro_torch.launch.trace_ingest {inspect,summarize,convert} PATH`` and
``python -m repro_torch.launch.zoo --trace FILE|DIR``.
"""
from __future__ import annotations

import math
import os
import re
from collections import Counter
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.sim.config import (BAR, CLASS_NAMES, FP32, INT32, LDG, SFU,
                                    STG, TENSOR)
from repro_torch.sim.trace import (A_RANDOM, A_STREAM, A_STRIDED,
                                   KernelTrace, Workload)

DEFAULT_MEM_BLOCKS = 1 << 22     # matches GPUConfig.mem_blocks (TINY + 3080Ti)
BLOCK_BYTES = 128                # one simulated memory block
_RANDOM_PARAM_SPACE = 4096       # brute-force window for A_RANDOM recovery

# first dotted opcode token → instruction class
_FP32_OPS = {"FADD", "FMUL", "FFMA", "FSET", "FSETP", "FSEL", "FMNMX",
             "FCHK", "FRND", "F2F", "DADD", "DMUL", "DFMA", "HADD2",
             "HMUL2", "HFMA2"}
_SFU_OPS = {"MUFU", "RCP", "LG2", "EX2", "RSQ", "SQRT"}
_TENSOR_OPS = {"HMMA", "IMMA", "BMMA", "DMMA"}
_LOAD_OPS = {"LDG", "LD", "LDL"}
_STORE_OPS = {"STG", "ST", "STL", "ATOM", "ATOMG", "RED"}
_BAR_OPS = {"BAR", "MEMBAR"}
_SHMEM_OPS = {"LDS", "STS", "LDSM"}
_DROP_OPS = {"EXIT", "RET"}
# known ALU/control opcodes (classification falls through to INT32 for
# anything unlisted, but unknowns are *counted* — see KernelFit)
_INT_OPS = {"IMAD", "IADD", "IADD3", "ISETP", "IABS", "IMNMX", "LOP",
            "LOP3", "PLOP3", "LEA", "SHF", "SHL", "SHR", "MOV", "MOV32I",
            "SEL", "S2R", "CS2R", "PRMT", "POPC", "FLO", "BREV", "VOTE",
            "VOTEU", "NOP", "BRA", "BRX", "BSSY", "BSYNC", "I2F", "F2I",
            "I2I", "ISCADD", "LDC", "ULDC", "UMOV", "UIMAD", "USHF",
            "ULOP3", "R2P", "P2R"}

_REG_RE = re.compile(r"^(U?R|U?P)\d+$")
_DIM_RE = re.compile(r"^\((\d+),(\d+),(\d+)\)$")


class TraceFormatError(ValueError):
    """Malformed trace input; names the offending line number."""

    def __init__(self, msg: str, line_no: int | None = None,
                 path: str = ""):
        self.line_no = line_no
        self.path = path
        where = path or "<trace>"
        if line_no is not None:
            where += f":{line_no}"
        super().__init__(f"{where}: {msg}")


def classify_opcode(opcode: str) -> int | None:
    """Instruction class of a SASS opcode (first dotted token), or None
    for dropped control ops (EXIT/RET)."""
    head = opcode.split(".")[0].upper()
    if head in _DROP_OPS:
        return None
    if head in _FP32_OPS:
        return FP32
    if head in _SFU_OPS:
        return SFU
    if head in _TENSOR_OPS:
        return TENSOR
    if head in _LOAD_OPS:
        return LDG
    if head in _STORE_OPS:
        return STG
    if head in _BAR_OPS:
        return BAR
    return INT32


def _opcode_kind(opcode: str) -> str:
    """'known' | 'shmem' | 'unknown' — bookkeeping for KernelFit."""
    head = opcode.split(".")[0].upper()
    if head in _SHMEM_OPS:
        return "shmem"
    known = (_FP32_OPS | _SFU_OPS | _TENSOR_OPS | _LOAD_OPS | _STORE_OPS
             | _BAR_OPS | _DROP_OPS | _INT_OPS)
    return "known" if head in known else "unknown"


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

@dataclass
class ParsedInstr:
    pc: int
    mask: int
    dests: tuple
    opcode: str
    srcs: tuple
    mem_width: int
    base_addr: int | None = None      # byte address; None for non-mem
    line_no: int = 0


@dataclass
class ParsedWarp:
    warp_id: int
    instrs: list = field(default_factory=list)
    declared_insts: int | None = None


@dataclass
class ParsedTB:
    block: tuple
    warps: list = field(default_factory=list)


@dataclass
class ParsedKernel:
    name: str
    grid: tuple
    block: tuple
    kernel_id: int = 0
    shmem: int = 0
    extras: dict = field(default_factory=dict)   # tolerated-and-dropped headers
    tbs: list = field(default_factory=list)

    @property
    def n_ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def threads_per_cta(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    @property
    def warps_per_cta(self) -> int:
        return max(1, math.ceil(self.threads_per_cta / 32))

    def tb_linear(self, block: tuple) -> int:
        gx, gy, _gz = self.grid
        x, y, z = block
        return x + gx * (y + gy * z)


def _parse_dim(value: str, no: int, path: str, min_val: int = 1) -> tuple:
    m = _DIM_RE.match(value.replace(" ", ""))
    if not m:
        raise TraceFormatError(
            f"expected dimension tuple '(x,y,z)', got {value!r}", no, path)
    dims = tuple(int(g) for g in m.groups())
    if any(d < min_val for d in dims):
        raise TraceFormatError(
            f"dimension must be >= {min_val}: {value!r}", no, path)
    return dims


def _parse_int(tok: str, what: str, no: int, path: str, base: int = 10) -> int:
    try:
        return int(tok, base)
    except ValueError:
        raise TraceFormatError(
            f"expected {what}, got {tok!r}", no, path) from None


def _parse_regs(toks: list, i: int, count: int, no: int,
                path: str) -> tuple:
    if i + count > len(toks):
        raise TraceFormatError(
            f"instruction line truncated: expected {count} register(s), "
            f"found {len(toks) - i}", no, path)
    regs = toks[i:i + count]
    for r in regs:
        if not _REG_RE.match(r):
            raise TraceFormatError(
                f"expected register operand, got {r!r}", no, path)
    return tuple(regs)


def _parse_instr(toks: list, no: int, path: str) -> ParsedInstr:
    if len(toks) < 5:
        raise TraceFormatError(
            "instruction line truncated: need at least "
            "'PC MASK NDEST OPCODE NSRC'", no, path)
    pc = _parse_int(toks[0], "hex PC", no, path, base=16)
    mask = _parse_int(toks[1], "hex active mask", no, path, base=16)
    ndest = _parse_int(toks[2], "dest-register count", no, path)
    i = 3
    dests = _parse_regs(toks, i, ndest, no, path)
    i += ndest
    if i >= len(toks):
        raise TraceFormatError("instruction line truncated: missing opcode",
                               no, path)
    opcode = toks[i]
    i += 1
    if i >= len(toks):
        raise TraceFormatError(
            f"instruction line truncated after opcode {opcode!r}", no, path)
    nsrc = _parse_int(toks[i], "source-register count", no, path)
    i += 1
    srcs = _parse_regs(toks, i, nsrc, no, path)
    i += nsrc
    if i >= len(toks):
        raise TraceFormatError(
            f"instruction line truncated: missing mem_width for {opcode!r}",
            no, path)
    mem_width = _parse_int(toks[i], "mem_width", no, path)
    i += 1
    base_addr = None
    if mem_width > 0:
        if i + 1 >= len(toks):
            raise TraceFormatError(
                f"mem op {opcode!r} (width {mem_width}) is missing its "
                "address info: expected 'MODE BASEADDR ...'", no, path)
        mode = _parse_int(toks[i], "address compression mode", no, path)
        if mode not in (0, 1, 2):
            raise TraceFormatError(
                f"unsupported address compression mode {mode} (the subset "
                "accepts 0=list, 1=base+stride, 2=base+deltas)", no, path)
        base_addr = _parse_int(toks[i + 1], "base address", no, path, base=0)
        # trailing tokens (stride / deltas / the rest of an address list)
        # are part of addrinfo and dropped: the IR addresses per warp.
    elif i < len(toks):
        raise TraceFormatError(
            f"unexpected trailing tokens {toks[i:]} on a non-memory "
            "instruction (mem_width = 0)", no, path)
    return ParsedInstr(pc=pc, mask=mask, dests=dests, opcode=opcode,
                       srcs=srcs, mem_width=mem_width, base_addr=base_addr,
                       line_no=no)


def parse_trace_text(text: str, path: str = "<trace>") -> list:
    """Parse subset trace text into a list of ``ParsedKernel``."""
    kernels: list = []
    kern: ParsedKernel | None = None
    hdr: dict = {}
    extras: dict = {}
    tb: ParsedTB | None = None
    warp: ParsedWarp | None = None

    def close_warp(no):
        nonlocal warp
        if warp is None:
            return
        if (warp.declared_insts is not None
                and warp.declared_insts != len(warp.instrs)):
            raise TraceFormatError(
                f"warp {warp.warp_id} declared insts = "
                f"{warp.declared_insts} but has {len(warp.instrs)} "
                "instruction lines", no, path)
        warp = None

    def materialize(no):
        """Promote accumulated header lines into a ParsedKernel."""
        nonlocal kern, hdr, extras
        if kern is not None:
            return
        missing = [k for k in ("kernel name", "grid dim", "block dim")
                   if k not in hdr]
        if missing:
            raise TraceFormatError(
                f"kernel header incomplete: missing "
                f"{['-' + m for m in missing]}", no, path)
        kern = ParsedKernel(
            name=hdr["kernel name"], grid=hdr["grid dim"],
            block=hdr["block dim"], kernel_id=int(hdr.get("kernel id", 0)),
            shmem=int(hdr.get("shmem", 0)), extras=dict(extras))
        hdr, extras = {}, {}

    def flush_kernel(no):
        nonlocal kern
        if kern is None and (hdr or extras):
            materialize(no)
        if kern is not None:
            kernels.append(kern)
            kern = None

    for no, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line:
            continue

        if line.startswith("-"):
            if tb is not None:
                raise TraceFormatError(
                    "header line inside a #BEGIN_TB block", no, path)
            if "=" not in line:
                raise TraceFormatError(
                    f"malformed header line {line!r}: expected "
                    "'-key = value'", no, path)
            key, _, value = line[1:].partition("=")
            key, value = key.strip(), value.strip()
            if key == "kernel name":
                flush_kernel(no)            # a new kernel begins
                hdr = {"kernel name": value}
                extras = {}
            elif key in ("grid dim", "block dim"):
                hdr[key] = _parse_dim(value, no, path)
            elif key in ("kernel id", "shmem"):
                hdr[key] = _parse_int(value, f"integer for '-{key}'", no,
                                      path)
            else:
                extras[key] = value         # tolerated, dropped
            continue

        if line == "#BEGIN_TB":
            materialize(no)
            if tb is not None:
                raise TraceFormatError("#BEGIN_TB inside an open TB block",
                                       no, path)
            tb = ParsedTB(block=())
            continue

        if line == "#END_TB":
            if tb is None:
                raise TraceFormatError("#END_TB without #BEGIN_TB", no, path)
            close_warp(no)
            if not tb.block:
                raise TraceFormatError(
                    "TB block missing its 'thread block = x,y,z' line",
                    no, path)
            if len(kern.tbs) >= kern.n_ctas:
                raise TraceFormatError(
                    f"more thread blocks than grid size {kern.n_ctas}",
                    no, path)
            kern.tbs.append(tb)
            tb = None
            continue

        if line.startswith("thread block"):
            if tb is None:
                raise TraceFormatError(
                    "'thread block' line outside #BEGIN_TB", no, path)
            _, _, value = line.partition("=")
            tb.block = _parse_dim(f"({value.strip()})", no, path, min_val=0)
            if any(c >= g for c, g in zip(tb.block, kern.grid)):
                raise TraceFormatError(
                    f"thread block {tb.block} outside grid {kern.grid}",
                    no, path)
            continue

        if line.startswith("warp"):
            if tb is None:
                raise TraceFormatError("'warp = N' line outside #BEGIN_TB",
                                       no, path)
            close_warp(no)
            _, _, value = line.partition("=")
            wid = _parse_int(value.strip(), "warp id", no, path)
            warp = ParsedWarp(warp_id=wid)
            tb.warps.append(warp)
            continue

        if line.startswith("insts"):
            if warp is None:
                raise TraceFormatError(
                    "'insts = N' line outside a warp block", no, path)
            _, _, value = line.partition("=")
            warp.declared_insts = _parse_int(value.strip(),
                                             "instruction count", no, path)
            continue

        # anything else must be an instruction line inside a warp block
        if tb is None or warp is None:
            raise TraceFormatError(
                f"unexpected line {line!r}: instruction lines must appear "
                "inside a '#BEGIN_TB' / 'warp = N' block", no, path)
        warp.instrs.append(_parse_instr(line.split(), no, path))

    if tb is not None:
        raise TraceFormatError("unterminated #BEGIN_TB block (missing "
                               "#END_TB)", len(text.splitlines()), path)
    flush_kernel(len(text.splitlines()))
    if not kernels:
        raise TraceFormatError("no kernels found", None, path)
    return kernels


def parse_trace_file(path: str) -> list:
    with open(path) as f:
        text = f.read()
    return parse_trace_text(text, path=path)


# ---------------------------------------------------------------------------
# address fitting
# ---------------------------------------------------------------------------

def _circ_err(pred: np.ndarray, obs: np.ndarray, mem_blocks: int):
    d = np.abs(pred.astype(np.int64) - obs.astype(np.int64))
    return np.minimum(d, mem_blocks - d)


def _fit_linear(gwarps, addrs, pc, mem_blocks, coeff, pc_term):
    off = (coeff * gwarps.astype(np.int64) + pc_term) % mem_blocks
    cand = (np.rint(((addrs.astype(np.int64) - off) % mem_blocks) / 4096)
            .astype(np.int64) % max(mem_blocks // 4096, 1))
    vals, counts = np.unique(cand, return_counts=True)
    p = int(vals[np.argmax(counts)])
    pred = (p * 4096 + off) % mem_blocks
    return p, float(_circ_err(pred, addrs, mem_blocks).mean())


def _fit_random(gwarps, addrs, pc, mem_blocks):
    ps = np.arange(min(_RANDOM_PARAM_SPACE, mem_blocks), dtype=np.int64)
    h = (gwarps.astype(np.int64)[None, :] * 2654435761
         + pc * 40503 + ps[:, None] * 97) % (1 << 32)
    pred = h % mem_blocks
    errs = _circ_err(pred, addrs[None, :].astype(np.int64),
                     mem_blocks).mean(axis=1)
    best = int(np.argmin(errs))
    return int(ps[best]), float(errs[best])


def fit_addresses(gwarps: np.ndarray, addrs: np.ndarray, pc: int,
                  mem_blocks: int = DEFAULT_MEM_BLOCKS):
    """Fit observed per-gwarp block addresses of one instruction to the
    procedural generators.  Returns (mode, param, mean_err_blocks).
    Candidates are scored by mean circular distance; the lowest error
    wins, ties resolving STREAM → STRIDED → RANDOM."""
    gwarps = np.asarray(gwarps, np.int64)
    addrs = np.asarray(addrs, np.int64) % mem_blocks
    p_st, e_st = _fit_linear(gwarps, addrs, pc, mem_blocks, 8, pc % 8)
    p_sd, e_sd = _fit_linear(gwarps, addrs, pc, mem_blocks, 257, 31 * pc)
    p_rn, e_rn = _fit_random(gwarps, addrs, pc, mem_blocks)
    best = min(((e_st, 0, A_STREAM, p_st), (e_sd, 1, A_STRIDED, p_sd),
                (e_rn, 2, A_RANDOM, p_rn)))
    return best[2], best[3], best[0]


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

@dataclass
class KernelFit:
    """Ingest/conformance stats recorded while lowering one kernel."""
    name: str
    n_instr: int = 0
    n_mem: int = 0                       # fitted memory instructions
    n_warps_seen: int = 0                # warp streams observed in the trace
    divergent_warps: int = 0             # opcode stream != canonical
    dropped: dict = field(default_factory=dict)    # opcode head -> count
    shmem_ops: int = 0                   # LDS/STS/... lowered to INT32
    unknown_ops: int = 0                 # unlisted opcodes lowered to INT32
    fit_err: list = field(default_factory=list)    # per-mem-instr, blocks
    cta_split: int = 1                   # ctas each original CTA became

    @property
    def fit_err_mean(self) -> float:
        return float(np.mean(self.fit_err)) if self.fit_err else 0.0

    @property
    def fit_err_max(self) -> float:
        return float(np.max(self.fit_err)) if self.fit_err else 0.0

    def summary(self) -> dict:
        return {
            "name": self.name, "n_instr": self.n_instr, "n_mem": self.n_mem,
            "n_warps_seen": self.n_warps_seen,
            "divergent_warps": self.divergent_warps,
            "dropped": dict(self.dropped), "shmem_ops": self.shmem_ops,
            "unknown_ops": self.unknown_ops,
            "fit_err_mean": round(self.fit_err_mean, 4),
            "fit_err_max": round(self.fit_err_max, 4),
            "cta_split": self.cta_split,
        }


_ZERO_REGS = {"R255", "UR255"}           # RZ reads as zero: never a dep


def _dep_chain(instrs: list) -> np.ndarray:
    dep = np.zeros(len(instrs), bool)
    for i in range(1, len(instrs)):
        prev_dests = {d for d in instrs[i - 1].dests
                      if d not in _ZERO_REGS}
        srcs = {s for s in instrs[i].srcs if s not in _ZERO_REGS}
        dep[i] = bool(prev_dests & srcs)
    return dep


def lower_kernel(pk: ParsedKernel, mem_blocks: int = DEFAULT_MEM_BLOCKS,
                 max_warps_per_cta: int | None = None):
    """Lower one parsed kernel to the IR.  Returns (KernelTrace, KernelFit).

    Canonical stream: thread block 0 (grid-linear order), lowest warp id,
    control ops dropped.  Other conforming warps contribute only their
    memory base addresses, which are fitted per instruction to the
    A_STREAM / A_STRIDED / A_RANDOM generators (module docstring)."""
    fit = KernelFit(name=pk.name)
    if not pk.tbs:
        raise TraceFormatError(
            f"kernel {pk.name!r} has no thread blocks", None, "")
    tbs = sorted(pk.tbs, key=lambda tb: pk.tb_linear(tb.block))
    wpc = pk.warps_per_cta

    def stream_of(warp: ParsedWarp) -> list:
        kept = []
        for ins in warp.instrs:
            cls = classify_opcode(ins.opcode)
            if cls is None:
                head = ins.opcode.split(".")[0].upper()
                fit.dropped[head] = fit.dropped.get(head, 0) + 1
                continue
            kept.append((cls, ins))
        return kept

    canon_tb = tbs[0]
    if not canon_tb.warps:
        raise TraceFormatError(
            f"kernel {pk.name!r}: thread block {canon_tb.block} has no "
            "warps", None, "")
    canon_warp = min(canon_tb.warps, key=lambda w: w.warp_id)
    canon = stream_of(canon_warp)
    if not canon:
        raise TraceFormatError(
            f"kernel {pk.name!r}: canonical warp has no instructions "
            "after dropping control ops", None, "")

    ops = np.array([c for c, _ in canon], np.int32)
    dep = _dep_chain([ins for _, ins in canon])
    addr_mode = np.zeros(len(canon), np.int32)
    addr_param = np.zeros(len(canon), np.int32)
    fit.n_instr = len(canon)
    for cls, ins in canon:
        kind = _opcode_kind(ins.opcode)
        if kind == "shmem":
            fit.shmem_ops += 1
        elif kind == "unknown":
            fit.unknown_ops += 1

    canon_sig = [(c, ins.opcode) for c, ins in canon]
    # gather per-gwarp base addresses from every conforming warp
    obs: dict = {i: {} for i, (c, _) in enumerate(canon)
                 if c in (LDG, STG)}
    for tb in tbs:
        linear = pk.tb_linear(tb.block)
        for w in tb.warps:
            if w.warp_id >= wpc:
                raise TraceFormatError(
                    f"kernel {pk.name!r}: warp id {w.warp_id} >= "
                    f"warps_per_cta {wpc}", None, "")
            fit.n_warps_seen += 1
            stream = stream_of(w) if w is not canon_warp else canon
            if [(c, ins.opcode) for c, ins in stream] != canon_sig:
                fit.divergent_warps += 1
                continue
            gwarp = linear * wpc + w.warp_id
            for i, (_c, ins) in enumerate(stream):
                if i in obs and ins.base_addr is not None:
                    obs[i][gwarp] = (ins.base_addr // BLOCK_BYTES) \
                        % mem_blocks

    for i in sorted(obs):
        if not obs[i]:
            continue                     # mem op with no observed addresses
        gw = np.array(sorted(obs[i]), np.int64)
        ad = np.array([obs[i][g] for g in sorted(obs[i])], np.int64)
        mode, param, err = fit_addresses(gw, ad, i, mem_blocks)
        addr_mode[i], addr_param[i] = mode, param
        fit.n_mem += 1
        fit.fit_err.append(err)

    n_ctas = pk.n_ctas
    if max_warps_per_cta is not None and wpc > max_warps_per_cta:
        split = math.ceil(wpc / max_warps_per_cta)
        fit.cta_split = split
        n_ctas *= split
        wpc = math.ceil(wpc / split)

    kt = KernelTrace(name=pk.name, n_ctas=n_ctas, warps_per_cta=wpc,
                     ops=ops, dep=dep, addr_mode=addr_mode,
                     addr_param=addr_param)
    return kt, fit


# ---------------------------------------------------------------------------
# whole-file ingest
# ---------------------------------------------------------------------------

@dataclass
class TraceIngest:
    """A lowered trace file: the Workload plus per-kernel fit stats."""
    workload: Workload
    fits: list                           # KernelFit per kernel
    path: str = ""

    def summary(self) -> dict:
        errs = [e for f in self.fits for e in f.fit_err]
        return {
            "name": self.workload.name, "path": self.path,
            "n_kernels": len(self.workload.kernels),
            "total_ctas": self.workload.total_ctas,
            "n_instr": [k.n_instr for k in self.workload.kernels],
            "fit_err_mean": round(float(np.mean(errs)), 4) if errs else 0.0,
            "fit_err_max": round(float(np.max(errs)), 4) if errs else 0.0,
            "kernels": [f.summary() for f in self.fits],
        }


def trace_name(path: str) -> str:
    """Zoo registry name of a trace file: ``trace:<stem>``."""
    stem = os.path.splitext(os.path.basename(path))[0]
    return f"trace:{stem}"


def load_trace(path: str, mem_blocks: int = DEFAULT_MEM_BLOCKS,
               max_warps_per_cta: int | None = None) -> TraceIngest:
    """Parse + lower one trace file into a multi-kernel Workload (kernels
    in file order) named ``trace:<stem>``."""
    parsed = parse_trace_file(path)
    kernels, fits = [], []
    for pk in parsed:
        kt, f = lower_kernel(pk, mem_blocks=mem_blocks,
                             max_warps_per_cta=max_warps_per_cta)
        kernels.append(kt)
        fits.append(f)
    w = Workload(trace_name(path), kernels)
    return TraceIngest(workload=w, fits=fits, path=path)


def trace_files(path: str) -> list:
    """``.trace`` files under a file-or-directory path, sorted by name."""
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".trace"))
    return [path]


def load_traces(path: str, **kw) -> list:
    """Ingest a file or every ``*.trace`` in a directory."""
    files = trace_files(path)
    if not files:
        raise FileNotFoundError(f"no .trace files under {path!r}")
    return [load_trace(f, **kw) for f in files]


# ---------------------------------------------------------------------------
# synthesis (IR → subset text) — the round-trip half of the conformance
# suite, and a way to turn any procedural workload into a trace fixture
# ---------------------------------------------------------------------------

_SYNTH_OPCODE = {FP32: "FFMA", INT32: "IMAD", SFU: "MUFU.RCP",
                 TENSOR: "HMMA.1688.F32", LDG: "LDG.E.SYS",
                 STG: "STG.E.SYS", BAR: "BAR.SYNC"}
_SYNTH_BASE = 0x7F0000000000        # ≡ 0 mod (mem_blocks * BLOCK_BYTES)


def _gen_address_np(mode: int, param: int, gwarp: int, pc: int,
                    mem_blocks: int) -> int:
    """Numpy mirror of sim/trace.py:gen_address for one (gwarp, pc)."""
    if mode == A_STREAM:
        return (param * 4096 + gwarp * 8 + pc % 8) % mem_blocks
    if mode == A_STRIDED:
        return (param * 4096 + gwarp * 257 + pc * 31) % mem_blocks
    h = (gwarp * 2654435761 + pc * 40503 + param * 97) % (1 << 32)
    return int(h % mem_blocks)


def synthesize_kernel(kt: KernelTrace, kernel_id: int = 1,
                      mem_blocks: int = DEFAULT_MEM_BLOCKS) -> str:
    """Subset trace text for one KernelTrace: every CTA/warp emitted,
    addresses generated by the procedural generators, so parsing and
    re-lowering recovers the IR exactly within the fitter's param
    windows — STREAM/STRIDED params modulo ``mem_blocks/4096`` (1024 by
    default; larger params alias to the same addresses), A_RANDOM
    params < 4096.  A_NONE memory ops come back as A_RANDOM — the two
    are runtime-identical.  Every synthesized instruction gets a dest
    register so ``dep`` round-trips even across stores and barriers."""
    lines = [
        f"-kernel name = {kt.name}",
        f"-kernel id = {kernel_id}",
        f"-grid dim = ({kt.n_ctas},1,1)",
        f"-block dim = ({kt.warps_per_cta * 32},1,1)",
        "-shmem = 0",
        "-nregs = 32",
        "-binary version = 86",
        "",
    ]
    n = kt.n_instr
    for cta in range(kt.n_ctas):
        lines.append("#BEGIN_TB")
        lines.append("")
        lines.append(f"thread block = {cta},0,0")
        lines.append("")
        for w in range(kt.warps_per_cta):
            gwarp = cta * kt.warps_per_cta + w
            lines.append(f"warp = {w}")
            lines.append(f"insts = {n + 1}")
            for i in range(n):
                dest = f"R{i + 2}"
                src = f"R{i + 1}" if kt.dep[i] else "R1"
                opcode = _SYNTH_OPCODE[int(kt.ops[i])]
                cls = int(kt.ops[i])
                if cls in (LDG, STG):
                    blk = _gen_address_np(
                        int(kt.addr_mode[i]), int(kt.addr_param[i]),
                        gwarp, i, mem_blocks)
                    addr = _SYNTH_BASE + blk * BLOCK_BYTES
                    lines.append(
                        f"{i * 16:04x} ffffffff 1 {dest} {opcode} 1 {src} "
                        f"4 1 0x{addr:x} 4")
                else:
                    lines.append(
                        f"{i * 16:04x} ffffffff 1 {dest} {opcode} 1 {src} 0")
            lines.append(f"{n * 16:04x} ffffffff 0 EXIT 0 0")
            lines.append("")
        lines.append("#END_TB")
        lines.append("")
    return "\n".join(lines)


def synthesize_trace(workload: Workload,
                     mem_blocks: int = DEFAULT_MEM_BLOCKS) -> str:
    """Subset trace text for a whole (multi-kernel) workload."""
    return "\n".join(
        synthesize_kernel(k, kernel_id=i + 1, mem_blocks=mem_blocks)
        for i, k in enumerate(workload.kernels))


def class_histogram(kt: KernelTrace) -> dict:
    """{class name: count} over one kernel's lowered stream."""
    c = Counter(int(o) for o in kt.ops)
    return {CLASS_NAMES[k]: v for k, v in sorted(c.items())}


def scale_trace_workload(w: Workload, scale: float) -> Workload:
    """Scale a trace-derived workload's CTA counts like the zoo
    generators do (scale=1.0 keeps the real grid)."""
    if scale == 1.0:
        return w
    return Workload(w.name, [
        replace(k, n_ctas=max(1, int(round(k.n_ctas * scale))))
        for k in w.kernels])
