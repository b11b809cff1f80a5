"""Trace ingestion: the port's ``sim/traceio.py``, ``trace:`` registry and
``launch/trace_ingest.py`` against the JAX package's, on the bundled
fixtures (tests/data/traces) and on malformed and synthesized input.

The port keeps its own copy of the parser and lowering; every lowered
``KernelTrace`` IR, every ``KernelFit`` summary, every ``TraceFormatError``
(message and line) and every line the CLI prints must equal the
reference's."""
import json
import os

import numpy as np
import pytest

import repro.sim.traceio as JT
import repro.sim.workloads as JZ
import repro_torch.sim.traceio as PT
import repro_torch.sim.workloads as PZ
from repro.launch import trace_ingest as jcli
from repro_torch.core.batch import check_workload_fits
from repro_torch.launch import trace_ingest as pcli
from repro_torch.sim.config import LDG, TINY, static_part
from repro_torch.sim.trace import A_RANDOM, KernelTrace, Workload

HERE = os.path.dirname(os.path.abspath(__file__))
TRACE_DIR = os.path.join(HERE, "data", "traces")
FIXTURES = ("gather_chain", "mm_tile", "vecadd")

# tests/test_traceio.py's malformed cases
HDR = "-kernel name = k\n-grid dim = (2,1,1)\n-block dim = (32,1,1)\n"
TB = "#BEGIN_TB\nthread block = 0,0,0\nwarp = 0\n"
MALFORMED = [
    (HDR.replace("(2,1,1)", "(2,1)"), 2),
    ("0000 ffffffff 1 R2 FFMA 1 R1 0\n", 1),
    (HDR + TB + "zz00 ffffffff 1 R2 FFMA 1 R1 0\n#END_TB\n", 7),
    (HDR + TB + "0000 ffffffff 2 R2 FFMA 1 R1 0\n#END_TB\n", 7),
    (HDR + TB + "insts = 3\n0000 ffffffff 1 R2 FFMA 1 R1 0\n#END_TB\n", 9),
    (HDR + TB + "0000 ffffffff 1 R2 LDG.E 1 R1 4 7 0x80 4\n#END_TB\n", 7),
    (HDR + TB + "0000 ffffffff 1 R2 LDG.E 1 R1 4\n#END_TB\n", 7),
    ("#BEGIN_TB\n", 1),
    (HDR + "warp = 0\n", 4),
    (HDR + TB + "0000 ffffffff 1 R2 FFMA 1 R1 0 junk\n#END_TB\n", 7),
    (HDR + TB + "0000 ffffffff 1 R2 FFMA 1 R1 0\n", 7),
    (HDR + "#BEGIN_TB\nthread block = 5,0,0\n", 5),
    (HDR.replace("(2,1,1)", "(1,1,1)") + TB
     + "0000 ffffffff 1 R2 FFMA 1 R1 0\n#END_TB\n"
     + TB + "0000 ffffffff 1 R2 FFMA 1 R1 0\n#END_TB\n", 13),
    ("", None),
]


def assert_ir_equal(jk, pk):
    """A reference KernelTrace and a port KernelTrace hold the same IR."""
    assert (pk.name, pk.n_ctas, pk.warps_per_cta) == \
        (jk.name, jk.n_ctas, jk.warps_per_cta)
    for f in ("ops", "dep", "addr_mode", "addr_param"):
        a, b = np.asarray(getattr(jk, f)), np.asarray(getattr(pk, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), (jk.name, f)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_ir_and_fit_equal(name):
    path = os.path.join(TRACE_DIR, name + ".trace")
    want, got = JT.load_trace(path), PT.load_trace(path)
    assert got.workload.name == want.workload.name
    assert len(got.workload.kernels) == len(want.workload.kernels)
    for jk, pk in zip(want.workload.kernels, got.workload.kernels):
        assert_ir_equal(jk, pk)
    assert [f.summary() for f in got.fits] == \
        [f.summary() for f in want.fits]
    assert got.summary() == want.summary()


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_parse_equal(name):
    """The parsed kernels (before lowering) carry the same launch shape,
    headers and warp streams."""
    path = os.path.join(TRACE_DIR, name + ".trace")
    for jp, pp in zip(JT.parse_trace_file(path), PT.parse_trace_file(path)):
        assert (pp.name, pp.grid, pp.block, pp.shmem, pp.extras) == \
            (jp.name, jp.grid, jp.block, jp.shmem, jp.extras)
        assert repr(pp.tbs) == repr(jp.tbs)


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_malformed_input_same_error(case):
    text, line_no = MALFORMED[case]
    with pytest.raises(JT.TraceFormatError) as want:
        JT.parse_trace_text(text, path="bad.trace")
    with pytest.raises(PT.TraceFormatError) as got:
        PT.parse_trace_text(text, path="bad.trace")
    assert str(got.value) == str(want.value)
    assert got.value.line_no == want.value.line_no == line_no
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("opcode", [
    "LDG.E.SYS", "STG.E", "ATOMG.ADD", "FFMA", "HFMA2.MMA", "IMAD.MOV.U32",
    "MUFU.RCP", "HMMA.1688.F32", "BAR.SYNC", "MEMBAR.GPU", "EXIT", "BRA",
    "LDS.U", "FROBNICATE", "RET", "DMMA.884", "ISETP.GE.AND"])
def test_classify_opcode_equal(opcode):
    assert PT.classify_opcode(opcode) == JT.classify_opcode(opcode)


def _synth_roundtrip(module, workload):
    text = module.synthesize_trace(workload)
    return [module.lower_kernel(pk)[0]
            for pk in module.parse_trace_text(text, path="<synth>")]


@pytest.mark.parametrize("name", ["trace:mm_tile", "trace:gather_chain",
                                  "zoo:gemm_tiled", "zoo:random_gather",
                                  "zoo:reduction_tree"])
def test_roundtrip_equal(name):
    """Fixtures and zoo workloads: IR → synthesized text → parse → lower
    gives the same IR back, and the same text, on both sides."""
    pw = PZ.resolve_workload(name, 0.01 if name.startswith("zoo:") else 1.0)
    jw = JZ.resolve_workload(name, 0.01 if name.startswith("zoo:") else 1.0)
    assert PT.synthesize_trace(pw) == JT.synthesize_trace(jw)
    back = _synth_roundtrip(PT, pw)
    assert back == pw.kernels
    for jk, pk in zip(_synth_roundtrip(JT, jw), back):
        assert_ir_equal(jk, pk)


def test_random_param_recovered_exactly():
    k = KernelTrace("r", 2, 2, np.array([LDG], np.int32),
                    np.array([False]), np.array([A_RANDOM], np.int32),
                    np.array([777], np.int32))
    assert _synth_roundtrip(PT, Workload("r", [k])) == [k]
    # fit_addresses: the brute-force A_RANDOM recovery, on both sides
    text = PT.synthesize_trace(Workload("r", [k]))
    pk = PT.parse_trace_text(text)[0]
    jk = JT.parse_trace_text(text)[0]
    assert PT.lower_kernel(pk)[1].summary() == JT.lower_kernel(jk)[1].summary()


def test_fit_addresses_equal():
    rng = np.random.default_rng(0)
    gw = rng.permutation(64)[:12]
    for addrs in (rng.integers(0, 1 << 22, 12), gw * 8 + 3 * 4096 + 5,
                  (gw * 257 + 31 * 4 + 9 * 4096) % (1 << 22)):
        assert PT.fit_addresses(gw, addrs, 4) == JT.fit_addresses(gw, addrs,
                                                                  4)


@pytest.mark.parametrize("max_wpc", [None, 8, 5])
def test_cta_split_equal(max_wpc):
    """A 1024-thread CTA (32 warps): split by max_warps_per_cta as the
    reference splits it."""
    text = HDR.replace("(32,1,1)", "(1024,1,1)") + TB + \
        "0000 ffffffff 1 R2 FFMA 1 R1 0\n#END_TB\n"
    kw = {} if max_wpc is None else {"max_warps_per_cta": max_wpc}
    pk, pfit = PT.lower_kernel(PT.parse_trace_text(text)[0], **kw)
    jk, jfit = JT.lower_kernel(JT.parse_trace_text(text)[0], **kw)
    assert_ir_equal(jk, pk)
    assert pfit.summary() == jfit.summary()
    if max_wpc == 8:
        assert (pk.n_ctas, pk.warps_per_cta, pfit.cta_split) == (8, 8, 4)
    # unsplit, the CTA can never dispatch on TINY: refused by name
    if max_wpc is None:
        with pytest.raises(ValueError, match="max_warps_per_cta"):
            check_workload_fits(static_part(TINY), Workload("trace:big",
                                                            [pk]))


def test_registration_and_scaling():
    names = PZ.register_traces(TRACE_DIR)
    assert names == JZ.register_traces(TRACE_DIR) == [
        "trace:gather_chain", "trace:mm_tile", "trace:vecadd"]
    assert set(names) <= set(PZ.TRACE_INGESTS)
    for scale in (1.0, 0.5):
        pw = PZ.zoo_workload("trace:vecadd", scale=scale)
        jw = JZ.zoo_workload("trace:vecadd", scale=scale)
        for jk, pk in zip(jw.kernels, pw.kernels):
            assert_ir_equal(jk, pk)
    assert [k.n_ctas for k in PZ.zoo_workload("trace:vecadd", 0.5).kernels] \
        == [2]
    with pytest.raises(FileNotFoundError, match="no .trace files"):
        PZ.register_traces(HERE)                  # dir without traces


def test_autoregister_from_trace_path(monkeypatch, tmp_path):
    """``trace:<x>`` resolves from REPRO_TRACE_PATH first, then the
    bundled fixtures; unknown names raise the zoo KeyError."""
    src = os.path.join(TRACE_DIR, "vecadd.trace")
    with open(src) as f:
        text = f.read()
    (tmp_path / "mine.trace").write_text(text)
    monkeypatch.setenv("REPRO_TRACE_PATH", str(tmp_path))
    monkeypatch.setattr(PZ, "ZOO", dict(PZ.ZOO))
    monkeypatch.setattr(PZ, "TRACE_INGESTS", {})
    PZ.ZOO.pop("trace:mm_tile", None)
    assert PZ.trace_search_dirs()[0] == str(tmp_path)
    assert PZ.trace_search_dirs()[-1] == TRACE_DIR
    mine = PZ.zoo_workload("trace:mine")
    assert mine.name == "trace:mine"
    assert mine.kernels == PT.load_trace(src).workload.kernels
    assert PZ.zoo_workload("trace:mm_tile").kernels[0].name == "mm_tile"
    assert set(PZ.TRACE_INGESTS) == {"trace:mine", "trace:mm_tile"}
    with pytest.raises(KeyError, match="unknown zoo workload"):
        PZ.zoo_workload("trace:no_such_fixture")


def test_resolve_workload_namespaces():
    assert PZ.resolve_workload("trace:vecadd").name == "trace:vecadd"
    assert PZ.resolve_workload("zoo:mixed", 0.02).name == "mixed"
    assert PZ.resolve_workload("gemm_tiled", 0.02).name == "gemm_tiled"
    assert PZ.resolve_workload("hotspot", 0.02).name == "hotspot"


@pytest.mark.parametrize("argv", [
    ["inspect", TRACE_DIR], ["summarize", TRACE_DIR],
    ["summarize", os.path.join(TRACE_DIR, "vecadd.trace")],
    ["convert", os.path.join(TRACE_DIR, "mm_tile.trace")],
    ["roundtrip", os.path.join(TRACE_DIR, "gather_chain.trace")]])
def test_trace_ingest_cli_same_stdout(argv, capsys):
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert pcli.main(argv) == 0
    assert capsys.readouterr().out == want
    if argv[0] == "summarize":
        json.loads(want)


def test_trace_ingest_cli_convert_to_file(tmp_path, capsys):
    vec = os.path.join(TRACE_DIR, "vecadd.trace")
    dst = tmp_path / "p.json"
    assert pcli.main(["convert", vec, "-o", str(dst)]) == 0
    assert capsys.readouterr().out == f"[trace_ingest] wrote {dst}\n"
    assert jcli.main(["convert", vec, "-o", str(tmp_path / "j.json")]) == 0
    assert dst.read_text() == (tmp_path / "j.json").read_text()
