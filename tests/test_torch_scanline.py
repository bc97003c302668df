"""The port's fused scan programs and elementwise rule evaluator against the
JAX Pallas kernels in interpret mode.

On the CPU, ``fused_scan`` runs the port's programs through the plain
executor (``scanline.run_program`` with the builds as lambdas); the CUDA
kernel ``csrc/scanline.cu`` runs the same programs lowered to its IR
(``scanline_ir.lower``), which ``scanline_ir.run_lowered`` interprets here
tile by tile as the kernel does. Every JAX comparison holds both to the JAX
kernel; ``elementwise_map`` runs the port's ``_lb_rules``, which
``csrc/lbrules.cu`` writes out in CUDA. The streams cross the JAX kernel's
32,768-position tiles and the port kernel's tiles of 2,048, 4,096 and
8,192 positions. Results are integers: equality is exact.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stringwars_tpu.ops import scanline as JL
from stringwars_tpu.ops import segment as JS
from stringwars_tpu_torch.ops import scanline as PL
from stringwars_tpu_torch.ops import scanline_cuda as PC
from stringwars_tpu_torch.ops import scanline_ir as IR
from stringwars_tpu_torch.ops import segment as PS
from stringwars_tpu_torch.unicode import tables
from _torch_threads import one_thread  # noqa: F401


N = 2 * 32768 + 3 * 2048 + 5  # crosses both tiles


def _lowered(streams: dict, port_ops, n, reverse, tiles=(None, 2048)) -> list[dict]:
    """The program lowered for the streams' dtypes, interpreted at the
    kernel's own tile and at the smallest one."""
    inputs = {k: torch.from_numpy(v) for k, v in streams.items()}
    low = IR.lower(port_ops, {k: t.dtype for k, t in inputs.items()})
    return [IR.run_lowered(low, inputs, n, reverse, tile=tile) for tile in tiles]


def _run_both(streams: dict, jax_ops, port_ops, n, reverse=False):
    want = JL.fused_scan({k: jnp.asarray(v) for k, v in streams.items()}, jax_ops, n, reverse=reverse, interpret=True)
    got = PL.fused_scan({k: torch.from_numpy(v) for k, v in streams.items()}, port_ops, n, reverse=reverse)
    for result in [got] + _lowered(streams, port_ops, n, reverse):
        assert sorted(result) == sorted(want)
        for name in want:
            assert result[name].dtype == torch.int32 and result[name].shape == (n,)
            mism = np.flatnonzero(result[name].numpy() != np.asarray(want[name]))
            assert mism.size == 0, f"{name}: first mismatches at {mism[:10]}"
    return got


def _kind_ops(module, kind):
    jnp_or_torch = jnp if module is JL else torch
    if kind in ("last", "last2"):
        build = lambda e: (e["v"] * 3 - 1, e["f"])  # noqa: E731
    elif kind == "max":
        build = lambda e: jnp_or_torch.where(e["f"] > 0, e["v"], -100)  # noqa: E731
    else:
        build = lambda e: e["v"]  # noqa: E731
    return (module.Op(kind, "o", build, init=-7),)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("kind", ["sum", "max", "last", "last2", "delay"])
def test_fused_scan_kind_equals_jax(kind, reverse):
    rng = np.random.default_rng(["sum", "max", "last", "last2", "delay"].index(kind) * 2 + reverse)
    streams = {
        "v": rng.integers(-60, 60, N).astype(np.int32),
        "f": (rng.random(N) < (0.002 if kind != "sum" else 0.3)).astype(np.int32),
    }
    _run_both(streams, _kind_ops(JL, kind), _kind_ops(PL, kind), N, reverse)


def _text_streams(n: int) -> dict:
    """Realistic program inputs: class streams of a multilingual + fuzz text."""
    from stringwars_tpu_torch import datasets

    raw = (datasets.synthesize("multilingual", n // 2) + _soup(n)) [:n]
    b = np.frombuffer(raw, np.uint8)
    data = torch.from_numpy(b.copy())
    cp, is_lead, _ = PS._byte_space(data, n)
    lead = is_lead.numpy().astype(np.int32)
    gcb = PS._lead_cls(cp, is_lead, "grapheme_break_table", None).numpy()
    wb = PS._lead_cls(cp, is_lead, "word_break_table", None).numpy()
    sb = PS._lead_cls(cp, is_lead, "sentence_break_table", None).numpy()
    lb = PS._lb_classes(cp, is_lead, None).numpy()
    incb = PS._lead_cls(cp, is_lead, "incb_table", None).numpy()
    pict = ((PS._class_of(cp, "extended_pictographic_table").numpy() > 0) & (lead > 0)).astype(np.int32)
    return {"lead": lead, "gcb": gcb, "wb": wb, "sb": sb, "lb": lb, "incb": incb, "pict": pict}


def _soup(n: int) -> bytes:
    rng = np.random.default_rng(5)
    pool = ["word", "Don't", "3.14", "U.S.A. Next", "א״א", "é́", "x‍☺", "\U0001F1FA\U0001F1F8", "가각", " ", "\r\n",
            "Mr. Smith went. Home! now? ok", "क्ष", "(foo) [bar]", "$100", "US$-10", "“quoted”", "\U0001F600\U0001F3FB"]
    return "".join(pool[i] for i in rng.integers(0, len(pool), n // 4)).encode()


def _program_inputs(name: str, s: dict) -> dict:
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    lead = s["lead"] > 0
    if name == "whitespace":
        ws = np.isin(s["wb"], [tables.WB_VALUES.index("WSegSpace"), tables.WB_VALUES.index("LF")])
        return {"tok": i32(lead & ~ws), "lead": s["lead"]}
    if name == "graphemes":
        G = {k: i for i, k in enumerate(tables.GCB_VALUES)}
        cls, incb = s["gcb"], s["incb"]
        return {
            "cls": cls, "lead": s["lead"], "pict": s["pict"], "incb": incb,
            "ri": i32(cls == G["Regional_Indicator"]), "nonext": i32((cls != G["Extend"]) & lead),
            "ctl": i32(np.isin(cls, [G["Control"], G["CR"], G["LF"]])), "lnk": i32(incb == 2),
            "nel": i32(~np.isin(incb, [1, 2]) & lead),
        }
    if name in ("words-fwd", "words-bwd"):
        W = {k: i for i, k in enumerate(tables.WB_VALUES)}
        cls = s["wb"]
        ignore = np.isin(cls, [W["Extend"], W["Format"], W["ZWJ"]])
        ri = (cls == W["Regional_Indicator"]) & ~ignore
        out = {"cls": cls, "keep": i32(~ignore & lead)}
        if name == "words-fwd":
            out.update(lead=s["lead"], nl=i32(np.isin(cls, [W["CR"], W["LF"], W["Newline"]])), ri=i32(ri),
                       basemask=i32(~ri & ~ignore & lead))
        return out
    if name in ("sentences-fwd", "sentences-bwd"):
        S = {k: i for i, k in enumerate(tables.SB_VALUES)}
        cls = s["sb"]
        ign = np.isin(cls, [S["Extend"], S["Format"]])
        if name == "sentences-bwd":
            stop = np.isin(cls, [S["OLetter"], S["Upper"], S["Lower"], S["ATerm"], S["STerm"], S["Sep"]]) & lead
            return {"eff": cls, "stop": i32(stop)}
        return {"cls": cls, "keep": i32(~ign & lead), "lead": s["lead"], "ign": i32(ign),
                "ps": i32(np.isin(cls, [S["Sep"], S["CR"], S["LF"]]))}
    L = {k: i for i, k in enumerate(tables.LB_VALUES)}
    cls = s["lb"]
    cm = np.isin(cls, [L["CM"], L["ZWJ"]])
    if name == "linebreaks-bwd":
        return {"eff": cls, "lead": s["lead"]}
    hard = np.isin(cls, [L["BK"], L["CR"], L["LF"], L["NL"], L["SP"], L["ZW"]])
    return {"cls": cls, "cm": i32(cm), "hard": i32(hard), "basemask": i32(~cm & lead), "lead": s["lead"]}


PROGRAMS = {
    "whitespace": (JS._WS_OPS, PS._WS_OPS, False),
    "graphemes": (JS._GRAPH_OPS, PS._GRAPH_OPS, False),
    "words-fwd": (JS._WORD_OPS_FWD, PS._WORD_OPS_FWD, False),
    "words-bwd": (JS._WORD_OPS_BWD, PS._WORD_OPS_BWD, True),
    "sentences-fwd": (JS._sent_ops_fwd(), PS._SENT_OPS_FWD, False),
    "sentences-bwd": (JS._SENT_OPS_BWD, PS._SENT_OPS_BWD, True),
    "linebreaks-fwd": (JS._lb_ops()[0], PS._LB_OPS_FWD, False),
    "linebreaks-bwd": (JS._lb_ops()[1], PS._LB_OPS_BWD, True),
}


@pytest.fixture(scope="module")
def text_streams():
    return _text_streams(N)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fused_scan_program_equals_jax(name, text_streams):
    """Every op program of ``ops/segment``, in its own direction."""
    jax_ops, port_ops, reverse = PROGRAMS[name]
    assert [(op.kind, op.name, op.init) for op in port_ops] == [(op.kind, op.name, op.init) for op in jax_ops]
    _run_both(_program_inputs(name, text_streams), jax_ops, port_ops, N, reverse)


def test_fused_scan_bool_and_int8_streams_read_as_int32():
    """Streams are read as int32 whatever their type; a flag is set where > 0."""
    rng = np.random.default_rng(3)
    n = 5000
    v = rng.integers(-100, 100, n)
    f = rng.integers(-2, 3, n)
    ops = (PL.Op("last2", "l", lambda e: (e["v"], e["f"]), init=5), PL.Op("sum", "s", lambda e: e["v"]))
    want = PL.fused_scan({"v": torch.from_numpy(v.astype(np.int32)), "f": torch.from_numpy(f.astype(np.int32))}, ops, n)
    got = PL.fused_scan({"v": torch.from_numpy(v.astype(np.int8)), "f": torch.from_numpy(f.astype(np.int8))}, ops, n)
    for k in want:
        assert torch.equal(got[k], want[k])
    flags = torch.from_numpy(f > 0)
    got = PL.fused_scan({"v": torch.from_numpy(v.astype(np.int32)), "f": flags}, ops, n)
    for k in want:
        assert torch.equal(got[k], want[k])


def test_fused_scan_reverse_and_chaining():
    """The JAX package's chaining test: an op reads an earlier op's output."""
    rng = np.random.default_rng(3)
    n = 12345
    v = rng.integers(0, 50, n).astype(np.int32)
    f = (rng.random(n) < 0.2).astype(np.int32)
    jax_ops = (
        JL.Op("sum", "s", lambda e: e["f"]),
        JL.Op("last", "lv", lambda e: (e["s"] * 2, e["f"]), init=-5),
        JL.Op("delay", "d", lambda e: e["lv"], init=-5),
    )
    port_ops = (
        PL.Op("sum", "s", lambda e: e["f"]),
        PL.Op("last", "lv", lambda e: (e["s"] * 2, e["f"]), init=-5),
        PL.Op("delay", "d", lambda e: e["lv"], init=-5),
    )
    for reverse in (False, True):
        _run_both({"v": v, "f": f}, jax_ops, port_ops, n, reverse)


def test_program_groups():
    """Ops whose builds read no pending output share one executor call."""
    calls = []

    def execute(group, n, reverse):
        calls.append([op.name for op, _, _ in group])
        return PL.scan_group_plain(group, n, reverse)

    lead = torch.ones(10, dtype=torch.bool)
    inputs = {"tok": lead, "cls": torch.arange(10), "lead": lead, "ri": ~lead}
    PL.run_program(inputs, PS._WS_OPS[:1] + PS._GRAPH_OPS[:4], 10, False, execute)
    assert calls == [["ltok", "lcls"], ["prev", "s"], ["base"]]
    with pytest.raises(KeyError):
        PL.fused_scan({"x": lead}, PS._WS_OPS, 10)
    with pytest.raises(ValueError):
        PC.fused_scan_kernel({"tok": lead, "lead": lead}, PS._WS_OPS, 10, False)  # a CPU tensor never reaches the kernel


def test_builds_run_in_the_profiler_range():
    """Each op's build, and nothing of the executor, runs inside
    ``BUILD_RANGE``: a trace splits a program's builds from its scans."""
    n = 1000
    lead = torch.ones(n, dtype=torch.bool)
    inputs = {"cls": torch.arange(n) % 7, "lead": lead, "ri": torch.arange(n) % 3 == 0}
    ops = PS._GRAPH_OPS[:5]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        PL.run_program(inputs, ops, n, False, PL.scan_group_plain)
    ranges = [e for e in prof.events() if e.name == PL.BUILD_RANGE]
    assert len(ranges) == len(ops) + 3  # "prev", "base" and "lrr" read a pending output: built again after a flush
    inside = {c.name for e in ranges for c in e.cpu_children}
    assert "aten::where" in inside  # the build of "base"
    assert not inside & {"aten::cumsum", "aten::cummax", "aten::nonzero"}  # the plain scans


def _lb_env(n: int, rng) -> dict:
    L = len(tables.LB_VALUES)
    cls = rng.integers(-9, L, n)
    return {
        "cls": cls, "lead": rng.random(n) < 0.9, "attached": rng.random(n) < 0.1,
        "eff": rng.integers(0, L, n), "prev_raw": rng.integers(0, L, n), "prev": rng.integers(0, L, n),
        "before_sp": rng.integers(0, L, n), "prev2": rng.integers(0, L, n), "ri_run_prev": rng.integers(-3, 5, n),
        "nxt": rng.integers(0, L, n), "lead_ord": rng.integers(0, 4, n),
    }


def test_elementwise_map_lb_rules_equals_jax():
    """Random class streams covering every (prev, eff) pair of LB classes."""
    rng = np.random.default_rng(11)
    n = N
    env = {k: np.asarray(v, np.int32) for k, v in _lb_env(n, rng).items()}
    L = len(tables.LB_VALUES)
    pairs = np.arange(L * L)
    env["prev"][: L * L], env["eff"][: L * L] = pairs // L, pairs % L
    want = np.asarray(JL.elementwise_map({k: jnp.asarray(v) for k, v in env.items()}, JS._lb_rules, n, interpret=True))
    got = PL.elementwise_map({k: torch.from_numpy(v) for k, v in env.items()}, PS._lb_rules, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(want.sum()) < n


def test_lb_rules_kernel_enums_match_python():
    """The class and stream numbering of ``csrc/lbrules.cu`` equals the
    port's LB values tuple and the wrapper's stream order."""
    source = (Path(PC.__file__).resolve().parents[1] / "csrc" / "lbrules.cu").read_text()
    classes = {name: int(v) for name, v in re.findall(r"\bLB_(\w+)\s*=\s*(\d+)", source)}
    assert classes == {name: i for i, name in enumerate(tables.LB_VALUES)}
    streams = {name: int(v) for name, v in re.findall(r"\bLS_(\w+)\s*=\s*(\d+)", source)}
    assert streams.pop("count") == len(PC.LB_STREAMS)
    assert streams == {name: i for i, name in enumerate(PC.LB_STREAMS)}


def test_elementwise_map_on_a_card_needs_a_registered_kernel():
    assert PL._KERNELS[PS._lb_rules] is PC.lb_rules
    assert PS._graph_rules not in PL._KERNELS


# ---------------------------------------------------------------------------
# The lowering to the scan kernel's IR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_lowered_program_other_direction_equals_jax(name, text_streams):
    """Every program of ``ops/segment`` the other way round: the plain
    executor and the lowered program against the JAX kernel."""
    jax_ops, port_ops, reverse = PROGRAMS[name]
    _run_both(_program_inputs(name, text_streams), jax_ops, port_ops, N, not reverse)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_lowered_program_at_every_tile(name, text_streams):
    """The lowered program at each tile the kernel takes, over lengths at
    the tiles' seams, both ways, against the plain executor."""
    _, port_ops, _ = PROGRAMS[name]
    streams = _program_inputs(name, text_streams)
    for n in (1, 2047, 2049, 8193, 3 * 8192 + 77):
        cut = {k: v[:n] for k, v in streams.items()}
        for reverse in (False, True):
            want = PL.fused_scan_plain({k: torch.from_numpy(v) for k, v in cut.items()}, port_ops, n, reverse=reverse)
            for got in _lowered(cut, port_ops, n, reverse, tiles=(2048, 4096, 8192)):
                for key in want:
                    assert torch.equal(got[key], want[key]), (n, reverse, key)


def _typed_streams(n: int) -> dict:
    rng = np.random.default_rng(9)
    return {
        "u": torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8)),
        "i8": torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": torch.from_numpy(rng.integers(-30000, 30000, n).astype(np.int16)),
        "b": torch.from_numpy(rng.random(n) < 0.3),
        "v": torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)),
    }


TYPED_BUILDS = {
    # constants cast to the stream's dtype, as torch compares and wraps
    "u8-compare-negative": lambda e: (e["u"] == -9) | (e["u"] < 3),
    "u8-wraps": lambda e: e["u"] + 300,
    "i8-wraps": lambda e: e["i8"] * 3 - 1,
    "i8-invert": lambda e: ~e["i8"],
    "i16-mul": lambda e: e["i16"] * e["i16"],
    "bool-add-or": lambda e: e["b"] + e["b"],
    "bool-mul": lambda e: e["b"] * (e["u"] > 100),
    "bool-int-promote": lambda e: e["b"] + 1,
    "mixed-promote": lambda e: e["u"] - e["i8"],
    "i32-wraps": lambda e: e["v"] * 7 + e["v"],
    "where-scalars": lambda e: torch.where(e["b"], 5, -3),
    "where-nested": lambda e: torch.where(~e["b"], torch.where(e["u"] >= 128, e["i8"], e["u"]), 1000),
    "and-or-invert": lambda e: ~((e["u"] & 12) | (e["i8"] != 0)),
    "reflected": lambda e: 7 - e["u"] + (3 * e["i8"]) + (1 & e["u"]) + (2 | e["i8"]),
}


@pytest.mark.parametrize("build", sorted(TYPED_BUILDS))
@pytest.mark.parametrize("kind", ["sum", "max", "delay", "last2"])
def test_lowered_builds_keep_torch_dtypes(build, kind):
    """Builds over uint8, int8, int16, bool and int32 streams: the IR wraps,
    promotes and compares as torch does on the same tensors."""
    n = 3 * 2048 + 11
    inputs = _typed_streams(n)
    fn = TYPED_BUILDS[build]
    ops = (
        PL.Op("id", "x", fn),
        PL.Op(kind, "o", (lambda e: (e["x"], e["b"])) if kind == "last2" else (lambda e: e["x"] * 1), init=-5),
        PL.Op("sum", "raw", fn),
    )
    low = IR.lower(ops, {k: t.dtype for k, t in inputs.items()})
    for reverse in (False, True):
        want = PL.fused_scan_plain(inputs, ops, n, reverse=reverse)
        got = IR.run_lowered(low, inputs, n, reverse, tile=2048)
        for key in want:
            assert torch.equal(got[key], want[key]), (build, kind, reverse, key)


BAD_BUILDS = {
    "method": (lambda e: e["v"].to(torch.int64), ".to"),
    "torch-function": (lambda e: torch.cumsum(e["v"], 0), "torch.cumsum"),
    "floor-division": (lambda e: e["v"] // 2, "//"),
    "truth-value": (lambda e: e["v"] if e["f"] else e["f"], "truth value"),
    "float-constant": (lambda e: e["v"] * 1.5, "1.5"),
    "outside-tensor": (lambda e: e["v"] + torch.ones(3, dtype=torch.int32), "outside its env"),
    "int-condition": (lambda e: torch.where(e["v"], 1, 0), "torch.where"),
    "bool-subtract": (lambda e: e["f"] - e["f"], "sub"),
}


@pytest.mark.parametrize("case", sorted(BAD_BUILDS))
def test_lowering_rejects_what_the_kernel_cannot_run(case):
    """A build with another operation raises at lowering, naming the op and
    the operation."""
    fn, what = BAD_BUILDS[case]
    ops = (PL.Op("sum", "ok", lambda e: e["v"]), PL.Op("max", "bad_op", fn))
    with pytest.raises(IR.LoweringError, match=r"(?s)'bad_op'.*" + re.escape(what)):
        IR.lower(ops, {"v": torch.int32, "f": torch.bool})


def test_lowering_reads_only_present_streams_and_known_kinds():
    with pytest.raises(KeyError):
        IR.lower(PS._WS_OPS, {"tok": torch.bool})
    with pytest.raises(ValueError, match="unknown scan kind"):
        IR.lower((PL.Op("min", "m", lambda e: e["v"]),), {"v": torch.int32})
    with pytest.raises(IR.LoweringError, match="float"):
        IR.lower((PL.Op("sum", "s", lambda e: e["v"]),), {"v": torch.float32})


def test_outputs_names_what_the_call_returns():
    """``outputs`` filters the result and leaves it unchanged; the lowered
    program then writes only those streams."""
    rng = np.random.default_rng(4)
    n = 5000
    inputs = {"f": torch.from_numpy(rng.random(n) < 0.2), "v": torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))}
    ops = (
        PL.Op("sum", "s", lambda e: e["f"]),
        PL.Op("last2", "lv", lambda e: (e["s"] * 2 + e["v"], e["f"]), init=-5),
        PL.Op("delay", "d", lambda e: e["lv2"], init=-5),
    )
    whole = PL.fused_scan(inputs, ops, n, reverse=True)
    for outputs in (("d",), ("lv2", "s"), ("s", "lv", "lv2", "d")):
        for fn in (PL.fused_scan, PL.fused_scan_plain):
            got = fn(inputs, ops, n, reverse=True, outputs=outputs)
            assert sorted(got) == sorted(outputs)
            for key in outputs:
                assert torch.equal(got[key], whole[key])
        low = IR.lower(ops, {k: t.dtype for k, t in inputs.items()}, outputs)
        assert sorted(low.outputs) == sorted(outputs)
        assert int((low.scans[:, 8:10] >= 0).sum()) == len(outputs)
        got = IR.run_lowered(low, inputs, n, True, tile=2048)
        assert all(torch.equal(got[key], whole[key]) for key in outputs)
    with pytest.raises(KeyError):
        PL.fused_scan(inputs, ops, n, outputs=("nope",))
    with pytest.raises(KeyError):
        IR.lower(ops, {k: t.dtype for k, t in inputs.items()}, ("nope",))


def test_segment_callers_name_outputs_their_programs_make():
    for feats, ops in ((PS._GRAPH_FEATS, PS._GRAPH_OPS), (PS._WORD_FEATS, PS._WORD_OPS_FWD),
                       (PS._SENT_FEATS, PS._SENT_OPS_FWD), (PS._LB_FEATS, PS._LB_OPS_FWD)):
        made = {name for op in ops for name in op.outs}
        assert set(feats) <= made and len(set(feats)) == len(feats)


def test_lowering_stages_steps_and_slots():
    """Ops are scanned by stage, at most eight a step; a helper a build calls
    twice is computed once; a slot is reused once its stream is dead."""
    dtypes = {k: torch.int32 for k in ("cls", "incb")}
    dtypes.update({k: torch.bool for k in ("lead", "ri", "pict", "nonext", "ctl", "lnk", "nel")})
    low = IR.lower(PS._GRAPH_OPS, dtypes)
    scan_steps = low.steps[low.steps[:, 0] == IR.STEP_SCAN]
    assert len(low.scans) == sum(op.kind != "id" for op in PS._GRAPH_OPS)
    assert len(scan_steps) == 5 and scan_steps[:, 2].max() <= IR.MAX_STAGE_OPS
    assert sorted(low.inputs) == sorted(dtypes) and len(set(low.inputs)) == len(low.inputs)
    assert low.slots < len(low.inputs) + len(low.scans)
    assert low.outputs == tuple(name for op in PS._GRAPH_OPS for name in op.outs)
    sent = IR.lower(PS._SENT_OPS_FWD, {"cls": torch.int32, "keep": torch.bool, "lead": torch.bool, "ign": torch.bool,
                                       "ps": torch.bool})
    wheres = sent.steps[(sent.steps[:, 0] == IR.STEP_EW) & (sent.steps[:, 1] == IR.OPCODES["where"])]
    assert len(wheres) == 1  # _sent_eff_env, built by three ops, evaluated once
    lb = IR.lower(PS._LB_OPS_FWD, {"cls": torch.int32, "cm": torch.bool, "hard": torch.bool, "basemask": torch.bool,
                                   "lead": torch.bool})
    assert "effv" not in lb.outputs  # an id stream is never an output


def test_tile_follows_the_slots():
    """The most positions a thread whose slots leave room for two blocks an
    SM: single-op programs take 8,192-position tiles, the graphemes program
    (bool streams in byte slots, its delays written in place) 2,048, and
    1,024 with every stream an int32."""
    one = IR.lower((PL.Op("sum", "s", lambda e: e["v"]),), {"v": torch.int32})
    two = IR.lower((PL.Op("last2", "l", lambda e: (e["v"], e["f"])),), {"v": torch.int32, "f": torch.bool})
    flags = ("lead", "ri", "pict", "nonext", "ctl", "lnk", "nel")
    graph = IR.lower(PS._GRAPH_OPS, {"cls": torch.int32, "incb": torch.int32, **{k: torch.bool for k in flags}},
                     PS._GRAPH_FEATS)
    wide = IR.lower(PS._GRAPH_OPS, {k: torch.int32 for k in ("cls", "incb") + flags})
    assert (one.items, one.tile, two.items, graph.items, wide.items) == (32, 8192, 32, 8, 4)
    assert (one.slots, one.byte_slots, two.slots, two.byte_slots) == (1, 0, 2, 1)  # outputs in place of the values
    assert graph.byte_slots == len(flags) and wide.byte_slots < graph.byte_slots
    for low in (one, two, graph, wide):
        assert low.shared == IR.shared_limits(*IR.H100_SHARED)
        assert low.shared_bytes(low.items) <= low.shared[0]
        bigger = [i for i in IR.ITEMS if i > low.items]
        assert all(low.shared_bytes(i) > low.shared[0] for i in bigger)


@pytest.mark.parametrize("card,items", [((233472, 232448), 8), ((167936, 166912), 4), ((102400, 101376), 4)])
def test_tile_follows_the_card(card, items):
    """The tile follows the card's shared memory (an H100's, an A100's, a
    card of 100 KB an SM): the graphemes program keeps two blocks an SM
    where it can, else takes the most that fit one block, and its
    interpreted result is the same at every tile."""
    flags = ("lead", "ri", "pict", "nonext", "ctl", "lnk", "nel")
    dtypes = {"cls": torch.int32, "incb": torch.int32, **{k: torch.bool for k in flags}}
    low = IR.lower(PS._GRAPH_OPS, dtypes, PS._GRAPH_FEATS, shared=card)
    target, limit = low.shared
    assert low.items == items and low.shared_bytes(low.items) <= limit
    assert low.shared_bytes(low.items) <= target or all(low.shared_bytes(i) > target for i in IR.ITEMS)
    rng = np.random.default_rng(7)
    n = 3 * low.tile + 5
    inputs = {"cls": torch.from_numpy(rng.integers(0, 20, n).astype(np.int32)),
              "incb": torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)),
              **{k: torch.from_numpy(rng.random(n) < 0.3) for k in flags}}
    want = PL.fused_scan_plain(inputs, PS._GRAPH_OPS, n, outputs=PS._GRAPH_FEATS)
    got = IR.run_lowered(low, inputs, n)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
