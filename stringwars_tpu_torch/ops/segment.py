"""Segmentation: whitespace/newline splits, TR29 graphemes, words and
sentences, UAX#14 line breaks (K9).

The port of ``stringwars_tpu.ops.segment`` (reference rows
``tokenization/bench.rs:78-456``). Segmentation is a boundary-mask problem
in byte-position space: codepoints sit at their lead bytes, classes come from
the UCD tables (``unicode.tables``, looked up by ``ops/lut.class_map``),
and every pair rule is elementwise logic over feature streams: the class of
the previous codepoint, of the last non-ignorable one, run lengths, RI
parity and the like. Counts are mask sums.

The features have two routes, chosen by ``scanline`` (default: the scan
route on a card, the plain route on the CPU):

- the plain route (``_*_feats_plain``) mirrors the JAX package's
  ``_*_feats_xla``: each feature is its own torch scan (cumulative sums and
  maxima, gathers at the last flagged index);
- the scan route (``_*_feats_scan``) runs the JAX package's op programs
  through ``ops/scanline.fused_scan``: one launch of the CUDA kernel
  ``csrc/scanline.cu`` a program on a card, naming the outputs it reads.

The rule functions ``_graph_rules``, ``_word_rules`` and ``_sent_rules`` run
as torch elementwise ops on both routes, as in the JAX package. The UAX#14
rules ``_lb_rules`` run through ``elementwise_map`` on the scan route: the
kernel ``csrc/lbrules.cu`` on a card.

Class tables are staged once per (table, ``max_cp``, device), pruned to the
corpus' codepoint ceiling and narrowed to uint8. Codepoints above the table
(the invalid lead bytes 0xF5-0xFF decode above 0x10FFFF) take the last
entry's class, as on the TPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stringwars_tpu_torch.ops import scanline_cuda
from stringwars_tpu_torch.ops.lut import class_map, stage_table
from stringwars_tpu_torch.ops.rulemap import compile_steps
from stringwars_tpu_torch.ops.scanline import Op, elementwise_map, fused_scan, last_index, register_kernel
from stringwars_tpu_torch.ops.utf8 import _codepoints_at
from stringwars_tpu_torch.parallel.mesh import resolve_device
from stringwars_tpu_torch.unicode import tables

_CONT = -9  # class sentinel at continuation bytes (matches no rule)


def _use_scanline(scanline: bool | None, data: torch.Tensor) -> bool:
    """Feature route: the op programs on a card, the plain scans elsewhere,
    unless the caller names one."""
    return data.device.type == "cuda" if scanline is None else scanline


# ---------------------------------------------------------------------------
# Plain building blocks: the torch forms of the JAX package's XLA scans
# ---------------------------------------------------------------------------

def _cumsum_1d(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values if x.numel() else x


def _last_value(values: torch.Tensor, mask: torch.Tensor, init) -> torch.Tensor:
    """out[i] = values[j] for the largest j <= i with mask[j], else init."""
    j = last_index(mask)
    return torch.where(j >= 0, values[j.clamp(min=0)], init)


def _next_value(values: torch.Tensor, mask: torch.Tensor, init) -> torch.Tensor:
    """out[i] = values[j] for the smallest j >= i with mask[j], else init."""
    return _last_value(values.flip(0), mask.flip(0), init).flip(0)


def _shift_in(x: torch.Tensor, fill) -> torch.Tensor:
    """x[i - 1] at i, ``fill`` at 0 (``jnp.pad(x, (1, 0))[:n]``)."""
    return torch.cat([x.new_full((1,), fill), x[:-1]]) if x.numel() else x


def _shift_out(x: torch.Tensor, fill) -> torch.Tensor:
    """x[i + 1] at i, ``fill`` at n - 1 (``jnp.pad(x, (0, 1))[1:]``)."""
    return torch.cat([x[1:], x.new_full((1,), fill)]) if x.numel() else x


def _prev1(x: torch.Tensor, is_lead: torch.Tensor, default) -> torch.Tensor:
    """Value of ``x`` at the previous lead (strictly before each position)."""
    return _shift_in(_last_value(x, is_lead, default), default)


def _next1(x: torch.Tensor, is_lead: torch.Tensor, default) -> torch.Tensor:
    """Value of ``x`` at the next lead (strictly after each position)."""
    return _shift_out(_next_value(x, is_lead, default), default)


def _last_two_values(values: torch.Tensor, mask: torch.Tensor, init) -> tuple[torch.Tensor, torch.Tensor]:
    """(last, second_to_last) masked values at or before each position."""
    last = last_index(mask)
    second = torch.where(last >= 0, _shift_in(last, -1)[last.clamp(min=0)], -1)
    return (
        torch.where(last >= 0, values[last.clamp(min=0)], init),
        torch.where(second >= 0, values[second.clamp(min=0)], init),
    )


@functools.lru_cache(maxsize=None)
def _class_table(table_name: str, max_cp: int | None, device: torch.device) -> torch.Tensor:
    """The dense class table on ``device``, cut where its step function
    stops changing below ``max_cp`` (the JAX package's pruned rules)."""
    table = getattr(tables, table_name)()
    if isinstance(table, tuple):  # line_break_table returns (table, values)
        table = table[0]
    rules = compile_steps(np.asarray(table))
    if max_cp is not None:
        rules = rules.prune(max_cp)
    return stage_table(np.asarray(table)[: rules.size], device)


def _class_of(cps: torch.Tensor, table_name: str, max_cp: int | None = None) -> torch.Tensor:
    """Class lookup; ``max_cp`` (from staging) prunes the table to the
    corpus' codepoint ceiling."""
    return class_map(cps, _class_table(table_name, max_cp, cps.device))


def _byte_space(data: torch.Tensor, n: int):
    """(cp, is_lead, count): codepoints AT their lead-byte positions."""
    b = data[:n].to(torch.int32)
    is_lead = (b & 0xC0) != 0x80
    cp = _codepoints_at(b, n)
    return cp, is_lead, is_lead.sum(dtype=torch.int32)


def _lead_cls(cps, is_lead, table_name, max_cp):
    return torch.where(is_lead, _class_of(cps, table_name, max_cp), _CONT)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Whitespace / newline splitting
# ---------------------------------------------------------------------------

_WS_OPS = (
    Op("last", "ltok", lambda e: (e["tok"], e["lead"])),
    Op("delay", "ptok", lambda e: e["ltok"]),
)


def whitespace_token_count(
    data: torch.Tensor, n: int, *, max_cp: int | None = None, scanline: bool | None = None
) -> torch.Tensor:
    """Count of runs of non-whitespace codepoints (whitespace as ``str.isspace``:
    the 25 UCD White_Space codepoints plus U+001C-U+001F)."""
    cp, is_lead, _ = _byte_space(data, n)
    is_ws = _class_of(cp, "whitespace_table", max_cp) > 0
    tok = is_lead & ~is_ws
    if _use_scanline(scanline, data):
        prev_tok = fused_scan({"tok": tok, "lead": is_lead}, _WS_OPS, n, outputs=("ptok",))["ptok"] > 0
    else:
        prev_tok = _prev1(tok, is_lead, False)
    return _count(tok & ~prev_tok)


def newline_split_count(data: torch.Tensor, n: int, *, max_cp: int | None = None) -> torch.Tensor:
    """Count of segments delimited by Unicode newline functions
    (LF, VT, FF, CR, NEL, LS, PS; CRLF counts once)."""
    cp, is_lead, _ = _byte_space(data, n)
    nl = (_class_of(cp, "newline_table", max_cp) > 0) & is_lead
    # CR and LF are single-byte, so CRLF adjacency is byte adjacency.
    crlf = is_lead & (cp == 0x0D) & (_shift_out(cp, 0) == 0x0A)
    return _count(nl & ~crlf) + 1


# ---------------------------------------------------------------------------
# TR29 grapheme clusters
# ---------------------------------------------------------------------------

_G = {name: i for i, name in enumerate(tables.GCB_VALUES)}


def _graph_feats_plain(cls, pict, incb, is_lead, n):
    G = _G
    prev = _prev1(cls, is_lead, 0)
    ri = cls == G["Regional_Indicator"]
    s = _cumsum_1d(ri)
    base = _cummax(torch.where(~ri & is_lead, s, 0))
    ri_run_prev = _prev1(s - base, is_lead, 0)
    pe = _last_value(pict, (cls != G["Extend"]) & is_lead, False)
    pe_before_zwj = _prev1(_prev1(pe, is_lead, False), is_lead, False)
    ctl = (cls == G["Control"]) | (cls == G["CR"]) | (cls == G["LF"])
    ctl_prev = _prev1(ctl, is_lead, False)
    el = (incb == 1) | (incb == 2)  # Extend | Linker
    linker_cum = _cumsum_1d(incb == 2)
    incb_at_j = _prev1(_last_value(incb, ~el & is_lead, -1), is_lead, -1)
    cum_at_j = _prev1(_last_value(linker_cum, ~el & is_lead, 0), is_lead, 0)
    linker_at_prev = _prev1(linker_cum, is_lead, 0)
    return {
        "prev": prev,
        "ri_run_prev": ri_run_prev,
        "pe_before_zwj": pe_before_zwj,
        "ctl_prev": ctl_prev,
        "incb_at_j": incb_at_j,
        "cum_at_j": cum_at_j,
        "linker_at_prev": linker_at_prev,
        "lead_ord": _cumsum_1d(is_lead),
    }


# The outputs of each program that its caller reads (``fused_scan``'s
# ``outputs``: the kernel writes no other to device memory).
_GRAPH_FEATS = (
    "prev", "ri_run_prev", "pe_before_zwj", "ctl_prev", "incb_at_j", "cum_at_j", "linker_at_prev", "lead_ord",
)
_WORD_FEATS = ("prev_eff", "prev2_eff", "prev_raw", "prev_is_nl", "ri_run_prev_eff", "lead_ord")
_SENT_FEATS = (
    "effraw", "pk", "hk", "ctx_cls", "ctx9_cls", "prev_raw", "prev_eff", "prev2_eff", "prev_parasep", "lead_ord",
)
_LB_FEATS = (
    "base_cls", "has_base", "hard_at_base", "prev_raw", "prev", "before_sp", "prev2", "ri_run_prev", "lead_ord",
)

_GRAPH_OPS = (
    Op("last", "lcls", lambda e: (e["cls"], e["lead"])),
    Op("delay", "prev", lambda e: e["lcls"]),
    Op("sum", "s", lambda e: e["ri"]),
    Op("max", "base", lambda e: torch.where((e["ri"] == 0) & (e["lead"] > 0), e["s"], 0)),
    Op("last", "lrr", lambda e: (e["s"] - e["base"], e["lead"])),
    Op("delay", "ri_run_prev", lambda e: e["lrr"]),
    Op("last", "pe", lambda e: (e["pict"], e["nonext"])),
    Op("last", "lpe", lambda e: (e["pe"], e["lead"])),
    Op("delay", "pe1", lambda e: e["lpe"]),
    Op("last", "lpe1", lambda e: (e["pe1"], e["lead"])),
    Op("delay", "pe_before_zwj", lambda e: e["lpe1"]),
    Op("last", "lctl", lambda e: (e["ctl"], e["lead"])),
    Op("delay", "ctl_prev", lambda e: e["lctl"]),
    Op("sum", "linker_cum", lambda e: e["lnk"]),
    Op("last", "lincb", lambda e: (e["incb"], e["nel"]), init=-1),
    Op("last", "l2incb", lambda e: (e["lincb"], e["lead"]), init=-1),
    Op("delay", "incb_at_j", lambda e: e["l2incb"], init=-1),
    Op("last", "lcum", lambda e: (e["linker_cum"], e["nel"])),
    Op("last", "l2cum", lambda e: (e["lcum"], e["lead"])),
    Op("delay", "cum_at_j", lambda e: e["l2cum"]),
    Op("last", "llc", lambda e: (e["linker_cum"], e["lead"])),
    Op("delay", "linker_at_prev", lambda e: e["llc"]),
    Op("sum", "lead_ord", lambda e: e["lead"]),
)


def _graph_feats_scan(cls, pict, incb, is_lead, n):
    G = _G
    return fused_scan(
        {
            "cls": cls,
            "lead": is_lead,
            "pict": pict,
            "incb": incb,
            "ri": cls == G["Regional_Indicator"],
            "nonext": (cls != G["Extend"]) & is_lead,
            "ctl": (cls == G["Control"]) | (cls == G["CR"]) | (cls == G["LF"]),
            "lnk": incb == 2,
            "nel": ~((incb == 1) | (incb == 2)) & is_lead,
        },
        _GRAPH_OPS,
        n,
        outputs=_GRAPH_FEATS,
    )


def grapheme_boundaries(
    data: torch.Tensor, n: int, *, max_cp: int | None = None, scanline: bool | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(boundary bool[n], cluster_count) over ``data[:n]`` (UTF-8): a
    grapheme cluster starts at byte offset i where ``boundary[i]``."""
    cp, is_lead, _ = _byte_space(data, n)
    cls = _lead_cls(cp, is_lead, "grapheme_break_table", max_cp)
    pict = (_class_of(cp, "extended_pictographic_table", max_cp) > 0) & is_lead
    incb = _lead_cls(cp, is_lead, "incb_table", max_cp)
    feats_fn = _graph_feats_scan if _use_scanline(scanline, data) else _graph_feats_plain
    feats = feats_fn(cls, pict, incb, is_lead, n)
    env = {"cls": cls, "pict": pict, "incb": incb, "lead": is_lead}
    env.update({k: feats[k] for k in (
        "prev", "ri_run_prev", "pe_before_zwj", "ctl_prev", "incb_at_j", "cum_at_j", "linker_at_prev", "lead_ord"
    )})
    boundary = _graph_rules(env)
    return boundary, _count(boundary)


def _graph_rules(e):
    """TR29 grapheme pair rules, elementwise over the feature env."""
    G = _G
    cls = e["cls"]
    incb = e["incb"]
    is_lead = e["lead"] > 0
    pict = e["pict"] > 0
    prev = e["prev"]
    ri = cls == G["Regional_Indicator"]
    pe_before_zwj = e["pe_before_zwj"] > 0
    ctl = (cls == G["Control"]) | (cls == G["CR"]) | (cls == G["LF"])
    ctl_prev = e["ctl_prev"] > 0

    # GB3: CR x LF
    no_break = (prev == G["CR"]) & (cls == G["LF"])
    gb45 = (ctl_prev | ctl) & ~no_break
    # GB6-8 Hangul
    hangul = (
        ((prev == G["L"]) & ((cls == G["L"]) | (cls == G["V"]) | (cls == G["LV"]) | (cls == G["LVT"])))
        | (((prev == G["LV"]) | (prev == G["V"])) & ((cls == G["V"]) | (cls == G["T"])))
        | (((prev == G["LVT"]) | (prev == G["T"])) & (cls == G["T"]))
    )
    # GB9 / 9a / 9b
    attach = (cls == G["Extend"]) | (cls == G["ZWJ"]) | (cls == G["SpacingMark"])
    prepend = prev == G["Prepend"]
    # GB11
    zwj_pict = (prev == G["ZWJ"]) & pict & pe_before_zwj
    # GB12/13
    ri_pair = (prev == G["Regional_Indicator"]) & ri & ((e["ri_run_prev"] % 2) == 1)
    # GB9c (Unicode 15.1 Indic conjuncts): Consonant [Extend|Linker]*
    # Linker [Extend|Linker]* x Consonant.
    conjunct = (incb == 3) & (e["incb_at_j"] == 3) & ((e["linker_at_prev"] - e["cum_at_j"]) >= 1)

    no_break |= (~gb45) & (hangul | attach | prepend | zwj_pict | ri_pair | conjunct)
    boundary = ~no_break & is_lead
    boundary |= is_lead & (e["lead_ord"] == 1)
    return boundary


def _byte_segments(text: str, boundary_fn, device) -> list[str]:
    """Split ``text`` at the byte-offset boundaries a byte-space function
    returns (boundaries land on lead bytes, so slices are valid UTF-8)."""
    raw = text.encode()
    n = len(raw)
    if n == 0:
        return []
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(resolve_device(device))
    boundary, _ = boundary_fn(data, n)
    starts = np.flatnonzero(boundary.cpu().numpy())
    ends = np.append(starts[1:], n)
    return [raw[s:e].decode("utf-8") for s, e in zip(starts, ends)]


def grapheme_clusters(text: str, device: str = "cuda") -> list[str]:
    """Host API: split a string into grapheme clusters."""
    return _byte_segments(text, grapheme_boundaries, device)


# ---------------------------------------------------------------------------
# TR29 word boundaries
# ---------------------------------------------------------------------------

_W = {name: i for i, name in enumerate(tables.WB_VALUES)}


def _word_feats_plain(cls, keep, is_lead, newline, ri, basemask, n):
    last_cls, prev2_cls = _last_two_values(cls, keep, -1)
    s = _cumsum_1d(ri)
    base = _cummax(torch.where(basemask, s, 0))
    return {
        "prev_eff": _shift_in(last_cls, -1),
        "prev2_eff": _shift_in(prev2_cls, -1),
        "next_eff": _shift_out(_next_value(cls, keep, -1), -1),
        "prev_raw": _prev1(cls, is_lead, 0),
        "prev_is_nl": _prev1(newline, is_lead, False),
        "ri_run_prev_eff": _shift_in(_last_value(s - base, keep, 0), 0),
        "lead_ord": _cumsum_1d(is_lead),
    }


_WORD_OPS_FWD = (
    Op("last2", "lc", lambda e: (e["cls"], e["keep"]), init=-1),
    Op("delay", "prev_eff", lambda e: e["lc"], init=-1),
    Op("delay", "prev2_eff", lambda e: e["lc2"], init=-1),
    Op("last", "lraw", lambda e: (e["cls"], e["lead"])),
    Op("delay", "prev_raw", lambda e: e["lraw"]),
    Op("last", "lnl", lambda e: (e["nl"], e["lead"])),
    Op("delay", "prev_is_nl", lambda e: e["lnl"]),
    Op("sum", "s", lambda e: e["ri"]),
    Op("max", "base", lambda e: torch.where(e["basemask"] > 0, e["s"], 0)),
    Op("last", "lrr", lambda e: (e["s"] - e["base"], e["keep"])),
    Op("delay", "ri_run_prev_eff", lambda e: e["lrr"]),
    Op("sum", "lead_ord", lambda e: e["lead"]),
)

_WORD_OPS_BWD = (
    Op("last", "nc", lambda e: (e["cls"], e["keep"]), init=-1),
    Op("delay", "next_eff", lambda e: e["nc"], init=-1),
)


def _word_feats_scan(cls, keep, is_lead, newline, ri, basemask, n):
    feats = fused_scan(
        {"cls": cls, "keep": keep, "lead": is_lead, "nl": newline, "ri": ri, "basemask": basemask},
        _WORD_OPS_FWD,
        n,
        outputs=_WORD_FEATS,
    )
    bwd = fused_scan({"cls": cls, "keep": keep}, _WORD_OPS_BWD, n, reverse=True, outputs=("next_eff",))
    feats["next_eff"] = bwd["next_eff"]
    return feats


def word_boundaries(
    data: torch.Tensor, n: int, *, max_cp: int | None = None, scanline: bool | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(boundary bool[n], word_segment_count) per TR29 word rules: a word
    boundary lies before byte offset i where ``boundary[i]``."""
    cp, is_lead, _ = _byte_space(data, n)
    cls = _lead_cls(cp, is_lead, "word_break_table", max_cp)
    pict = (_class_of(cp, "extended_pictographic_table", max_cp) > 0) & is_lead
    W = _W
    ignore = (cls == W["Extend"]) | (cls == W["Format"]) | (cls == W["ZWJ"])
    newline = (cls == W["CR"]) | (cls == W["LF"]) | (cls == W["Newline"])
    keep = ~ignore & is_lead
    ri = (cls == W["Regional_Indicator"]) & ~ignore
    basemask = ~ri & ~ignore & is_lead
    feats_fn = _word_feats_scan if _use_scanline(scanline, data) else _word_feats_plain
    feats = feats_fn(cls, keep, is_lead, newline, ri, basemask, n)
    env = {"cls": cls, "pict": pict, "lead": is_lead}
    env.update({k: feats[k] for k in (
        "prev_eff", "prev2_eff", "next_eff", "prev_raw", "prev_is_nl", "ri_run_prev_eff", "lead_ord"
    )})
    boundary = _word_rules(env)
    return boundary, _count(boundary)


def _word_rules(e):
    """TR29 word pair rules, elementwise over the feature env."""
    W = _W
    cls = e["cls"]
    is_lead = e["lead"] > 0
    pict = e["pict"] > 0
    prev_is_nl = e["prev_is_nl"] > 0
    prev_raw = e["prev_raw"]
    next_eff = e["next_eff"]
    ri_run_prev_eff = e["ri_run_prev_eff"]
    ignore = (cls == W["Extend"]) | (cls == W["Format"]) | (cls == W["ZWJ"])
    newline = (cls == W["CR"]) | (cls == W["LF"]) | (cls == W["Newline"])

    def isin(c, names):
        out = c == W[names[0]]
        for name in names[1:]:
            out = out | (c == W[name])
        return out

    AH = ("ALetter", "Hebrew_Letter")
    MidNumLetQ = ("MidNumLet", "Single_Quote")

    # WB3: CR x LF
    wb3 = (prev_raw == W["CR"]) & (cls == W["LF"])
    no_break = wb3
    # WB3a/3b: breaks around newlines (dominates everything except WB3).
    wb3ab = (prev_is_nl | newline) & ~wb3
    # WB3c: ZWJ x ExtPict (raw adjacency)
    no_break = no_break | ((prev_raw == W["ZWJ"]) & pict)
    # WB3d: WSegSpace x WSegSpace (raw adjacency)
    no_break = no_break | ((prev_raw == W["WSegSpace"]) & (cls == W["WSegSpace"]))
    # WB4: X (Extend|Format|ZWJ)* -> no break before ignorables (X may
    # itself be an ignorable; after sot or a newline WB3a/3b decide).
    no_break = no_break | (ignore & (e["lead_ord"] > 1) & ~prev_is_nl)
    # Rules on effective classes (current must be non-ignored).
    cur = torch.where(ignore, -2, cls)
    pe, p2 = e["prev_eff"], e["prev2_eff"]
    nb = isin(pe, AH) & isin(cur, AH)  # WB5
    nb |= isin(pe, AH) & (isin(cur, ("MidLetter",)) | isin(cur, MidNumLetQ)) & isin(next_eff, AH)  # WB6
    nb |= (isin(p2, AH) & (isin(pe, ("MidLetter",)) | isin(pe, MidNumLetQ))) & isin(cur, AH)  # WB7
    nb |= (pe == W["Hebrew_Letter"]) & (cur == W["Single_Quote"])  # WB7a
    nb |= (pe == W["Hebrew_Letter"]) & (cur == W["Double_Quote"]) & (next_eff == W["Hebrew_Letter"])  # WB7b
    nb |= (p2 == W["Hebrew_Letter"]) & (pe == W["Double_Quote"]) & (cur == W["Hebrew_Letter"])  # WB7c
    nb |= (pe == W["Numeric"]) & (cur == W["Numeric"])  # WB8
    nb |= isin(pe, AH) & (cur == W["Numeric"])  # WB9
    nb |= (pe == W["Numeric"]) & isin(cur, AH)  # WB10
    nb |= (p2 == W["Numeric"]) & (isin(pe, ("MidNum",)) | isin(pe, MidNumLetQ)) & (cur == W["Numeric"])  # WB11
    nb |= (pe == W["Numeric"]) & (isin(cur, ("MidNum",)) | isin(cur, MidNumLetQ)) & (next_eff == W["Numeric"])  # WB12
    nb |= (pe == W["Katakana"]) & (cur == W["Katakana"])  # WB13
    nb |= isin(pe, ("ALetter", "Hebrew_Letter", "Numeric", "Katakana", "ExtendNumLet")) & (cur == W["ExtendNumLet"])  # WB13a
    nb |= (pe == W["ExtendNumLet"]) & isin(cur, ("ALetter", "Hebrew_Letter", "Numeric", "Katakana"))  # WB13b
    nb |= (pe == W["Regional_Indicator"]) & (cur == W["Regional_Indicator"]) & ((ri_run_prev_eff % 2) == 1)  # WB15/16
    no_break = no_break | (nb & ~wb3ab)

    boundary = ~no_break & is_lead
    boundary |= is_lead & (e["lead_ord"] == 1)
    return boundary


def word_segments(text: str, device: str = "cuda") -> list[str]:
    """Host API: split into TR29 word segments (including space runs)."""
    return _byte_segments(text, word_boundaries, device)


# ---------------------------------------------------------------------------
# TR29 sentence boundaries (SB1-SB11; default is NO break, SB998)
# ---------------------------------------------------------------------------

_S = {name: i for i, name in enumerate(tables.SB_VALUES)}


def _sent_eff_env(e):
    """Effective class (SB5 attachment) derived from scan-env entries."""
    return torch.where((e["ign"] > 0) & (e["pk"] > 0) & (e["hk"] > 0), _S["Other"], e["effraw"])


def _sent_feats_plain(cls, keep, is_lead, ign, parasep, n):
    S = _S
    other = S["Other"]
    eff = _last_value(cls, keep, other)
    parasep_at_keep = _last_value(parasep, keep, False)
    has_keep = last_index(keep) >= 0
    eff = torch.where(ign & parasep_at_keep & has_keep, other, eff)
    _, prev2_c = _last_two_values(cls, keep, other)
    # Backward context at prev: skip Sp*, then Close*, then test SATerm.
    f_ctx = _last_value(eff, (eff != S["Close"]) & is_lead, other)
    g_ctx = _last_value(f_ctx, (eff != S["Sp"]) & is_lead, other)
    return {
        "eff": eff,
        "ctx_cls": _shift_in(g_ctx, other),
        "ctx9_cls": _shift_in(f_ctx, other),
        "prev_raw": _prev1(cls, is_lead, other),
        "prev_eff": _prev1(eff, is_lead, other),
        "prev2_eff": _shift_in(prev2_c, other),
        "prev_parasep": _prev1(parasep, is_lead, False),
        "lead_ord": _cumsum_1d(is_lead),
    }


def _sent_ops_fwd():
    S = _S
    other = S["Other"]
    return (
        Op("last", "effraw", lambda e: (e["cls"], e["keep"]), init=other),
        Op("last", "pk", lambda e: (e["ps"], e["keep"])),
        Op("max", "hk", lambda e: e["keep"]),
        Op("last", "fctx", lambda e: (
            _sent_eff_env(e), (_sent_eff_env(e) != S["Close"]) & (e["lead"] > 0)
        ), init=other),
        Op("last", "gctx", lambda e: (
            e["fctx"], (_sent_eff_env(e) != S["Sp"]) & (e["lead"] > 0)
        ), init=other),
        Op("delay", "ctx_cls", lambda e: e["gctx"], init=other),
        Op("delay", "ctx9_cls", lambda e: e["fctx"], init=other),
        Op("last", "lraw", lambda e: (e["cls"], e["lead"]), init=other),
        Op("delay", "prev_raw", lambda e: e["lraw"], init=other),
        Op("last", "leff", lambda e: (_sent_eff_env(e), e["lead"]), init=other),
        Op("delay", "prev_eff", lambda e: e["leff"], init=other),
        Op("last2", "l2", lambda e: (e["cls"], e["keep"]), init=other),
        Op("delay", "prev2_eff", lambda e: e["l22"], init=other),
        Op("last", "lps", lambda e: (e["ps"], e["lead"])),
        Op("delay", "prev_parasep", lambda e: e["lps"]),
        Op("sum", "lead_ord", lambda e: e["lead"]),
    )


_SENT_OPS_FWD = _sent_ops_fwd()

_SENT_OPS_BWD = (
    Op("last", "next_stop_cls", lambda e: (e["eff"], e["stop"]), init=_S["Other"]),
)


def _sent_feats_scan(cls, keep, is_lead, ign, parasep, n):
    feats = fused_scan(
        {"cls": cls, "keep": keep, "lead": is_lead, "ign": ign, "ps": parasep}, _SENT_OPS_FWD, n, outputs=_SENT_FEATS
    )
    feats["eff"] = torch.where(ign & (feats["pk"] > 0) & (feats["hk"] > 0), _S["Other"], feats["effraw"])
    return feats


def sentence_boundaries(
    data: torch.Tensor, n: int, *, max_cp: int | None = None, scanline: bool | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(boundary bool[n], sentence_count) per TR29 sentence rules."""
    cp, is_lead, _ = _byte_space(data, n)
    cls = _lead_cls(cp, is_lead, "sentence_break_table", max_cp)
    S = _S
    ign = (cls == S["Extend"]) | (cls == S["Format"])
    parasep = (cls == S["Sep"]) | (cls == S["CR"]) | (cls == S["LF"])
    keep = ~ign & is_lead

    use_scan = _use_scanline(scanline, data)
    feats = (_sent_feats_scan if use_scan else _sent_feats_plain)(cls, keep, is_lead, ign, parasep, n)
    eff = feats["eff"]
    # SB8 lookahead: the first "stopper" at or after each position.
    stopper = (
        (eff == S["OLetter"]) | (eff == S["Upper"]) | (eff == S["Lower"])
        | parasep | (eff == S["ATerm"]) | (eff == S["STerm"])
    )
    if use_scan:
        next_stop_cls = fused_scan(
            {"eff": eff, "stop": stopper & is_lead}, _SENT_OPS_BWD, n, reverse=True, outputs=("next_stop_cls",)
        )["next_stop_cls"]
    else:
        next_stop_cls = _next_value(eff, stopper & is_lead, S["Other"])
    env = {"cls": cls, "lead": is_lead, "eff": eff, "next_stop_cls": next_stop_cls}
    env.update({k: feats[k] for k in (
        "ctx_cls", "ctx9_cls", "prev_raw", "prev_eff", "prev2_eff", "prev_parasep", "lead_ord"
    )})
    boundary = _sent_rules(env)
    return boundary, _count(boundary)


def _sent_rules(e):
    """TR29 sentence rules (SB3-SB11), lowest to highest precedence."""
    S = _S
    cls = e["cls"]
    is_lead = e["lead"] > 0
    cur = e["eff"]
    ctx_cls, ctx9_cls = e["ctx_cls"], e["ctx9_cls"]
    prev_eff, prev2_eff = e["prev_eff"], e["prev2_eff"]
    prev_parasep = e["prev_parasep"] > 0
    ign = (cls == S["Extend"]) | (cls == S["Format"])
    parasep = (cls == S["Sep"]) | (cls == S["CR"]) | (cls == S["LF"])
    saterm_ctx = (ctx_cls == S["ATerm"]) | (ctx_cls == S["STerm"])
    aterm_ctx = ctx_cls == S["ATerm"]
    saterm_ctx9 = (ctx9_cls == S["ATerm"]) | (ctx9_cls == S["STerm"])

    boundary = torch.zeros_like(is_lead)  # SB998: no break
    # SB11: SATerm Close* Sp* ÷ (anything not matched below).
    boundary = torch.where(saterm_ctx, True, boundary)
    # SB10: ... x (Sp | ParaSep).
    boundary = torch.where(saterm_ctx & ((cur == S["Sp"]) | parasep), False, boundary)
    # SB9: SATerm Close* x (Close | Sp | ParaSep).
    boundary = torch.where(saterm_ctx9 & ((cur == S["Close"]) | (cur == S["Sp"]) | parasep), False, boundary)
    # SB8a: ... x (SContinue | SATerm).
    boundary = torch.where(
        saterm_ctx & ((cur == S["SContinue"]) | (cur == S["ATerm"]) | (cur == S["STerm"])), False, boundary
    )
    # SB8: ATerm Close* Sp* x (not-stopper)* Lower.
    boundary = torch.where(aterm_ctx & (e["next_stop_cls"] == S["Lower"]), False, boundary)
    # SB7: (Upper|Lower) ATerm x Upper.
    boundary = torch.where(
        ((prev2_eff == S["Upper"]) | (prev2_eff == S["Lower"])) & (prev_eff == S["ATerm"]) & (cur == S["Upper"]),
        False,
        boundary,
    )
    # SB6: ATerm x Numeric.
    boundary = torch.where((prev_eff == S["ATerm"]) & (cur == S["Numeric"]), False, boundary)
    # SB5: x (Extend | Format), unless after ParaSep.
    boundary = torch.where(ign & ~prev_parasep, False, boundary)
    # SB4: ParaSep ÷.
    boundary = torch.where(prev_parasep, True, boundary)
    # SB3: CR x LF.
    boundary = torch.where((e["prev_raw"] == S["CR"]) & (cls == S["LF"]), False, boundary)

    out = boundary & is_lead
    out |= is_lead & (e["lead_ord"] == 1)
    return out


def sentence_segments(text: str, device: str = "cuda") -> list[str]:
    """Host API: split a string into TR29 sentence segments."""
    return _byte_segments(text, sentence_boundaries, device)


# ---------------------------------------------------------------------------
# UAX#14 line-break opportunities (core rule set LB1-LB31)
# ---------------------------------------------------------------------------

_L = {name: i for i, name in enumerate(tables.LB_VALUES)}


def _lb_feats_plain(cls, cm, hard, base_mask, is_lead, n):
    L = _L
    base_cls = _last_value(cls, base_mask, L["AL"])
    has_base = last_index(base_mask) >= 0
    hard_at_base = _last_value(hard, base_mask, False)
    attached = cm & has_base & ~hard_at_base
    eff = torch.where(cm, torch.where(attached, base_cls, L["AL"]), cls)  # LB10: lone CM -> AL
    prev = _prev1(eff, is_lead, L["BK"])
    ri = eff == L["RI"]
    s = _cumsum_1d(ri)
    base = _cummax(torch.where(~ri & is_lead, s, 0))
    return {
        "attached": attached,
        "eff": eff,
        "prev_raw": _prev1(cls, is_lead, L["BK"]),
        "prev": prev,
        # SP*-skipping context (LB8/14/16/17): class before the space run.
        "before_sp": _shift_in(_last_value(eff, (eff != L["SP"]) & is_lead, L["BK"]), L["BK"]),
        "prev2": _prev1(prev, is_lead, L["BK"]),
        "ri_run_prev": _prev1(s - base, is_lead, 0),
        "nxt": _next1(eff, is_lead, L["BK"]),
        "lead_ord": _cumsum_1d(is_lead),
    }


def _lb_eff_env(e, L):
    attached = (e["cm"] > 0) & (e["has_base"] > 0) & (e["hard_at_base"] == 0)
    return torch.where(e["cm"] > 0, torch.where(attached, e["base_cls"], L["AL"]), e["cls"])


def _lb_ops():
    L = _L
    bk, al = L["BK"], L["AL"]
    sp, ri_c = L["SP"], L["RI"]
    fwd = (
        Op("last", "base_cls", lambda e: (e["cls"], e["basemask"]), init=al),
        Op("max", "has_base", lambda e: e["basemask"]),
        Op("last", "hard_at_base", lambda e: (e["hard"], e["basemask"])),
        # eff computed ONCE; later ops reference the env entry.
        Op("id", "effv", functools.partial(_lb_eff_env, L=L)),
        Op("last", "lraw", lambda e: (e["cls"], e["lead"]), init=bk),
        Op("delay", "prev_raw", lambda e: e["lraw"], init=bk),
        Op("last", "leff", lambda e: (e["effv"], e["lead"]), init=bk),
        Op("delay", "prev", lambda e: e["leff"], init=bk),
        Op("last", "lbsp", lambda e: (e["effv"], (e["effv"] != sp) & (e["lead"] > 0)), init=bk),
        Op("delay", "before_sp", lambda e: e["lbsp"], init=bk),
        Op("last", "lprev2", lambda e: (e["prev"], e["lead"]), init=bk),
        Op("delay", "prev2", lambda e: e["lprev2"], init=bk),
        Op("sum", "s", lambda e: e["effv"] == ri_c),
        Op("max", "sbase", lambda e: torch.where((e["effv"] != ri_c) & (e["lead"] > 0), e["s"], 0)),
        Op("last", "lrr", lambda e: (e["s"] - e["sbase"], e["lead"])),
        Op("delay", "ri_run_prev", lambda e: e["lrr"]),
        Op("sum", "lead_ord", lambda e: e["lead"]),
    )
    bwd = (
        Op("last", "nv", lambda e: (e["eff"], e["lead"]), init=bk),
        Op("delay", "nxt", lambda e: e["nv"], init=bk),
    )
    return fwd, bwd


_LB_OPS_FWD, _LB_OPS_BWD = _lb_ops()


def _lb_feats_scan(cls, cm, hard, base_mask, is_lead, n):
    L = _L
    feats = fused_scan(
        {"cls": cls, "cm": cm, "hard": hard, "basemask": base_mask, "lead": is_lead}, _LB_OPS_FWD, n, outputs=_LB_FEATS
    )
    attached = cm & (feats["has_base"] > 0) & (feats["hard_at_base"] == 0)
    feats["attached"] = attached
    feats["eff"] = torch.where(cm, torch.where(attached, feats["base_cls"], L["AL"]), cls)
    feats["nxt"] = fused_scan(
        {"eff": feats["eff"], "lead": is_lead}, _LB_OPS_BWD, n, reverse=True, outputs=("nxt",)
    )["nxt"]
    return feats


def _lb_classes(cp: torch.Tensor, is_lead: torch.Tensor, max_cp: int | None) -> torch.Tensor:
    """UAX#14 classes after LB1 resolution (AI/SA/XX -> AL, CJ -> NS)."""
    L = _L
    cls = _class_of(cp, "line_break_table", max_cp)
    cls = torch.where((cls == L["AI"]) | (cls == L["SA"]) | (cls == L["XX"]), L["AL"], cls)
    cls = torch.where(cls == L["CJ"], L["NS"], cls)
    return torch.where(is_lead, cls, _CONT)


def linebreak_opportunities(
    data: torch.Tensor, n: int, *, max_cp: int | None = None, scanline: bool | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(break_allowed bool[n], opportunity_count) per UAX#14 core rules:
    a line may break before byte offset i where ``break_allowed[i]``
    (mandatory breaks included). LB1 class resolution and the pair rules
    LB4-LB31, with LB15 in its UCD 15.0 form and LB25 as pairs plus the
    (PR|PO) x (OP|HY) NU lookahead; LB28a is left out, as in the JAX
    package (its classes exist from UCD 15.1)."""
    L = _L
    cp, is_lead, _ = _byte_space(data, n)
    cls = _lb_classes(cp, is_lead, max_cp)
    # LB9: X CM* -> X (CM/ZWJ attach to base unless base is BK/CR/LF/NL/SP/ZW).
    cm = (cls == L["CM"]) | (cls == L["ZWJ"])
    hard = (
        (cls == L["BK"]) | (cls == L["CR"]) | (cls == L["LF"]) | (cls == L["NL"])
        | (cls == L["SP"]) | (cls == L["ZW"])
    )
    base_mask = ~cm & is_lead
    use_scan = _use_scanline(scanline, data)
    feats = (_lb_feats_scan if use_scan else _lb_feats_plain)(cls, cm, hard, base_mask, is_lead, n)
    env = {"cls": cls, "lead": is_lead}
    env.update({k: feats[k] for k in (
        "attached", "eff", "prev_raw", "prev", "before_sp", "prev2", "ri_run_prev", "nxt", "lead_ord"
    )})
    breaks = elementwise_map(env, _lb_rules, n) > 0 if use_scan else _lb_rules(env)
    return breaks, _count(breaks)


def _lb_rules(e):
    """UAX#14 pair rules LB4-LB31, elementwise over the feature env (the
    kernel ``csrc/lbrules.cu`` writes the same rules out in CUDA)."""
    L = _L
    cls = e["cls"]
    is_lead = e["lead"] > 0
    attached = e["attached"] > 0
    eff = e["eff"]
    prev_raw = e["prev_raw"]
    prev = e["prev"]
    before_sp = e["before_sp"]
    prev2 = e["prev2"]
    ri_run_prev = e["ri_run_prev"]
    ri = eff == L["RI"]

    def isin(c, names):
        out = c == L[names[0]]
        for name in names[1:]:
            out = out | (c == L[name])
        return out

    mandatory_prev = isin(prev_raw, ("BK", "CR", "LF", "NL")) & ~((prev_raw == L["CR"]) & (cls == L["LF"]))

    # LB6: x (BK|CR|LF|NL); LB5 CRxLF folded in via mandatory_prev.
    no_break = isin(eff, ("BK", "CR", "LF", "NL"))
    no_break |= isin(eff, ("SP", "ZW"))  # LB7: x SP, x ZW.
    no_break |= prev_raw == L["ZWJ"]  # LB8a: ZWJ x.
    no_break |= attached  # LB9 attachment: x CM (attached).
    no_break |= (eff == L["WJ"]) | (prev == L["WJ"])  # LB11
    no_break |= prev == L["GL"]  # LB12
    no_break |= (eff == L["GL"]) & ~isin(prev, ("SP", "BA", "HY"))  # LB12a
    no_break |= isin(eff, ("CL", "CP", "EX", "IS", "SY"))  # LB13
    no_break |= before_sp == L["OP"]  # LB14: OP SP* x.
    no_break |= isin(before_sp, ("CL", "CP")) & (eff == L["NS"])  # LB16
    no_break |= (before_sp == L["B2"]) & (eff == L["B2"])  # LB17
    no_break |= (before_sp == L["QU"]) & (eff == L["OP"])  # LB15 (UCD 15.0 form)
    no_break |= (eff == L["QU"]) | (prev == L["QU"])  # LB19
    no_break |= isin(eff, ("BA", "HY", "NS")) | (prev == L["BB"])  # LB21
    no_break |= (prev2 == L["HL"]) & isin(prev, ("HY", "BA"))  # LB21a
    no_break |= (prev == L["SY"]) & (eff == L["HL"])  # LB21b
    no_break |= eff == L["IN"]  # LB22
    no_break |= isin(prev, ("AL", "HL")) & (eff == L["NU"])  # LB23
    no_break |= (prev == L["NU"]) & isin(eff, ("AL", "HL"))
    no_break |= (prev == L["PR"]) & isin(eff, ("ID", "EB", "EM"))  # LB23a
    no_break |= isin(prev, ("ID", "EB", "EM")) & (eff == L["PO"])
    no_break |= isin(prev, ("PR", "PO")) & isin(eff, ("AL", "HL"))  # LB24
    no_break |= isin(prev, ("AL", "HL")) & isin(eff, ("PR", "PO"))
    no_break |= isin(prev, ("PR", "PO", "OP", "HY", "NU", "SY", "IS")) & (eff == L["NU"])  # LB25 pairs
    no_break |= (prev == L["NU"]) & isin(eff, ("NU", "SY", "IS", "CL", "CP", "PO", "PR"))
    no_break |= isin(prev, ("CL", "CP")) & isin(eff, ("PO", "PR"))
    # LB25 lookahead: (PR|PO) x (OP|HY) NU ("$ (100)", "US$-10").
    no_break |= isin(prev, ("PR", "PO")) & isin(eff, ("OP", "HY")) & (e["nxt"] == L["NU"])
    no_break |= (prev == L["JL"]) & isin(eff, ("JL", "JV", "H2", "H3"))  # LB26
    no_break |= isin(prev, ("JV", "H2")) & isin(eff, ("JV", "JT"))
    no_break |= isin(prev, ("JT", "H3")) & (eff == L["JT"])
    no_break |= isin(prev, ("JL", "JV", "JT", "H2", "H3")) & (eff == L["PO"])  # LB27
    no_break |= (prev == L["PR"]) & isin(eff, ("JL", "JV", "JT", "H2", "H3"))
    no_break |= isin(prev, ("AL", "HL")) & isin(eff, ("AL", "HL"))  # LB28
    no_break |= (prev == L["IS"]) & isin(eff, ("AL", "HL"))  # LB29
    no_break |= isin(prev, ("AL", "HL", "NU")) & (eff == L["OP"])  # LB30
    no_break |= (prev == L["CP"]) & isin(eff, ("AL", "HL", "NU"))
    no_break |= (prev == L["RI"]) & ri & ((ri_run_prev % 2) == 1)  # LB30a: RI x RI (pairs).
    no_break |= (prev == L["EB"]) & (eff == L["EM"])  # LB30b
    # LB20: break before/after CB (except LB8a/9 above).
    cb_break = ((eff == L["CB"]) | (prev == L["CB"])) & ~attached & (prev_raw != L["ZWJ"])
    no_break &= ~cb_break

    breaks = ~no_break
    breaks |= mandatory_prev  # LB4/5: mandatory after BK/CR/LF/NL.
    breaks |= (before_sp == L["ZW"]) | (prev == L["ZW"])  # LB8: ZW SP* ÷.
    breaks &= is_lead
    breaks &= ~(is_lead & (e["lead_ord"] == 1))  # LB2: no break at sot
    return breaks


register_kernel(_lb_rules, scanline_cuda.lb_rules)


def line_break_positions(text: str, device: str = "cuda") -> list[int]:
    """Host API: codepoint indices where a line break is allowed."""
    raw = text.encode()
    n = len(raw)
    if n == 0:
        return []
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(resolve_device(device))
    breaks, _ = linebreak_opportunities(data, n)
    lead = (np.frombuffer(raw, np.uint8) & 0xC0) != 0x80
    cp_index = np.cumsum(lead) - 1  # codepoint index of each lead byte
    return cp_index[np.flatnonzero(breaks.cpu().numpy())].tolist()
