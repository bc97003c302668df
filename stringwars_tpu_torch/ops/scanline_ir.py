"""Lowering of fused-scan programs to the elementwise IR of the scan kernel.

``ops/scanline.fused_scan`` takes a program, a tuple of ``Op``s whose
``build(env)`` lambdas make each op's input from the input streams and the
outputs of earlier ops. The kernel ``csrc/scanline.cu`` runs a whole program
in one launch, so it cannot call the lambdas: each build is traced once, per
program and input dtypes, into a small IR that the kernel interprets.

Tracing. ``env`` hands each build proxy streams. A proxy records the
operators ``== != < <= > >= & | ~ + - *`` and, through
``__torch_function__``, ``torch.where``, with integer and bool constants;
anything else raises ``LoweringError`` naming the op and the operation.
Each recorded node keeps torch's dtype for it (found by running the same
torch operation on one-element tensors of the operands' dtypes), and its
constants are cast to the dtype torch computes in, so the IR wraps and
compares exactly as torch does on the same streams (int64 intermediates
are computed in 32 bits, as the kernel holds every value in an int32).
Equal nodes are merged, so a build that calls one helper twice computes it
once.

Scheduling. An op's stage is one more than the latest stage of the ops
whose outputs its build reads (0 if it reads only inputs). The kernel runs
the stages in order, at most ``MAX_STAGE_OPS`` ops a step: it evaluates the
step's builds, scans each op over the tile and finds every op's carry from
the tiles before it at once. The node values live in on-chip slots of one
tile each; a slot is freed after its last reader. An op's output takes a
slot when a later build reads it or the call returns it (the kernel copies
a returned output from its slot to device memory in coalesced rows).

``run_lowered`` is the plain torch interpreter of the IR: it walks the
tiles in scan order as the kernel's tiles finish, with the kernel's carries
(a ``delay`` op carries its build's value at the tile's last position), so
the CPU tests hold the lowering and the tiling against ``run_program``
with the lambdas and against the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The kernel's tiles: 256 threads of 4, 8, 16 or 32 consecutive positions
# each: the most whose slots leave room for 2 blocks an SM (of the SM's
# shared memory, each block with its 1 KB reserve and the kernel's static
# arrays), else the most that fit one block (the most a block may opt in
# to, less the static arrays). Larger tiles take fewer look-back rounds (64
# positions a thread measured slower on an H100); a second block hides one
# block's waits. The wrapper lowers with its card's shared memory; the CPU
# interpreter tiles as on an H100 (228 KB an SM, 227 KB a block).
THREADS = 256
ITEMS = (32, 16, 8, 4)
H100_SHARED = (233472, 232448)  # bytes of shared memory: an SM's, a block's opt-in
_STATIC_SHARED = (2 * 8 * 8 + 8) * 12 + 64  # StepShared and the drawn tile, with room to spare
_BLOCK_RESERVE = 1024  # what CUDA reserves of an SM's shared memory for each block


def shared_limits(per_sm: int, per_block: int) -> tuple[int, int]:
    """(target, limit) of a launch's dynamic shared memory on a card with
    ``per_sm`` bytes of shared memory an SM and ``per_block`` a block: the
    target leaves room for two blocks an SM, the limit is one block's."""
    return per_sm // 2 - _BLOCK_RESERVE - _STATIC_SHARED, per_block - _STATIC_SHARED


MAX_STAGE_OPS = 8  # ops per scan step: one warp each finds its carry
MAX_INPUTS = 16  # kMaxInputs
MAX_OUTPUTS = 32  # kMaxOutputs
STEP_WORDS = 12  # int32 words per step and per scan op in the staged program

KIND_CODES = {"sum": 0, "max": 1, "last": 2, "last2": 3, "delay": 4}
# Node dtypes: values are held as int32, wrapped to these after each operation;
# a node of a one-byte dtype lives in a byte slot on chip.
_BYTE_DTYPES = (torch.bool, torch.uint8, torch.int8)
DTYPE_CODES = {torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3, torch.int32: 4, torch.int64: 4}
# Opcodes of the elementwise steps (Code in csrc/scanline.cu).
OPCODES = {
    "eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5, "and": 6, "or": 7, "not": 8,
    "add": 9, "sub": 10, "mul": 11, "where": 12, "cast": 13,
}
STEP_LOAD, STEP_EW, STEP_SCAN = 0, 1, 2

_TORCH_BINARY = {
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "and": torch.bitwise_and, "or": torch.bitwise_or, "add": torch.add, "sub": torch.sub, "mul": torch.mul,
}
_COMPARE = ("eq", "ne", "lt", "le", "gt", "ge")


class LoweringError(ValueError):
    """A build uses an operation the scan kernel's IR does not have."""


@dataclasses.dataclass(frozen=True)
class Node:
    """One value of the IR: an input stream ("in", name), an earlier op's
    output ("out", op index, output 0/1), a constant ("const", value) or an
    operation over ``args``. ``dtype`` is torch's dtype for the value."""

    op: str
    args: tuple
    dtype: torch.dtype
    value: object = None

    def operands(self) -> tuple["Node", ...]:
        return () if self.op in ("in", "out", "const") else self.args


def _wrap(value: int, dtype: torch.dtype) -> int:
    """A Python int as ``dtype`` holds it (int64 as the kernel's int32)."""
    if dtype == torch.bool:
        return int(bool(value))
    bits = {torch.uint8: 8, torch.int8: 8, torch.int16: 16}.get(dtype, 32)
    value &= (1 << bits) - 1
    if dtype != torch.uint8 and value >= 1 << (bits - 1):
        value -= 1 << bits
    return value


def cast_stream(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int32 stream wrapped to ``dtype``, held as int32: the kernel's cast."""
    if dtype == torch.bool:
        return (x != 0).to(torch.int32)
    if dtype == torch.uint8:
        return x & 0xFF
    if dtype == torch.int8:
        return ((x + 128) & 0xFF) - 128
    if dtype == torch.int16:
        return ((x + 32768) & 0xFFFF) - 32768
    return x


class _Tracer:
    def __init__(self):
        self.nodes: dict[tuple, Node] = {}
        self.where = "?"  # "op <name>" of the build being traced, for errors

    def node(self, op: str, args: tuple, dtype: torch.dtype, value=None) -> Node:
        key = (op, args, dtype, value)
        found = self.nodes.get(key)
        if found is None:
            found = self.nodes[key] = Node(op, args, dtype, value)
        return found

    def fail(self, what: str):
        raise LoweringError(f"fused_scan: the build of {self.where} uses {what}, which the scan kernel cannot run")

    def const(self, value) -> Node:
        if isinstance(value, (bool, np.bool_)):
            return self.node("const", (), torch.bool, int(bool(value)))
        if isinstance(value, (int, np.integer)):
            return self.node("const", (), torch.int64, _wrap(int(value), torch.int32))
        self.fail(f"the constant {value!r} of type {type(value).__name__}")

    def operand(self, x) -> Node:
        if isinstance(x, Proxy):
            return x.node
        if isinstance(x, torch.Tensor):
            self.fail("a tensor from outside its env")
        return self.const(x)

    @staticmethod
    def sample(x):
        """A one-element stand-in for torch's dtype rules: a tensor of the
        node's dtype, or the Python constant itself."""
        if isinstance(x, Proxy):
            return torch.zeros(1, dtype=x.node.dtype)
        return x

    def as_dtype(self, node: Node, dtype: torch.dtype) -> Node:
        """``node`` as torch computes with it in ``dtype``: a constant is
        cast now; a stream's values are exact in any dtype torch promotes
        it to."""
        if node.op == "const":
            return self.node("const", (), dtype, _wrap(node.value, dtype))
        return node

    def binary(self, name: str, x, y, swap: bool = False) -> "Proxy":
        if swap:
            x, y = y, x
        try:
            compute = torch.result_type(self.sample(x), self.sample(y))
            out = _TORCH_BINARY[name](torch.zeros(1, dtype=compute), torch.zeros(1, dtype=compute)).dtype
        except (RuntimeError, TypeError) as error:
            self.fail(f"{name} of these operands ({error})")
        a, b = self.as_dtype(self.operand(x), compute), self.as_dtype(self.operand(y), compute)
        return Proxy(self, self.node(name, (a, b), out))

    def invert(self, x) -> "Proxy":
        node = x.node
        try:
            torch.bitwise_not(torch.zeros(1, dtype=node.dtype))
        except RuntimeError as error:
            self.fail(f"~ of a {node.dtype} stream ({error})")
        return Proxy(self, self.node("not", (node,), node.dtype))

    def select(self, cond, x, y) -> "Proxy":
        try:
            out = torch.where(torch.zeros(1, dtype=torch.bool) if isinstance(cond, Proxy) else cond,
                              self.sample(x), self.sample(y)).dtype
            if isinstance(cond, Proxy) and cond.node.dtype != torch.bool:
                raise RuntimeError(f"where expected condition to be a boolean tensor, got {cond.node.dtype}")
        except (RuntimeError, TypeError) as error:
            self.fail(f"torch.where of these operands ({error})")
        c = self.operand(cond)
        a, b = self.as_dtype(self.operand(x), out), self.as_dtype(self.operand(y), out)
        return Proxy(self, self.node("where", (c, a, b), out))


class Proxy:
    """A stream while a build is traced: records what the build does."""

    __slots__ = ("tracer", "node")
    __hash__ = None

    def __init__(self, tracer: _Tracer, node: Node):
        self.tracer = tracer
        self.node = node

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        tracer = next(a.tracer for a in args if isinstance(a, Proxy))
        if func is torch.where and not kwargs and len(args) == 3:
            return tracer.select(*args)
        tracer.fail(f"torch.{getattr(func, '__name__', func)}")

    def __getattr__(self, name):
        self.tracer.fail(f".{name}")

    def __bool__(self):
        self.tracer.fail("a stream as a Python truth value (and, or, if)")

    def __eq__(self, other):
        return self.tracer.binary("eq", self, other)

    def __ne__(self, other):
        return self.tracer.binary("ne", self, other)

    def __lt__(self, other):
        return self.tracer.binary("lt", self, other)

    def __le__(self, other):
        return self.tracer.binary("le", self, other)

    def __gt__(self, other):
        return self.tracer.binary("gt", self, other)

    def __ge__(self, other):
        return self.tracer.binary("ge", self, other)

    def __and__(self, other):
        return self.tracer.binary("and", self, other)

    def __rand__(self, other):
        return self.tracer.binary("and", self, other, swap=True)

    def __or__(self, other):
        return self.tracer.binary("or", self, other)

    def __ror__(self, other):
        return self.tracer.binary("or", self, other, swap=True)

    def __add__(self, other):
        return self.tracer.binary("add", self, other)

    def __radd__(self, other):
        return self.tracer.binary("add", self, other, swap=True)

    def __sub__(self, other):
        return self.tracer.binary("sub", self, other)

    def __rsub__(self, other):
        return self.tracer.binary("sub", self, other, swap=True)

    def __mul__(self, other):
        return self.tracer.binary("mul", self, other)

    def __rmul__(self, other):
        return self.tracer.binary("mul", self, other, swap=True)

    def __invert__(self):
        return self.tracer.invert(self)


def _refuse(symbol: str):
    def method(self, *args):
        self.tracer.fail(symbol)

    return method


for _name, _symbol in (
    ("floordiv", "//"), ("truediv", "/"), ("mod", "%"), ("pow", "**"), ("lshift", "<<"), ("rshift", ">>"),
    ("xor", "^"), ("matmul", "@"),
):
    setattr(Proxy, f"__{_name}__", _refuse(_symbol))
    setattr(Proxy, f"__r{_name}__", _refuse(_symbol))
for _name, _symbol in (("neg", "unary -"), ("pos", "unary +"), ("abs", "abs()"), ("index", "a stream as an index"),
                       ("int", "int()"), ("float", "float()"), ("iter", "iteration"), ("len", "len()")):
    setattr(Proxy, f"__{_name}__", _refuse(_symbol))


class _TraceEnv(dict):
    """The env a build sees while traced: proxies by name; a missing name
    raises ``KeyError``, as the plain executor's env does."""


@dataclasses.dataclass(frozen=True)
class ScanOp:
    """One lowered scan: the op, its position in the program, its value and
    flag nodes (flag None but for last/last2) and its stage."""

    op: object
    index: int
    value: Node
    flag: Node | None
    stage: int

    def reads(self) -> tuple[Node, ...]:
        return (self.value,) if self.flag is None else (self.value, self.flag)


@dataclasses.dataclass(frozen=True)
class Lowered:
    """A program lowered for given input dtypes.

    ``inputs``: the input names the kernel loads, in the order of its input
    pointers; ``outputs``: the names the call returns, in the order of its
    output pointers; ``steps``: int32[steps, STEP_WORDS]; ``scans``:
    int32[scan ops, STEP_WORDS]; ``slots``, ``byte_slots``: the most tile
    streams of int32 and of one byte (bool, uint8, int8 values) the program
    holds on chip at once; ``stage_ops``: the most ops of a step. A slot
    operand is ``s >= 0`` for word slot s, -1 for the constant beside it,
    ``-2 - (2 * b + signed)`` for byte slot b."""

    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    steps: np.ndarray
    scans: np.ndarray
    slots: int
    stage_ops: int
    byte_slots: int = 0
    shared: tuple[int, int] = shared_limits(*H100_SHARED)  # (target, limit): the card's

    def shared_bytes(self, items: int) -> int:
        """Dynamic shared memory of a launch at ``items`` positions a
        thread: the word slots (one int32 a position, a word of padding
        every 32), the byte slots and a state of 3 int32 per thread for each
        op of a step."""
        size = THREADS * items
        return self.slots * (size + size // 32) * 4 + self.byte_slots * size + self.stage_ops * THREADS * 12

    @property
    def items(self) -> int:
        """Positions a thread of the kernel scans (its tile: 256 x items)."""
        for limit in self.shared:
            for items in ITEMS:
                if self.shared_bytes(items) <= limit:
                    return items
        return ITEMS[-1]

    @property
    def tile(self) -> int:
        return THREADS * self.items

    def table(self) -> np.ndarray:
        """The staged program: a header of STEP_WORDS words (steps, slots,
        scan ops, most ops of a step, byte slots), the steps, then the scan
        ops."""
        head = np.zeros(STEP_WORDS, np.int32)
        head[:5] = (len(self.steps), self.slots, len(self.scans), self.stage_ops, self.byte_slots)
        return np.concatenate([head, self.steps.reshape(-1), self.scans.reshape(-1)]).astype(np.int32)


def _trace(ops, dtypes: dict[str, torch.dtype]) -> list[ScanOp]:
    """Each op's build, traced in program order."""
    tracer = _Tracer()
    env = _TraceEnv({name: Proxy(tracer, tracer.node("in", (name,), dtype)) for name, dtype in dtypes.items()})
    stage_of: dict[int, int] = {}
    depth: dict[Node, int] = {}

    def node_depth(node: Node) -> int:
        if node not in depth:
            if node.op == "out":
                depth[node] = stage_of[node.args[0]] + 1
            else:
                depth[node] = max((node_depth(a) for a in node.operands()), default=0)
        return depth[node]

    scans: list[ScanOp] = []
    for index, op in enumerate(ops):
        tracer.where = f"op {op.name!r} ({op.kind})"
        built = op.build(env)
        flag = None
        if op.kind in ("last", "last2"):
            if not (isinstance(built, tuple) and len(built) == 2):
                tracer.fail("a result that is not a (values, flags) pair")
            built, flag = built
            flag = tracer.operand(flag)
        value = tracer.operand(built)
        if op.kind == "id":  # the plain executor keeps an id stream as int32
            env[op.name] = Proxy(tracer, tracer.node("cast", (value,), torch.int32))
            continue
        stage_of[index] = max(node_depth(value), node_depth(flag) if flag is not None else 0)
        scans.append(ScanOp(op, index, value, flag, stage_of[index]))
        for k, name in enumerate(op.outs):
            env[name] = Proxy(tracer, tracer.node("out", (index, k), torch.int32))
    return scans


def lower(ops, dtypes: dict[str, torch.dtype], outputs=None, shared=H100_SHARED) -> Lowered:
    """Lower the program ``ops`` for input streams of ``dtypes`` (name ->
    torch dtype). ``outputs``: the output names the call returns (default:
    every output); ``shared``: the card's shared memory (an SM's, a block's
    opt-in), which sizes the tile. Raises ``LoweringError`` for a build the IR cannot hold,
    ``KeyError`` for a build reading a stream that is not there."""
    from stringwars_tpu_torch.ops.scanline import KINDS

    for op in ops:
        if op.kind not in KINDS:
            raise ValueError(f"unknown scan kind {op.kind!r}")
    for name, dtype in dtypes.items():
        if dtype not in DTYPE_CODES:
            raise LoweringError(
                f"fused_scan: input {name!r} is {dtype}; the scan kernel reads bool and integer streams"
            )
    scans = _trace(ops, dtypes)
    every = [name for s in scans for name in s.op.outs]
    if outputs is not None and set(outputs) - set(every):
        raise KeyError(f"fused_scan: no op makes the outputs {sorted(set(outputs) - set(every))}")
    wanted = tuple(every) if outputs is None else tuple(name for name in every if name in set(outputs))
    if len(wanted) > MAX_OUTPUTS:
        raise LoweringError(f"fused_scan: {len(wanted)} outputs; the scan kernel writes at most {MAX_OUTPUTS}")

    # Scan steps: by stage, then in program order, at most MAX_STAGE_OPS each.
    chunks: list[list[ScanOp]] = []
    for s in sorted(scans, key=lambda s: (s.stage, s.index)):
        if chunks and chunks[-1][0].stage == s.stage and len(chunks[-1]) < MAX_STAGE_OPS:
            chunks[-1].append(s)
        else:
            chunks.append([s])

    # The program in order: each chunk's nodes (inputs at their first use),
    # then the chunk.
    program: list[tuple[str, object]] = []
    placed: set[Node] = set()

    def place(node: Node):
        if node in placed or node.op in ("const", "out"):
            return
        for a in node.operands():
            place(a)
        program.append(("node", node))
        placed.add(node)

    for chunk in chunks:
        for s in chunk:
            for node in s.reads():
                place(node)
        program.append(("scan", chunk))
    return dataclasses.replace(_emit(program, wanted), shared=shared_limits(*shared))


def _in_place(s: ScanOp, chunk: list, last_use: dict, slot_of: dict, at: int) -> bool:
    """Whether op ``s`` may write its first output over its value's word
    slot: the value dies at this step and no other read of the step takes
    it (a delay reads its one neighbour outside its run before any thread
    writes)."""
    value = s.value
    return (
        value.op != "const" and last_use.get(value) == at and slot_of.get(value, -1) >= 0
        and sum(n == value for t in chunk for n in t.reads()) == 1
    )


def _emit(program: list, wanted: tuple[str, ...]) -> Lowered:
    """Slots, steps and scan rows for the ordered ``program``."""
    def reads(what, item) -> list[Node]:
        nodes = list(item.operands()) if what == "node" else [n for s in item for n in s.reads()]
        return [n for n in nodes if n.op != "const"]

    last_use: dict[Node, int] = {}
    for at, (what, item) in enumerate(program):
        for node in reads(what, item):
            last_use[node] = at
    slot_of: dict[Node, int] = {}  # the operand code of each node's slot
    free: dict[bool, list[int]] = {False: [], True: []}  # word, byte slots
    count = {False: 0, True: 0}

    def take(node: Node) -> int:
        narrow = node.op != "out" and node.dtype in _BYTE_DTYPES
        if free[narrow]:
            slot = free[narrow].pop()
        else:
            slot, count[narrow] = count[narrow], count[narrow] + 1
        slot_of[node] = -2 - (2 * slot + (node.dtype == torch.int8)) if narrow else slot
        return slot_of[node]

    def release(node: Node) -> None:
        code = slot_of[node]
        free[code < 0].append(code if code >= 0 else (-2 - code) // 2)

    def operand(node: Node | None) -> tuple[int, int]:
        if node is None:
            return -1, 0
        return (-1, int(node.value)) if node.op == "const" else (slot_of[node], 0)

    inputs: list[str] = []
    steps, rows = [], []
    out_nodes = {}
    for at, (what, item) in enumerate(program):
        word = [0] * STEP_WORDS
        if what == "node" and item.op == "in":
            inputs.append(item.args[0])
            word[:3] = STEP_LOAD, len(inputs) - 1, take(item)
        elif what == "node":
            args = [operand(a) for a in item.args] + [(-1, 0)] * (3 - len(item.args))
            word[:4] = STEP_EW, OPCODES[item.op], DTYPE_CODES[item.dtype], 0
            word[4:10] = [x for pair in args for x in pair]
            word[3] = take(item)
        else:
            word[:3] = STEP_SCAN, len(rows), len(item)
            for s in item:
                row = [0] * STEP_WORDS
                row[:2] = KIND_CODES[s.op.kind], _wrap(int(s.op.init), torch.int32)
                row[2:4] = operand(s.value)
                row[4:6] = operand(s.flag)
                row[6:10] = -1, -1, -1, -1
                for k, name in enumerate(s.op.outs):
                    out = out_nodes.setdefault((s.index, k), Node("out", (s.index, k), torch.int32))
                    if not (out in last_use or name in wanted):
                        continue
                    if k == 0 and _in_place(s, item, last_use, slot_of, at):
                        # The op's value slot takes its first output: each
                        # thread reads a position before it writes it there.
                        slot_of[out] = slot_of[s.value]
                        del last_use[s.value]
                        row[6] = slot_of[out]
                    else:  # a returned output leaves the tile from its slot
                        row[6 + k] = take(out)
                    last_use.setdefault(out, at)
                    if name in wanted:
                        row[8 + k] = wanted.index(name)
                row[10] = len(rows)
                # A delay of an input reads its carry from the input itself.
                row[11] = inputs.index(s.value.args[0]) if s.op.kind == "delay" and s.value.op == "in" else -1
                rows.append(row)
        steps.append(word)
        written = [n for n in out_nodes.values() if what == "scan" and n in slot_of and last_use.get(n) == at]
        for node in reads(what, item) + written:
            if last_use.get(node) == at:
                release(node)
                del last_use[node]
    if len(inputs) > MAX_INPUTS:
        raise LoweringError(f"fused_scan: {len(inputs)} input streams; the scan kernel reads at most {MAX_INPUTS}")
    return Lowered(
        inputs=tuple(inputs), outputs=wanted,
        steps=np.asarray(steps, np.int32).reshape(-1, STEP_WORDS),
        scans=np.asarray(rows, np.int32).reshape(-1, STEP_WORDS),
        slots=count[False], stage_ops=max((len(item) for what, item in program if what == "scan"), default=0),
        byte_slots=count[True],
    )


# ---------------------------------------------------------------------------
# Plain interpreter of the IR, tile by tile as the kernel runs it
# ---------------------------------------------------------------------------

_DTYPES = {code: dtype for dtype, code in DTYPE_CODES.items() if dtype != torch.int64}


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _ew(code: int, dtype: torch.dtype, a, b, c) -> torch.Tensor:
    name = next(k for k, v in OPCODES.items() if v == code)
    if name in _COMPARE:
        return _TORCH_BINARY[name](a, b).to(torch.int32)
    if name == "where":
        return torch.where(a != 0, b, c)
    if name == "not":
        return a ^ 1 if dtype == torch.bool else cast_stream(~a, dtype)
    if name == "cast":
        return cast_stream(a, dtype)
    wide = _TORCH_BINARY[name](a.to(torch.int64), b.to(torch.int64))
    return cast_stream(_wrap32(wide), dtype)


def _scan_tile(kind: int, init: int, v: torch.Tensor, f: torch.Tensor | None, carry: tuple[int, int, int]):
    """One tile of one op in scan order from the exclusive carry (a, b, c):
    its outputs and the carry after it (the kernel's combine, op by op)."""
    from stringwars_tpu_torch.ops.scanline import last_index

    a, b, c = carry
    if kind == KIND_CODES["sum"]:
        out = _wrap32(torch.cumsum(v.to(torch.int64), 0) + a)
        return (out,), (int(out[-1]), 0, 0)
    if kind == KIND_CODES["max"]:
        out = torch.cummax(v, 0).values.clamp(min=a)
        return (out,), (int(out[-1]), 0, 0)
    if kind == KIND_CODES["delay"]:
        out = torch.cat([v.new_full((1,), a), v[:-1]])
        return (out,), (int(v[-1]), 0, 0)
    last = last_index(f)
    count = torch.cumsum(f > 0, 0).clamp(max=2)
    before = torch.cat([last.new_full((1,), -1), last[:-1]])
    second = torch.where(last >= 0, before[last.clamp(min=0)], -1)
    at_last = torch.where(last >= 0, v[last.clamp(min=0)], 0)
    at_second = torch.where(second >= 0, v[second.clamp(min=0)], 0)
    if kind == KIND_CODES["last"]:
        held = torch.where(count >= 1, at_last, a)
        out = torch.where((count >= 1) | (c > 0), held, init).to(torch.int32)
        return (out,), (int(held[-1]), 0, int(c > 0 or count[-1] >= 1))
    l2 = torch.where(count >= 1, at_last, a)
    p2 = torch.where(count >= 2, at_second, torch.where(count == 1, a, b))
    c2 = (count + c).clamp(max=2)
    outs = torch.where(c2 >= 1, l2, init).to(torch.int32), torch.where(c2 >= 2, p2, init).to(torch.int32)
    return outs, (int(l2[-1]), int(p2[-1]), int(c2[-1]))


def _initial(kind: int, init: int) -> tuple[int, int, int]:
    return (0 if kind == KIND_CODES["sum"] else init, init, 0)


def run_lowered(
    lowered: Lowered, inputs: dict, n: int, reverse: bool = False, tile: int | None = None
) -> dict[str, torch.Tensor]:
    """The lowered program over streams of n positions on the CPU, by the
    kernel's algorithm: tiles of ``tile`` positions (default: the kernel's,
    ``lowered.tile``) in scan order (from the end when ``reverse``), each
    step's elementwise operations over the tile, each scan from the
    exclusive carry of the tiles before."""
    tile = lowered.tile if tile is None else tile
    streams = [inputs[name][:n].to(torch.int32) for name in lowered.inputs]
    outs = [torch.empty(n, dtype=torch.int32) for _ in lowered.outputs]
    carries = [_initial(int(row[0]), int(row[1])) for row in lowered.scans]
    tiles = -(-n // tile)
    for t in range(tiles):
        m = tiles - 1 - t if reverse else t
        lo, hi = m * tile, min(n, m * tile + tile)
        flip = (lambda x: x.flip(0)) if reverse else (lambda x: x)
        slots: dict[int, torch.Tensor] = {}

        def fetch(slot: int, imm: int) -> torch.Tensor:
            return slots[slot] if slot != -1 else torch.full((hi - lo,), imm, dtype=torch.int32)

        for step in lowered.steps:
            kind = int(step[0])
            if kind == STEP_LOAD:
                slots[int(step[2])] = flip(streams[int(step[1])][lo:hi])
            elif kind == STEP_EW:
                a, b, c = (fetch(int(step[k]), int(step[k + 1])) for k in (4, 6, 8))
                slots[int(step[3])] = _ew(int(step[1]), _DTYPES[int(step[2])], a, b, c)
            else:
                for row in lowered.scans[int(step[1]) : int(step[1]) + int(step[2])]:
                    v = fetch(int(row[2]), int(row[3]))
                    f = fetch(int(row[4]), int(row[5])) if int(row[0]) in (2, 3) else None
                    results, carries[int(row[10])] = _scan_tile(int(row[0]), int(row[1]), v, f, carries[int(row[10])])
                    for k, out in enumerate(results):
                        if row[6 + k] != -1:
                            slots[int(row[6 + k])] = out
                        if row[8 + k] >= 0:
                            outs[int(row[8 + k])][lo:hi] = flip(out)
    return dict(zip(lowered.outputs, outs))
