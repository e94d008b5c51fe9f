"""Shared trace front end for the pexlint passes (DESIGN.md §10, §12).

The port's counterpart of ``src/repro/analysis/_jaxpr.py``: where the
reference walks a jaxpr, the port walks a flat record of one run of the
program — every aten op of the forward and of each backward pass, in the
order the dispatcher sees them, with the tensors each reads and writes.
The record is taken on ``meta`` tensors, so nothing is computed and no
kernel runs; a full-width step records in seconds on any host.

  * ``Recorder`` — a ``TorchDispatchMode`` that records each op, plus what
    dispatch cannot see: the Tap sites (``core.taps._site``), the
    provenance marks (``core.provenance``), every kernel launch the
    wrappers would make (``kernels.ops``: the launchers call their CUDA
    kernels through ``ctypes``, out of the dispatcher's sight, so under a
    trace each records its site and returns ``meta`` outputs), every
    all-reduce of ``dist.pex``, and every random draw with the generator it
    draws from (the draw itself is not made: a ``meta`` tensor of the
    output's shape stands for it).
  * ``Walker`` — forward taint propagation over the record on the union
    semilattice of frozensets, per tensor, with in-place writes added to
    every tensor of the written storage. A pass overrides ``hook`` for the
    records it gives meaning to (coverage: the Tap sites; privacy: the
    marks and draws; collectives: the all-reduces).
  * ``trace_step`` — record one full ``Engine.step`` (local or mesh path)
    and return it with the maps the passes need: which outputs are which
    result field (gradient leaves keep their parameter paths) and which
    generators the consumers brought.

  * ``trace_train_step`` — record one whole *training* step: the same
    ``Engine.step`` and then the optimizer apply (``optim.adamw.update`` or
    ``optim.adafactor.update`` on ``meta`` optimizer state), with the plain
    forward of the same model recorded apart, for the traffic and cost
    passes. The ``grad_leaf`` marks ``plan.execute`` plants are the
    boundary between the plan and the apply.

Sharded (DTensor) programs: the recorder records each rank's own work.
An op on DTensors is handed on to DTensor (the mode returns
``NotImplemented``), whose dispatch then runs the local ops on the rank's
shards — and the functional collectives (``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_to_all``) of
every redistribution — through the recorder, which records those; the
fake tensors DTensor propagates shapes with are not recorded. A DTensor
is known by its local tensor (``tid``). Each recorded functional
collective carries its kind and the mesh axes of its group
(:func:`collective_meta`) when the recorder was given the mesh.

The route a trace models is the card's: CUDA with ``PexSpec.use_kernels``,
so a trace taken on the CPU names the kernel sites the H100 would
launch.

Random draws under a trace: a ``torch.Generator`` cannot draw into a
``meta`` tensor, and a ``meta`` generator does not exist, so the recorder
takes every op tagged ``nondeterministic_seeded`` itself: it records the
generator and a key for the draw — a digest of the generator's state when
the trace first met it, and the count of draws from it since — and
returns an undrawn ``meta`` output. Reading a scalar out of a ``meta``
tensor (``int(t)``, ``bool(t)``) returns a stand-in: False for a bool, 0.0
for a float, and for an integer a fresh value per read, remembered as
keyed when the tensor read derives from a draw (a seed drawn from a
consumer's generator).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import plan as plan_mod
from repro_torch.core import provenance as _prov
from repro_torch.kernels.contract import dtype_name
from repro_torch.nn.param import tree_leaves, tree_map, tree_paths

EMPTY = frozenset()

#: aten ops through which no gradient flows back
DETACH_OPS = frozenset({"aten.detach.default"})


class AnalysisError(RuntimeError):
    """A trace could not be taken or walked soundly."""


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """A recorded tensor: its shape and dtype, the identity of its storage
    (views share it), the bytes an op touches reading or writing it (its
    distinct elements: a broadcast axis of stride 0 is read once) and the
    bytes of its storage."""
    shape: Tuple[int, ...]
    dtype: str
    storage: int
    nbytes: int = 0
    storage_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class Op:
    """One record of a trace.

    kind: "aten" (a dispatched op), "tap" (a Tap site: its forward's own
    ops precede it with ``site`` set), "mark", "kernel", "collective",
    "draw" or "read" (a scalar read). ``ins``/``outs`` are tensor ids,
    ``writes`` the storages an in-place op mutates. ``remat``: recorded
    while a backward re-ran a checkpointed block (``core.taps.checkpoint``)."""
    index: int
    kind: str
    name: str
    ins: Tuple[int, ...]
    outs: Tuple[int, ...]
    writes: Tuple[int, ...] = ()
    meta: Any = None
    site: int = -1
    remat: bool = False


@dataclasses.dataclass
class GenState:
    """A generator the trace met: the digest of its state then, the draws
    from it since, whether a consumer brought it, whether an rng_use mark
    named it, and whether it was seeded (``mark_rng(seed=)``) from a
    consumer draw. Keyed in ``Trace.gens`` by the ``id`` of the object
    the mark received (a draw no mark names gets a key of its own)."""
    digest: str
    draws: int = 0
    consumer: Optional[str] = None
    keyed_seed: bool = False
    marked: bool = False


#: the functional collectives a DTensor redistribution issues, by op name
#: → kind
FUNCTIONAL_COLLECTIVES = {
    "_c10d_functional.all_reduce.default": "all_reduce",
    "_c10d_functional.all_reduce_.default": "all_reduce",
    "_c10d_functional.all_gather_into_tensor.default": "all_gather",
    "_c10d_functional.reduce_scatter_tensor.default": "reduce_scatter",
    "_c10d_functional.all_to_all_single.default": "all_to_all",
}


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "_local_tensor")


def _is_fake(x) -> bool:
    return type(x).__name__ == "FakeTensor"


def mesh_groups(mesh) -> Dict[str, Tuple[str, ...]]:
    """{process-group name: mesh axes} of a ``DeviceMesh``'s one-dim
    groups."""
    out = {}
    if mesh is None:
        return out
    for i, name in enumerate(mesh.mesh_dim_names or ()):
        try:
            out[mesh.get_group(i).group_name] = (name,)
        except (RuntimeError, AttributeError):
            continue
    return out


def _tensors(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _tensors(x)]
    return []


def _schema_arg(func, args, kwargs, i, name):
    return args[i] if i < len(args) else kwargs.get(name)


def _flop_registry():
    """``torch.utils.flop_counter``'s registry of contraction ops (mm,
    bmm, addmm, baddbmm, convolutions, fused attention), whose functions
    give an op's flops from its arguments."""
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _digest(gen: torch.Generator) -> str:
    state = gen.get_state()
    return hashlib.sha1(state.numpy().tobytes()).hexdigest()[:16]


class Recorder(TorchDispatchMode):
    """Records one run of the program on ``meta`` tensors (module
    docstring). Use as a context manager; one trace at a time.
    ``consumer_gens`` maps ``id(generator)`` → purpose for the generators
    the step's consumers carry."""

    #: integer stand-ins for scalar reads start here
    SCALAR_BASE = 0x5EED_0000_0000

    def __init__(self, consumer_gens: Optional[Dict[int, str]] = None,
                 mesh=None):
        super().__init__()
        self.groups = mesh_groups(mesh)
        self.ops: List[Op] = []
        self.tensors: Dict[int, TensorInfo] = {}
        self.gens: Dict[int, GenState] = {}
        self.keyed_scalars: set = set()
        self._refs: list = []
        self._site_stack: List[int] = []
        self._n_sites = 0
        self._draw_outs: set = set()
        self._next_scalar = self.SCALAR_BASE
        self._quiet = 0
        self._consumer_gens = dict(consumer_gens or {})
        self._pending: Optional[Tuple[int, GenState]] = None
        #: > 0 while a backward re-runs a checkpointed block (set by
        #: ``core.taps``): its ops are flagged, its Tap sites not recorded
        self.remat = 0

    # -- the active trace --------------------------------------------------
    def __enter__(self):
        if _prov.RECORDER is not None:
            raise AnalysisError("an analysis trace is already recording")
        _prov.RECORDER = self
        try:
            return super().__enter__()
        except BaseException:
            _prov.RECORDER = None
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _prov.RECORDER = None

    # -- identities ----------------------------------------------------------
    def tid(self, t: torch.Tensor) -> int:
        if _is_dtensor(t):
            t = t._local_tensor       # a rank's own piece
        key = id(t)
        if key not in self.tensors:
            self._quiet += 1
            try:
                try:
                    st = t.untyped_storage()
                    storage, sbytes = st._cdata, st.nbytes()
                except (RuntimeError, NotImplementedError):
                    storage, sbytes = key, 0
                elems = 1
                for d, stride in zip(t.shape, t.stride()):
                    if stride:
                        elems *= d
                self.tensors[key] = TensorInfo(
                    tuple(t.shape), dtype_name(t.dtype), storage,
                    elems * t.element_size(), sbytes)
            finally:
                self._quiet -= 1
            self._refs.append(t)
        return key

    def _append(self, kind, name, ins, outs, writes=(), meta=None) -> Op:
        op = Op(len(self.ops), kind, name, tuple(ins), tuple(outs),
                tuple(writes), meta,
                self._site_stack[-1] if self._site_stack else -1,
                self.remat > 0)
        self.ops.append(op)
        return op

    def _digest(self, gen) -> str:
        self._quiet += 1
        try:
            return _digest(gen)
        finally:
            self._quiet -= 1

    def _gen(self, gen) -> GenState:
        g = self.gens.get(id(gen))
        if g is None:
            g = GenState(self._digest(gen),
                         consumer=self._consumer_gens.get(id(gen)))
            self.gens[id(gen)] = g
            self._refs.append(gen)
        return g

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._quiet:
            return func(*args, **kwargs)
        flat = _tensors(list(args)) + _tensors(list(kwargs.values()))
        if any(_is_dtensor(t) for t in flat):
            return NotImplemented   # DTensor runs the rank's local ops
        if any(_is_fake(t) for t in flat):
            return func(*args, **kwargs)   # DTensor's shape propagation
        if func is torch.ops.aten._local_scalar_dense.default:
            return self._scalar(args[0])
        if torch.Tag.nondeterministic_seeded in func.tags:
            return self._draw(func, args, kwargs)
        out = func(*args, **kwargs)
        if any(_is_fake(t) for t in _tensors(out)):
            return out
        ins = [self.tid(t) for t in _tensors(list(args))
               + _tensors(list(kwargs.values()))]
        outs = [self.tid(t) for t in _tensors(out)]
        writes = [self.tensors[self.tid(t)].storage
                  for t in self._written(func, args, kwargs)]
        if self._draw_outs.intersection(ins):
            self._draw_outs.update(outs)    # derived from a draw
        meta = None
        kind = FUNCTIONAL_COLLECTIVES.get(str(func))
        if kind is not None:
            group = next((_schema_arg(func, args, kwargs, i, a.name)
                          for i, a in enumerate(func._schema.arguments)
                          if a.name == "group_name"), None)
            meta = {"collective": kind, "group": group,
                    "axes": self.groups.get(group, ())}
        if func.overloadpacket in _flop_registry():
            # a contraction: its 2·M·N·K from torch's own flop counter
            meta = {"flops": float(_flop_registry()[func.overloadpacket](
                *args, **kwargs, out_val=out))}
        self._append("aten", str(func), ins, outs, writes, meta)
        return out

    @staticmethod
    def _written(func, args, kwargs) -> List[torch.Tensor]:
        out = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                out += _tensors(_schema_arg(func, args, kwargs, i, a.name))
        return out

    def _scalar(self, t: torch.Tensor):
        tid = self.tid(t)
        if t.dtype == torch.bool:
            v = False
        elif t.is_floating_point() or t.is_complex():
            v = 0.0
        else:
            v = self._next_scalar
            self._next_scalar += 1
            if tid in self._draw_outs:
                self.keyed_scalars.add(v)
        self._append("read", "_local_scalar_dense", [tid], [],
                     meta={"value": v})
        return v

    def _draw(self, func, args, kwargs):
        gen = None
        for i, a in enumerate(func._schema.arguments):
            if a.name == "generator":
                gen = _schema_arg(func, args, kwargs, i, a.name)
        written = self._written(func, args, kwargs)
        if written:
            out = written[0]                   # in place: left undrawn
        else:
            kw = dict(kwargs)
            if "generator" in kw:
                kw["generator"] = None
            if kw.get("device") is not None:
                kw["device"] = torch.device("meta")
            out = func(*args, **kw)
        ins = [self.tid(t) for t in _tensors(list(args))
               + _tensors(list(kwargs.values()))]
        outs = [self.tid(t) for t in _tensors(out)]
        self._draw_outs.update(outs)
        key = gid = None
        if gen is not None:
            # the dispatcher hands over another Python object for the same
            # generator, so a draw is bound to the rng_use mark just before
            # it when the states agree (draws are never made, so a
            # generator's state stays the one the trace first met)
            digest = self._digest(gen)
            pending = self._pending
            if pending is not None and pending[1].digest == digest:
                gid, g = pending
            else:
                gid = ("unmarked", len(self.ops))
                g = self.gens[gid] = GenState(digest)
            key = (g.digest, g.draws)
            g.draws += 1
        self._pending = None
        self._append("draw", str(func), ins, outs,
                     [self.tensors[self.tid(t)].storage for t in written],
                     meta={"gen": gid, "key": key})
        return out

    # -- what dispatch does not see ----------------------------------------
    def tap_site(self, info, operands, run):
        """Run one tapped op (``core.taps._site``) and record it as a site
        after its forward's ops; a tapped op inside another's forward is
        part of the outer site, and a recompute's are the forward's sites
        again (not recorded)."""
        if self._site_stack or self.remat:
            return run()
        k = self._n_sites
        self._n_sites += 1
        self._site_stack.append(k)
        try:
            z, acc = run()
        finally:
            self._site_stack.pop()
        ins = [self.tid(t) for t in operands]
        self._append("tap", info.name, ins, [self.tid(z), self.tid(acc)],
                     meta={"info": info, "site": k})
        return z, acc

    def mark(self, x, tag: str, meta: dict) -> None:
        if isinstance(x, torch.Tensor):
            t = self.tid(x)
            self._append("mark", tag, [t], [t], meta=meta)
        else:
            self._append("mark", tag, [], [], meta=meta)

    def mark_rng(self, gen, purpose, index, seed) -> None:
        g = self._gen(gen)
        g.marked = True
        self._pending = (id(gen), g)
        if seed is not None and seed in self.keyed_scalars:
            g.keyed_seed = True
        self._append("mark", _prov.TAG_RNG, [], [], meta={
            "purpose": purpose, "index": index, "seed": seed,
            "gen": id(gen), "key": (g.digest, g.draws)})

    def kernel(self, name, inputs, outputs, meta) -> None:
        outs = outputs if isinstance(outputs, tuple) else (outputs,)
        self._append("kernel", name, [self.tid(t) for t in inputs],
                     [self.tid(t) for t in outs], meta={
                         **meta,
                         "shapes": tuple(tuple(t.shape) for t in inputs),
                         "dtypes": tuple(dtype_name(t.dtype)
                                         for t in inputs),
                         "strides": tuple(tuple(t.stride()) for t in inputs),
                         "offsets": tuple(t.storage_offset()
                                          for t in inputs)})

    def collective(self, x, kind: str, count: int) -> None:
        t = self.tid(x)
        self._append("collective", "all_reduce", [t], [t],
                     [self.tensors[t].storage],
                     meta={"kind": kind, "count": count, "op": "sum",
                           "shape": tuple(x.shape)})


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

class Walker:
    """Forward taint propagation over a trace's records.

    Override ``hook(op, in_taints)``: return a list of output taints to
    take over the record (an empty list claims it with no output), or None
    for the default — every output and every written storage gets the
    union of the inputs. ``replace`` sets a tensor's taint outright (a
    marker's semantics)."""

    def hook(self, op: Op, in_t: List[frozenset]) -> Optional[List[frozenset]]:
        return None

    def taint(self, tid: int) -> frozenset:
        s = self._storage(tid)
        base = self.env.get(tid)
        if base is None:
            base = self.senv.get(s, EMPTY)
        return base | self.wenv.get(s, EMPTY)

    def replace(self, tid: int, t: frozenset) -> None:
        self.env[tid] = t
        self.wenv[self._storage(tid)] = EMPTY

    def _storage(self, tid: int) -> int:
        info = self.tensors.get(tid)
        return tid if info is None else info.storage

    def _write(self, tid: int, t: frozenset) -> None:
        self.env[tid] = self.env.get(tid, EMPTY) | t
        s = self._storage(tid)
        self.senv[s] = self.senv.get(s, EMPTY) | t

    def run(self, trace, init: Dict[int, frozenset]) -> "Walker":
        self.tensors = trace.tensors
        self.env: Dict[int, frozenset] = {}
        self.wenv: Dict[int, frozenset] = {}
        self.senv: Dict[int, frozenset] = {}
        for tid, t in init.items():
            self._write(tid, t)
        for op in trace.ops:
            in_t = [self.taint(t) for t in op.ins]
            outs = self.hook(op, in_t)
            if outs is None:
                u = frozenset().union(*in_t) if in_t else EMPTY
                outs = [u] * len(op.outs)
                wt = u
            else:
                wt = frozenset().union(*outs) if outs else EMPTY
            for tid, t in zip(op.outs, outs):
                self._write(tid, t)
            for s in op.writes:
                self.wenv[s] = self.wenv.get(s, EMPTY) | wt
        return self


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def to_meta(tree):
    """``tree`` with every tensor leaf replaced by a ``meta`` tensor of its
    shape, strides and dtype (other leaves as they are)."""
    def meta(x):
        if isinstance(x, torch.Tensor):
            return torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                       dtype=x.dtype, device="meta")
        return x
    return tree_map(meta, tree)


def path_str(path) -> str:
    """A leaf's key path as ``a/0/b``."""
    return "/".join(str(k) for k in path)


@dataclasses.dataclass
class Trace:
    """The records of one trace and the identities they name."""
    ops: List[Op]
    tensors: Dict[int, TensorInfo]
    gens: Dict[int, GenState]
    keyed_scalars: frozenset

    @classmethod
    def of(cls, rec: Recorder) -> "Trace":
        return cls(rec.ops, rec.tensors, rec.gens,
                   frozenset(rec.keyed_scalars))

    def of_kind(self, kind: str) -> List[Op]:
        return [op for op in self.ops if op.kind == kind]

    def kernel_counts(self) -> Dict[str, int]:
        """{kernel: launches} of the trace."""
        out: Dict[str, int] = {}
        for op in self.of_kind("kernel"):
            out[op.name] = out.get(op.name, 0) + 1
        return out

    def norm_launches(self) -> Dict[str, Dict[Tuple[int, int], int]]:
        """{"gram_norm" / "direct_norm": {(p_in, p_out): launches}}."""
        out = {"gram_norm": {}, "direct_norm": {}}
        for op in self.of_kind("kernel"):
            if op.name in out:
                (_, _, p_in), (_, _, p_out) = op.meta["shapes"]
                d = out[op.name]
                d[(p_in, p_out)] = d.get((p_in, p_out), 0) + 1
        return out


_KEYED = (plan_mod.Noise, plan_mod.Importance)


@dataclasses.dataclass
class StepTrace(Trace):
    """One recorded ``Engine.step`` plus the maps the privacy and
    collectives passes anchor on."""
    plan: Any = None
    granularity: str = "example"
    batch_size: int = 0
    data_axes: Tuple[str, ...] = ("data",)
    meshed: bool = False
    mesh: Any = None
    outputs: Tuple[Tuple[str, str, int], ...] = ()  # (field, leaf path, tid)

    def grad_outputs(self) -> List[Tuple[str, int]]:
        """(leaf path, tensor id) of every gradient leaf output."""
        return [(p, t) for f, p, t in self.outputs if f == "grads"]


#: StepResult fields that hold per-example (or per-token) values
PER_EXAMPLE_FIELDS = ("loss_vec", "sq_norms", "weights", "token_weights",
                      "clip_coef")


def _outputs(rec: Recorder, r) -> Tuple[Tuple[str, str, int], ...]:
    out = []
    for field in PER_EXAMPLE_FIELDS + ("gns",):
        v = getattr(r, field)
        if isinstance(v, torch.Tensor):
            out.append((field, "", rec.tid(v)))
    if r.grads is not None:
        for path, g in zip(tree_paths(r.grads), tree_leaves(r.grads)):
            out.append(("grads", path_str(path), rec.tid(g)))
    return tuple(out)


def trace_step(loss_fn: Callable, params, batch, consumers: Sequence, *,
               spec=None, granularity: str = "example", mesh=None,
               data_axes: Sequence[str] = ("data",),
               batch_size: Optional[int] = None, seq: Optional[int] = None,
               loss_weights=None) -> StepTrace:
    """Record ``Engine.step`` for one consumer list on ``meta`` copies of
    ``params`` and ``batch`` (any device; nothing is read from them). The
    consumers' generators (``Noise.rng`` / ``Importance.rng``) are met as
    they are: their draws are recorded, not made. With ``mesh`` the mesh
    path runs (its process group must exist; no collective is sent)."""
    from repro_torch.core.engine import Engine, infer_batch_size

    eng = Engine(spec, mesh=mesh, data_axes=data_axes,
                 granularity=granularity)
    plan = plan_mod.analyze(consumers, engine_granularity=granularity)
    mparams, mbatch = to_meta(params), to_meta(batch)
    bs = batch_size if batch_size is not None else infer_batch_size(mbatch)
    gens = {}
    for c in consumers:
        if isinstance(c, _KEYED) and c.rng is not None:
            gens[id(c.rng)] = ("noise" if isinstance(c, plan_mod.Noise)
                               else "importance")
    lw = None if loss_weights is None else to_meta(loss_weights)
    rec = Recorder(gens)
    with rec:
        r = eng.step(loss_fn, mparams, mbatch, consumers, batch_size=bs,
                     seq=seq, loss_weights=lw)
        outputs = _outputs(rec, r)
    base = Trace.of(rec)
    return StepTrace(base.ops, base.tensors, base.gens, base.keyed_scalars,
                     plan=plan, granularity=granularity, batch_size=bs,
                     data_axes=eng.data_axes, meshed=mesh is not None,
                     mesh=mesh, outputs=outputs)


@dataclasses.dataclass
class TrainTrace(StepTrace):
    """One recorded training step: ``Engine.step`` and the optimizer
    apply, with the identities the traffic and cost passes anchor on — the
    tensor ids of the parameter, optimizer-state and batch leaves as they
    entered the record, each parameter leaf's path, and ``reference``, the
    plain forward (``loss_fn`` with the inert tap) of the same model and
    batch, recorded apart: the duplicate-forward baseline must not share
    the plan's path, or a mutant that doubles the plan's forward would
    double it too. The apply updates the ``meta`` parameters and moments
    in place, so its outputs (``new_params``, ``opt_state``) are the very
    tensors the step read."""
    optimizer: str = "none"              # 'adamw' | 'adafactor' | 'none'
    global_clip: Optional[float] = None  # the optimizer's global-norm clip
    seq: Optional[int] = None
    param_ids: Tuple[int, ...] = ()
    param_labels: Tuple[str, ...] = ()
    opt_ids: Tuple[int, ...] = ()
    batch_ids: Tuple[int, ...] = ()
    reference: Optional[Trace] = None


def _optimizer(optimizer: str):
    """(module, default config, global clip) of an optimizer name; ``none``
    gives Nones."""
    if optimizer == "adamw":
        from repro_torch.optim import adamw as mod
        cfg = mod.AdamWConfig()
        return mod, cfg, cfg.global_clip
    if optimizer == "adafactor":
        from repro_torch.optim import adafactor as mod
        cfg = mod.AdafactorConfig()
        return mod, cfg, getattr(cfg, "global_clip", None)
    if optimizer == "none":
        return None, None, None
    raise ValueError(f"unknown optimizer {optimizer!r}; expected 'adamw', "
                     f"'adafactor', or 'none'")


def record_program(fn: Callable, *args) -> Trace:
    """The record of ``fn(*args)`` on ``meta`` copies of its arguments."""
    margs = [to_meta(a) for a in args]
    rec = Recorder()
    with rec:
        fn(*margs)
    return Trace.of(rec)


def record_forward(loss_fn: Callable, params, batch) -> Trace:
    """The plain forward of ``loss_fn`` (the inert tap, no gradient) on
    ``meta`` copies of ``params`` and ``batch``."""
    from repro_torch.core.taps import NULL

    def forward(p, b):
        with torch.no_grad():
            loss_fn(p, b, NULL)
    return record_program(forward, params, batch)


def trace_train_step(loss_fn: Callable, params, batch, consumers: Sequence,
                     *, optimizer: str = "adamw", spec=None,
                     granularity: str = "example", mesh=None,
                     data_axes: Sequence[str] = ("data",),
                     batch_size: Optional[int] = None,
                     seq: Optional[int] = None,
                     with_reference: bool = True) -> TrainTrace:
    """Record one whole training step on ``meta`` copies of ``params`` and
    ``batch``: ``Engine.step`` (local or mesh path, as ``trace_step``) and,
    when the plan yields gradients, the ``optimizer`` update of them (its
    default config) with its state made by its ``init`` on the ``meta``
    parameters — the clip-scale, the moments and the parameter write, which
    no other pass covers."""
    from repro_torch.core.engine import Engine, infer_batch_size

    eng = Engine(spec, mesh=mesh, data_axes=data_axes,
                 granularity=granularity)
    plan = plan_mod.analyze(consumers, engine_granularity=granularity)
    mod, cfg, global_clip = _optimizer(optimizer)
    apply = mod is not None and plan.needs_grads
    mparams, mbatch = to_meta(params), to_meta(batch)
    bs = batch_size if batch_size is not None else infer_batch_size(mbatch)
    state = mod.init(mparams) if apply else None
    gens = {}
    for c in consumers:
        if isinstance(c, _KEYED) and c.rng is not None:
            gens[id(c.rng)] = ("noise" if isinstance(c, plan_mod.Noise)
                               else "importance")
    p_leaves = tree_leaves(mparams)
    o_leaves = [x for x in tree_leaves(state)
                if isinstance(x, torch.Tensor)] if apply else []
    rec = Recorder(gens)
    with rec:
        pids = tuple(rec.tid(x) for x in p_leaves)
        oids = tuple(rec.tid(x) for x in o_leaves)
        bids = tuple(rec.tid(x) for x in tree_leaves(mbatch))
        r = eng.step(loss_fn, mparams, mbatch, consumers, batch_size=bs,
                     seq=seq)
        outputs = _outputs(rec, r)
        if apply:
            mod.update(cfg, state, mparams, r.grads)
            paths = [path_str(p) for p in tree_paths(mparams)]
            outputs += tuple(("new_params", p, t)
                             for p, t in zip(paths, pids))
            outputs += tuple(("opt_state", "", t) for t in oids)
    base = Trace.of(rec)
    ref = record_forward(loss_fn, params, batch) if with_reference else None
    if seq is None:
        from repro_torch.core.engine import infer_seq_len
        try:
            seq = infer_seq_len(mbatch)
        except ValueError:
            seq = None
    return TrainTrace(
        base.ops, base.tensors, base.gens, base.keyed_scalars, plan=plan,
        granularity=granularity, batch_size=bs, data_axes=eng.data_axes,
        meshed=mesh is not None, mesh=mesh, outputs=outputs,
        optimizer=optimizer if apply else "none",
        global_clip=global_clip if apply else None, seq=seq,
        param_ids=pids,
        param_labels=tuple(path_str(p) for p in tree_paths(mparams)),
        opt_ids=oids, batch_ids=bids, reference=ref)
