"""Builders that trace the REAL program families (port of
`paddle_tpu/analysis/programs.py`).

The audit's whole value is that it inspects the programs the port
actually runs — not idealized stand-ins. Each builder runs the genuine
code path (the `HybridParallelEngine` train step, the `PagedEngine`'s
device functions, `fused_linear_cross_entropy`, `adamw_update`) at a
CPU-friendly toy size and returns `AuditProgram` records holding the
traced `GraphModule`.

How a program is traced (`trace`): `make_fx` over fake tensors, so no
flop runs and no pointer is read. A kernel's wrapper sees fake tensors
and goes through its custom operator (one node: `paddle_tpu_torch::
flash_fwd`, `::paged_decode_attention`, ...), a backward taken inside the
function is part of the graph, and an in-place write stays an in-place
node. Never trace with real tensors: a wrapper would launch its kernel
off the record (`kernels/_build.launch` raises instead). The tensors of
the arguments become the program's inputs, in pytree order; a model
(`nn.Module`) argument is lifted to its named parameters and buffers,
which `torch.func.functional_call` swaps in while the function runs; every other leaf (an int, a flag) is
fixed at trace time, as the reference fixes a static argument.

Serving programs are captured, not reconstructed: the engine's device
functions are wrapped with a `_Recorder`, a couple of tiny requests are
served, and the recorded arguments of the first call are traced through
the same function. A signature change in the engine therefore can't
silently diverge from what the audit inspects.

Every builder takes `device=`: None (the default) is the card, as
everywhere in the port, and raises without one; the tests pass "cpu".
`chip_smoke.py`'s analysis phase runs the toy families on the card and
traces the same functions at 7B width.
The toy builders are memoized per process and device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import DataDependentOutputException
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode

from paddle_tpu_torch.analysis import graph_walk

__all__ = ["AuditProgram", "TOY", "TOY_CARD", "TOY_BATCH", "TOY_SEQ",
           "TOY_CHUNK", "toy_geometry",
           "toy_args", "trace", "patched", "fused_ce_programs",
           "train_step_program", "train_step_trace",
           "opt_writeback_program", "serving_programs", "disagg_programs"]

# one toy geometry for every family: 2 layers, divisible by a degree-2
# TP mesh (heads, kv heads, intermediate), tiny enough that every build
# in this module traces in seconds on the CPU. intermediate_size must NOT
# equal vocab_size or the forbidden-(b,s,vocab) probe would false-flag
# the MLP intermediates.
TOY = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
           num_layers=2, num_heads=2, num_kv_heads=2)
TOY_BATCH, TOY_SEQ, TOY_CHUNK = 2, 16, 8
# on a card the toy's head_dim is 64: the engines launch the decode
# kernels while they serve, and B4-B7 take head_dim 64 or 128 only
TOY_CARD = dict(TOY, hidden_size=128)

# a read the fake trace cannot answer (a branch, int() or bool() on a
# traced value): the trace stops there, and the line is the finding
_HOST_READS = (GuardOnDataDependentSymNode, DataDependentOutputException)


@dataclasses.dataclass
class AuditProgram:
    """One traced program, ready for rules.

    graph_module: the GraphModule (None when a host read stopped the
                  trace; `host_reads` then says where).
    example_args: the positional arguments it was traced on (a model
                  lifted to its parameter and buffer dict).
    donated:      argnums whose tensors the program must write in place.
    leaves:       [(argnum or kwarg name, key path)] of each traced input,
                  in the graph's placeholder order.
    host_reads:   [(provenance, what)] of a trace stopped by a host read.
    meta:         program-specific context (forbidden shapes, policy).
    """

    name: str
    graph_module: object = None
    example_args: tuple = ()
    donated: tuple = ()
    arg_names: tuple | None = None
    leaves: list = dataclasses.field(default_factory=list)
    host_reads: list = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)
    _flatten: object = None

    def flat_inputs(self, *args, **kwargs):
        """The tensors of (args, kwargs) in the graph's input order."""
        return self._flatten(args, kwargs)

    def run(self, *args, **kwargs):
        """Run the traced graph on real arguments of the traced structure
        (the same non-tensor leaves); returns the function's outputs. Its
        in-place writes land in the given tensors."""
        if self.graph_module is None:
            raise RuntimeError(f"{self.name}: the trace stopped at a host "
                               f"read: {self.host_reads}")
        with torch.no_grad():
            return self.graph_module(self.flat_inputs(*args, **kwargs))

    def node_counts(self):
        """{operator name: node count} over the graph and its subgraphs."""
        counts = {}
        for node, _ in graph_walk.iter_eqns(self.graph_module):
            k = graph_walk.op_name(node)
            counts[k] = counts.get(k, 0) + 1
        return counts


def _lift(args):
    """(args with each nn.Module replaced by its {name: tensor} dict of
    parameters and buffers, {argnum: module})."""
    modules, out = {}, []
    for i, a in enumerate(args):
        if isinstance(a, torch.nn.Module):
            modules[i] = a
            out.append({**dict(a.named_parameters()),
                        **dict(a.named_buffers())})
        else:
            out.append(a)
    return tuple(out), modules


class _Call(torch.nn.Module):
    """fn(*args, **kwargs) with the module arguments held as submodules, so
    that `torch.func.functional_call` swaps their parameters and buffers
    for the traced inputs while fn runs."""

    def __init__(self, fn, modules):
        super().__init__()
        self.fn = fn
        self.mods = torch.nn.ModuleDict(
            {str(i): m for i, m in modules.items()})

    def forward(self, args, kwargs):
        args = list(args)
        for i, m in self.mods.items():
            args[int(i)] = m
        return self.fn(*args, **kwargs)


def _flattener(spec):
    def flatten(args, kwargs):
        lifted, _ = _lift(args)
        leaves, got = pytree.tree_flatten((lifted, kwargs))
        if got != spec:
            raise ValueError(f"arguments of another structure than the "
                             f"traced one: {got} != {spec}")
        return [x for x in leaves if isinstance(x, torch.Tensor)]
    return flatten


@contextlib.contextmanager
def _generators_as_constants():
    """Let a traced op take a `torch.Generator` argument (the seeded
    stochastic rounding of bf16 moments): the generator becomes a
    constant of the graph, read through a `get_attr` node, where the
    tracer of some torch versions has no way to record one."""
    from torch.fx.proxy import TracerBase

    orig = TracerBase.create_arg

    def create_arg(self, a):
        if isinstance(a, torch.Generator) and hasattr(self, "root"):
            names = self.__dict__.setdefault("_generator_names", {})
            if id(a) not in names:
                names[id(a)] = f"_generator_{len(names)}"
                setattr(self.root, names[id(a)], a)
            return self.create_node("get_attr", names[id(a)], (), {})
        return orig(self, a)

    TracerBase.create_arg = create_arg
    try:
        yield
    finally:
        TracerBase.create_arg = orig


def trace(name, fn, args, kwargs=None, donated=(), arg_names=None,
          meta=None):
    """fn(*args, **kwargs) traced with `make_fx` over fake tensors into an
    AuditProgram (module docstring). A host read that stops the trace is
    recorded in `host_reads` with the line that read."""
    kwargs = dict(kwargs or {})
    lifted, modules = _lift(args)
    with_paths, spec = pytree.tree_flatten_with_path((lifted, kwargs))
    statics = [x for _, x in with_paths]
    tensor_at = [i for i, x in enumerate(statics)
                 if isinstance(x, torch.Tensor)]
    leaves = []
    for i in tensor_at:
        path = with_paths[i][0]
        top, key = path[1], path[2:]
        where = top.idx if path[0].idx == 0 else top.key
        leaves.append((where, pytree.keystr(key)))

    call = _Call(fn, modules)

    def run(flat):
        ls = list(statics)
        for i, t in zip(tensor_at, flat):
            ls[i] = t
        a, k = pytree.tree_unflatten(ls, spec)
        state = {f"mods.{i}.{n}": t for i in modules for n, t in a[i].items()}
        return torch.func.functional_call(call, state, (a, k))

    prog = AuditProgram(name, example_args=lifted, donated=tuple(donated),
                        arg_names=arg_names, leaves=leaves,
                        meta=dict(meta or {}),
                        _flatten=_flattener(spec))
    flat = [statics[i] for i in tensor_at]
    with graph_walk.stamping(), _generators_as_constants():
        try:
            prog.graph_module = make_fx(
                run, tracing_mode="fake", _allow_non_fake_inputs=True)(flat)
        except _HOST_READS as e:
            fr = graph_walk.frame_of_traceback(e.__traceback__)
            line = (graph_walk.provenance_of(fr) if fr is not None else "")
            prog.host_reads.append(
                (line, f"{type(e).__name__}: "
                       f"{str(e).splitlines()[0][:160]}"))
    return prog


@contextlib.contextmanager
def patched(owner, attr, new):
    """owner.attr = new while the block runs."""
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    try:
        yield new
    finally:
        setattr(owner, attr, old)


def _snapshot(tree):
    """The tree with every tensor cloned (strides kept): what a call was
    given, before it writes its state in place."""
    return pytree.tree_map(
        lambda t: t.clone(memory_format=torch.preserve_format)
        if isinstance(t, torch.Tensor) else t, tree)


class _Recorder:
    """Wrap one of the engine's device functions; record the first call's
    arguments (a copy of each tensor, taken before the call writes its
    state; a model is kept as it is), so that the exact program can be
    traced for audit and run again on the same inputs. `trace` traces the
    wrapped function on them."""

    def __init__(self, fn):
        self.fn = fn
        self.args = None
        self.kwargs = {}

    def __call__(self, *a, **k):
        if self.args is None:
            self.args = _snapshot(a)
            self.kwargs = _snapshot(dict(k))
        return self.fn(*a, **k)

    def trace(self, name, donated=(), meta=None):
        if self.args is None:
            return None
        return trace(name, self.fn, self.args, self.kwargs, donated=donated,
                     meta=meta)


def toy_geometry(device=None):
    """"card" (TOY_CARD) on a CUDA device, else "cpu" (TOY): the geometry
    the toy builders trace on `device`, which picks the byte ceilings."""
    from paddle_tpu_torch.device import resolve_device

    return "card" if resolve_device(device).type == "cuda" else "cpu"


def toy_args(device=None):
    from paddle_tpu_torch.models import llama_functional as lf

    toy = TOY_CARD if toy_geometry(device) == "card" else TOY
    return lf.LlamaArgs(rope_theta=10000.0, rms_eps=1e-6, use_flash=False,
                        **toy)


@functools.lru_cache(maxsize=None)
def fused_ce_programs(device=None):
    """Fused-CE fwd+bwd (the no-[b,s,vocab] family) AND the unchunked
    reference — the reference is the teeth check: it MUST trip the
    forbidden-shape rule or the probe has silently gone blind."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models import llama_functional as lf

    dev = resolve_device(device)
    args = toy_args(device)
    b, s, chunk = TOY_BATCH, TOY_SEQ, TOY_CHUNK
    g = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((b, s, args.hidden_size), generator=g, device=dev) * 0.5
    head = torch.randn((args.hidden_size, args.vocab_size), generator=g,
                       device=dev) * 0.05
    labels = torch.randint(0, args.vocab_size, (b, s), generator=g,
                           device=dev)

    def value_and_grad(loss_fn):
        def fn(a, w):
            a, w = a.requires_grad_(True), w.requires_grad_(True)
            with torch.enable_grad():
                loss = loss_fn(a, w)
                return (loss,) + torch.autograd.grad(loss, (a, w))
        return fn

    fused = trace("fused_ce_fwd_bwd", value_and_grad(
        lambda a, w: lf.fused_linear_cross_entropy(a, w, labels, chunk)),
        (h, head))
    ref = trace("unchunked_ce_reference", value_and_grad(
        lambda a, w: lf.parallel_cross_entropy(a @ w, labels)), (h, head))
    for p in (fused, ref):
        p.meta.update(forbidden_shape=(b, s, args.vocab_size),
                      toy=toy_geometry(device))
    return fused, ref


def train_step_trace(engine, params, opt_state, ids, labels,
                     name="hybrid_train_step"):
    """The engine's REAL train step (`build_train_step`) traced on
    (params, opt_state, ids, labels): the forward and loss, the backward
    (`loss.backward()` accumulating into `.grad`) and the in-place AdamW
    update, with params and the optimizer state donated (argnums 0, 1).

    The step counter `opt_state["step"]` is a 0-d CPU tensor by design
    (`adamw_init`: the bias corrections are read without waiting for the
    card); it stays out of the traced inputs, as the reference keeps a
    static argument: the program is fixed to the step it was traced at."""
    step_counter = opt_state["step"]
    state = {k: v for k, v in opt_state.items() if k != "step"}
    ids, labels = engine.shard_batch(ids, labels)
    step = engine.build_train_step()

    def fn(params, state, ids, labels):
        from paddle_tpu_torch.core.tree import tree_leaves

        for p in tree_leaves(params):
            p.requires_grad_(True)
        with torch.enable_grad():
            return step(params, dict(state, step=step_counter), ids,
                        labels)[0]

    policy = "bf16" if engine.dtype == torch.bfloat16 else "f32"
    b = ids.shape[0] * ids.shape[1]
    return trace(name, fn, (params, state, ids, labels), donated=(0, 1),
                 arg_names=("params", "opt_state", "ids", "labels"),
                 meta={"policy": policy, "forbidden_shape": (
                     b, ids.shape[2], engine.args.vocab_size)})


@functools.lru_cache(maxsize=None)
def train_step_program(dtype_name="bfloat16", device=None):
    """The hybrid engine's REAL train step at TOY, bf16 params, chunked
    fused-CE loss, bf16 moments + f32 master weights, remat off: the
    program the MFU headline runs. Donates params and optimizer state."""
    from paddle_tpu_torch.distributed.hybrid_engine import \
        HybridParallelEngine

    eng = HybridParallelEngine(
        toy_args(device), dtype=getattr(torch, dtype_name), remat=False,
        loss_chunk=TOY_CHUNK, moments="bf16", master_weights=True,
        device=device)
    params, opt = eng.init_state(0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TOY["vocab_size"], (TOY_BATCH, TOY_SEQ))
    labels = rng.integers(0, TOY["vocab_size"], (TOY_BATCH, TOY_SEQ))
    p = train_step_trace(eng, params, opt, ids, labels)
    p.meta["toy"] = toy_geometry(device)
    return p


@functools.lru_cache(maxsize=None)
def opt_writeback_program(moments="bf16", device=None):
    """The optimizer write-back on its own: one tree-level `adamw_update`
    over bf16 params (no master weights), params + optimizer state donated
    (argnums 0, 2); the step counter stays on the host, as in
    `train_step_trace`."""
    from paddle_tpu_torch.core.tree import tree_map
    from paddle_tpu_torch.distributed.hybrid_engine import (adamw_init,
                                                            adamw_update)
    from paddle_tpu_torch.models import llama_functional as lf

    params = lf.init_params(toy_args(device), device=device,
                            dtype=torch.bfloat16)
    grads = tree_map(torch.ones_like, params)
    state = adamw_init(params, moments=moments, master_weights=False)
    step_counter = state.pop("step")

    def fn(params, grads, state):
        adamw_update(params, grads, dict(state, step=step_counter),
                     moments=moments)
        return params, state

    return trace("fused_opt_writeback", fn, (params, grads, state),
                 donated=(0, 2), arg_names=("params", "grads", "opt_state"),
                 meta={"policy": "bf16", "toy": toy_geometry(device)})


def _toy_model(device):
    from paddle_tpu_torch.models import llama_functional as lf
    from paddle_tpu_torch.models.llama import Llama

    args = toy_args(device)
    return Llama(args, lf.init_params(args, device=device))


def _prompt(rng, n, vocab):
    return rng.integers(1, vocab, size=n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def serving_programs(tp=0, device=None):
    """Capture the PagedEngine's device functions by serving tiny requests
    through three engines (plain: prefill/decode, the COW page copy; an
    int8 pool: the same; with a draft: the speculative verify), then trace
    the recorded calls: `generation._paged_forward_decode` and
    `_paged_forward_verify`, `paged_engine._paged_prefill` (the prefill
    behind `PagedEngine._prefill_device`) and `PagedEngine._copy_page`.
    Returns {name: AuditProgram};
    each program donates the pool it writes (pk, pv).

    tp > 0 raises NotImplementedError: `PagedEngine(mesh=)` is not ported
    (ROADMAP A9), so the TP goldens stay data for it."""
    if tp:
        raise NotImplementedError(
            f"serving_programs(tp={tp}): tensor-parallel serving is not "
            "ported yet (ROADMAP A9); the port audits the one-card "
            "programs (tp=0)")
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.serving import paged_engine as pe
    from paddle_tpu_torch.serving import PagedEngine, Request

    model = _toy_model(device)
    vocab = model.args.vocab_size
    kw = dict(max_slots=2, max_len=32, page_size=8, min_bucket=8,
              device=device)
    meta = {"toy": toy_geometry(device)}
    rng = np.random.default_rng(7)
    out, recs, donated = {}, {}, {}

    def serve(eng, suffix):
        pre = recs[f"paged_prefill{suffix}"] = _Recorder(pe._paged_prefill)
        dec = recs[f"paged_decode{suffix}"] = _Recorder(
            gen._paged_forward_decode)
        donated[f"paged_prefill{suffix}"] = (5, 6)
        donated[f"paged_decode{suffix}"] = (2, 3)
        with patched(pe, "_paged_prefill", pre), \
                patched(gen, "_paged_forward_decode", dec):
            eng.serve([Request(_prompt(rng, 16, vocab), max_new_tokens=4),
                       Request(_prompt(rng, 10, vocab), max_new_tokens=3)])
        # the COW page copy never fires on the natural flow (the allocator
        # only copies shared or registered tail pages): traced directly on
        # the live pool
        out[f"page_copy{suffix}"] = trace(
            f"page_copy{suffix}", _page_copy(eng), (eng._pk, eng._pv, 1, 2),
            donated=(0, 1), meta=meta)

    serve(PagedEngine(model, **kw), "")
    serve(PagedEngine(model, kv_dtype="int8", **kw), "_int8")

    draft = gen.draft_from_params(model, 1)
    spec = PagedEngine(model, draft_params=draft, spec_tokens=2, **kw)
    recs["spec_verify"] = _Recorder(gen._paged_forward_verify)
    donated["spec_verify"] = (2, 3)
    with patched(gen, "_paged_forward_verify", recs["spec_verify"]):
        spec.serve([Request(_prompt(rng, 9, vocab), max_new_tokens=4)])

    for name, rec in recs.items():
        p = rec.trace(name, donated=donated[name], meta=meta)
        if p is not None:   # never dispatched: presets reports it
            out[name] = p
    return out


def _page_copy(eng):
    """`PagedEngine._copy_page` as a function of the pools."""
    def copy_page(pk, pv, src, dst):
        saved = eng._pk, eng._pv
        eng._pk, eng._pv = pk, pv
        try:
            eng._copy_page(src, dst)
        finally:
            eng._pk, eng._pv = saved
        return pk, pv
    return copy_page


@functools.lru_cache(maxsize=None)
def disagg_programs(device=None):
    """Capture the disaggregated-serving + router device programs by
    migrating tiny requests end to end (prefill worker -> LocalTransport
    -> decode worker, model-dtype AND int8 pools) and serving a couple of
    GPT requests through the router's `GptEngine`:

      page_extract[_int8]   the prefill side's gather of a request's
                            pages (`disagg._extract_pages`; donates
                            nothing — the pool must survive the ship)
      page_scatter[_int8]   the decode side's write of shipped pages into
                            fresh ones (`disagg._scatter_pages`; donates
                            the pool half it writes)
      gpt_prefill/gpt_decode  `models.gpt._gpt_forward_cached` as
                            `GptEngine._prefill_device` and
                            `_decode_device` call it (donated KV stripes)

    Returns {name: AuditProgram}."""
    from paddle_tpu_torch.models import gpt as gpt_m
    from paddle_tpu_torch.serving import Request
    from paddle_tpu_torch.serving import disagg
    from paddle_tpu_torch.serving.router import GptEngine

    model = _toy_model(device)
    vocab = model.args.vocab_size
    kw = dict(max_slots=2, max_len=32, page_size=8, min_bucket=8,
              device=device)
    meta = {"toy": toy_geometry(device)}
    rng = np.random.default_rng(11)
    recs, donated = {}, {}

    def migrate(kv_dtype, suffix):
        lt = disagg.LocalTransport()
        pw = disagg.PrefillWorker(model, transport=lt, kv_dtype=kv_dtype,
                                  **kw)
        done = []
        dw = disagg.DecodeWorker(model, transport=lt, kv_dtype=kv_dtype,
                                 completion_cb=done.append, **kw)
        ext = recs[f"page_extract{suffix}"] = _Recorder(
            disagg._extract_pages)
        sca = recs[f"page_scatter{suffix}"] = _Recorder(
            disagg._scatter_pages)
        donated[f"page_extract{suffix}"] = ()
        donated[f"page_scatter{suffix}"] = (0,)
        with patched(disagg, "_extract_pages", ext), \
                patched(disagg, "_scatter_pages", sca):
            pw.submit(Request(_prompt(rng, 12, vocab), max_new_tokens=3))
            for _ in range(64):
                if not (pw.queue or pw.slots.active_slots
                        or pw._chunk_streams):
                    break
                pw.step()
            for _ in range(64):
                if done:
                    break
                dw.step()
        if not done:
            raise RuntimeError("migration never completed — capture "
                               "harness broken")

    migrate(None, "")
    migrate("int8", "_int8")

    gpt = GptEngine(_gpt_toy(device), max_slots=2, max_len=32,
                    min_bucket=8, device=device)
    for name, method in (("gpt_prefill", "_prefill_device"),
                         ("gpt_decode", "_decode_device")):
        rec = recs[name] = _Recorder(gpt_m._gpt_forward_cached)
        donated[name] = (2, 3)
        setattr(gpt, method, _within(getattr(gpt, method), gpt_m,
                                     "_gpt_forward_cached", rec))
    gpt.serve([Request(_prompt(rng, 10, 64), max_new_tokens=3),
               Request(_prompt(rng, 6, 64), max_new_tokens=2)])

    out = {}
    for name, rec in recs.items():
        p = rec.trace(name, donated=donated[name], meta=meta)
        if p is not None:   # never dispatched: presets reports it
            out[name] = p
    return out


def _within(method, owner, attr, rec):
    """`method` with owner.attr replaced by `rec` while it runs."""
    def call(*a, **k):
        with patched(owner, attr, rec):
            return method(*a, **k)
    return call


@functools.lru_cache(maxsize=None)
def _gpt_toy(device=None):
    """Toy GPT-2 for the router's second autoregressive family — same
    scale discipline as TOY (2 layers, degree-2-divisible heads, a
    position table bounding max_len=32, TOY_CARD's width on a card),
    weights drawn from seed 0."""
    from paddle_tpu_torch.models.gpt import Gpt, GPTGenArgs

    args = GPTGenArgs(vocab_size=64, hidden_size=toy_args(device).hidden_size,
                      num_layers=2, num_heads=2, max_position_embeddings=32,
                      intermediate_size=48)
    return Gpt(args, device=device)
